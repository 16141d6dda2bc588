"""Natural-gradient VI updates for the Gaussian variational distribution
q(u) = N(m, S), S = L L^T: the port of the JAX package's `train/natgrad.py`.

Natural parameters theta1 = S^{-1} m, theta2 = -1/2 S^{-1}; expectation
parameters eta1 = m, eta2 = S + m m^T.  The natural-gradient step in theta
is the ordinary gradient in eta:

    theta  <-  theta + gamma * dELBO/deta,
    dELBO/deta1 = dELBO/dm - 2 (dELBO/dS) m,     dELBO/deta2 = dELBO/dS,

with dELBO/d(m, S) taken at fixed hyperparameters, S entering the ELBO
through its Cholesky factor.  For a conjugate ELBO (Gaussian likelihood,
identity flow, fixed hyperparameters, full batch) one step at gamma = 1
lands on the optimal q(U).

The step fails only when the new precision -2 theta2 is not positive
definite.  Then gamma is halved, up to `max_halvings` times, and a step
that cannot be made positive definite leaves q(U) as it was.  Where the
JAX package's Cholesky returns NaN, `torch.linalg.cholesky_ex` reports
`info > 0`: a step is taken when both factorisations succeed and the new
(m, L) are finite, the JAX package's condition.  Deciding that reads one
boolean back to the host for each attempt, so a natgrad step syncs the
host with the device once when no halving is needed.

The Trainer's fused step (`natgrad_train_step`) writes the loss as a
function of (params, m, S): one forward and one backward give both the
hyperparameter gradients, for the grouped optimizer with q_mu and q_L
frozen, and dELBO/d(m, S).  Everything is batched over q(U)'s leading axis
(1 when q(U) is shared, else Dy).  The battery's step
(`natgrad_multiseed_step`) does the same on a replica-stacked tree, each
replica halving its own gamma (`natgrad_apply_replicas`).
"""

from __future__ import annotations

import numpy as np
import torch

from ..models import tgp as tgp_mod
from ..ops.linalg import tril_mask, tril_solve, triu_solve
from ..weights import tree_leaves


def _sym(A):
    return 0.5 * (A + A.transpose(-1, -2))


def _qu_ms(params):
    m = params["q_mu"]
    Lq = tril_mask(params["q_L"])
    return m, Lq, Lq @ Lq.transpose(-1, -2)


def _attempts(spec, params, dm, dS):
    """(m, Lq, attempt): the current q(U) and attempt(g), the step at gamma
    g: (m_new, L_new, fine), `fine` per factor (q(U)'s leading axes) where
    both factorisations succeeded and the new (m, L) are finite.  g is a
    number, or a tensor with one entry per index of q(U)'s first axis."""
    m, Lq, _ = _qu_ms(params)
    eye = torch.eye(spec.M, dtype=Lq.dtype, device=Lq.device).expand(Lq.shape)
    # S^{-1} and theta from the current factor (an unconstrained lower
    # triangle, still a valid triangular-solve operand)
    Linv = tril_solve(Lq, eye)
    Sinv = Linv.transpose(-1, -2) @ Linv
    theta1 = (Sinv @ m[..., None])[..., 0]
    theta2 = -0.5 * Sinv
    deta1 = dm - 2.0 * (dS @ m[..., None])[..., 0]

    def scaled(g, t):
        if torch.is_tensor(g):
            g = g.reshape(g.shape + (1,) * (t.ndim - g.ndim))
        return g * t

    def attempt(g):
        t1 = theta1 + scaled(g, deta1)
        t2 = theta2 + scaled(g, dS)
        Lp, info = torch.linalg.cholesky_ex(-2.0 * _sym(t2))   # new precision
        Lpi = tril_solve(Lp, eye)
        S_new = Lpi.transpose(-1, -2) @ Lpi
        half = tril_solve(Lp, t1[..., None])
        m_new = triu_solve(Lp.transpose(-1, -2), half)[..., 0]
        L_new, info2 = torch.linalg.cholesky_ex(_sym(S_new))
        fine = ((info == 0) & (info2 == 0) & torch.isfinite(m_new).all(-1)
                & torch.isfinite(L_new).all(-1).all(-1))
        return m_new, L_new, fine

    return m, Lq, attempt


@torch.no_grad()
def natgrad_apply(spec, params, dm, dS, gamma, max_halvings: int = 8):
    """One natural-gradient ascent step, given dELBO/d(m, S) (dS symmetric).
    Returns the params with the new q_mu and q_L (the others as they are).
    `gamma` is a number; it is applied in the params' dtype."""
    m, Lq, attempt = _attempts(spec, params, dm, dS)
    g = torch.tensor(float(gamma), dtype=Lq.dtype).item()  # gamma in the dtype
    m_new, L_new, fine = attempt(g)
    k = 0
    while not bool(fine.all()) and k < max_halvings:
        g *= 0.5
        m_new, L_new, fine = attempt(g)
        k += 1
    if not bool(fine.all()):
        m_new, L_new = m, Lq
    return dict(params, q_mu=m_new, q_L=L_new)


@torch.no_grad()
def natgrad_apply_replicas(spec, params, dm, dS, gamma,
                           max_halvings: int = 8):
    """`natgrad_apply` for each replica of a stacked battery (every tree
    with a leading replica axis R), each with its own halving: a replica
    whose step fails halves its own gamma while the others keep theirs, and
    each ends where it would alone.  One (R,) flag comes to the host per
    attempt."""
    m, Lq, attempt = _attempts(spec, params, dm, dS)
    R = m.shape[0]

    def ok_of(fine):
        return fine.reshape(R, -1).all(-1).cpu().numpy()

    g = np.full(R, torch.tensor(float(gamma), dtype=Lq.dtype).item())
    gt = lambda: torch.as_tensor(g, dtype=Lq.dtype, device=Lq.device)  # noqa: E731
    m_new, L_new, fine = attempt(gt())
    ok = ok_of(fine)
    k = 0
    while not ok.all() and k < max_halvings:
        g = np.where(ok, g, 0.5 * g)
        m2, L2, fine2 = attempt(gt())
        redo = torch.as_tensor(~ok, device=m.device)
        m_new = torch.where(redo[:, None, None], m2, m_new)
        L_new = torch.where(redo[:, None, None, None], L2, L_new)
        ok = ok | ok_of(fine2)
        k += 1
    if not ok.all():
        keep = torch.as_tensor(ok, device=m.device)
        m_new = torch.where(keep[:, None, None], m_new, m)
        L_new = torch.where(keep[:, None, None, None], L_new, Lq)
    return dict(params, q_mu=m_new, q_L=L_new)


def _params_of_ms(params):
    """(params with q(U) given by leaf tensors m and S, L = chol(sym(S)),
    m, S), m and S requiring grad."""
    m, _, S = _qu_ms(params)
    m = m.detach().requires_grad_(True)
    S = S.detach().requires_grad_(True)
    return dict(params, q_mu=m, q_L=torch.linalg.cholesky(_sym(S))), m, S


def natgrad_update(spec, params, X, Y, rng, gamma, max_halvings: int = 8):
    """A standalone step: dELBO/d(m, S) at `params`, then `natgrad_apply`.
    (The Trainer uses `natgrad_train_step`, which shares the backward pass
    with the hyperparameter gradients.)"""
    p, m, S = _params_of_ms(params)
    e = tgp_mod.elbo(spec, p, X, Y, rng)[0]
    dm, dS = torch.autograd.grad(e, (m, S))
    return natgrad_apply(spec, params, dm, _sym(dS), gamma,
                         max_halvings=max_halvings)


def gamma_at(gamma, warmup, t):
    """Linear warmup ramp: gamma * min(1, (t + 1) / warmup); t a number or
    a numpy array."""
    return gamma * np.minimum(1.0, (np.asarray(t) + 1.0) / float(warmup))


def natgrad_train_step(spec, optimizer, gamma, value_and_grad):
    """The fused hybrid step: one backward gives the hyperparameter
    gradients, which `optimizer` (the Trainer's phase step: a function of
    the gradients in `tree_leaves` order, q_mu and q_L frozen) applies in
    place, and dELBO/d(m, S), for the natural-gradient step on q(U), which
    is then written into params["q_mu"] and params["q_L"] in place.

        step(params, X, Y, g=None) -> (elbo, ell, kld)

    `g` overrides gamma for one call (the warmup ramp's).
    `value_and_grad(p, X, Y, wrt) -> (elbo, ell, kld, grads)` is the
    Trainer's: the ELBO of p and the gradient of its negative with respect
    to `wrt` (on a mesh, the rank's block, summed)."""

    def step(params, X, Y, g=None):
        leaves = tree_leaves(params)
        p, m, S = _params_of_ms(params)
        e, ell, kld, (*grads, gm, gS) = value_and_grad(
            p, X, Y, leaves + [m, S])
        optimizer(grads)
        new = natgrad_apply(spec, params, -gm, -_sym(gS),
                            gamma if g is None else g)
        with torch.no_grad():
            params["q_mu"].copy_(new["q_mu"])
            params["q_L"].copy_(new["q_L"])
        return e.detach(), ell.detach(), kld.detach()

    return step


def guard_step_arch(spec, gamma, force: bool = False, threshold: float = 0.3):
    """Refuse a gamma above `threshold` with a step-flow arch (the flow or
    the warped likelihood's warp) unless `force`, which prints a warning
    instead: gamma=1.0 mis-converged 7/10 boston StepTanhL seeds at full
    length with plausible ELBO curves, and a warmup ramp does not rescue
    it (the JAX package's measurement, PARITY.md natgrad section)."""
    flow = tuple(getattr(spec, "flow", None) or ())
    lik = getattr(spec, "likelihood", None)
    flow = flow + tuple(getattr(lik, "warp_flow", None) or ())
    if gamma > threshold and any(
            getattr(st, "kind", None) == "step_flow" for st in flow):
        msg = (f"natgrad_gamma={gamma} with a step-flow arch mis-converged "
               f"7/10 boston StepTanhL seeds at full length with "
               f"plausible-looking ELBO curves, and a warmup ramp does not "
               f"rescue it (PARITY.md natgrad section); use "
               f"gamma<={threshold} for Step* archs")
        if not force:
            raise ValueError(
                msg + ", or pass natgrad_force=True / --natgrad_force to "
                "run this configuration anyway")
        print("WARNING (forced): " + msg, flush=True)


def warn_if_step_arch(spec, gamma, threshold: float = 0.3):
    """`guard_step_arch` forced: it warns and never refuses."""
    guard_step_arch(spec, gamma, force=True, threshold=threshold)


def natgrad_multiseed_step(spec, optimizer, gamma):
    """The fused hybrid step on a stacked battery (`train/multiseed.py`):
    every tree carries a leading replica axis R.  One mapped ELBO over the
    replicas (`torch.func.vmap`), one backward of their sum (the terms are
    independent, so each replica gets its own gradients), `optimizer` on
    the hyperparameters (q_mu and q_L frozen), then the natural-gradient
    step on q(U) per replica (`natgrad_apply_replicas`), written in place.

        step(params, X, Y, elbo_map, g=None) -> (3, R): elbo, ell, kld

    `elbo_map(params, X, Y)` is the battery's mapped ELBO; `g` overrides
    gamma for one call (the warmup ramp's)."""

    def step(params, X, Y, elbo_map, g=None):
        leaves = tree_leaves(params)
        m, _, S = _qu_ms(params)
        m = m.detach().requires_grad_(True)
        S = S.detach().requires_grad_(True)
        # cholesky_ex: torch.linalg.cholesky checks its info on the host,
        # which the map refuses; a factor that fails is NaN here and fails
        # the step's halving test as it would alone
        L = torch.linalg.cholesky_ex(_sym(S)).L
        e, ell, kld = elbo_map(dict(params, q_mu=m, q_L=L), X, Y)
        *grads, gm, gS = torch.autograd.grad(
            -e.sum(), leaves + [m, S], allow_unused=True,
            materialize_grads=True)
        optimizer(grads)
        new = natgrad_apply_replicas(spec, params, -gm, -_sym(gS),
                                     gamma if g is None else g)
        with torch.no_grad():
            params["q_mu"].copy_(new["q_mu"])
            params["q_L"].copy_(new["q_L"])
        return torch.stack([e.detach(), ell.detach(), kld.detach()])

    return step
