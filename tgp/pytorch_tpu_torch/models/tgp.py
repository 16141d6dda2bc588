"""Transformed Gaussian Process (TGP): the counterpart of the JAX package's
`models/tgp.py`.

Everything is a plain function of (spec, params): `TGPSpec` is static,
params is a dict tree of tensors with the JAX package's layout (inducing
locations Z, q(U) (q_mu, q_L), kernel/mean/flow/likelihood parameters).
The JAX package's `vmap` over the Dy outputs becomes a leading batch
dimension.

`marginal_qf` has the JAX package's four branches.  Whitened:
  q(f) = N( K_xz L^{-T} m + mu_x,
            K_xx - K_xz K_zz^{-1} K_zx + K_xz L^{-T} S L^{-1} K_zx );
unwhitened (whiten=False):
  q(f) = N( K_xz K_zz^{-1} (m - mu_z) + mu_x,
            K_xx - K_xz K_zz^{-1} K_zx + K_xz K_zz^{-1} S K_zz^{-1} K_zx ),
with L = chol(K_zz + jitter I), S = tril(Lq) tril(Lq)^T; each with the
covariance's diagonal or (diagonal=False) the full (MB, MB) matrix.
`fast_solves` forms L^{-1} once and applies it by GEMMs;
`solve_precision` sets the precision of the factor's applications
(`ops.linalg.einsum_at`), never of K_zz or its Cholesky.  The unwhitened
KL takes `marginal_qf`'s K_zz and factor inside `elbo`, so a step still
makes one Gram pair and one backward call for each rbf leaf of the kernel.

Every flow kind is ported, the input-dependent (hypernet) steps included,
with the VI hypernets' KL term in the ELBO and fully-Bayesian prediction:
S_MC hypernet draws on one leading axis, one `marginal_qf` for all of
them; per-output flow architectures (`flow_per_output`) loop the outputs.
Every likelihood is ported: Gaussian, Gaussian through the flow, the
warped GP (an observation warp T), and classification (Bernoulli with a
Gauss-CDF link, categorical MC softmax).  The public functions dispatch
on `spec.layers` to the deep TGP (`models/deep.py`).

`spec.remat` recomputes `marginal_qf` and the warp in the backward pass
(`torch.utils.checkpoint`), replaying the warp's draws (`_remat`): the same
value and gradients, and one more launch of the Gram kernel's forward a
step (2 forward, 1 backward for each rbf leaf).  A deep TGP has no remat.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch

from .. import config as cfg
from ..ops import kernels as kernels_mod
from ..ops.kernels import KernelSpec
from ..ops.linalg import (cholesky_solve, einsum_at, kl_gaussian,
                          kl_whitened, safe_cholesky, tril_mask, tril_solve,
                          triu_solve)
from ..ops.quadrature import GaussHermite
from ..flows import hypernet
from ..flows.core import (
    FlowCtx,
    FlowStep,
    IDENTITY_SPEC,
    check_step,
    finalize_bn,
    flow_forward,
    flow_inverse,
    flow_kld,
    init_flow_params,
    is_identity_spec,
)
from ..likelihoods.classification import (
    bernoulli_ell_at,
    bernoulli_moments,
    bernoulli_nodes,
    categorical_ell_at,
    categorical_moments,
    categorical_nodes,
)
from ..likelihoods.gaussian import (
    LikelihoodSpec,
    check_likelihood,
    init_likelihood_params,
    noise_variance,
    gaussian_ell,
    gaussian_flow_ell_at,
    gaussian_flow_nodes,
    gaussian_moments,
    gaussian_flow_moments,
)
from ..likelihoods.warped import warped_ell, warped_moments
from .means import mean_init, mean_apply


# ===========================================================================
# Spec
# ===========================================================================

@dataclasses.dataclass(frozen=True)
class TGPSpec:
    """Static TGP model description (the JAX package's fields)."""

    Dy: int
    Dx: int
    M: int
    N: float
    kernel: KernelSpec
    likelihood: LikelihoodSpec
    flow: Tuple[FlowStep, ...] = IDENTITY_SPEC
    flow_per_output: Optional[Tuple[Tuple[FlowStep, ...], ...]] = None
    mean: str = "zero"
    whiten: bool = True
    Z_is_shared: bool = False
    K_is_shared: bool = False
    mean_is_shared: bool = False
    q_U_is_shared: bool = False
    flow_is_shared: bool = False
    min_var: float = 1e-12
    remat: bool = False
    fast_solves: bool = False
    solve_precision: str = "highest"

    def __post_init__(self):
        if self.solve_precision not in ("highest", "high", "default"):
            raise ValueError(
                f"solve_precision must be 'highest'|'high'|'default', "
                f"got {self.solve_precision!r}")

    @property
    def has_flow(self) -> bool:
        if self.flow_per_output is not None:
            return any(not is_identity_spec(f) for f in self.flow_per_output)
        return not is_identity_spec(self.flow)

    def _any_step(self, pred) -> bool:
        def walk(steps):
            return any(pred(s) or walk(s.sub) for s in steps)
        flows = (self.flow_per_output if self.flow_per_output is not None
                 else (self.flow,))
        return any(walk(f) for f in flows)

    @property
    def has_input_dependent_flow(self) -> bool:
        return self._any_step(lambda s: s.input_dependent)

    @property
    def has_bn_flow(self) -> bool:
        """True if a hypernet has batch-norm layers, whose stored statistics
        `finalize_batch_norm` sets after training."""
        return self._any_step(lambda s: s.input_dependent
                              and s.hypernet.batch_norm)

    @property
    def has_stochastic_flow(self) -> bool:
        """True if evaluating the flow draws random numbers: MC dropout
        above 0, or VI nets (MC dropout at 0 is deterministic)."""
        return self._any_step(lambda s: s.input_dependent and (
            s.hypernet.dropout > 0.0
            or s.hypernet.inference == "mean_field_gaussian"))


def check_spec(spec: TGPSpec) -> None:
    """Raise ValueError for a likelihood or flow step that cannot be
    evaluated.  A `DeepTGPSpec` is checked layer by layer."""
    if deep.is_deep(spec):
        return deep.check_spec(spec)
    check_likelihood(spec.likelihood)
    flows = (spec.flow_per_output if spec.flow_per_output is not None
             else (spec.flow,))
    for flow in flows:
        for step in flow:
            check_step(step)


def svgp_spec(**kw) -> TGPSpec:
    """SVGP (Hensman et al.): a TGP with identity flows, one per output
    (JAX `models/tgp.py:190-195`)."""
    kw.setdefault("flow", IDENTITY_SPEC)
    kw.setdefault("flow_is_shared", False)
    return TGPSpec(**kw)


# ===========================================================================
# Parameter initialisation
# ===========================================================================

def _stack_leaves(trees):
    """Stack a list of structurally equal param trees along a new axis 0."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack_leaves([t[k] for t in trees]) for k in first}
    if isinstance(first, (list, tuple)):
        return [_stack_leaves([t[i] for t in trees]) for i in range(len(first))]
    return torch.stack(trees)


def init_tgp_params(
    spec: TGPSpec,
    X_train,
    init_Z,
    *,
    variance_scale: float = 1.0,
    mean_scale: float = 0.0,
    kernel_init: dict | None = None,
    noise_init: float = 0.05,
    add_noise_inducing: float = 0.0,
    flow_inits=None,
    warp_inits=None,
    dtype=None,
    device=None,
):
    """Build the full TGP parameter tree, with the JAX package's defaults.

    `init_Z` is an (M, Dx) array; `X_train` feeds the identity mean's
    projection.
    `warp_inits` initialises the warped likelihood's observation warp
    (JAX `models/tgp.py:214, 257-258`).
    The flows' hypernets (one set per output) draw from one CPU generator
    seeded with `config.config_seed`.
    """
    check_spec(spec)
    dtype = dtype or cfg.default_dtype()
    device = cfg.resolve_device(device)
    Dy, M, Dx = spec.Dy, spec.M, spec.Dx
    init_Z = np.asarray(init_Z, dtype=np.float64)
    if init_Z.shape != (M, Dx):
        raise ValueError(f"init_Z must be (M, Dx), got {init_Z.shape}")

    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype).to(device)

    nZ = 1 if spec.Z_is_shared else Dy
    Z = t(init_Z)[None].repeat(nZ, 1, 1)
    if add_noise_inducing > 0.0 and not spec.Z_is_shared:
        # multiplicative perturbation, as the JAX package draws it
        rng = np.random.RandomState(cfg.config_seed)
        Z = Z * t(add_noise_inducing * rng.randn(nZ, M, Dx))

    nq = 1 if spec.q_U_is_shared else Dy
    q_mu = torch.full((nq, M), float(mean_scale), dtype=dtype, device=device)
    q_L = (math.sqrt(variance_scale)
           * torch.eye(M, dtype=dtype, device=device))[None].repeat(nq, 1, 1)

    nk = 1 if spec.K_is_shared else Dy
    kparams = kernels_mod.init_params(spec.kernel, nk, Dx, kernel_init, dtype,
                                      device)
    nm = 1 if spec.mean_is_shared else Dy
    mparams = mean_init(spec.mean, nm, Dx, X=X_train, dtype=dtype,
                        device=device)
    lparams = init_likelihood_params(spec.likelihood, noise_init, dtype, device,
                                     warp_inits=warp_inits)

    gen = torch.Generator().manual_seed(cfg.config_seed)
    if spec.flow_per_output is not None:
        fparams = [init_flow_params(fs, None if flow_inits is None
                                    else flow_inits[d], dtype, device, gen)
                   for d, fs in enumerate(spec.flow_per_output)]
    elif spec.has_flow and not spec.flow_is_shared:
        per_out = []
        for d in range(Dy):
            inits_d = flow_inits
            if (isinstance(flow_inits, (list, tuple)) and len(flow_inits) == Dy
                    and isinstance(flow_inits[0], list)):
                inits_d = flow_inits[d]
            per_out.append(init_flow_params(spec.flow, inits_d, dtype, device,
                                            gen))
        fparams = _stack_leaves(per_out)
    else:
        fparams = init_flow_params(spec.flow, flow_inits if spec.has_flow
                                   else None, dtype, device, gen)

    return {"Z": Z, "q_mu": q_mu, "q_L": q_L, "kernel": kparams,
            "mean": mparams, "flow": fparams, "likelihood": lparams}


def _expand(x, Dy):
    """Broadcast a possibly-shared (1, ...) param block to (Dy, ...)."""
    return x.expand((Dy,) + tuple(x.shape[1:]))


def _expand_tree(tree, Dy):
    if isinstance(tree, dict):
        return {k: _expand_tree(v, Dy) for k, v in tree.items()}
    return _expand(tree, Dy)


# ===========================================================================
# Core math
# ===========================================================================

def _ensure_3d(spec: TGPSpec, X):
    """(MB, Dx) -> (Dy, MB, Dx)."""
    if X.ndim == 2:
        X = X.expand((spec.Dy,) + tuple(X.shape))
    return X


def _marginal_qf(spec: TGPSpec, params, X, diagonal: bool):
    """`marginal_qf`, plus what the unwhitened KL needs of it: (mu, cov,
    prior) with prior = (mu_z, K_zz, L) when whiten=False, else None."""
    check_spec(spec)
    Dy, M = spec.Dy, spec.M
    X = _ensure_3d(spec, X)

    Z = _expand(params["Z"], Dy)
    kp = _expand_tree(params["kernel"], Dy) if spec.K_is_shared else params["kernel"]
    mp = _expand_tree(params["mean"], Dy) if spec.mean_is_shared else params["mean"]

    Kxz, Kzz = kernels_mod.gram_pair(spec.kernel, kp, X, Z)
    mu_x = mean_apply(spec.mean, mp, X)
    L, _ = safe_cholesky(Kzz)

    q_mu = _expand(params["q_mu"], Dy)
    Lq = tril_mask(_expand(params["q_L"], Dy))
    Kzx = Kxz.transpose(-1, -2)                       # (Dy, M, MB)

    def ein(eq, a, b):
        # the factor's applications, at the spec's solve precision
        return einsum_at(eq, a, b, spec.solve_precision)

    def kxx():
        return (kernels_mod.gram_diag(spec.kernel, kp, X, same=True) if diagonal
                else kernels_mod.gram(spec.kernel, kp, X, X, same=True))

    prior = None
    if spec.whiten:
        if spec.fast_solves:
            # one (M, M) triangular solve for L^{-1}, then GEMMs
            eye = torch.eye(M, dtype=L.dtype, device=L.device).expand(L.shape)
            Linv = tril_solve(L, eye)
            sol = ein("dmk,dmo->dko", Linv, q_mu[..., None])
            rhs = ein("dkm,dmn->dkn", Linv, Kzx)
        else:
            sol = triu_solve(L.transpose(-1, -2), q_mu[..., None])
            rhs = tril_solve(L, Kzx)                  # L^{-1} K_zx
        mu = ein("dnm,dmo->dn", Kxz, sol) + mu_x
        A = ein("dmk,dmn->dkn", Lq, rhs)              # Lq^T rhs
        if diagonal:
            cov = kxx() - torch.sum(torch.square(rhs), dim=-2) \
                + torch.sum(torch.square(A), dim=-2)
        else:
            sol2 = cholesky_solve(L, Kzx)
            cov = kxx() - ein("dnm,dmk->dnk", Kxz, sol2) \
                + ein("dmn,dmk->dnk", A, A)
    else:
        mu_z = mean_apply(spec.mean, mp, Z)
        prior = (mu_z, Kzz, L)
        lhs = cholesky_solve(L, (q_mu - mu_z)[..., None])
        mu = ein("dnm,dmo->dn", Kxz, lhs) + mu_x
        sol2 = cholesky_solve(L, Kzx)                 # K_zz^{-1} K_zx
        B = ein("dmk,dmn->dkn", Lq, sol2)             # Lq^T K_zz^{-1} K_zx
        if diagonal:
            cov = kxx() - torch.sum(Kzx * sol2, dim=-2) \
                + torch.sum(torch.square(B), dim=-2)
        else:
            cov = kxx() - ein("dnm,dmk->dnk", Kxz, sol2) \
                + ein("dmn,dmk->dnk", B, B)
    if diagonal:
        cov = torch.clamp_min(cov, spec.min_var)
    return mu, cov, prior


def marginal_qf(spec: TGPSpec, params, X, *, diagonal: bool = True):
    """Moments of q(f) at locations X: (mu, cov), mu (Dy, MB) and cov
    (Dy, MB), or (Dy, MB, MB) with diagonal=False.

    K_xz and K_zz come from one `gram_pair` call (one launch of the CUDA
    kernel for each rbf leaf when the tensors lie on the card); the full
    covariance adds K_xx from one `gram` call.
    """
    return _marginal_qf(spec, params, X, diagonal)[:2]


def kld_qu(spec: TGPSpec, params, prior=None):
    """KL(q(U) || p(U)) per output, shape (Dy,).  A shared q(U) is counted
    once per output, as in the JAX package.

    whiten=False takes K_zz and its factor from `prior` = (mu_z, K_zz, L),
    `_marginal_qf`'s, when given (as `elbo` gives them); without it, K_zz
    comes from its own `gram` call, as in the JAX package."""
    check_spec(spec)
    Dy = spec.Dy
    q_mu = _expand(params["q_mu"], Dy)
    q_L = _expand(params["q_L"], Dy)
    if spec.whiten:
        return kl_whitened(q_mu, q_L)
    if prior is None:
        Z = _expand(params["Z"], Dy)
        kp = (_expand_tree(params["kernel"], Dy) if spec.K_is_shared
              else params["kernel"])
        mp = (_expand_tree(params["mean"], Dy) if spec.mean_is_shared
              else params["mean"])
        prior = (mean_apply(spec.mean, mp, Z),
                 kernels_mod.gram(spec.kernel, kp, Z, Z, same=False), None)
    mu_z, Kzz, L = prior
    return kl_gaussian(q_mu, q_L, mu_z, Kzz, L_p=L)


# -- flow warping (batched over outputs) ------------------------------------

def _warp_clip(f):
    """Dtype-aware magnitude clip on warped values (1e15 fp32, 1e150 fp64)."""
    big = 1e15 if f.dtype == torch.float32 else 1e150
    return torch.clamp(f, -big, big)


def _per_output(tree):
    """Stacked per-output flow parameters, every scalar or `log_exp` leaf
    (Dy, *rest), as (Dy, 1, *rest): a scalar's (Dy, 1) broadcasts against
    the trailing (Dy, MB) axes of f, and a `log_exp` vector keeps its terms
    on the last axis.  Walks step_flow's nested {"sub", "gates"} trees.
    Hypernets ("net_*") stay as they are: `apply_hypernet` takes stacked
    nets against X3 (Dy, MB, Dx)."""
    if isinstance(tree, dict):
        return {k: v if k.startswith("net_") else _per_output(v)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_per_output(v) for v in tree]
    return tree.unsqueeze(1)


def _make_warp(spec: TGPSpec, params, X3=None, rng=None,
               stochastic: bool = False, train: bool = False, draws=()):
    """Build warp: f (S, Dy, MB) -> (S, Dy, MB).

    The JAX package vmaps the flow over Dy; here the per-output axis of the
    stacked parameters broadcasts against f (`_per_output`), and the
    hypernets of input-dependent steps read X3 (Dy, MB, Dx).  While
    `stochastic`, they draw dropout masks or VI noise from the generator
    `rng` (one mask per output and row, shared by every quadrature node);
    `draws` adds leading axes of independent draws to the hypernets'
    outputs, and so to the warped values' shape.  A shared flow uses its
    parameters as they are; `flow_per_output` evaluates each output's flow
    on its own row of f.
    """
    if not spec.has_flow:
        return lambda f: f
    fp = params["flow"]
    ctx = FlowCtx(rng=rng, stochastic=stochastic, train=train,
                  draws=tuple(draws))
    if spec.flow_per_output is not None:
        # per-output architectures: a loop over the outputs, output d's
        # draws after output d-1's
        def warp_each(f):
            outs = [flow_forward(fs, fp[d], f[..., d, :],
                                 None if X3 is None else X3[d], ctx)
                    for d, fs in enumerate(spec.flow_per_output)]
            return _warp_clip(torch.stack(outs, dim=-2))

        return warp_each
    if not spec.flow_is_shared:
        fp = _per_output(fp)

    def warp(f):
        return _warp_clip(flow_forward(spec.flow, fp, f, X3, ctx))

    return warp


def _bayes_warp(spec: TGPSpec, params, X3, rng, S_MC: int):
    """The flow under S_MC independent hypernet draws, as one batched pass:
    f (Q, Dy, MB) -> (Q, S_MC, Dy, MB)."""
    warp = _make_warp(spec, params, X3, rng, stochastic=True,
                      draws=(S_MC, 1))
    return lambda f: warp(f).transpose(0, 1)


def flows_kld(spec: TGPSpec, params):
    """Sum of the flows' KL terms: non-zero only for VI hypernets, summed
    over the outputs."""
    check_spec(spec)
    ref = params["q_mu"]
    zero = torch.zeros((), dtype=ref.dtype, device=ref.device)
    if not spec._any_step(lambda s: s.input_dependent and
                          s.hypernet.inference == "mean_field_gaussian"):
        return zero
    if spec.flow_per_output is not None:
        return zero + sum(flow_kld(fs, params["flow"][d])
                          for d, fs in enumerate(spec.flow_per_output))
    return zero + flow_kld(spec.flow, params["flow"])


def finalize_batch_norm(spec: TGPSpec, params, X):
    """Recalibrate every hypernet's batch-norm statistics from a
    deterministic pass over the training inputs X (N, Dx), per output;
    returns the params with the new statistics.  The Trainer calls it after
    training; it returns `params` itself when no hypernet has batch norm."""
    if deep.is_deep(spec):
        return deep.finalize_batch_norm(spec, params, X)
    if not spec.has_bn_flow:
        return params
    fp = params["flow"]
    ref = params["q_mu"]
    X3 = _ensure_3d(spec, torch.as_tensor(X, dtype=ref.dtype, device=ref.device))
    if spec.flow_per_output is not None:
        new_fp = [finalize_bn(fs, fp[d], X3[d])
                  for d, fs in enumerate(spec.flow_per_output)]
    elif spec.flow_is_shared:
        new_fp = finalize_bn(spec.flow, fp, X3[0])
    else:
        new_fp = finalize_bn(spec.flow, fp, X3)
    return dict(params, flow=new_fp)


# ===========================================================================
# ELBO
# ===========================================================================

def _remat(fn, rng, *args):
    """fn(*args) under `torch.utils.checkpoint` (non-reentrant): its saved
    activations are dropped and recomputed in the backward.  The recompute
    replays the draws the first call made from `rng` (a `torch.Generator`,
    `DeviceDraws` or `ReplicaGenerators`; `preserve_rng_state` keeps only
    the default generators'), and then puts `rng` back where the backward
    found it, so the stream moves as in a plain step: JAX's
    `jax.checkpoint` replays its key in the same way.  A test's replacement
    of `hypernet._draw` is called again in the recompute."""
    from torch.utils.checkpoint import checkpoint

    state = None if rng is None else rng.get_state()
    calls = []

    def run(*a):
        if not calls or state is None:
            calls.append(1)
            return fn(*a)
        now = rng.get_state()
        rng.set_state(state)
        try:
            return fn(*a)
        finally:
            rng.set_state(now)

    return checkpoint(run, *args, use_reentrant=False,
                      preserve_rng_state=False)


def elbo(spec: TGPSpec, params, X, Y, rng=None, block=None):
    """Evidence lower bound for one minibatch:
        ELBO = N/MB * ELL - KL(q(U)||p(U)) - KL_flows.

    X is (MB, Dx); Y is (MB, Dy), or (MB,) or (MB, 1) class labels for
    classification.  One `marginal_qf` call, so one launch of the Gram
    kernel for each rbf leaf when the tensors lie on the card (the
    unwhitened KL reuses its K_zz).  `rng` (a torch.Generator on
    the tensors' device) is required when the flow is stochastic (dropout
    or VI hypernets, in training mode) and for the categorical likelihood.
    The categorical ELL takes two distinct draws from it, in this order:
    the MC normals of f, then the hypernets' masks or noise as the warp
    reaches them (the JAX package keeps their keys apart with
    `fold_in(rng, 7919)`, JAX `models/tgp.py:555-563`).
    With `spec.remat`, `marginal_qf` and the warp run under `_remat`.
    `block` (a mesh rank's share, `parallel/mesh.py`) cuts the GP part
    (marginals and KL(q(U)||p(U))) to the rank's rows and outputs and joins
    the whole marginals and KL across the mesh before the likelihood; None
    computes the whole batch.
    Returns (elbo, ell, kld), all 0-d tensors (maximise the elbo).
    A `DeepTGPSpec` dispatches to `deep.elbo`.
    """
    if deep.is_deep(spec):
        return deep.elbo(spec, params, X, Y, rng)
    X3 = _ensure_3d(spec, X)
    gp_spec, gp_params, gp_X = (spec, params, X3) if block is None else \
        block.cut(spec, params, X)
    if spec.remat:
        mu, var, prior = _remat(
            lambda x: _marginal_qf(gp_spec, gp_params, x, diagonal=True),
            None, gp_X)
    else:
        mu, var, prior = _marginal_qf(gp_spec, gp_params, gp_X, diagonal=True)
    kl = torch.sum(kld_qu(gp_spec, gp_params, prior))
    if block is not None:
        mu, var, kl = block.join(mu, var, kl)

    parts = _ell_parts(spec, params["likelihood"], Y, rng)
    if parts is None:
        ell = _plain_ell(spec, params["likelihood"], Y, mu, var)
    else:
        nodes, ell_at = parts
        warp = _make_warp(spec, params, X3, rng, stochastic=True, train=True)
        if spec.remat and spec.has_flow:
            inner = warp
            warp = lambda f: _remat(inner, rng, f)          # noqa: E731
        ell = ell_at(warp(nodes(mu, var)))
    return _elbo_sum(spec, params, X.shape[0], ell, kl)


def _ell_parts(spec: TGPSpec, lp, Y, rng):
    """The expected log-likelihood of a likelihood with a warp, cut at the
    warp: (nodes(mu, var), ell_at(fk)), with the ELL ell_at(warp(nodes)).
    The categorical nodes draw the MC normals from `rng`, before the warp
    draws its masks.  None for the likelihoods without one ('gaussian',
    'warped': `_plain_ell`)."""
    lik = spec.likelihood
    if lik.kind == "gaussian_flow":
        return (lambda mu, var: gaussian_flow_nodes(lik, mu, var),
                lambda fk: torch.sum(gaussian_flow_ell_at(lik, lp, Y.T, fk)))
    if lik.kind == "bernoulli":
        return (lambda mu, var: bernoulli_nodes(lik, mu, var),
                lambda fk: bernoulli_ell_at(lik, Y.reshape(1, -1), fk))
    if lik.kind == "categorical":
        if rng is None:
            raise ValueError("the categorical ELL requires an rng")
        return (lambda mu, var: categorical_nodes(lik, mu, var, rng),
                lambda fk: categorical_ell_at(lik, Y.reshape(-1), fk))
    return None


def _plain_ell(spec: TGPSpec, lp, Y, mu, var):
    """The ELL of the 'gaussian' and 'warped' likelihoods."""
    lik = spec.likelihood
    if lik.kind == "gaussian":
        return torch.sum(gaussian_ell(lik, lp, Y.T, mu, var))
    return torch.sum(warped_ell(lik, lp, Y.T, mu, var, lik.warp_flow,
                                lp["warp"]))


def _elbo_sum(spec: TGPSpec, params, MB: int, ell, kl):
    """(elbo, ell, kld) from a batch of MB rows' ELL and KL(q(U)||p(U))."""
    ell = spec.N / MB * ell
    total_kl = kl + flows_kld(spec, params)
    return ell - total_kl, ell, total_kl


# ===========================================================================
# Prediction / evaluation
# ===========================================================================

def predictive_distribution(spec: TGPSpec, params, X, *, S_MC: int = 1,
                            fully_bayesian: bool = False, rng=None, qf=None):
    """Moments (m1, m2) of p(y*|x*) plus the latent q(f) moments.

    With `fully_bayesian` and a stochastic flow, the moments are those of
    the mixture over S_MC hypernet draws from the generator `rng`:
    m1 = mean(m_s), m2 = mean(C_s + m_s^2) - m1^2; class probabilities are
    the mean over the draws.  `qf`, when given, is a (mu, var) pair already
    computed by `marginal_qf` on the same X, so a caller that also samples
    computes it once.
    Returns (m1, m2, mu_f, var_f); for classification m1 is the class
    probabilities (MB, C) and m2 is None (JAX `models/tgp.py:595-672`).
    The categorical likelihood draws its MC normals from `rng` (required).
    A `DeepTGPSpec` dispatches to `deep.predictive_distribution`, `qf`
    being a `deep.propagate` result there.
    """
    if deep.is_deep(spec):
        return deep.predictive_distribution(
            spec, params, X, S_MC=S_MC, fully_bayesian=fully_bayesian,
            rng=rng, prop=qf)
    X3 = _ensure_3d(spec, X)
    mu, var = qf if qf is not None else marginal_qf(spec, params, X3)
    lik = spec.likelihood
    lp = params["likelihood"]
    check_likelihood(lik)
    bayes = fully_bayesian and spec.has_stochastic_flow
    if (bayes or lik.kind == "categorical") and rng is None:
        raise ValueError("fully-Bayesian and categorical prediction require "
                         "an rng")
    if lik.kind == "gaussian":
        m1, m2 = gaussian_moments(lik, lp, mu, var)
    elif lik.kind == "warped":
        m1, m2 = warped_moments(lik, lp, mu, var, lik.warp_flow, lp["warp"])
    elif lik.kind == "bernoulli":
        warp = (_bayes_warp(spec, params, X3, rng, S_MC) if bayes
                else _make_warp(spec, params, X3))
        p1 = bernoulli_moments(lik, lp, mu, var, warp,
                               identity_flow=not spec.has_flow)
        if bayes:
            p1 = torch.mean(p1, dim=0)
        return torch.stack([1.0 - p1, p1], dim=-1), None, mu, var
    elif lik.kind == "categorical":
        if bayes:
            warp = _make_warp(spec, params, X3, rng, stochastic=True,
                              draws=(S_MC, 1))
            probs = torch.mean(categorical_moments(
                lik, lp, mu, var, warp, rng, draws=(S_MC,)), dim=0)
        else:
            probs = categorical_moments(lik, lp, mu, var,
                                        _make_warp(spec, params, X3), rng)
        return probs, None, mu, var
    elif bayes:
        m_Y, C_Y = gaussian_flow_moments(
            lik, lp, mu, var, _bayes_warp(spec, params, X3, rng, S_MC))
        m1 = torch.mean(m_Y, dim=0)
        m2 = torch.mean(C_Y + torch.square(m_Y), dim=0) - torch.square(m1)
    else:
        m1, m2 = gaussian_flow_moments(lik, lp, mu, var,
                                       _make_warp(spec, params, X3))
    return m1, m2, mu, var


def test_log_likelihood(spec: TGPSpec, params, X, Y, Y_std, *, S_MC: int = 1,
                        fully_bayesian: bool = False, rng=None,
                        reduce: bool = True, qf=None):
    """log p(Y*|X*) per output, shape (Dy,) (or (Dy, MB) with reduce=False),
    by Gauss-Hermite quadrature; densities rescaled by Y_std (Dy,).  With
    `fully_bayesian` and a stochastic flow, a log-mean-exp over S_MC
    hypernet draws from `rng` follows the quadrature's log-sum-exp.  The
    warped likelihood takes the Gaussian density of its predictive moments
    (JAX `models/tgp.py:700-715`).  Classification sums the log of the true
    class's probability, clipped at 1e-12: shape (1,) (or (1, MB)).

    Y is (MB, Dy), or class labels (MB,) or (MB, 1).  `qf`, when given, is
    `marginal_qf` on the same X, as in `predictive_distribution`.  A
    `DeepTGPSpec` dispatches to `deep.test_log_likelihood`, `qf` being a
    `deep.propagate` result there.
    """
    if deep.is_deep(spec):
        return deep.test_log_likelihood(
            spec, params, X, Y, Y_std, S_MC=S_MC,
            fully_bayesian=fully_bayesian, rng=rng, reduce=reduce, prop=qf)
    MB = X.shape[-2]
    X3 = _ensure_3d(spec, X)
    lik = spec.likelihood
    lp = params["likelihood"]
    check_likelihood(lik)
    if lik.is_classification:
        probs = predictive_distribution(spec, params, X3, S_MC=S_MC,
                                        fully_bayesian=fully_bayesian,
                                        rng=rng, qf=qf)[0]
        p_true = torch.gather(probs, 1, Y.reshape(-1, 1).long())[:, 0]
        ll = torch.log(torch.clamp(p_true, 1e-12, 1.0))
        return torch.sum(ll)[None] if reduce else ll[None]
    mu, var = qf if qf is not None else marginal_qf(spec, params, X3)
    Ys = Y_std[:, None]                                   # (Dy, 1)

    if lik.kind in ("gaussian", "warped"):
        if lik.kind == "gaussian":
            m, C = gaussian_moments(lik, lp, mu, var)
        else:
            m, C = warped_moments(lik, lp, mu, var, lik.warp_flow, lp["warp"])
        lpp = -0.5 * (torch.log(2 * math.pi * torch.square(Ys) * C)
                      + torch.square(Ys * Y.T - Ys * m) / (torch.square(Ys) * C))
        return torch.sum(lpp, dim=-1) if reduce else lpp

    gh = GaussHermite(lik.quad_points)
    f = gh.shifted_locations(mu, var)                     # (S, Dy, MB)
    C_y = noise_variance(lik, lp)                         # (Dy, 1)
    log_w = torch.log(gh.weights(mu.dtype, mu.device))
    bayes = fully_bayesian and spec.has_stochastic_flow
    if bayes:
        if rng is None:
            raise ValueError("Bayesian test LL requires an rng")
        warped = _bayes_warp(spec, params, X3, rng, S_MC)(f)  # (S, S_MC, Dy, MB)
    else:
        warped = _make_warp(spec, params, X3)(f)
    scale2 = torch.square(Ys) * C_y
    lp_s = -0.5 * (torch.log(2 * math.pi * scale2)
                   + torch.square(Ys * Y.T - Ys * warped) / scale2)
    log_w = log_w.reshape((-1,) + (1,) * (lp_s.ndim - 1))
    red = torch.logsumexp(log_w + lp_s, dim=0)
    if bayes:
        red = torch.logsumexp(red - 0.5 * math.log(math.pi), dim=0) \
            - math.log(S_MC)
        return torch.sum(red, dim=-1) if reduce else red
    if not reduce:
        return red - 0.5 * math.log(math.pi)
    return torch.sum(red, dim=-1) - 0.5 * MB * math.log(math.pi)


# ===========================================================================
# Sampling
# ===========================================================================

def sample_marginal(spec: TGPSpec, params, X, S: int, rng: torch.Generator,
                    fully_bayesian: bool = False, qf=None):
    """S reparameterized samples from the warped marginal q(f_K).

    Draws come from the torch.Generator `rng` (on the tensors' device, or
    `flows.hypernet.ReplicaGenerators` under the battery's map); with
    `fully_bayesian` and a stochastic flow, each sample takes its own
    hypernet draw.  Returns (fk, mu, var, f0): fk, f0 (S, Dy, MB).  A
    `DeepTGPSpec` dispatches to `deep.sample_marginal`.
    """
    if deep.is_deep(spec):
        return deep.sample_marginal(spec, params, X, S, rng, fully_bayesian,
                                    prop=qf)
    X3 = _ensure_3d(spec, X)
    mu, var = qf if qf is not None else marginal_qf(spec, params, X3)
    eps = hypernet.randn((S,) + tuple(mu.shape), rng, mu.dtype, mu.device)
    f0 = mu[None] + torch.sqrt(var)[None] * eps
    if not spec.has_flow:
        return f0, mu, var, f0
    if fully_bayesian and spec.has_stochastic_flow:
        warp = _make_warp(spec, params, X3, rng, stochastic=True, draws=(S,))
    else:
        warp = _make_warp(spec, params, X3)
    return warp(f0), mu, var, f0


def sample_predictive(spec: TGPSpec, params, X, S: int, rng: torch.Generator,
                      fully_bayesian: bool = False, qf=None):
    """S samples from p(y*|x*) (JAX `models/tgp.py:807-841`): posterior
    samples of the warped process, then the observation model: Gaussian
    noise; for the warped GP, T^{-1} of f + noise; a Bernoulli draw of
    Phi(f); a categorical draw from softmax(f) (labels, shape (1, S, MB)).

    Returns (y_samples, fk, f0) with y (Dy, S, MB).  A `DeepTGPSpec`
    dispatches to `deep.sample_predictive`, which returns (y, f0, mu).
    """
    if deep.is_deep(spec):
        return deep.sample_predictive(spec, params, X, S, rng, fully_bayesian,
                                      prop=qf)
    lik = spec.likelihood
    lp = params["likelihood"]
    check_likelihood(lik)
    fk, _, _, f0 = sample_marginal(spec, params, X, S, rng, fully_bayesian, qf)
    if lik.kind == "bernoulli":
        y = hypernet.with_generator(
            lambda p, g: torch.bernoulli(p, generator=g),
            torch.special.ndtr(fk), rng)
    elif lik.kind == "categorical":
        probs = torch.softmax(torch.movedim(fk, 1, -1), dim=-1)  # (S, MB, C)
        y = hypernet.with_generator(
            lambda p, g: torch.multinomial(p, 1, generator=g),
            probs.reshape(-1, probs.shape[-1]), rng)
        y = y.reshape(S, 1, -1).to(fk.dtype)
    else:
        C_y = noise_variance(lik, lp)                             # (Dy, 1)
        y = fk + hypernet.randn(fk.shape, rng, fk.dtype, fk.device) \
            * torch.sqrt(C_y)[None]
        if lik.kind == "warped":
            y = flow_inverse(lik.warp_flow, lp["warp"], y)
    return y.transpose(0, 1), fk, f0


# ===========================================================================
# Convenience OO wrapper
# ===========================================================================

class TGP:
    """A spec and its params tree held together; each method is the
    functional call of the same name on them (JAX `models/tgp.py:851-872`).
    `.params` is the tree that the functions take; where the JAX wrapper
    takes a key, this one takes a `torch.Generator`."""

    def __init__(self, spec: TGPSpec, params):
        self.spec = spec
        self.params = params

    def elbo(self, X, Y, rng=None):
        return elbo(self.spec, self.params, X, Y, rng)

    def marginal_qf(self, X, diagonal=True):
        return marginal_qf(self.spec, self.params, X, diagonal=diagonal)

    def predictive_distribution(self, X, **kw):
        return predictive_distribution(self.spec, self.params, X, **kw)

    def test_log_likelihood(self, X, Y, Y_std, **kw):
        return test_log_likelihood(self.spec, self.params, X, Y, Y_std, **kw)

    def sample_predictive(self, X, S, rng, **kw):
        return sample_predictive(self.spec, self.params, X, S, rng, **kw)


# the deep TGP's module imports this one; imported last, so that each can
# reach the other whichever is imported first
from . import deep  # noqa: E402
