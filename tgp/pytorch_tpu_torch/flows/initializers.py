"""Flow initializers (before training): the port of the JAX package's
`flows/initializers.py`.

  * `fit_flow_to_identity`: fit T(x) ~= x over a linspace of the output
    range by MSE with Adam, over random restarts; NaN restarts are dropped;
  * `fit_hypernet_to_anchors`: fit input-dependent steps' hypernets to
    their anchor values (the identity flow) over the training inputs;
  * `gaussianize`: minimise the cross-entropy of the data under the flow's
    push-forward of N(0, 1), by SGD with momentum;
  * `step_flow_ladder`: a ladder-shaped step_flow of tanh steps.

The fits are eager loops whose optimizers do optax's arithmetic (the JAX
package runs them as `lax.scan` over optax steps), so a seeded fit follows
the JAX trajectory where it draws no random numbers.
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch

from .. import config as cfg
from ..weights import tree_leaves, tree_map
from .core import (FlowCtx, flow_forward, flow_forward_initializer,
                   init_flow_params, spec_from_list)


def _adam_step(params, grads, mu, nu, count, lr, b1=0.9, b2=0.999, eps=1e-8):
    """One optax.adam(lr) step on lists of tensors, in place: the moments'
    EMAs, bias correction by the step count, eps outside the sqrt."""
    mu[:] = torch._foreach_add(torch._foreach_mul(grads, 1 - b1),
                               torch._foreach_mul(mu, b1))
    sq = torch._foreach_mul(grads, grads)
    torch._foreach_mul_(sq, 1 - b2)
    nu[:] = torch._foreach_add(sq, torch._foreach_mul(nu, b2))
    mu_hat = torch._foreach_div(mu, 1 - b1 ** count)
    den = torch._foreach_sqrt(torch._foreach_div(nu, 1 - b2 ** count))
    torch._foreach_add_(den, eps)
    upd = torch._foreach_div(mu_hat, den)
    torch._foreach_mul_(upd, -lr)
    torch._foreach_add_(params, upd)


def fit_flow_to_identity(flow_list_fn: Callable[[], list], y_min: float,
                         y_max: float, *, num_restarts: int = 1,
                         num_epochs: int = 2000, lr: float = 0.01,
                         n_points: int = 5000, seed: int = 0, device=None):
    """Fit a flow to the identity map on [y_min, y_max] (n_points evenly
    spaced) by the mean squared error, with Adam at lr for num_epochs.

    Seeds numpy's global RNG with `seed`, then calls `flow_list_fn` (which
    returns a fresh random `[('name', kwargs), ...]` list) once per restart.
    Returns (spec, params, mse) of the best restart, where mse is the loss
    of the last epoch before its update (the JAX package's `losses[-1]`).
    Raises RuntimeError if every restart went NaN.  `device` None is the
    card.
    """
    np.random.seed(seed)
    device = cfg.resolve_device(device)
    x = torch.as_tensor(np.linspace(y_min, y_max, n_points),
                        dtype=cfg.default_dtype()).to(device)

    best = None
    for _ in range(num_restarts):
        spec, inits = spec_from_list(flow_list_fn())
        params = init_flow_params(spec, inits, device=device)
        leaves = tree_leaves(params)
        for t in leaves:
            t.requires_grad_(True)
        mu = [torch.zeros_like(t) for t in leaves]
        nu = [torch.zeros_like(t) for t in leaves]
        loss = None
        for epoch in range(1, num_epochs + 1):
            loss = torch.mean(torch.square(flow_forward(spec, params, x) - x))
            grads = torch.autograd.grad(loss, leaves)
            with torch.no_grad():
                _adam_step(leaves, list(grads), mu, nu, epoch, lr)
        for t in leaves:
            t.requires_grad_(False)
        final = float(loss.detach()) if loss is not None else float("nan")
        if np.isnan(final):
            continue
        if best is None or final < best[2]:
            best = (spec, params, final)

    if best is None:
        raise RuntimeError("flow identity initializer: all restarts went NaN")
    return best


def fit_hypernet_to_anchors(spec, params, batches, *, num_epochs: int = 2000,
                            lr: float = 0.01, noise_var: float = 0.0,
                            seed: int = 0):
    """Fit the flow's hypernets so that each net(X) matches its anchor (the
    step's scalar parameter): minimise `flow_forward_initializer`, the sum
    over nets of mean((net(X) - anchor)^2), with optax.adam(lr) over every
    leaf of `params` (the anchors get no gradient and do not move), one
    step per batch for num_epochs.  Dropout is on and VI weights are
    sampled, from a generator on the params' device seeded from `seed`
    (through numpy's SeedSequence, so that it is not the stream of a
    Trainer's generator seeded with the same number: the JAX package's fit
    and Trainer draw from unrelated keys too); noise_var > 0 adds
    N(0, noise_var) noise to each batch.

    `params` is one flow's params (not stacked per output) and is not
    changed; `batches` is a list of (rows, Dx) arrays.  Returns (the fitted
    params, the loss of the last step before its update).
    """
    params = tree_map(lambda t: t.detach().clone().requires_grad_(True), params)
    leaves = tree_leaves(params)
    dtype, device = leaves[0].dtype, leaves[0].device
    gen = torch.Generator(device=device).manual_seed(int(
        np.random.SeedSequence((int(seed), 1)).generate_state(1, np.uint64)[0]))
    ctx = FlowCtx(rng=gen, stochastic=True)
    Xs = [torch.as_tensor(np.asarray(b), dtype=dtype).to(device)
          for b in batches]
    mu = [torch.zeros_like(t) for t in leaves]
    nu = [torch.zeros_like(t) for t in leaves]
    loss, count = None, 0
    for _ in range(num_epochs):
        for X in Xs:
            if noise_var > 0.0:
                X = X + math.sqrt(noise_var) * torch.randn(
                    X.shape, generator=gen, dtype=dtype, device=device)
            loss = flow_forward_initializer(spec, params, X, ctx)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                        materialize_grads=True)
            count += 1
            with torch.no_grad():
                _adam_step(leaves, list(grads), mu, nu, count, lr)
    for t in leaves:
        t.requires_grad_(False)
    return params, float(loss.detach()) if loss is not None else 0.0


def gaussianize(spec, params, y, *, num_epochs: int = 100, lr: float = 0.001,
                momentum: float = 0.9):
    """Fit flow params so that T(y) has a standard-normal histogram:
    minimise -E[log N(T(y)) + log|dT/dy|] by optax.sgd(lr, momentum).

    `params` is copied, not changed.  Returns (params, loss of the last
    epoch before its update).
    """
    params = tree_map(lambda t: t.detach().clone().requires_grad_(True), params)
    leaves = tree_leaves(params)
    y = torch.as_tensor(np.asarray(y), dtype=leaves[0].dtype)
    y = y.to(leaves[0].device).reshape(-1)
    trace = [torch.zeros_like(t) for t in leaves]
    log_2pi = math.log(2 * math.pi)
    loss = None
    for _ in range(num_epochs):
        yv = y.detach().requires_grad_(True)
        y0 = flow_forward(spec, params, yv)
        # the flow is elementwise: dT/dy is the gradient of sum(T(y))
        dy, = torch.autograd.grad(y0.sum(), yv, create_graph=True)
        log_det = torch.mean(torch.log(torch.abs(dy) + 1e-6))
        log_gauss = torch.mean((log_2pi + torch.square(y0)) / -2.0)
        loss = -(log_gauss + log_det)
        grads = torch.autograd.grad(loss, leaves)
        with torch.no_grad():
            # optax.trace (t = g + momentum t), then scale by -lr
            trace[:] = torch._foreach_add(list(grads),
                                          torch._foreach_mul(trace, momentum))
            torch._foreach_add_(leaves, torch._foreach_mul(trace, -lr))
    for t in leaves:
        t.requires_grad_(False)
    return params, float(loss.detach()) if loss is not None else float("nan")


def step_flow_ladder(K: int, output_range, smoothness_scale: float = 0.1,
                     remove_tails: bool = False):
    """Ladder-shaped step_flow-of-tanh init spec: K tanh steps of equal
    height spanning output_range, parameterised in softplus space.
    Returns a `[('step_flow', {...})]` list for `spec_from_list`."""
    softminus = lambda x: np.log(np.expm1(x))        # noqa: E731
    softplus_np = lambda x: np.log1p(np.exp(x))      # noqa: E731
    lo, hi = output_range
    diff = abs(hi - lo)
    if remove_tails:
        pts = np.linspace(lo, hi, K)
    else:
        pts = np.linspace(lo, hi, K + 2)[1:-1]
    steps = []
    for k in range(K):
        shift = lo if k == 0 else 0.0
        a = (diff / 2) / K
        b = softminus(a)
        c = pts[k] * smoothness_scale
        d = softminus(smoothness_scale)
        a = a + shift
        b = softplus_np(b)
        c = c / softplus_np(d)
        d = 1.0 / softplus_np(d)
        steps.append(("tanh", {"init_a": a, "init_b": softminus(b),
                               "init_c": c, "init_d": softminus(d),
                               "set_restrictions": True, "add_init_f0": False}))
    return [("step_flow", {"flow_arr": steps, "add_init_f0": False})]
