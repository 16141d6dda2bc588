"""Classification likelihoods, Bernoulli (Gauss-CDF link) and categorical
(MC softmax through per-class flows): the port of the JAX package's
`likelihoods/classification.py`.

The categorical likelihood's reparameterised normal draws go through
`flows.hypernet._draw`, as every draw of the hypernets does, so a test can
replay another package's draws and `chip_smoke.py` can give the card and
the CPU the same ones.
"""

from __future__ import annotations

import torch

from ..flows import hypernet
from ..ops.quadrature import GaussHermite
from ..ops.transforms import log_ndtr
from .gaussian import LikelihoodSpec


def bernoulli_ell(spec: LikelihoodSpec, params, Y, mu, var, warp):
    """E_q(f0)[log p(y | Phi(G(f0)))] by Gauss-Hermite quadrature (JAX
    `classification.py:23-45`).

    Y, mu and var are (1, MB), Y in {0, 1}; `warp` maps the shifted nodes
    (S, 1, MB) to warped values.  Returns the sum over the minibatch.
    log Phi comes from `ops.transforms.log_ndtr` on both tails: a CDF
    clipped at 1 - 1e-12 rounds to 1 in fp32, and the gradient of
    log1p(-1) is NaN; its derivative is finite where warped nodes reach
    |f| ~ 1e15 (the fp32 warp clip).
    """
    return bernoulli_ell_at(spec, Y, warp(bernoulli_nodes(spec, mu, var)))


def bernoulli_nodes(spec: LikelihoodSpec, mu, var):
    """The shifted nodes that `bernoulli_ell` warps, (S, 1, MB)."""
    gh = GaussHermite(spec.quad_points)
    return gh.shifted_locations(mu, torch.clamp_min(var, 0.0))


def bernoulli_ell_at(spec: LikelihoodSpec, Y, fk):
    """`bernoulli_ell` from the warped nodes fk (S, 1, MB)."""
    gh = GaussHermite(spec.quad_points)
    bce = Y[None] * log_ndtr(fk) + (1.0 - Y[None]) * log_ndtr(-fk)
    return torch.sum(gh.reduce(bce))


def bernoulli_moments(spec: LikelihoodSpec, params, mu, var, warp,
                      identity_flow: bool):
    """p(y=1 | x) (JAX `classification.py:48-77`).

    The identity flow takes the closed form Phi(mu / sqrt(1 + var)); any
    other flow Gauss-Hermite quadrature of Phi(G(f)), clamped to [0, 1],
    with the per-point sqrt(var) (the JAX package's deliberate deviation
    from the reference's scalar width).  mu and var are (1, MB); the warped
    values may carry leading draw axes (fully-Bayesian), which the result
    keeps: (..., MB).
    """
    if identity_flow:
        return torch.special.ndtr(mu / torch.sqrt(1.0 + var))[0]
    gh = GaussHermite(spec.quad_points)
    f = gh.shifted_locations(mu, torch.clamp_min(var, 0.0))
    p = gh.reduce(torch.special.ndtr(warp(f)))
    return torch.clamp(p, 0.0, 1.0)[..., 0, :]


def categorical_nodes(spec: LikelihoodSpec, mu, var, rng, draws=()):
    """S = quad_points reparameterised draws of f, draws + (S, C, MB): the
    values that the per-class warp takes."""
    shape = tuple(draws) + (spec.quad_points,) + tuple(mu.shape)
    eps = hypernet._draw("normal", shape, None, rng, mu.dtype, mu.device)
    return mu + torch.sqrt(var) * eps


def _mc_logits(spec: LikelihoodSpec, mu, var, warp, rng, draws):
    """`categorical_nodes` through the per-class warp, as logits
    draws + (S, MB, C)."""
    return torch.movedim(warp(categorical_nodes(spec, mu, var, rng, draws)),
                         -2, -1)


def categorical_ell(spec: LikelihoodSpec, params, Y, mu, var, warp, rng):
    """MC softmax cross-entropy through per-class flows (JAX
    `classification.py:80-96`): the mean over S draws of log softmax at the
    true class, summed over the minibatch.

    Y is (MB,) labels; mu and var are (C, MB); `warp` maps (S, C, MB) to the
    same shape; `rng` is the generator of the draws.
    """
    return categorical_ell_at(
        spec, Y, warp(categorical_nodes(spec, mu, var, rng)))


def categorical_ell_at(spec: LikelihoodSpec, Y, fk):
    """`categorical_ell` from the warped draws fk (S, C, MB)."""
    logp = torch.log_softmax(torch.movedim(fk, -2, -1), dim=-1)
    idx = Y.reshape(1, -1, 1).long().expand(logp.shape[0], -1, 1)
    return torch.sum(torch.mean(torch.gather(logp, -1, idx)[..., 0], dim=0))


def categorical_moments(spec: LikelihoodSpec, params, mu, var, warp, rng,
                        draws=()):
    """Predictive class probabilities, the mean over S draws of the softmax
    (JAX `classification.py:99-106`): (MB, C), or draws + (MB, C) when
    `draws` adds leading axes of independent draws (the fully-Bayesian
    prediction's S_MC, whose warp draws its hypernets on the same axes)."""
    logits = _mc_logits(spec, mu, var, warp, rng, draws)
    return torch.mean(torch.softmax(logits, dim=-1), dim=len(draws))
