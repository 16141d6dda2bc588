"""Model utilities: pointwise confidence intervals and prior samples, the
port of the JAX package's `models/utils.py` (`propagate_inducing`, for deep
stacks, waits for ROADMAP Queue 1 item 19 with the deep models).
"""

from __future__ import annotations

import numpy as np
import torch

from ..flows.core import flow_inverse
from ..likelihoods.warped import warped_unwarped_moments
from ..ops import kernels as kernels_mod
from ..ops.linalg import safe_cholesky
from . import tgp as tgp_mod
from .means import mean_apply
from .tgp import TGPSpec, _ensure_3d, _expand_tree


def confidence_intervals(spec: TGPSpec, params, X, intervals, S: int, rng,
                         distribution: str = "predictive",
                         fully_bayesian: bool = False):
    """Pointwise quantile confidence intervals (JAX `models/utils.py:22-62`).

    The warped likelihood's predictive takes the closed path: the Gaussian
    bands m0 -/+ 1.96 sqrt(C0) and the median m0 of T(y), mapped through
    T^{-1}.  Everything else draws S samples from the generator `rng` and
    takes per-point quantiles.
    Returns a list over outputs of a list over `intervals` of (MB,) arrays.
    """
    lik = spec.likelihood
    if lik.kind == "warped" and distribution == "predictive":
        if list(intervals) != [0.025, 0.5, 0.975]:
            raise NotImplementedError("warped closed path supports 95% + median")
        with torch.no_grad():
            mu, var = tgp_mod.marginal_qf(spec, params, X)
            m0, C0 = warped_unwarped_moments(lik, params["likelihood"], mu, var)
            half = 1.96 * torch.sqrt(C0)
            # the three bands through one Newton inverse
            band = flow_inverse(lik.warp_flow, params["likelihood"]["warp"],
                                torch.stack([m0 - half, m0, m0 + half]))
        band = band.cpu().numpy()
        return [[band[0, d], band[1, d], band[2, d]] for d in range(spec.Dy)]

    with torch.no_grad():
        if distribution == "predictive":
            samples = tgp_mod.sample_predictive(spec, params, X, S, rng,
                                                fully_bayesian)[0]
            samples = samples.transpose(0, 1)          # (S, Dy, MB)
        elif distribution == "posterior":
            samples = tgp_mod.sample_marginal(spec, params, X, S, rng,
                                              fully_bayesian)[0]
        else:
            raise ValueError(distribution)
    s_np = samples.cpu().numpy()
    return [[np.quantile(s_np[:, d, :], q, axis=0) for q in intervals]
            for d in range(spec.Dy)]


def compute_95_and_median_confidence_intervals(spec, params, X, S, rng,
                                               distribution="predictive",
                                               fully_bayesian=False):
    """The 2.5%, 50% and 97.5% intervals (JAX `models/utils.py:65-70`)."""
    return confidence_intervals(spec, params, X, [0.025, 0.5, 0.975], S, rng,
                                distribution, fully_bayesian)


def sample_prior(spec: TGPSpec, params, X, S: int, rng):
    """S samples from the GP prior p(f) at X, drawn from the generator
    `rng`: (S, Dy, MB) (JAX `models/utils.py:73-87`)."""
    X3 = _ensure_3d(spec, X)
    Dy = spec.Dy
    kp = (_expand_tree(params["kernel"], Dy) if spec.K_is_shared
          else params["kernel"])
    mp = (_expand_tree(params["mean"], Dy) if spec.mean_is_shared
          else params["mean"])
    Kxx = kernels_mod.gram(spec.kernel, kp, X3, X3, same=True)
    mu = mean_apply(spec.mean, mp, X3)
    L, _ = safe_cholesky(Kxx)
    eps = torch.randn((S,) + tuple(mu.shape), generator=rng, dtype=mu.dtype,
                      device=mu.device)
    return mu[None] + torch.einsum("dnm,sdm->sdn", L, eps)
