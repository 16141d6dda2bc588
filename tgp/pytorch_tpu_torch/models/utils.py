"""Model utilities: pointwise confidence intervals, prior samples and the
propagation of inducing locations through a deep stack, the port of the JAX
package's `models/utils.py`.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import config as cfg
from ..flows import hypernet
from ..flows.core import flow_inverse
from ..likelihoods.warped import warped_unwarped_moments
from ..ops import kernels as kernels_mod
from ..ops.linalg import safe_cholesky
from . import tgp as tgp_mod
from .means import mean_apply, projection_matrix
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
    `rng` through `flows.hypernet._draw`: (S, Dy, MB) (JAX
    `models/utils.py:73-87`)."""
    X3 = _ensure_3d(spec, X)
    Dy = spec.Dy
    kp = (_expand_tree(params["kernel"], Dy) if spec.K_is_shared
          else params["kernel"])
    mp = (_expand_tree(params["mean"], Dy) if spec.mean_is_shared
          else params["mean"])
    Kxx = kernels_mod.gram(spec.kernel, kp, X3, X3, same=True)
    mu = mean_apply(spec.mean, mp, X3)
    L, _ = safe_cholesky(Kxx)
    eps = hypernet._draw("normal", (S,) + tuple(mu.shape), None, rng,
                         mu.dtype, mu.device)
    return mu[None] + torch.einsum("dnm,sdm->sdn", L, eps)


def propagate_inducing(spec: TGPSpec, params, Z, out_dim: int, rng=None,
                       how: str = "salimbeni", W=None):
    """Inducing locations Z (M, in_dim) carried through a layer of a deep
    stack, as numpy (M, out_dim) (JAX `models/utils.py:88-116`):

      'salimbeni'          : Z @ W, W the identity mean's projection,
      'sampling'           : one draw of the layer's GP prior at Z,
      'salimbeni+sampling' : the projection, its zero-padded columns
                             (out_dim > in_dim) replaced by the draw.

    `W` reuses the layer's projection (the SVD of the training inputs), so
    that Z lands in the subspace of the propagated inputs; by default it is
    the SVD of Z.  The draw comes from the generator `rng` (a CPU generator
    seeded with `config.config_seed` when None) on the params' device.
    """
    Z = np.asarray(Z)
    in_dim = Z.shape[-1]

    def draw():
        ref = params["q_mu"]
        gen = rng
        if gen is None:
            gen = torch.Generator(device=ref.device).manual_seed(cfg.config_seed)
        Zt = torch.as_tensor(Z, dtype=ref.dtype).to(ref.device)
        with torch.no_grad():
            f = sample_prior(spec, params, Zt, 1, gen)[0]      # (Dy, M)
        return f.cpu().numpy().T

    if how == "sampling":
        return draw()
    if how not in ("salimbeni", "salimbeni+sampling"):
        raise ValueError(how)
    W = projection_matrix(in_dim, out_dim, Z) if W is None else W
    Z_out = Z @ W
    if how == "salimbeni+sampling" and out_dim > in_dim:
        Z_out[:, in_dim:out_dim] = draw()[:, in_dim:out_dim]
    return Z_out
