"""Gaussian likelihoods, linear and flow-warped means: the expected
log-likelihoods and predictive moments of the JAX package's
`likelihoods/gaussian.py`.

Parameters are {'log_var_noise': (Dy or 1, 1)} with the 'exp' positive
transform (and, for the warped likelihood, the observation warp's flow
parameters under 'warp'); the classification likelihoods have none.  The
Bernoulli and categorical likelihoods live in `classification.py`, the
warped one in `warped.py`.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from .. import config as cfg
from ..ops.linalg import cholesky_solve, safe_cholesky
from ..ops.quadrature import GaussHermite

PORTED_KINDS = ("gaussian", "gaussian_flow", "bernoulli", "categorical",
                "warped")


@dataclasses.dataclass(frozen=True)
class LikelihoodSpec:
    """Static likelihood description.

    kind: 'gaussian' | 'gaussian_flow' | 'bernoulli' | 'categorical' |
    'warped'.  warp_flow: for 'warped', the flow spec of the observation
    warp T (applied to Y, not to the process).
    """

    kind: str
    out_dim: int
    noise_is_shared: bool = False
    quad_points: int = 100
    num_classes: int = 0
    warp_flow: tuple = ()

    @property
    def is_classification(self) -> bool:
        return self.kind in ("bernoulli", "categorical")


def check_likelihood(spec: LikelihoodSpec) -> None:
    if spec.kind not in PORTED_KINDS:
        raise ValueError(f"unknown likelihood kind {spec.kind!r}")


def init_likelihood_params(spec: LikelihoodSpec, noise_init: float = 0.05,
                           dtype=None, device=None, warp_inits=None):
    """A (Dy,1) (or shared (1,1)) log-variance parameter, plus the warp's
    flow parameters ('warp', from `warp_inits`) for the warped likelihood;
    {} for classification (JAX `likelihoods/gaussian.py:46-59`)."""
    check_likelihood(spec)
    if spec.is_classification:
        return {}
    dtype = dtype or cfg.default_dtype()
    device = cfg.resolve_device(device)
    n = 1 if spec.noise_is_shared else spec.out_dim
    params = {"log_var_noise": torch.full((n, 1), float(np.log(noise_init)),
                                          dtype=dtype, device=device)}
    if spec.kind == "warped" and spec.warp_flow:
        from ..flows.core import init_flow_params
        params["warp"] = init_flow_params(spec.warp_flow, warp_inits, dtype,
                                          device)
    return params


def noise_variance(spec: LikelihoodSpec, params, Dy: int | None = None):
    """(Dy, 1) positive noise variance (expanded if shared)."""
    Dy = Dy or spec.out_dim
    return torch.exp(params["log_var_noise"]).expand(Dy, 1)


def _log_normal(y, mean, var):
    return -0.5 * (torch.log(2.0 * math.pi * var) + torch.square(y - mean) / var)


def gaussian_ell(spec: LikelihoodSpec, params, Y, mu, var):
    """Closed-form expected log-likelihood:
        E_q(f)[log p(y|f)] = log N(y | mu, C_y) - 0.5 tr(C_y^{-1} C_f).

    Y, mu and var are (Dy, MB); returns (Dy,).
    """
    C_y = noise_variance(spec, params)                    # (Dy, 1)
    log_p = torch.sum(_log_normal(Y, mu, C_y), dim=-1)
    trace = -0.5 * torch.sum(var / C_y, dim=-1)
    return log_p + trace


def gaussian_log_marginal(spec: LikelihoodSpec, params, Y, mu, K):
    """Exact log marginal likelihood log N(Y | mu, K + sigma^2 I), (Dy,).

    Y and mu are (Dy, N), K is (Dy, N, N)."""
    N = Y.shape[-1]
    C_y = noise_variance(spec, params, Y.shape[0])        # (Dy, 1)
    Kn = K + C_y[..., None] * torch.eye(N, dtype=K.dtype, device=K.device)
    L, _ = safe_cholesky(Kn)
    diff = (Y - mu)[..., None]
    data_fit = torch.sum(diff * cholesky_solve(L, diff), dim=(-2, -1))
    complexity = 2.0 * torch.sum(
        torch.log(torch.diagonal(L, dim1=-2, dim2=-1)), dim=-1)
    return -0.5 * (data_fit + complexity + N * math.log(2.0 * math.pi))


def gaussian_flow_ell(spec: LikelihoodSpec, params, Y, mu, var, warp):
    """Quadrature expected log-likelihood through a flow:
        E_q(f0)[log p(y | G(f0))]
          ~= 1/sqrt(pi) sum_i w_i log N(y | G(sqrt(2) s x_i + mu), C_y).

    Y, mu and var are (Dy, MB); `warp` maps the shifted nodes (S, Dy, MB) to
    warped values of the same shape.  Returns (Dy,).
    """
    return gaussian_flow_ell_at(spec, params, Y,
                                warp(gaussian_flow_nodes(spec, mu, var)))


def gaussian_flow_nodes(spec: LikelihoodSpec, mu, var):
    """The shifted nodes that `gaussian_flow_ell` warps, (S, Dy, MB)."""
    return GaussHermite(spec.quad_points).shifted_locations(mu, var)


def gaussian_flow_ell_at(spec: LikelihoodSpec, params, Y, fk):
    """`gaussian_flow_ell` from the warped nodes fk (S, Dy, MB)."""
    gh = GaussHermite(spec.quad_points)
    C_y = noise_variance(spec, params)                    # (Dy, 1)
    log_p = _log_normal(Y[None], fk, C_y.reshape(1, -1, 1))
    return torch.sum(gh.reduce(log_p), dim=-1)


def gaussian_moments(spec: LikelihoodSpec, params, mu, var):
    """Predictive moments: (m1, m2) = (mu, var + sigma^2)."""
    return mu, var + noise_variance(spec, params)


def gaussian_flow_moments(spec: LikelihoodSpec, params, mu, var, warp):
    """Predictive moments by quadrature through the flow.

    m1 = E_quad[G(f)];  m2 = sigma^2 + E_quad[G(f)^2] - m1^2
    """
    gh = GaussHermite(spec.quad_points)
    C_y = noise_variance(spec, params)
    fk = warp(gh.shifted_locations(mu, var))
    m1 = gh.reduce(fk)
    e2 = gh.reduce(torch.square(fk))
    return m1, C_y + e2 - torch.square(m1)
