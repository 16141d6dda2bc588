"""Gaussian likelihoods, linear and flow-warped means: the expected
log-likelihoods and predictive moments of the JAX package's
`likelihoods/gaussian.py`.

Parameters are {'log_var_noise': (Dy or 1, 1)} with the 'exp' positive
transform.  The other likelihood kinds wait for ROADMAP Queue 1 item 16.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from .. import config as cfg
from ..ops.quadrature import GaussHermite

PORTED_KINDS = ("gaussian", "gaussian_flow")


@dataclasses.dataclass(frozen=True)
class LikelihoodSpec:
    """Static likelihood description.

    kind: 'gaussian' | 'gaussian_flow' are ported; 'bernoulli',
    'categorical' and 'warped' raise NotImplementedError.
    """

    kind: str
    out_dim: int
    noise_is_shared: bool = False
    quad_points: int = 100
    num_classes: int = 0
    warp_flow: tuple = ()


def check_likelihood(spec: LikelihoodSpec) -> None:
    if spec.kind not in PORTED_KINDS:
        raise NotImplementedError(f"likelihood {spec.kind!r} is not ported yet "
                                  "(ROADMAP Queue 1 item 16)")


def init_likelihood_params(spec: LikelihoodSpec, noise_init: float = 0.05,
                           dtype=None, device=None):
    """A (Dy,1) (or shared (1,1)) log-variance parameter."""
    check_likelihood(spec)
    dtype = dtype or cfg.default_dtype()
    device = cfg.resolve_device(device)
    n = 1 if spec.noise_is_shared else spec.out_dim
    return {"log_var_noise": torch.full((n, 1), float(np.log(noise_init)),
                                        dtype=dtype, device=device)}


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


def gaussian_flow_ell(spec: LikelihoodSpec, params, Y, mu, var, warp):
    """Quadrature expected log-likelihood through a flow:
        E_q(f0)[log p(y | G(f0))]
          ~= 1/sqrt(pi) sum_i w_i log N(y | G(sqrt(2) s x_i + mu), C_y).

    Y, mu and var are (Dy, MB); `warp` maps the shifted nodes (S, Dy, MB) to
    warped values of the same shape.  Returns (Dy,).
    """
    gh = GaussHermite(spec.quad_points)
    C_y = noise_variance(spec, params)                    # (Dy, 1)
    fk = warp(gh.shifted_locations(mu, var))              # (S, Dy, MB)
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
