"""Warped-GP (Snelson et al.) likelihood, N(T(y) | f, sigma^2) |dT/dy|: the
port of the JAX package's `likelihoods/warped.py`.

The warp T acts on the observations instead of the process: the expected
log-likelihood adds the log-Jacobian of T, and the predictive moments are
quadrature integrals of T^{-1} under the unwarped marginal.  The JAX
package takes dT/dy with `jax.jvp`; a warp flow is elementwise, so here
dT/dy is the gradient of sum(T(y)) (`flows.core.value_and_derivative`, as
`flows.core.newton_inverse` takes its derivative), kept in the graph while
grad mode is on.
"""

from __future__ import annotations

import torch

from ..flows.core import flow_forward, flow_inverse, value_and_derivative
from ..ops.quadrature import GaussHermite
from .gaussian import (
    LikelihoodSpec,
    gaussian_ell,
    gaussian_log_marginal,
    gaussian_moments,
)


def _forward_and_grad(flow_spec, flow_params, Y):
    """(T(Y), dT/dy at Y), elementwise (JAX `warped.py:27-30`).

    With grad mode on, dT/dy stays differentiable in the warp's parameters
    (a training step differentiates through it again); under no_grad (the
    Trainer's evaluation) both come back detached."""
    return value_and_derivative(
        lambda y: flow_forward(flow_spec, flow_params, y), Y)


def _log_jacobian(dT):
    """Per-output sum of log|dT/dy| (axis -1): (Dy,)."""
    return torch.sum(torch.log(torch.abs(dT) + 1e-30), dim=-1)


def warped_ell(spec: LikelihoodSpec, params, Y, mu, var, flow_spec,
               flow_params):
    """E_q(f)[log N(T(y) | f, sigma^2)] + sum log |dT/dy| (JAX `warped.py:
    33-46`).

    Y, mu and var are (Dy, MB); returns (Dy,).  The log-Jacobian is summed
    per output, so each output's row gets its own Jacobian."""
    TY, dT = _forward_and_grad(flow_spec, flow_params, Y)
    return gaussian_ell(spec, params, TY, mu, var) + _log_jacobian(dT)


def warped_unwarped_moments(spec: LikelihoodSpec, params, mu, var):
    """Moments of the unwarped observation process p(T(y) | f) (JAX
    `warped.py:49-52`)."""
    return gaussian_moments(spec, params, mu, var)


def warped_moments(spec: LikelihoodSpec, params, mu, var, flow_spec,
                   flow_params, newton_iters: int = 100):
    """Predictive moments of y = T^{-1}(f + eps) by Gauss-Hermite quadrature
    of the inverse (JAX `warped.py:55-63`): m1 = E[T^{-1}], m2 = E[(T^{-1})^2]
    - m1^2.  T^{-1} is evaluated once at the nodes and serves both
    integrals (the JAX package evaluates it twice on the same nodes)."""
    gh = GaussHermite(spec.quad_points)
    m0, C0 = gaussian_moments(spec, params, mu, var)
    y = flow_inverse(flow_spec, flow_params, gh.shifted_locations(m0, C0),
                     iters=newton_iters)
    m1 = gh.reduce(y)
    return m1, gh.reduce(torch.square(y)) - torch.square(m1)


def warped_log_marginal(spec: LikelihoodSpec, params, Y, mu, K, flow_spec,
                        flow_params):
    """log p(Y | x) = log N(T(Y) | mu, K + sigma^2 I) + sum log |dT/dy|,
    per output (JAX `warped.py:66-72`).  Y and mu are (Dy, N), K (Dy, N, N)."""
    TY, dT = _forward_and_grad(flow_spec, flow_params, Y)
    return gaussian_log_marginal(spec, params, TY, mu, K) + _log_jacobian(dT)
