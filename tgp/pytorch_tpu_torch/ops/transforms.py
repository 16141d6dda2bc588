"""Positive-parameter transforms (counterpart of `ops/transforms.py`)."""

from __future__ import annotations

import math

import numpy as np
import torch


def softplus(x):
    """log(1 + e^x) as logaddexp(x, 0).

    Not `F.softplus`: that switches to the identity above x=20 and would
    differ from the JAX package's `jnp.logaddexp(x, 0.0)`.
    """
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _sinh_lim(dtype) -> float:
    return 30.0 if dtype == torch.float32 else 300.0


class _SafeSinh(torch.autograd.Function):
    """sinh with the argument clipped dtype-dependently (30 in fp32, 300 in
    fp64), forward 0.5*(e - 1/e) with one exp.

    Derivative cosh = sqrt(1 + sinh^2) reuses the primal value; it is 0
    outside the clip, so a clipped value never meets cosh(inf) = inf in the
    backward pass (0*inf = NaN would poison the whole gradient).
    """

    generate_vmap_rule = True

    @staticmethod
    def forward(x):
        lim = _sinh_lim(x.dtype)
        e = torch.exp(torch.clamp(x, -lim, lim))
        return 0.5 * (e - 1.0 / e)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(inputs[0], output)

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        lim = _sinh_lim(x.dtype)
        inside = (x > -lim) & (x < lim)
        dy = torch.where(inside, torch.sqrt(1.0 + torch.square(y)),
                         torch.zeros((), dtype=y.dtype, device=y.device))
        return g * dy


def safe_sinh(x):
    return _SafeSinh.apply(x)


class _LogNdtr(torch.autograd.Function):
    """log Phi(x) (`torch.special.log_ndtr`) with the derivative
    phi(x)/Phi(x) = 1 / (sqrt(pi/2) erfcx(-x/sqrt(2))), finite and accurate
    on both tails.  The derivative autograd takes for `torch.special.
    log_ndtr` cancels two terms of size x^2/2 and is wrong below x ~ -100
    (0 at -1e6 in fp32, inf at -1e15 in fp64, where it should be about
    -x): a warped quadrature node there makes a Bernoulli gradient 0 * inf
    = NaN."""

    @staticmethod
    def forward(x):
        return torch.special.log_ndtr(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(inputs[0])

    @staticmethod
    def vmap(info, in_dims, x):
        # elementwise on the mapped tensor as it lies (torch.func has no
        # batching rule for log_ndtr)
        return _LogNdtr.apply(x), in_dims[0]

    @staticmethod
    def backward(ctx, g):
        x, = ctx.saved_tensors
        return g / (math.sqrt(0.5 * math.pi)
                    * torch.special.erfcx(-x / math.sqrt(2.0)))


def log_ndtr(x):
    return _LogNdtr.apply(x)


def safe_exp(x):
    """exp with the argument clipped below the overflow threshold."""
    lim = 80.0 if x.dtype == torch.float32 else 700.0
    return torch.exp(torch.clamp(x, max=lim))


def safe_tanh(x):
    """tanh with the argument clipped to +-30 (exact: tanh saturates to 1
    ulp of +-1 well before 30), as the JAX package computes it."""
    return torch.tanh(torch.clamp(x, -30.0, 30.0))


def inv_softplus(x):
    """Numerically-stable inverse of softplus: log(exp(x) - 1)."""
    return x + torch.log(-torch.expm1(-x))


def np_inv_softplus(x):
    x = np.asarray(x, dtype=np.float64)
    return x + np.log(-np.expm1(-x))


def positive(x, kind: str = "exp"):
    """Map an unconstrained parameter to a strictly positive value."""
    if kind == "exp":
        return torch.exp(x)
    if kind == "softplus":
        return softplus(x)
    raise NotImplementedError(kind)


def inverse_positive(x, kind: str = "exp"):
    if kind == "exp":
        return torch.log(x)
    if kind == "softplus":
        return inv_softplus(x)
    raise NotImplementedError(kind)
