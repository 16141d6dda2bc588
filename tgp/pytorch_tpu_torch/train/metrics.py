"""Regression metrics: the `coverage_95` and `rmse` of the JAX package's
`train/metrics.py`, on tensors.  The classification calibration metrics
wait for ROADMAP Queue 1 item 16.
"""

from __future__ import annotations

import torch


def inside_95(samples, Y, dim: int = 0):
    """Whether each Y lies inside the [2.5%, 97.5%] quantiles of `samples`
    along `dim`, computed on the samples' device (`torch.quantile`, with
    numpy's default linear interpolation)."""
    q = torch.tensor([0.025, 0.975], dtype=samples.dtype, device=samples.device)
    lo, hi = torch.quantile(samples, q, dim=dim)
    return (Y >= lo) & (Y <= hi)


def coverage_95(samples, Y):
    """Fraction of Y inside the [2.5%, 97.5%] sample quantiles (samples
    along the leading axis)."""
    return float(torch.mean(inside_95(samples, Y).to(samples.dtype)))


def rmse(pred_mean, Y, Y_std=1.0):
    return float(Y_std * torch.sqrt(torch.mean(torch.square(pred_mean - Y))))
