"""Evaluation metrics of the JAX package's `train/metrics.py`: the
regression metrics `coverage_95` and `rmse` on tensors, and the
classification calibration metrics (ECE, MCE, Brier, NLL) on host arrays,
and the seed battery's `replica_outliers`.
"""

from __future__ import annotations

import numpy as np
import torch


def calibration_accumulators(probs, labels, bins: int = 15):
    """Summable calibration statistics of a set of predictions (JAX
    `train/metrics.py:13-42`).

    probs is (N, C), labels (N,).  Returns a flat float64 vector
    [count_b, acc_sum_b, conf_sum_b] * bins + [brier_sum, nll_sum, N]: every
    entry is a sum over rows, so batches compose by vector addition.  Bin b
    holds the rows with lo_b < confidence <= hi_b; the NLL clips the true
    class's probability at 1e-12.
    """
    probs = np.asarray(probs)
    labels = np.asarray(labels).astype(int)
    N, C = probs.shape
    conf = probs.max(axis=1)
    acc = (probs.argmax(axis=1) == labels).astype(np.float64)
    edges = np.linspace(0.0, 1.0, bins + 1)
    vec = np.zeros(3 * bins + 3)
    for b, (lo, hi) in enumerate(zip(edges[:-1], edges[1:])):
        sel = (conf > lo) & (conf <= hi)
        vec[3 * b] = sel.sum()
        vec[3 * b + 1] = acc[sel].sum()
        vec[3 * b + 2] = conf[sel].sum()
    vec[-3] = np.sum((probs - np.eye(C)[labels]) ** 2)
    vec[-2] = -np.sum(np.log(np.clip(probs[np.arange(N), labels], 1e-12, 1.0)))
    vec[-1] = N
    return vec


def calibration_from_accumulators(vec, bins: int = 15):
    """ECE, MCE, BRIER and NLL from (a sum of) accumulator vectors (JAX
    `train/metrics.py:45-57`)."""
    vec = np.asarray(vec)
    N = vec[-1]
    ece, mce = 0.0, 0.0
    for b in range(bins):
        cnt, acc_s, conf_s = vec[3 * b: 3 * b + 3]
        if cnt == 0:
            continue
        gap = abs(acc_s / cnt - conf_s / cnt)
        ece += (cnt / N) * gap
        mce = max(mce, gap)
    return {"ECE": ece, "MCE": mce, "BRIER": vec[-3] / N, "NLL": vec[-2] / N}


def calibration_measures(probs, labels, bins: int = 15):
    """Expected and maximum calibration error, Brier score and mean NLL of
    probs (N, C) against labels (N,) (JAX `train/metrics.py:60-68`)."""
    return calibration_from_accumulators(
        calibration_accumulators(probs, labels, bins), bins)


def quantile(x, q: float, dim: int):
    """The q-quantile of x along `dim` with numpy's default linear
    interpolation, NaN where the slice holds a NaN: `torch.quantile`'s
    values bit for bit (its rank and weight in x's dtype, a sort, then
    `torch.lerp` between the neighbouring order statistics), from ops that
    `torch.func.vmap` batches (it has no batching rule for quantile)."""
    dt = np.float64 if x.dtype == torch.float64 else np.float32
    n = x.shape[dim]
    rank = dt(q) * dt(n - 1)
    lo = int(rank)
    w = torch.tensor(float(rank - dt(lo)), dtype=x.dtype, device=x.device)
    xs = torch.sort(x, dim=dim).values
    out = torch.lerp(xs.select(dim, lo), xs.select(dim, min(lo + 1, n - 1)), w)
    return torch.where(torch.isnan(x).any(dim), torch.nan, out)


def inside_95(samples, Y, dim: int = 0):
    """Whether each Y lies inside the [2.5%, 97.5%] quantiles of `samples`
    along `dim`, computed on the samples' device."""
    return ((Y >= quantile(samples, 0.025, dim))
            & (Y <= quantile(samples, 0.975, dim)))


def coverage_95(samples, Y):
    """Fraction of Y inside the [2.5%, 97.5%] sample quantiles (samples
    along the leading axis)."""
    return float(torch.mean(inside_95(samples, Y).to(samples.dtype)))


def rmse(pred_mean, Y, Y_std=1.0):
    return float(Y_std * torch.sqrt(torch.mean(torch.square(pred_mean - Y))))


def replica_outliers(values, z_thresh: float = 5.0, min_population: int = 5):
    """Cross-replica outliers of a battery by robust (median/MAD) z-score
    (JAX `train/metrics.py:83-110`).

    A discrete bad basin (the naval SAL_InvBCL study of the JAX package:
    trains as well as the healthy mode, sits ~11 healthy MADs away on test
    NLL) shows in the spread over the replicas.  values is (R,), any
    metric (the cut is two-sided); below `min_population` replicas, or at a
    MAD of exactly 0, nothing is flagged.

    Returns dict(flags=bool (R,), z=float (R,), median, mad).
    """
    v = np.asarray(values, dtype=np.float64)
    med = float(np.median(v))
    mad = float(np.median(np.abs(v - med)))
    z = np.zeros_like(v) if mad == 0.0 else (v - med) / mad
    flags = (np.abs(z) > z_thresh) & (mad > 0.0) & (v.size >= min_population)
    return {"flags": flags, "z": z, "median": med, "mad": mad}
