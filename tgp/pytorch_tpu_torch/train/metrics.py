"""Evaluation metrics of the JAX package's `train/metrics.py`: the
regression metrics `coverage_95` and `rmse` on tensors, and the
classification calibration metrics (ECE, MCE, Brier, NLL) on host arrays.
`replica_outliers` waits for the seed battery (ROADMAP Queue 1 item 19).
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
