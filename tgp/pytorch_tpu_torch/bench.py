"""Benchmark: full-batch ELBO training steps/s of the flagship TGP on the
card, the counterpart of the repo's `bench.py::bench_jax`.

    python -m tgp.pytorch_tpu_torch.bench

The configuration is `bench_jax`'s: UCI power split 1 (8611 training rows),
a 2-block SAL flow, a scale-RBF ARD kernel, whitened q(U) with M=100 and
Z = the first M rows, 100 Gauss-Hermite nodes, min_var 1e-8, fp32, Adam at
lr 0.01.  Steps run through the port's `Trainer` full-batch path (one Gram
launch and one backward-kernel call per step); the loader shuffles the one
batch once per `train()` call, where `bench_jax` feeds the rows in their
order, which changes only the order of the ELBO's sums.  One warm-up chunk
of CHUNK steps, then the best of WINDOWS windows of 2 x CHUNK steps.
Prints one JSON line with steps/s, the card's name and its power limit.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import time

import torch

from . import config as cfg, weights
from .data import return_dataset
from .train import Trainer

LR = 0.01
CHUNK = 1000        # full-batch steps per train() call
WINDOWS = 4         # timed windows of 2 chunks each

# The card's fp64 training against the CPU's (`flagship_trainer`, 20 Adam
# steps at LR), relative to the largest entry of the ELBO curve, of the KL
# curve and of each parameter: 10x the gaps measured on an NVIDIA H100 80GB
# HBM3 at 700 W.  The ELBO at the initial parameters agrees to 4.8e-15; the
# steps then amplify the order in which cuBLAS/cuSOLVER and LAPACK sum, most
# of all in the flow's shifts (1e-4), whose gradients are sums over 861,100
# quadrature terms that nearly cancel and whose Adam steps divide by their
# own small moments.
TRAIN_F64_STEP0_LIMIT = 4.8e-14
TRAIN_F64_LIMITS = {
    "curve": 2.1e-6, "kld": 8.5e-8, "Z": 6.8e-6, "q_mu": 6.6e-5,
    "q_L": 1.1e-4,
    "kernel/child/raw_lengthscale": 6.9e-6, "kernel/raw_outputscale": 1.7e-8,
    "likelihood/log_var_noise": 3.0e-8,
    "flow/0/a": 9.7e-4, "flow/0/b": 2.8e-8, "flow/1/a": 4.0e-8,
    "flow/1/b": 1.2e-3, "flow/2/a": 6.8e-4, "flow/2/b": 1.1e-7,
    "flow/3/a": 1.7e-7, "flow/3/b": 1.1e-3}


def flagship_trainer(device=None):
    """A `Trainer` of `bench_jax`'s model and init on UCI power split 1
    (`return_dataset("power", 10000, seed=1)`: the 8611 training rows in one
    full batch), in the configured precision: Z = the first 100 rows,
    variance_scale 1e-5, lengthscale and output scale 2, noise 0.05,
    identity SAL blocks, min_var 1e-8."""
    loaders, d = return_dataset("power", 10000, seed=1)
    X = d["X_tr"]
    spec = dataclasses.replace(weights.flagship_spec(X.shape[0]), min_var=1e-8)
    params = weights.flagship_init(spec, X, variance_scale=1e-5, device=device)
    return Trainer(spec, params, loaders, d["Y_std"], device=device)


def bench(tr) -> float:
    """Best steps/s of `tr`'s full-batch Adam steps at LR over WINDOWS
    windows of 2 x CHUNK steps, after one warm-up chunk."""
    tr.train(CHUNK, LR, "adam", verbose_each=0)
    best = 0.0
    for _ in range(WINDOWS):
        # each train() call ends by copying its chunk's ELBOs to the host,
        # which waits for the card
        t0 = time.perf_counter()
        for _ in range(2):
            tr.train(CHUNK, LR, "adam", verbose_each=0)
        best = max(best, 2 * CHUNK / (time.perf_counter() - t0))
    return best


def main():
    cfg.set_precision("fp32")
    tr = flagship_trainer()
    steps_per_s = bench(tr)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    print(json.dumps({
        "metric": "TGP(SAL x2) UCI-power M=100 full-batch ELBO steps/sec "
                  "(eager fp32, Trainer full-batch path)",
        "value": steps_per_s, "unit": "steps/sec",
        "final_elbo": float(tr.loss_curve[-1]),
        "device": torch.cuda.get_device_name(tr.device),
        "nvidia_smi": smi.splitlines()[0]}))


if __name__ == "__main__":
    main()
