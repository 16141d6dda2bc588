"""The spectral-mixture forecast of the port (the counterpart of the repo's
`benchmarks/sm_timeseries.py`):

    python -m tgp.pytorch_tpu_torch.experiments.sm_timeseries \\
        [--platform gpu|cpu] [--epochs 4000] [--out FILE]

A synthetic hourly series of 8 weeks (daily, weekly and 12-hour harmonics
plus noise, from a numpy seed) is split in time: the first 6 weeks train,
the last 2 are the forecast window.  Time and targets are z-scored on the
training window.  For 'spectral_mixture' (Periodic x ScaleRBF components)
and 'sm' (Cosine x ScaleRBF), the periodogram's top-K peaks seed the
components' periods, lengthscales (4 periods) and output scales (the
peaks' power shares, at least 0.05); 'scale_rbf' is the baseline.  Each
trains an SVGP (M=50 inducing points evenly spaced over the training
window, q(U) variance 1e-5, noise 0.05) with Adam at lr 0.01 and clip norm
100, full batch, in fp64, then prints one JSON record with the forecast
window's NLL and RMSE.  It runs on the card (the default) or, with
`--platform cpu`, on the CPU; without a card and without `--platform cpu`
it exits non-zero.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

KERNELS = ("scale_rbf", "spectral_mixture", "sm")


def make_series(n_hours=1344, seed=0):
    """n_hours hourly observations: daily, weekly and 12-hour harmonics
    plus noise."""
    rng = np.random.RandomState(seed)
    t = np.arange(n_hours, dtype=np.float64)
    y = (1.5 * np.sin(2 * np.pi * t / 24.0 + 0.7)
         + 1.0 * np.sin(2 * np.pi * t / 168.0 + 2.1)
         + 0.4 * np.sin(2 * np.pi * t / 12.0 + 1.3)
         + 0.35 * rng.randn(n_hours))
    return t.reshape(-1, 1), y.reshape(-1, 1)


@dataclasses.dataclass
class Run:
    """One kernel's run: the printed record, the trained Trainer, the
    unrounded forecast metrics (`Trainer.compute_metrics()["test"]`), and
    the Gram kernel's calls while training and while evaluating, each
    (forward launches, backward calls), read from `ops.rbf_gram`."""

    record: dict
    trainer: object
    metrics: dict
    kernel_calls: dict


def run(kernel_name: str, epochs: int, M_ind: int = 50, num_comp: int = 2,
        n_hours: int = 1344, device=None) -> Run:
    """Train and evaluate one kernel at the configured precision."""
    from ..data import ArrayDataset, DataLoader
    from ..likelihoods.gaussian import LikelihoodSpec
    from ..models import tgp as M
    from ..ops import kernels as K, rbf_gram as R
    from ..ops.spectral import estimate_spectral_density
    from ..train import Trainer

    X, Y = make_series(n_hours)
    n_tr = int(0.75 * X.shape[0])          # the last quarter is the forecast
    Xtr, Ytr, Xte, Yte = X[:n_tr], Y[:n_tr], X[n_tr:], Y[n_tr:]
    mu_y, sd_y = Ytr.mean(), Ytr.std()
    Ytr, Yte = (Ytr - mu_y) / sd_y, (Yte - mu_y) / sd_y
    mu_x, sd_x = Xtr.mean(), Xtr.std()
    Xtr, Xte = (Xtr - mu_x) / sd_x, (Xte - mu_x) / sd_x

    kparams = None
    if kernel_name == "scale_rbf":
        kspec = K.from_name("scale_rbf")
        kinit = {"length_scale": 2.0, "kernel_scale": 2.0}
    elif kernel_name in ("spectral_mixture", "sm"):
        base = "periodic" if kernel_name == "spectral_mixture" else "cosine"
        _, periods, powers = estimate_spectral_density(
            Xtr[:, 0], Ytr[:, 0], prominence=1.0, return_power=True)
        if not periods:
            raise ValueError("no periodogram peak cleared the prominence: the "
                             "spectral-mixture seeding is meaningless here; use "
                             "scale_rbf")
        if len(periods) < num_comp:
            print(f"# only {len(periods)} spectral peaks found; "
                  f"num_comp {num_comp} -> {len(periods)}")
            num_comp = len(periods)
        order = np.argsort(powers)[::-1][:num_comp]
        periods = [periods[i] for i in order]
        ptotal = sum(powers[i] for i in order)
        mags = [max(powers[i] / ptotal, 0.05) for i in order]
        lss = [4.0 * p for p in periods]
        kspec = K.spectral_mixture(num_comp, base=base)
        kinit = None
        kparams = K.init_spectral_mixture_params(kspec, 1, 1, periods, lss,
                                                 mags, device=device)
        print(f"# {kernel_name}: detected periods {np.round(periods, 4)} "
              f"(hours: {np.round(np.asarray(periods) * sd_x, 1)}), "
              f"mags {np.round(mags, 3)}", flush=True)
    else:
        raise ValueError(f"unknown kernel {kernel_name!r}")

    spec = M.TGPSpec(Dy=1, Dx=1, M=M_ind, N=float(n_tr), kernel=kspec,
                     likelihood=LikelihoodSpec("gaussian", 1))
    Z0 = np.linspace(Xtr.min(), Xtr.max(), M_ind).reshape(-1, 1)
    params = M.init_tgp_params(spec, Xtr, Z0, variance_scale=1e-5,
                               kernel_init=kinit, noise_init=0.05,
                               device=device)
    if kparams is not None:
        params["kernel"] = kparams

    loaders = [DataLoader(ArrayDataset(Xtr, Ytr), 10000, seed=0),
               DataLoader(ArrayDataset(Xte, Yte), 10000, shuffle=False)]
    tr = Trainer(spec, params, loaders, Y_std=np.ones(1), S_test=100,
                 device=device)
    calls = [(R.LAUNCHES, R.BWD_LAUNCHES)]
    t0 = time.time()
    tr.train(epochs, 0.01, "adam", verbose_each=0, clip_norm=100.0)
    train_s = time.time() - t0
    calls.append((R.LAUNCHES, R.BWD_LAUNCHES))
    m = tr.compute_metrics()["test"]
    calls.append((R.LAUNCHES, R.BWD_LAUNCHES))
    record = {"kernel": kernel_name, "epochs": epochs, "M": M_ind,
              "components": num_comp if kernel_name != "scale_rbf" else None,
              "forecast_nll": round(float(-m["logL"][0]), 4),
              "forecast_rmse": round(float(m["rmse"][0]), 4),
              "train_s": round(train_s, 2),
              "steps_per_sec": round(epochs / train_s, 1)}
    kernel_calls = {k: tuple(b - a for a, b in zip(calls[i], calls[i + 1]))
                    for i, k in enumerate(("train", "eval"))}
    return Run(record=record, trainer=tr, metrics=m, kernel_calls=kernel_calls)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="spectral-mixture forecast "
                                            "(PyTorch port)")
    p.add_argument("--platform", default="gpu", choices=["gpu", "cpu"],
                   help="gpu (the default) needs a CUDA device")
    p.add_argument("--epochs", type=int, default=4000)
    p.add_argument("--out", default=None)
    return p.parse_args(argv)


def main(argv=None):
    from .. import config as cfg

    args = parse_args(argv)
    if args.platform == "cpu":
        device = torch.device("cpu")
    elif torch.cuda.is_available():
        device = cfg.default_device()
    else:
        raise SystemExit("no CUDA device is available; pass --platform cpu "
                         "to run on the CPU")
    cfg.set_precision("fp64")
    recs = []
    for kern in KERNELS:
        rec = run(kern, args.epochs, device=device).record
        recs.append(rec)
        print(json.dumps(rec), flush=True)
    if args.out:
        with open(args.out, "a") as f:
            for r in recs:
                f.write(json.dumps(r) + "\n")


if __name__ == "__main__":
    main()
