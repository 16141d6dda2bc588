#!/usr/bin/env python3
"""The spread of the spectral-mixture forecast's result (fp64, 4000 epochs)
over starts moved by rounding, in the JAX package and in the PyTorch port.

    python tools/sm_nll_spread.py --package jax --kernel sm --moves 0-7
    python tools/sm_nll_spread.py --package port --kernel sm --moves 0-7 \\
        [--platform gpu|cpu]

Move k scales every initial parameter by (1 + k * 1e-15) as the Trainer
receives it (move 0 is the plain run of `benchmarks/sm_timeseries.py` or
`experiments/sm_timeseries.py`).  Prints one JSON line a move: the
package, the kernel, the move, the forecast NLL and RMSE (unrounded), and
the device.  The JAX package runs on the CPU; the port on the card by
default.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(REPO), str(REPO / "benchmarks")]

ULP = 1e-15


def jax_runs(kernel, moves, epochs):
    import jax

    jax.config.update("jax_platforms", "cpu")
    import tgp.pytorch_tpu.train as jtrain
    from tgp.pytorch_tpu import config as jcfg
    import sm_timeseries as jsm

    jcfg.set_precision("fp64")
    base = jtrain.Trainer
    for k in moves:
        seen = {}

        class Moved(base):
            def __init__(self, spec, params, *a, **kw):
                params = jax.tree_util.tree_map(lambda x: x * (1 + k * ULP),
                                                params)
                super().__init__(spec, params, *a, **kw)

            def compute_metrics(self):
                seen["m"] = super().compute_metrics()
                return seen["m"]

        jtrain.Trainer = Moved
        with contextlib.redirect_stdout(io.StringIO()):
            jsm.run(kernel, epochs)
        m = seen["m"]["test"]
        yield k, float(-m["logL"][0]), float(m["rmse"][0]), "cpu"


def port_runs(kernel, moves, epochs, platform):
    import torch

    import tgp.pytorch_tpu_torch.train as ptrain
    from tgp.pytorch_tpu_torch import config as cfg
    from tgp.pytorch_tpu_torch.experiments import sm_timeseries as psm
    from tgp.pytorch_tpu_torch.weights import tree_map

    cfg.set_precision("fp64")
    device = torch.device("cpu") if platform == "cpu" else cfg.default_device()
    base = ptrain.Trainer
    for k in moves:
        ptrain.Trainer = lambda spec, params, *a, **kw: base(
            spec, tree_map(lambda t: t * (1 + k * ULP), params), *a, **kw)
        with contextlib.redirect_stdout(io.StringIO()):
            run = psm.run(kernel, epochs, device=device)
        name = (torch.cuda.get_device_name(device) if device.type == "cuda"
                else "cpu")
        yield k, float(-run.metrics["logL"][0]), float(run.metrics["rmse"][0]), name


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--package", required=True, choices=["jax", "port"])
    p.add_argument("--kernel", required=True,
                   choices=["scale_rbf", "spectral_mixture", "sm"])
    p.add_argument("--moves", default="0", help="k or a range a-b")
    p.add_argument("--epochs", type=int, default=4000)
    p.add_argument("--platform", default="gpu", choices=["gpu", "cpu"])
    args = p.parse_args(argv)
    lo, _, hi = args.moves.partition("-")
    moves = range(int(lo), int(hi or lo) + 1)
    runs = (jax_runs(args.kernel, moves, args.epochs) if args.package == "jax"
            else port_runs(args.kernel, moves, args.epochs, args.platform))
    for k, nll, rmse, device in runs:
        print(json.dumps({"package": args.package, "kernel": args.kernel,
                          "move": k, "epochs": args.epochs,
                          "forecast_nll": nll, "forecast_rmse": rmse,
                          "device": device}), flush=True)


if __name__ == "__main__":
    main()
