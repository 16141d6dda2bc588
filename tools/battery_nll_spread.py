#!/usr/bin/env python3
"""The spread of a battery's per-seed test NLL over starts moved by
rounding, in the JAX package's battery and in the PyTorch port's.

    python tools/battery_nll_spread.py --package jax --model SVGP \\
        --dataset boston --seed 6 --moves 8 [--epochs 15000]
    python tools/battery_nll_spread.py --package port --model SVGP \\
        --dataset boston --seed 6 --moves 8 [--platform gpu|cpu]

One battery of `--moves` replicas of the same split seed: replica k starts
from every initial parameter scaled by (1 + k * 1e-15), or with
`--direction random` by (1 + 1e-15 * s) with signs s = +-1 drawn per entry
from a generator seeded k (replica 0 is the plain start in both), so one
run shows how far training carries a change of the size that another
order of sums makes.  The rest is the battery CLI's
(`experiments/battery.py`, `python -m tgp.pytorch_tpu_torch.experiments.
battery`) at fp64 and M=100 unless given.  Prints one JSON line: the
package, the cell, the test NLL and RMSE of each move (unrounded) and the
device.  The JAX package runs on the CPU; the port on the card by default.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(REPO), str(REPO / "experiments")]

ULP = 1e-15


def _factors(moves, shape, direction):
    """(moves, *shape) float64 factors of the start: 1 + k * ULP, or
    1 + ULP * s with per-entry signs s from a generator seeded k (1 for
    k = 0)."""
    import numpy as np

    if direction == "scale":
        k = np.arange(moves, dtype=np.float64)
        return (1 + k * ULP).reshape((-1,) + (1,) * len(shape)) \
            * np.ones((moves,) + tuple(shape))
    out = [np.ones(shape)]
    for k in range(1, moves):
        s = np.random.RandomState(k).choice([-1.0, 1.0], size=shape)
        out.append(1 + ULP * s)
    return np.stack(out)


def _moved(train, scale):
    """`train_multiseed_minibatch` with the stacked params moved by
    `scale`."""
    def inner(spec, params, *a, **kw):
        return train(spec, scale(params), *a, **kw)
    return inner


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--package", required=True, choices=["jax", "port"])
    p.add_argument("--model", default="SVGP")
    p.add_argument("--dataset", default="boston")
    p.add_argument("--seed", type=int, default=6)
    p.add_argument("--moves", type=int, default=8)
    p.add_argument("--epochs", type=int, default=15000)
    p.add_argument("--num_inducing", type=int, default=100)
    p.add_argument("--precision", default="fp64")
    p.add_argument("--platform", default="gpu", choices=["gpu", "cpu"])
    p.add_argument("--direction", default="scale", choices=["scale", "random"])
    a = p.parse_args()
    argv = ["--model", a.model, "--dataset", a.dataset, "--num_inducing",
            str(a.num_inducing), "--seeds", ",".join([str(a.seed)] * a.moves),
            "--epochs", str(a.epochs), "--precision", a.precision]
    seen = {}
    if a.package == "jax":
        import jax

        jax.config.update("jax_platforms", "cpu")
        from tgp.pytorch_tpu.train import multiseed as ms
        import battery

        def scale(params):
            return jax.tree_util.tree_map(
                lambda x: x * _factors(a.moves, x.shape[1:], a.direction),
                params)

        ev = ms.eval_multiseed
        ms.eval_multiseed = lambda *x, **kw: seen.setdefault("m", ev(*x, **kw))
        ms.train_multiseed_minibatch = _moved(ms.train_multiseed_minibatch,
                                              scale)
        sys.argv = ["battery.py", *argv, "--platform", "cpu"]
        with contextlib.redirect_stdout(io.StringIO()):
            battery.main()
        device = "cpu"
    else:
        import torch

        from tgp.pytorch_tpu_torch.experiments import battery
        from tgp.pytorch_tpu_torch.train import multiseed as ms
        from tgp.pytorch_tpu_torch.weights import tree_map

        def scale(params):
            return tree_map(lambda x: x * torch.as_tensor(
                _factors(a.moves, x.shape[1:], a.direction), dtype=x.dtype,
                device=x.device), params)

        ms.train_multiseed_minibatch = _moved(ms.train_multiseed_minibatch,
                                              scale)
        with contextlib.redirect_stdout(io.StringIO()):
            res = battery.main([*argv, "--platform", a.platform])
        seen["m"] = res.reports[0][1]
        device = (torch.cuda.get_device_name(0) if a.platform == "gpu"
                  else "cpu")
    m = seen["m"]
    print(json.dumps({
        "package": a.package, "model": a.model, "dataset": a.dataset,
        "seed": a.seed, "epochs": a.epochs, "precision": a.precision,
        "direction": a.direction,
        "nll": [float(v) for v in -m["logL"].mean(axis=-1)],
        "rmse": [float(v) for v in m["rmse"].mean(axis=-1)],
        "device": device}))


if __name__ == "__main__":
    main()
