#!/usr/bin/env python3
"""One split seed's test NLL inside port batteries of other compositions,
with K_zz's jitter ladder on or fixed at its first rung.

    python tools/battery_composition.py --seeds 1-10 --seed 6 \\
        [--fixed_jitter] [--platform gpu|cpu]

Runs `python -m tgp.pytorch_tpu_torch.experiments.battery` (boston SVGP,
M=100, fp64, 15000 epochs unless given) on `--seeds` and prints one JSON
line: the composition, whether the ladder was fixed, every seed's test NLL
(unrounded) and the device.  A replica's arithmetic does not depend on its
neighbours, but the batched factorisations' rounding does; with the ladder
(`ops.linalg.safe_cholesky`: x1, x10 or x100 the base jitter, the first
that factorises) a matrix at the edge of positive definiteness can take
another rung under another batch, a jump far larger than rounding.
`--fixed_jitter` takes the base jitter at every step.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--seeds", default="1-10")
    p.add_argument("--seed", type=int, default=6)
    p.add_argument("--model", default="SVGP")
    p.add_argument("--dataset", default="boston")
    p.add_argument("--num_inducing", type=int, default=100)
    p.add_argument("--epochs", type=int, default=15000)
    p.add_argument("--fixed_jitter", action="store_true")
    p.add_argument("--platform", default="gpu", choices=["gpu", "cpu"])
    a = p.parse_args()

    import torch

    from tgp.pytorch_tpu_torch import config as cfg
    from tgp.pytorch_tpu_torch.experiments import battery
    from tgp.pytorch_tpu_torch.models import tgp as tgp_mod

    if a.fixed_jitter:
        ladder = tgp_mod.safe_cholesky
        tgp_mod.safe_cholesky = lambda A, jitter=None: ladder(
            A, cfg.jitter_value(A.dtype) if jitter is None else jitter)
    out = {"seeds": a.seeds, "fixed_jitter": a.fixed_jitter,
           "device": (torch.cuda.get_device_name(0) if a.platform == "gpu"
                      else "cpu")}
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            res = battery.main([
                "--model", a.model, "--dataset", a.dataset, "--num_inducing",
                str(a.num_inducing), "--seeds", a.seeds, "--epochs",
                str(a.epochs), "--precision", "fp64", "--platform",
                a.platform])
    except FloatingPointError as e:     # a factor that failed at rung 1
        out["error"] = str(e)
    else:
        nll = -res.reports[0][1]["logL"].mean(axis=-1)
        out.update(nll=[float(v) for v in nll],
                   seed_nll=float(nll[res.seeds.index(a.seed)]))
    print(json.dumps(out))


if __name__ == "__main__":
    main()
