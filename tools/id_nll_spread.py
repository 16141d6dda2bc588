#!/usr/bin/env python3
"""The spread of the full-length boston ID_TGP result (split 1, M=100,
15000 epochs, fp64, on the CPU) in the JAX package and in the PyTorch port.

    python tools/id_nll_spread.py --package jax --seed K [--draws numpy]
    python tools/id_nll_spread.py --package port --seed K
    python tools/id_nll_spread.py --replayed 6000

`--seed K` draws every random choice of a run anew: the hypernets' initial
weights (the JAX key, or the port's CPU generator, seeded 1000 + K), the
anchor fit's draws (seed K) and the training draws (`--train_seed K`); the
split, Z, the anchors and the rest are the CLI's.  `--draws numpy` makes the
JAX package take its dropout masks from numpy (a RandomState seeded with
each key's bytes) in place of threefry.  Prints the CLI's two result
lines.

`--replayed EPOCHS` runs the JAX CLI, then the port's CLI on 1 and on 8
torch threads from the JAX run's initial hypernets, with the JAX run's
masks replayed to the port (`JaxOrderReplay` of
`tests/test_torch_port_hypernet.py`), and prints the ELBO gaps at a few
epochs and both lines' test logL.  EPOCHS is below 2000 or a multiple of
2000 above it: the replay tells the anchor fit's 2000 epochs from a
training chunk by their counts.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(REPO), str(REPO / "experiments"), str(REPO / "tests")]

ARGV = ["--model", "ID_TGP", "--dataset", "boston", "--train_test_seed_split",
        "1", "--num_inducing", "100", "--platform", "cpu"]


def jax_run(seed, draws):
    import jax

    import tgp.pytorch_tpu.flows.hypernet as jhyper
    import tgp.pytorch_tpu.flows.initializers as jinit
    from tgp.pytorch_tpu.models import tgp as JM
    import main as jmain

    if draws == "numpy":
        def bernoulli(key, p, shape):
            def cb(k):
                k = np.asarray(k)
                rs = np.random.RandomState(np.frombuffer(k.tobytes(), np.uint32))
                return rs.uniform(size=k.shape[:-1] + tuple(shape)) < p
            return jax.pure_callback(cb, jax.ShapeDtypeStruct(tuple(shape),
                                                              np.bool_),
                                     key, vmap_method="expand_dims")

        class Random:
            def __getattr__(self, name):
                return bernoulli if name == "bernoulli" else getattr(jax.random, name)

        class Jax:
            random = Random()

            def __getattr__(self, name):
                return getattr(jax, name)

        jhyper.jax = Jax()
    init, fit = JM.init_tgp_params, jinit.fit_hypernet_to_anchors
    JM.init_tgp_params = lambda *a, **k: init(
        *a, **dict(k, key=jax.random.PRNGKey(1000 + seed)))
    jinit.fit_hypernet_to_anchors = lambda *a, **k: fit(*a, **dict(k, seed=seed))
    jmain.run(jmain.parse_args(ARGV + ["--train_seed", str(seed)]))


def port_run(seed):
    import torch

    from tgp.pytorch_tpu_torch.experiments import main as pmain
    from tgp.pytorch_tpu_torch.flows import core, hypernet, initializers
    from tgp.pytorch_tpu_torch.models import tgp as PM
    from tgp.pytorch_tpu_torch.weights import tree_map

    init, fit = PM.init_tgp_params, initializers.fit_hypernet_to_anchors

    def seeded_init(spec, *a, **k):
        params = init(spec, *a, **k)
        gen = torch.Generator().manual_seed(1000 + seed)
        for step, p in zip(spec.flow, params["flow"]):
            for n in core._hyper_names(step) if step.input_dependent else ():
                net = hypernet.init_hypernet(step.hypernet, gen, params["Z"].dtype,
                                             params["Z"].device)
                p[f"net_{n}"] = tree_map(lambda t: torch.stack([t] * spec.Dy),
                                         net)
        return params

    PM.init_tgp_params = seeded_init
    initializers.fit_hypernet_to_anchors = lambda *a, **k: fit(
        *a, **dict(k, seed=seed))
    pmain.run(pmain.parse_args(ARGV + ["--train_seed", str(seed)]))


def replayed(epochs):
    import jax
    import torch
    from _pytest.monkeypatch import MonkeyPatch

    from tgp.pytorch_tpu.models import tgp as JM
    import tgp.pytorch_tpu.train as jtrain
    import main as jmain
    from tgp.pytorch_tpu_torch import weights
    from tgp.pytorch_tpu_torch.experiments import main as pmain
    from tgp.pytorch_tpu_torch.models import tgp as PM
    from test_torch_port_hypernet import JaxOrderReplay

    argv = ARGV + ["--epochs", str(epochs), "--verbose_each", "0"]
    mp = MonkeyPatch()
    replay = JaxOrderReplay().patch(mp)
    seen = {"metrics": []}

    class Caught(jtrain.Trainer):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            seen["trainer"] = self

        def compute_metrics(self):
            seen["metrics"].append(super().compute_metrics())
            return seen["metrics"][-1]

    init = JM.init_tgp_params

    def caught_init(*a, **k):
        params = init(*a, **k)
        # a host copy: the JAX Trainer donates the arrays it is given
        seen["flow0"] = jax.tree_util.tree_map(np.array, params["flow"])
        return params

    mp.setattr(jtrain, "Trainer", Caught)
    mp.setattr(JM, "init_tgp_params", caught_init)
    with contextlib.redirect_stdout(io.StringIO()):
        jmain.run(jmain.parse_args(argv))
    replay.seal()
    queue = list(replay.queue)
    flow0 = seen["flow0"]
    pinit = PM.init_tgp_params

    def port_init(*a, **k):
        params = pinit(*a, **k)
        params["flow"] = weights.params_from_jax(flow0, dtype=params["Z"].dtype,
                                                 device=params["Z"].device)
        return params

    mp.setattr(PM, "init_tgp_params", port_init)
    runs = {}
    for threads in (1, 8):
        replay.queue = list(queue)
        torch.set_num_threads(threads)
        with contextlib.redirect_stdout(io.StringIO()):
            runs[threads] = pmain.run(pmain.parse_args(argv))
        assert replay.queue == []
    mp.undo()
    jc = np.asarray([float(v) for v in seen["trainer"].loss_curve])
    p1, p8 = (np.asarray(runs[t].trainer.loss_curve, np.float64) for t in (1, 8))
    for e in (1, 10, 100, 1000, 2000, 3000, 4000, 5000, 6000, 8000, 10000, 15000):
        if e <= len(jc):
            print(f"epoch {e:5d}: ELBO {jc[e - 1]:.4f}, the port on 1 thread "
                  f"{abs(p1[e - 1] - jc[e - 1]) / abs(jc[e - 1]):.2e} from JAX, "
                  f"on 8 threads {abs(p8[e - 1] - p1[e - 1]) / abs(p1[e - 1]):.2e} "
                  f"from 1")
    for tag, j, r in (("point", seen["metrics"][0], "metrics"),
                      ("Bayesian", seen["metrics"][1], "metrics_bayes")):
        print(f"{tag} test logL: JAX {float(j['test']['logL'][0]):.8f}, the port "
              + ", ".join(f"{float(getattr(runs[t], r)['test']['logL'][0]):.8f}"
                          for t in (1, 8)))


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--package", choices=["jax", "port"])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--draws", choices=["native", "numpy"], default="native")
    p.add_argument("--replayed", type=int, metavar="EPOCHS")
    args = p.parse_args()
    if args.replayed:
        replayed(args.replayed)
    elif args.package == "jax":
        jax_run(args.seed, args.draws)
    elif args.package == "port" and args.draws == "native":
        port_run(args.seed)
    else:
        p.error("give --package jax|port (numpy draws: jax only) or --replayed")


if __name__ == "__main__":
    main()
