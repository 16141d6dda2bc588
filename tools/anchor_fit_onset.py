#!/usr/bin/env python3
"""Where the boston ID_TGP anchor fit at dropout 0 turns chaotic, in the JAX
package alone, in the PyTorch port alone, and between the two (the CPU, fp64).

    python tools/anchor_fit_onset.py run --package jax|port --epochs 100,300 \
        --out a.npz [--move 1e-15] [--threads N]
    python tools/anchor_fit_onset.py compare a.npz b.npz

`run` builds the fit's inputs as `tests/test_torch_port_id_cli.py` does for
its `[MC_dropout]` case: the JAX CLI's boston split 1, M=5 ID_TGP row with
dropout 0, its initial hypernets (the port starts from the same leaves), and
fits them to their anchors for each epoch count, from the start each time.
`--move` scales every initial leaf by (1 + move); `--threads` sets torch's
thread count (port) or runs XLA's CPU backend on one thread when 1 (jax;
set it before the first JAX call, so use one process per setting).  The
fitted leaves and the loss of each length go to `--out`.

`compare` prints, for each epoch count both files hold, the loss's relative
gap, the largest gap of a leaf relative to the leaf's largest entry, and
the largest element-wise relative gap (entries above 1e-6 of their leaf's
largest), as JSON lines.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(REPO), str(REPO / "experiments")]

ARGV = ["--model", "ID_TGP", "--dataset", "boston", "--train_test_seed_split",
        "1", "--num_inducing", "5", "--epochs", "1", "--S_test", "10",
        "--platform", "cpu", "--verbose_each", "0",
        "--nnet_inference", "MC_dropout"]


class _Caught(Exception):
    pass


def jax_inputs():
    """(flow spec, the JAX CLI's initial flow of output 0, batches)."""
    import jax
    import exp_config as JEC
    import main as jmain
    import tgp.pytorch_tpu.flows.initializers as jinit

    JEC.HYPERPARAMS[("ID_TGP", "boston")]["flow_DR"] = 0.0
    seen = {}

    def catch(spec, fp0, batches, **k):
        seen.update(spec=spec, fp0=jax.tree_util.tree_map(np.array, fp0),
                    batches=[np.array(b) for b in batches])
        raise _Caught

    orig, jinit.fit_hypernet_to_anchors = jinit.fit_hypernet_to_anchors, catch
    try:
        jmain.run(jmain.parse_args(ARGV))
    except _Caught:
        pass
    jinit.fit_hypernet_to_anchors = orig
    return seen


def run(args):
    epochs = [int(e) for e in args.epochs.split(",")]
    if args.package == "jax" and args.threads == 1:
        os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                                   + " --xla_cpu_multi_thread_eigen=false"
                                   " intra_op_parallelism_threads=1")
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    seen = jax_inputs()
    scale = 1.0 + args.move
    out = {}
    if args.package == "jax":
        import jax.numpy as jnp
        import tgp.pytorch_tpu.flows.initializers as jinit
        fp0 = jax.tree_util.tree_map(lambda a: jnp.asarray(a * scale),
                                     seen["fp0"])
        for n in epochs:
            p, loss = jinit.fit_hypernet_to_anchors(
                seen["spec"], fp0, seen["batches"], num_epochs=n,
                noise_var=0.0)
            leaves = [np.asarray(x) for x in jax.tree_util.tree_leaves(p)]
            out[n] = (leaves, float(loss))
    else:
        import torch
        from tgp.pytorch_tpu_torch import config as pcfg, weights
        from tgp.pytorch_tpu_torch.flows import initializers as pinit
        from tgp.pytorch_tpu_torch.flows.core import spec_from_list
        from tgp.pytorch_tpu_torch.flows import generators as G
        from tgp.pytorch_tpu_torch.experiments import exp_config as PEC

        pcfg.set_precision("fp64")
        if args.threads:
            torch.set_num_threads(args.threads)
        hp = PEC.return_hyperparams("ID_TGP", "boston")
        Dx = seen["batches"][0].shape[-1]
        np.random.seed(pcfg.config_seed)
        spec, _ = spec_from_list(G.SAL(
            hp["num_blocks"], input_dependent=True, input_dim=Dx,
            num_hidden_layers=hp["flow_num_hidden_layers"],
            batch_norm=hp["flow_BN"], dropout=0.0,
            hidden_dim=hp["flow_hidden_dim"],
            hidden_activation=hp["flow_hidden_act"], inference="MC_dropout"))
        fp0 = weights.params_from_jax(
            jax.tree_util.tree_map(lambda a: a * scale, seen["fp0"]),
            device="cpu", dtype=torch.float64)
        for n in epochs:
            p, loss = pinit.fit_hypernet_to_anchors(
                spec, fp0, seen["batches"], num_epochs=n, noise_var=0.0)
            out[n] = ([t.numpy().copy() for t in weights.tree_leaves(p)], loss)
    np.savez(args.out, **{f"e{n}_l{i}": a for n, (ls, _) in out.items()
                          for i, a in enumerate(ls)},
             **{f"e{n}_loss": np.asarray(loss) for n, (_, loss) in out.items()})


def load(path):
    z = np.load(path)
    runs = {}
    for k in z.files:
        e, rest = k[1:].split("_", 1)
        r = runs.setdefault(int(e), {"leaves": {}, "loss": None})
        if rest == "loss":
            r["loss"] = float(z[k])
        else:
            r["leaves"][int(rest[1:])] = z[k]
    return runs


def compare(a_path, b_path):
    a, b = load(a_path), load(b_path)
    for n in sorted(set(a) & set(b)):
        la, lb = a[n]["leaves"], b[n]["leaves"]
        leaf = elem = 0.0
        for i in la:
            x, y = la[i], lb[i]
            big = float(np.abs(x).max()) or 1.0
            leaf = max(leaf, float(np.abs(x - y).max()) / big)
            keep = np.abs(x) > 1e-6 * big
            if keep.any():
                elem = max(elem, float((np.abs(x - y)[keep]
                                        / np.abs(x)[keep]).max()))
        loss = abs(a[n]["loss"] - b[n]["loss"]) / abs(a[n]["loss"])
        print(json.dumps({"epochs": n, "loss_rel": loss, "leaf_rel": leaf,
                          "elem_rel": elem}))


def main():
    p = argparse.ArgumentParser()
    sub = p.add_subparsers(dest="cmd", required=True)
    r = sub.add_parser("run")
    r.add_argument("--package", choices=["jax", "port"], required=True)
    r.add_argument("--epochs", required=True)
    r.add_argument("--out", required=True)
    r.add_argument("--move", type=float, default=0.0)
    r.add_argument("--threads", type=int, default=0)
    c = sub.add_parser("compare")
    c.add_argument("a")
    c.add_argument("b")
    args = p.parse_args()
    if args.cmd == "run":
        run(args)
    else:
        compare(args.a, args.b)


if __name__ == "__main__":
    main()
