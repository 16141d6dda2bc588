"""The sweep runner of the port: the repo's `experiments/sweep.py` (the JAX
package's) for the torch package, one (model, dataset, seed, M) cell after
another, one JSON record a cell.

    python -m tgp.pytorch_tpu_torch.experiments.sweep --suite regression \\
        --models SVGP TGP --datasets boston power --seeds 1 2 3 \\
        --num_inducing 5 100 [--epochs 15000] [--precision fp32|fp64] \\
        [--platform gpu|cpu] [--arch NAME:NB[:NS]] [--out results.jsonl]

A cell is what the JAX runner's `run_one` does: the UCI split of the seed,
k-means inducing points, the dataset's flow arch from the sweep tables
(Step* archs fitted to the identity first; ID_TGP's hypernets fitted to
their anchors), Adam at lr 0.01 (a classification dataset holds the kernel
for its first 2000 epochs), then the metrics, with ID_TGP's fully-Bayesian
test metrics beside.  A cell that raises is recorded with its error in the
JSONL line and the grid goes on, as the JAX runner does.

It runs on the card (`--platform gpu`, the default) or, when asked, on the
CPU; without a card and without `--platform cpu` it exits non-zero.  A
dataset whose tables are not under the data root (`TGP_DATA_ROOT`, default
`data_assets/`, which holds neither of the `large` suite's year and
airline) is refused before the grid starts, naming them.
"""

from __future__ import annotations

import argparse
import itertools
import json
import time

import numpy as np
import torch

from . import exp_config as EC


def run_one(model, dataset, seed, M, epochs, precision, suite,
            arch_override=None, device=None):
    """One cell's record (the JAX `run_one`'s keys and rounding); `device`
    None is the card."""
    from .. import config as cfg
    from ..data import kmeans_centers, return_dataset
    from ..flows.core import IDENTITY_SPEC
    from ..flows.initializers import (fit_flow_to_identity,
                                      fit_hypernet_to_anchors)
    from ..likelihoods import LikelihoodSpec
    from ..models import tgp as Mm
    from ..ops import kernels as K
    from ..train import Trainer
    from ..weights import tree_map
    from . import flow_arch as FA

    cfg.set_precision(precision)
    device = cfg.resolve_device(device)
    loaders, dc = return_dataset(dataset, 10000, None, seed=seed)
    Dy, Dx = dc["Dy"], dc["Dx"]
    is_class = dc["task"] == "classification"
    Z0 = kmeans_centers(dc["X_tr"], M, n_init=10)

    flow_spec, flow_inits, fitted = IDENTITY_SPEC, None, None
    if model != "SVGP":
        np.random.seed(0)
        if model == "ID_TGP":
            flow_spec, flow_inits = FA.build_id_flow(dataset, Dx, is_class)
        else:
            arch, nb, ns = FA.resolve_tgp_arch(dataset, is_class,
                                               arch_override=arch_override)
            if FA.is_step_arch(arch):
                y = dc["Y_tr"]
                flow_spec, fitted, _ = fit_flow_to_identity(
                    FA.make_step_gen(arch, nb, ns),
                    float(np.min(y)) - 1, float(np.max(y)) + 1,
                    num_epochs=2000, device=device)
            else:
                flow_spec, flow_inits = FA.build_point_flow(arch, nb)

    if is_class:
        if Dy == 2:
            lik = LikelihoodSpec("bernoulli", 1, quad_points=cfg.quad_points)
            Dy_model = 1
        else:
            lik = LikelihoodSpec("categorical", Dy, quad_points=cfg.quad_points,
                                 num_classes=Dy)
            Dy_model = Dy
    else:
        Dy_model = Dy
        lik = (LikelihoodSpec("gaussian", Dy) if model == "SVGP"
               else LikelihoodSpec("gaussian_flow", Dy,
                                   quad_points=cfg.quad_points))

    spec = Mm.TGPSpec(Dy=Dy_model, Dx=Dx, M=M, N=float(dc["N_tr"]),
                      kernel=K.from_name("scale_rbf"), likelihood=lik,
                      flow=flow_spec)
    params = Mm.init_tgp_params(
        spec, dc["X_tr"], Z0, variance_scale=1e-5,
        kernel_init={"length_scale": 2.0, "kernel_scale": 2.0},
        noise_init=0.05, flow_inits=flow_inits, device=device)
    if fitted is not None:
        params["flow"] = tree_map(lambda x: torch.stack([x] * Dy_model),
                                  fitted)

    if model == "ID_TGP":
        batches = [b for b, _ in loaders[0]]
        fp0 = tree_map(lambda x: x[0], params["flow"])
        fp0, _ = fit_hypernet_to_anchors(flow_spec, fp0, batches,
                                         num_epochs=2000)
        params["flow"] = tree_map(lambda x: torch.stack([x] * Dy_model), fp0)

    # the hypernets keep their groups (wd 1e-5 on net_) in every phase, the
    # classification hold phase included
    specs = None
    if model == "ID_TGP":
        specs = [[0.01, 1e-5, "net_"], [0.01, 0.0, "flow"]]
    if is_class:
        frac = min(1.0, EC.HOLD_K_PARAMS_EPOCHS / epochs)
        sched = ([frac, 1.0 - frac],
                 [[[0.0, "kernel"]] + (specs or []), specs])
    else:
        sched = ([1.0], [specs])

    trainer = Trainer(spec, params, loaders, dc["Y_std"], S_test=100,
                      device=device)
    t0 = time.time()
    trainer.train(epochs, 0.01, "adam", optimisation_schedule=sched,
                  verbose_each=0)
    elapsed = time.time() - t0
    metrics = trainer.compute_metrics()
    rec = {"model": model, "dataset": dataset, "seed": seed, "M": M,
           "epochs": epochs, "train_s": round(elapsed, 2)}
    for split, vals in metrics.items():
        for k, v in vals.items():
            if k == "calibration":
                rec[f"{split}_ECE"] = round(v["ECE"], 5)
            else:
                rec[f"{split}_{k}"] = (round(float(np.mean(v)), 5)
                                       if hasattr(v, "__len__")
                                       else round(float(v), 5))
    if model == "ID_TGP":
        trainer.fully_bayesian = True
        mb = trainer.compute_metrics()
        rec["test_logL_BA"] = round(float(np.mean(mb["test"]["logL"])), 5)
        if "rmse" in mb["test"]:
            rec["test_rmse_BA"] = round(float(np.mean(mb["test"]["rmse"])), 5)
    return rec


def missing_tables(datasets) -> dict:
    """{dataset: why} for each dataset whose tables cannot be read."""
    from ..data import return_dataset

    missing = {}
    for ds in datasets:
        try:
            return_dataset(ds, 10000, None, seed=1)
        except (FileNotFoundError, NotImplementedError) as e:
            missing[ds] = f"{type(e).__name__}: {e}"
    return missing


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="sweep runner on the GPU "
                                            "(PyTorch port)")
    p.add_argument("--suite", default="regression",
                   choices=["regression", "classification", "large"])
    p.add_argument("--models", nargs="+", default=["SVGP", "TGP", "ID_TGP"])
    p.add_argument("--datasets", nargs="+", default=None)
    p.add_argument("--seeds", nargs="+", type=int, default=EC.SWEEP_SEEDS)
    p.add_argument("--num_inducing", nargs="+", type=int,
                   default=EC.SWEEP_NUM_INDUCING)
    p.add_argument("--epochs", type=int, default=15000)
    p.add_argument("--precision", default="fp32", choices=["fp32", "fp64"])
    p.add_argument("--platform", default="gpu", choices=["gpu", "cpu"],
                   help="the card (default) or the host CPU")
    p.add_argument("--out", default=None)
    p.add_argument("--arch", default=None,
                   help="override the TGP flow arch table: NAME:NUM_BLOCKS"
                        "[:NUM_STEPS], e.g. StepAllL:2 or StepTanhL:10:2")
    return p.parse_args(argv)


def main(argv=None):
    from .battery import device_of
    from . import flow_arch as FA

    args = parse_args(argv)
    device = device_of(args)
    arch_override = FA.parse_arch_flag(args.arch) if args.arch else None
    if args.datasets is None:
        args.datasets = {
            "regression": list(EC.TGP_REGRESSION_SWEEP)[:9],
            "classification": list(EC.TGP_CLASSIFICATION_SWEEP),
            "large": ["year", "airline"],
        }[args.suite]
    missing = missing_tables(args.datasets)
    if missing:
        raise SystemExit("the tables of these datasets are not in "
                         "data_assets/: " + "; ".join(
                             f"{k} ({v})" for k, v in missing.items()))

    records = []
    out = open(args.out, "a") if args.out else None
    for model, ds, seed, M in itertools.product(
            args.models, args.datasets, args.seeds, args.num_inducing):
        try:
            rec = run_one(model, ds, seed, M, args.epochs, args.precision,
                          args.suite, arch_override=arch_override,
                          device=device)
            if arch_override:
                rec["arch"] = args.arch
        except Exception as e:
            # one diverging cell (nan_guard's FloatingPointError) must not
            # end the grid; its error is in the record
            rec = {"model": model, "dataset": ds, "seed": seed, "M": M,
                   "error": f"{type(e).__name__}: {e}"}
        print(json.dumps(rec), flush=True)
        records.append(rec)
        if out:
            out.write(json.dumps(rec) + "\n")
            out.flush()
    if out:
        out.close()
    return records


if __name__ == "__main__":
    main()
