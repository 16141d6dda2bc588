"""The classification protocol on the synthetic corpora, on the card: the
port's counterpart of the repo's `benchmarks/classification_protocol.py`,
with its flags and its JSON records.

    python -m tgp.pytorch_tpu_torch.experiments.classification_protocol \\
        [--epochs 6000] [--model TGP|ID_TGP] [--train_seed S] \\
        [--task binary|categorical] [--out FILE] [--platform gpu|cpu]

  * binary: a Bernoulli likelihood (Gauss-CDF link, 50 quadrature nodes)
    through an SAL_InvBCL flow;
  * categorical: 3 classes, per-class BCL_AL flows, 32 MC draws;
  * `--model ID_TGP`: SAL(1) whose parameters come from MC-dropout nets of
    x (tanh, 1 hidden layer of 25; dropout 0.5 binary, 0.75 categorical),
    fitted to their anchors for 2000 epochs, weight decay 1e-5 on the nets
    in both phases, then a point-estimate (PE) and a fully-Bayesian (BA)
    evaluation;
  * 1080 training and 120 test rows of `data.uci_classification.
    synthetic_corpus` (Dx=4), M=50 k-means inducing points, fp32; Adam at
    lr 0.01 with the kernel held for min(2000, epochs // 3) epochs, then
    every parameter; gradients clipped at global norm 100.

It runs on the card (`--platform gpu`, the default) or, when asked, on the
CPU; without a card and without `--platform cpu` it exits non-zero.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch


@dataclasses.dataclass
class Run:
    """What `run` did: `records` are the JSON records (one, or PE and BA
    for ID_TGP); the rest is for checking and timing."""

    records: list
    trainer: object
    Z0: np.ndarray
    #: ID_TGP's anchor fit: (class 0's fitted flow params, its last loss)
    anchor_fit: tuple | None
    #: Gram kernel calls while training and while evaluating ("eval", for
    #: ID_TGP also "eval_bayes"), each (forward launches, backward calls),
    #: read from `ops.rbf_gram`
    kernel_calls: dict
    #: the metrics of each evaluation (PE, then BA)
    metrics: list


def run(kind: str, epochs: int, model: str = "TGP", train_seed: int = 0,
        out_path: str | None = None, device=None) -> Run:
    """One protocol run (JAX `benchmarks/classification_protocol.py:35-145`)
    in the port's current precision, on `device` (None: the card)."""
    from .. import config as cfg
    from ..data import ArrayDataset, DataLoader, kmeans_centers
    from ..data.uci_classification import synthetic_corpus
    from ..flows import generators as G
    from ..flows.core import spec_from_list
    from ..flows.initializers import fit_hypernet_to_anchors
    from ..likelihoods.gaussian import LikelihoodSpec
    from ..models import tgp as M
    from ..ops import kernels as K, rbf_gram as R
    from ..train import Trainer
    from ..weights import tree_map

    device = cfg.resolve_device(device)
    X, y = synthetic_corpus("binary" if kind == "binary" else "multiclass")
    y = y.reshape(-1, 1)
    N, Dx = X.shape
    id_kw = dict(input_dependent=True, input_dim=Dx, hidden_activation="tanh",
                 num_hidden_layers=1, hidden_dim=25, inference="MC_dropout")
    np.random.seed(0)
    if kind == "binary":
        C, Dy = 2, 1
        lik = LikelihoodSpec("bernoulli", 1, quad_points=50)
        fl = (G.SAL(1, dropout=0.5, **id_kw) if model == "ID_TGP"
              else G.build_chain("SAL_InvBCL", 1))
    else:
        C, Dy = 3, 3
        lik = LikelihoodSpec("categorical", 3, quad_points=32, num_classes=3)
        fl = (G.SAL(1, dropout=0.75, **id_kw) if model == "ID_TGP"
              else G.build_chain("BCL_AL", 1))
    fspec, finits = spec_from_list(fl)

    n_tr = int(0.9 * N)
    Xtr, ytr, Xte, yte = X[:n_tr], y[:n_tr], X[n_tr:], y[n_tr:]
    M_ind = 50
    Z0 = kmeans_centers(Xtr, M_ind, n_init=10)
    spec = M.TGPSpec(Dy=Dy, Dx=Dx, M=M_ind, N=float(n_tr),
                     kernel=K.from_name("scale_rbf"), likelihood=lik,
                     flow=fspec)
    params = M.init_tgp_params(
        spec, Xtr, Z0, variance_scale=1e-5,
        kernel_init={"length_scale": 2.0, "kernel_scale": 2.0},
        flow_inits=finits, device=device)

    t_init, anchor_fit = 0.0, None
    if model == "ID_TGP":
        # class 0's nets fitted to their anchors, stacked over the classes
        t0 = time.time()
        fp0 = tree_map(lambda x: x[0], params["flow"])
        anchor_fit = fit_hypernet_to_anchors(fspec, fp0, [Xtr],
                                             num_epochs=2000)
        params["flow"] = tree_map(lambda x: torch.stack([x] * Dy),
                                  anchor_fit[0])
        t_init = time.time() - t0
        print(f"# hypernet anchor-fit loss {anchor_fit[1]:.3e} in "
              f"{t_init:.1f}s", flush=True)

    loaders = [DataLoader(ArrayDataset(Xtr, ytr), 10000, seed=0),
               DataLoader(ArrayDataset(Xte, yte), 10000, shuffle=False)]
    tr = Trainer(spec, params, loaders, Y_std=np.ones(1), S_test=50,
                 seed=train_seed, device=device)
    hold = min(2000, epochs // 3)
    id_groups = [[0.01, 1e-5, "net_"]] if model == "ID_TGP" else []
    sched = ([hold / epochs, 1 - hold / epochs],
             [[[0.0, "kernel"]] + id_groups, id_groups or None])
    calls = [(R.LAUNCHES, R.BWD_LAUNCHES)]
    t0 = time.time()
    tr.train(epochs, 0.01, "adam", optimisation_schedule=sched,
             verbose_each=0, clip_norm=100.0)
    train_s = time.time() - t0
    calls.append((R.LAUNCHES, R.BWD_LAUNCHES))
    metrics = [tr.compute_metrics()]
    calls.append((R.LAUNCHES, R.BWD_LAUNCHES))
    m = metrics[0]["test"]
    rec = {"task": kind, "model": model, "classes": C, "epochs": epochs,
           "train_seed": train_seed,
           "test_acc": round(float(m["acc"]), 4),
           "test_nll": round(float(-m["logL"][0]), 4),
           "ECE": round(m["calibration"]["ECE"], 4),
           "train_s": round(train_s, 2), "init_s": round(t_init, 1),
           "steps_per_sec": round(epochs / train_s, 1)}
    recs = [rec]
    if model == "ID_TGP":
        tr.fully_bayesian = True
        metrics.append(tr.compute_metrics())
        calls.append((R.LAUNCHES, R.BWD_LAUNCHES))
        mb = metrics[1]["test"]
        recs.append(dict(rec, eval="BA",
                         test_acc=round(float(mb["acc"]), 4),
                         test_nll=round(float(-mb["logL"][0]), 4),
                         ECE=round(mb["calibration"]["ECE"], 4)))
        recs[0]["eval"] = "PE"
    if out_path:
        with open(out_path, "a") as f:
            for r in recs:
                f.write(json.dumps(r) + "\n")
    names = ("train", "eval", "eval_bayes")
    kernel_calls = {names[i]: tuple(b - a for a, b in zip(calls[i], calls[i + 1]))
                    for i in range(len(calls) - 1)}
    return Run(records=recs, trainer=tr, Z0=Z0, anchor_fit=anchor_fit,
               kernel_calls=kernel_calls, metrics=metrics)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="the classification protocol "
                                            "(PyTorch port)")
    p.add_argument("--platform", default="gpu", choices=["gpu", "cpu"],
                   help="gpu (the default) needs a CUDA device")
    p.add_argument("--epochs", type=int, default=6000)
    p.add_argument("--model", default="TGP", choices=["TGP", "ID_TGP"])
    p.add_argument("--train_seed", type=int, default=0)
    p.add_argument("--task", default=None, choices=[None, "binary", "categorical"])
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
    cfg.set_precision("fp32")
    kinds = (args.task,) if args.task else ("binary", "categorical")
    for kind in kinds:
        for rec in run(kind, args.epochs, model=args.model,
                       train_seed=args.train_seed, out_path=args.out,
                       device=device).records:
            print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
