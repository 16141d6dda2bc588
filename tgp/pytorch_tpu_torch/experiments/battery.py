"""The multi-seed battery of the port: every split seed of a (model,
dataset, M) cell trained as one model with a replica axis
(`train/multiseed.py`), with the flags, printed lines and `--out` records
of the repo's `experiments/battery.py` (the JAX package's).

    python -m tgp.pytorch_tpu_torch.experiments.battery \\
        --model {SVGP,TGP,ID_TGP,WGP,DGP} --dataset <name> \\
        --num_inducing M [--seeds 1-10] [--epochs 15000] \\
        [--precision fp32|fp64|bf16] [--platform gpu|cpu] [--batch_size B] \\
        [--arch NAME:NB[:NS]] [--num_blocks NB] [--hold_kernel_epochs E] \\
        [--natgrad GAMMA [--natgrad_warmup K] [--natgrad_force]] \\
        [--clip_norm C] [--fast_solves] [--solve_precision P] \\
        [--layers L] [--dgp_flow] [--warp_arch SAL|log_exp] \\
        [--nnet_inference MC_dropout|mean_field_gaussian] [--S_test S] \\
        [--train_seed S] [--out FILE] [--save_curves NPY] \\
        [--ckpt FILE [--ckpt_each E]] [--rng_impl threefry2x32|rbg] \\
        [--mesh DP]

Each replica has its own split, z-scoring, k-means inducing points and
parameters; a Step* table arch gets each split's identity fit and ID_TGP
each split's hypernet anchor fit, with numpy reseeded before each, as the
serial protocol does.  Full batch, or minibatch SVI where N > --batch_size;
a classification dataset holds the kernel for --hold_kernel_epochs, then
releases it with the Adam moments carried.  `--ckpt` trains in
--ckpt_each-epoch segments and saves the whole battery (`torch.save`, an
atomic `os.replace`) after each; a resumed run is bitwise the
uninterrupted one, and a checkpoint of another configuration, or a
completed one, is refused.

`--mesh DP` cuts the seed axis over DP ranks (`train/multiseed.py`), one
process a device, started by `python -m torch.distributed.run
--nproc_per_node DP -m tgp.pytorch_tpu_torch.experiments.battery ...`;
every rank prepares the cell, and only rank 0 prints and writes.
`--rng_impl rbg` and `--precision bf16` are the experiment CLI's.

It runs on the card (`--platform gpu`, the default) or, when asked, on the
CPU; without a card and without `--platform cpu` it exits non-zero.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import os
import time

import numpy as np
import torch


def parse_seeds(s):
    if "-" in s:
        a, b = s.split("-")
        return list(range(int(a), int(b) + 1))
    return [int(v) for v in s.split(",")]


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="multi-seed battery on the GPU (PyTorch port)")
    p.add_argument("--model", required=True,
                   choices=["SVGP", "TGP", "ID_TGP", "WGP", "DGP"])
    p.add_argument("--layers", type=int, default=2, help="DGP depth")
    p.add_argument("--dgp_flow", action="store_true",
                   help="the dataset's table flow arch on the DGP output "
                        "layer (non-step archs only)")
    p.add_argument("--warp_arch", default="SAL", choices=["SAL", "log_exp"])
    p.add_argument("--warp_terms", type=int, default=3)
    p.add_argument("--nnet_inference", default="MC_dropout",
                   choices=["MC_dropout", "mean_field_gaussian"])
    p.add_argument("--hold_kernel_epochs", type=int, default=None,
                   help="classification: hold the kernel this many epochs, "
                        "then release it (default exp_config."
                        "HOLD_K_PARAMS_EPOCHS)")
    p.add_argument("--dataset", required=True)
    p.add_argument("--num_inducing", required=True, type=int)
    p.add_argument("--seeds", default="1-10")
    p.add_argument("--epochs", type=int, default=15000)
    p.add_argument("--lr", type=float, default=0.01)
    p.add_argument("--precision", default="fp32",
                   choices=["fp32", "fp64", "bf16"])
    p.add_argument("--rng_impl", default="threefry2x32",
                   choices=["threefry2x32", "rbg"])
    p.add_argument("--platform", default="gpu", choices=["gpu", "cpu"],
                   help="gpu (the default) needs a CUDA device")
    p.add_argument("--S_test", type=int, default=100)
    p.add_argument("--batch_size", type=int, default=10000,
                   help="the reference protocol's batch; minibatch SVI "
                        "where N > batch")
    p.add_argument("--num_blocks", type=int, default=None)
    p.add_argument("--arch", default=None,
                   help="override the sweep-table arch: NAME:NUM_BLOCKS"
                        "[:NUM_STEPS]")
    p.add_argument("--mesh", default=None, metavar="DP")
    p.add_argument("--train_seed", type=int, default=0,
                   help="seed of the training draws and shuffles")
    p.add_argument("--natgrad", type=float, default=None, metavar="GAMMA")
    p.add_argument("--natgrad_force", action="store_true")
    p.add_argument("--natgrad_warmup", type=int, default=None, metavar="K")
    p.add_argument("--clip_norm", type=float, default=None,
                   help="per-replica global-norm gradient clip")
    p.add_argument("--fast_solves", action="store_true")
    p.add_argument("--solve_precision", default="highest",
                   choices=["highest", "high", "default"])
    p.add_argument("--out", default=None)
    p.add_argument("--save_curves", default=None, metavar="NPY",
                   help="save the per-seed ELBO curves (R, T) here")
    p.add_argument("--ckpt", default=None, metavar="FILE",
                   help="checkpoint/resume file (--ckpt_each-epoch segments)")
    p.add_argument("--ckpt_each", type=int, default=1000)
    p.add_argument("--ckpt_stop_after", type=int, default=None,
                   help=argparse.SUPPRESS)   # exit 75 after N saves (tests)
    return p.parse_args(argv)


def refusal(args):
    """The message for a malformed option, or None."""
    if args.mesh is not None and not args.mesh.isdigit():
        return f"--mesh takes the dp size DP, e.g. 8 (got {args.mesh!r})"
    return None


@dataclasses.dataclass
class Battery:
    """What `run` did: `reports` holds each evaluation's (tag, metrics,
    printed lines, --out record); the rest is for checking and timing."""

    reports: list
    params: dict
    curves: dict
    seeds: list
    train_s: float
    #: Gram kernel calls while training and while evaluating (one entry a
    #: report), each (forward launches, backward calls)
    kernel_calls: dict


@dataclasses.dataclass
class Cell:
    """A battery's model and data, each replica prepared as one process of
    the serial protocol prepares its seed: its split, k-means inducing
    points, fits and init, stacked."""

    spec: object
    params: dict
    X: np.ndarray            # (R, N, Dx) training inputs
    Y: np.ndarray            # (R, N, Dy), or (R, N) class labels
    X_test: np.ndarray
    Y_test: np.ndarray
    Y_std: np.ndarray        # (R, Dy)
    seeds: list
    is_class: bool
    N_tr: int
    flow_spec: tuple
    #: the optimizer's groups (ID_TGP: weight decay on the nets only)
    specs: list | None


def _ckpt_meta(args, seeds):
    """Everything that shapes the trajectory: a checkpoint of another cell
    must never resume silently."""
    return {"model": args.model, "dataset": args.dataset,
            "M": args.num_inducing, "seeds": seeds, "epochs": args.epochs,
            "lr": args.lr, "arch": args.arch, "batch": args.batch_size,
            "precision": args.precision, "fast_solves": args.fast_solves,
            "solve_precision": args.solve_precision,
            "clip_norm": args.clip_norm, "train_seed": args.train_seed,
            "natgrad": args.natgrad, "natgrad_warmup": args.natgrad_warmup,
            "nnet_inference": (args.nnet_inference
                               if args.model == "ID_TGP" else None),
            "layers": args.layers if args.model == "DGP" else None,
            "dgp_flow": args.dgp_flow if args.model == "DGP" else None,
            "rng_impl": args.rng_impl,
            "warp": ((args.warp_arch, args.warp_terms)
                     if args.model == "WGP" else None)}


def _to(tree, device):
    from ..train.group_adam import GroupAdamState
    from ..weights import tree_map
    if isinstance(tree, GroupAdamState):
        return GroupAdamState(list(tree.count), _to(tree.mu, device),
                              _to(tree.nu, device))
    return tree_map(lambda t: t.detach().to(device), tree)


def device_of(args):
    """The run's device: the card unless --platform cpu; exits without
    one."""
    from .. import config as cfg
    if args.platform == "cpu":
        return torch.device("cpu")
    if torch.cuda.is_available():
        return cfg.default_device()
    raise SystemExit("no CUDA device is available; pass --platform cpu to "
                     "run on the CPU")


def prepare(args, device, resume=None) -> Cell:
    """The cell of `args` on `device` in the configured precision: the
    per-seed splits, k-means centers, flow fits and inits, stacked.  From
    a checkpoint (`resume`), the flow spec and the params are its own and
    nothing is fitted."""
    from .. import config as cfg
    from ..data import kmeans_centers, return_dataset
    from ..flows import generators as G
    from ..flows.core import IDENTITY_SPEC, spec_from_list
    from ..flows.initializers import (fit_flow_to_identity,
                                      fit_hypernet_to_anchors)
    from ..likelihoods import LikelihoodSpec
    from ..models import tgp as M
    from ..models.deep import DeepTGPSpec, init_deep_params, layer_spec
    from ..ops import kernels as K
    from ..ops.transforms import np_inv_softplus
    from ..train import multiseed as ms
    from ..weights import tree_map
    from . import flow_arch as FA

    seeds = parse_seeds(args.seeds)
    R = len(seeds)

    # ---- per-seed splits (the serial protocol's) --------------------------
    Xtr, Ytr, Xte, Yte, Ystd, Z0s = [], [], [], [], [], []
    Dy = Dx = N_tr = None
    is_class = False
    for s in seeds:
        loaders, dc = return_dataset(args.dataset, 10 ** 9, None, seed=s,
                                     options={"shuffle_train": False})
        Dy, Dx, N_tr = dc["Dy"], dc["Dx"], dc["N_tr"]
        is_class = dc["task"] == "classification"
        Xtr.append(dc["X_tr"])
        Ytr.append(dc["Y_tr"])
        Xte.append(loaders[-1].dataset.X)
        Yte.append(loaders[-1].dataset.Y)
        Ystd.append(np.asarray(dc["Y_std"]).reshape(-1))
        if resume is None:
            Z0s.append(kmeans_centers(dc["X_tr"], args.num_inducing,
                                      n_init=10, seed=cfg.config_seed))

    # ---- flow architecture ------------------------------------------------
    flow_spec, flow_inits, flow_fitted = IDENTITY_SPEC, None, None

    def table_arch():
        try:
            return FA.resolve_tgp_arch(
                args.dataset, is_class,
                arch_override=(FA.parse_arch_flag(args.arch) if args.arch
                               else None),
                num_blocks=None if args.arch else args.num_blocks)
        except ValueError as e:
            raise SystemExit(str(e))

    if resume is not None:
        # the fitted spec and per-seed fitted params come from the checkpoint
        flow_spec = resume["flow_spec"]
    elif args.model == "ID_TGP":
        np.random.seed(cfg.config_seed)
        flow_spec, flow_inits = FA.build_id_flow(
            args.dataset, Dx, is_class, inference=args.nnet_inference)
    elif args.model == "TGP":
        arch, nb, ns = table_arch()
        np.random.seed(cfg.config_seed)
        if FA.is_step_arch(arch):
            # each split's Y range differs, so each replica gets its own
            # fit; numpy reseeded before each, as one process per seed is
            make = FA.make_step_gen(arch, nb, ns)
            flow_fitted = []
            for r in range(R):
                np.random.seed(cfg.config_seed)
                y = Ytr[r]
                flow_spec, fitted, mse = fit_flow_to_identity(
                    make, float(y.min()) - 1.0, float(y.max()) + 1.0,
                    num_restarts=1, num_epochs=2000, device=device)
                print(f"seed {seeds[r]}: identity-fit MSE {mse:.3e}")
                flow_fitted.append(fitted)
        else:
            flow_spec, flow_inits = FA.build_point_flow(arch, nb)
    elif args.model == "DGP" and args.dgp_flow:
        arch, nb, _ = table_arch()
        if FA.is_step_arch(arch):
            raise SystemExit("--dgp_flow supports the non-step table archs "
                             "(identity-fit of step warps inside a deep "
                             "stack is untested)")
        np.random.seed(cfg.config_seed)
        flow_spec, flow_inits = FA.build_point_flow(arch, nb)

    # ---- likelihood and spec ------------------------------------------------
    warp_inits = None
    if is_class:
        # one GP per class (binary: one Bernoulli GP)
        Dy_model = 1 if Dy == 2 else Dy
        lik = (LikelihoodSpec("bernoulli", 1, quad_points=cfg.quad_points)
               if Dy == 2 else
               LikelihoodSpec("categorical", Dy, quad_points=cfg.quad_points,
                              num_classes=Dy))
        if args.model in ("WGP", "DGP"):
            raise SystemExit(f"--model {args.model} is regression-only; "
                             f"{args.dataset} is classification")
    else:
        Dy_model = Dy
        if args.model == "SVGP" or (args.model == "DGP"
                                    and not args.dgp_flow):
            # DGP without a flow: the closed-form Gaussian ELL
            lik = LikelihoodSpec("gaussian", Dy, noise_is_shared=False)
        elif args.model == "WGP":
            np.random.seed(cfg.config_seed)
            if args.warp_arch == "SAL":
                wspec, _ = spec_from_list(G.SAL(1))
            else:
                Kt = args.warp_terms
                wspec, warp_inits = spec_from_list([("log_exp", {
                    "add_init_f0": True,
                    "init_a": [float(np_inv_softplus(1.0 / Kt))] * Kt,
                    "init_b": [float(np_inv_softplus(1.0))] * Kt,
                    "init_c": np.linspace(-1.0, 1.0, Kt).tolist()})])
            lik = LikelihoodSpec("warped", Dy, noise_is_shared=False,
                                 quad_points=cfg.quad_points, warp_flow=wspec)
        else:
            lik = LikelihoodSpec("gaussian_flow", Dy, noise_is_shared=False,
                                 quad_points=cfg.quad_points)
    kernel = K.from_name("scale_rbf")
    kernel_init = {"length_scale": 2.0, "kernel_scale": 2.0}
    if args.model == "DGP":
        if args.natgrad:
            raise SystemExit("--natgrad needs a single-layer q(U)")
        if args.fast_solves or args.solve_precision != "highest":
            raise SystemExit("--fast_solves/--solve_precision are not wired "
                             "into the DGP layer specs (measured guidance "
                             "covers shallow models only)")
        inner = tuple(layer_spec(Dx, Dx, args.num_inducing, float(N_tr),
                                 kernel, whiten=True)
                      for _ in range(args.layers - 1))
        last = M.TGPSpec(Dy=Dy_model, Dx=Dx, M=args.num_inducing,
                         N=float(N_tr), kernel=kernel, likelihood=lik,
                         flow=flow_spec, mean="zero", whiten=True)
        spec = DeepTGPSpec(layers=inner + (last,), S_train=1,
                           S_test=args.S_test)
        kernel_init["noisy_variance"] = 1e-6
    else:
        spec = M.TGPSpec(Dy=Dy_model, Dx=Dx, M=args.num_inducing,
                         N=float(N_tr), kernel=kernel, likelihood=lik,
                         flow=flow_spec, mean="zero", whiten=True,
                         fast_solves=args.fast_solves,
                         solve_precision=args.solve_precision)
    if args.fast_solves and args.solve_precision != "highest":
        # the battery has no per-replica plateau guard
        print("WARNING: --fast_solves + --solve_precision="
              f"{args.solve_precision} TOGETHER deterministically stalled "
              "at mid M in measurement (PARITY.md).  Validate the ELBO "
              "trace (--save_curves + tools/plateau_analysis.py) or prefer "
              "either lever alone / experiments/main.py "
              "--solve_warmup_epochs for this combination.", flush=True)

    # ---- per-seed init, stacked -------------------------------------------
    if resume is not None:
        params = resume["params"]
    else:
        per_seed = []
        for r in range(R):
            init = dict(variance_scale=1e-5, mean_scale=0.0,
                        kernel_init=kernel_init, noise_init=0.05,
                        flow_inits=flow_inits, device=device)
            if args.model == "DGP":
                pr = init_deep_params(spec, Xtr[r], Z0s[r], **init)
            else:
                pr = M.init_tgp_params(spec, Xtr[r], Z0s[r],
                                       warp_inits=warp_inits, **init)
            if flow_fitted is not None:
                pr["flow"] = tree_map(lambda x: torch.stack([x] * Dy_model),
                                      flow_fitted[r])
            if args.model == "ID_TGP":
                fp0 = tree_map(lambda x: x[0], pr["flow"])
                # batched as the serial CLI's loader batches (10000 rows)
                fit_batches = [Xtr[r][i:i + args.batch_size]
                               for i in range(0, N_tr, args.batch_size)]
                fp0, loss = fit_hypernet_to_anchors(
                    flow_spec, fp0, fit_batches, num_epochs=2000,
                    noise_var=0.0)
                pr["flow"] = tree_map(lambda x: torch.stack([x] * Dy_model),
                                      fp0)
                print(f"seed {seeds[r]}: hypernet anchor-fit loss {loss:.3e}")
            per_seed.append(pr)
        params = ms.stack_trees(per_seed)

    specs = None
    if args.model == "ID_TGP":
        # weight decay on the hypernet weights only
        specs = [[args.lr, 1e-5, "net_"], [args.lr, 0.0, "flow"]]
    return Cell(spec=spec, params=params, X=np.stack(Xtr), Y=np.stack(Ytr),
                X_test=np.stack(Xte), Y_test=np.stack(Yte),
                Y_std=np.stack(Ystd), seeds=seeds, is_class=is_class,
                N_tr=N_tr, flow_spec=flow_spec, specs=specs)


def run(args) -> Battery:
    msg = refusal(args)
    if msg:
        raise SystemExit(msg)
    if args.mesh is None:
        return _run(args, None)
    from ..parallel import multihost

    dp = int(args.mesh)
    mesh = multihost.join_mesh(dp, 1, args.platform,
                               "tgp.pytorch_tpu_torch.experiments.battery")
    try:
        # only rank 0 prints
        with (contextlib.redirect_stdout(io.StringIO()) if mesh.rank
              else contextlib.nullcontext()):
            print(f"==== battery on a {dp}-way dp mesh (seed axis sharded) "
                  "====", flush=True)
            return _run(args, mesh)
    finally:
        multihost.shutdown()


def _run(args, mesh) -> Battery:
    from .. import config as cfg
    from ..models import tgp as M
    from ..ops import rbf_gram as RG
    from ..train import multiseed as ms
    from ..train.metrics import replica_outliers
    from . import exp_config as EC

    from .main import BF16_WARNING

    cfg.set_precision(args.precision)
    cfg.set_rng_impl(args.rng_impl)
    if args.precision == "bf16":
        print(BF16_WARNING, flush=True)
    device = device_of(args) if mesh is None else mesh.device
    writer = mesh is None or mesh.rank == 0
    seeds = parse_seeds(args.seeds)
    R = len(seeds)

    # ---- checkpoint resume ------------------------------------------------
    ckpt_meta = _ckpt_meta(args, seeds)
    resume = None
    if args.ckpt and os.path.exists(args.ckpt):
        resume = torch.load(args.ckpt, map_location="cpu", weights_only=False)
        if resume["meta"] != ckpt_meta:
            raise SystemExit(
                f"checkpoint {args.ckpt} was written by a different battery "
                f"config:\n  ckpt: {resume['meta']}\n  this: {ckpt_meta}")
        if resume["epochs_done"] >= args.epochs:
            # a retry relaunching a finished battery must not evaluate it
            # again and append duplicate rows to --out
            raise SystemExit(
                f"checkpoint {args.ckpt} is already complete "
                f"({resume['epochs_done']}/{args.epochs} epochs); delete it "
                "to re-run this cell")
        print(f"resuming from {args.ckpt}: "
              f"{resume['epochs_done']}/{args.epochs} epochs done")

    cell = prepare(args, device, resume)
    spec, params, specs, is_class = (cell.spec, cell.params, cell.specs,
                                     cell.is_class)
    flow_spec, N_tr = cell.flow_spec, cell.N_tr
    print(f"battery: {args.model} {args.dataset} M={args.num_inducing} "
          f"R={R} epochs={args.epochs} on {device.type}", flush=True)
    Xs, Ys = cell.X, cell.Y
    verbose = min(max(args.epochs // 5, 1), 2000)
    common = dict(batch_size=args.batch_size, seed=args.train_seed,
                  clip_norm=args.clip_norm, verbose_each=verbose,
                  natgrad_gamma=args.natgrad,
                  natgrad_warmup=args.natgrad_warmup,
                  natgrad_force=args.natgrad_force, mesh=mesh, device=device)
    hold = 0
    if is_class:
        if args.ckpt is not None:
            raise SystemExit("--ckpt is not supported for classification "
                             "batteries yet (two-phase hold-kernel "
                             "segmentation)")
        hold = args.hold_kernel_epochs
        if hold is None:
            hold = EC.HOLD_K_PARAMS_EPOCHS
        hold = min(hold, args.epochs)

    calls = [(RG.LAUNCHES, RG.BWD_LAUNCHES)]
    if args.ckpt is None:
        t0 = time.time()
        if hold:
            specs_hold = [[0.0, "kernel"]] + (specs or [])
            params, cv1, carry = ms.train_multiseed_minibatch(
                spec, params, Xs, Ys, hold, args.lr, specs=specs_hold,
                return_state=True, **common)
            curves = dict(cv1)
            if args.epochs > hold:
                # released: the earlier groups' moments carry, the kernel's
                # start fresh (torch add_param_group semantics)
                params, cv2 = ms.train_multiseed_minibatch(
                    spec, params, Xs, Ys, args.epochs - hold, args.lr,
                    specs=specs, carry=carry, **common)
                curves = {k: np.concatenate([curves[k], cv2[k]], axis=0)
                          for k in curves}
        else:
            params, curves = ms.train_multiseed_minibatch(
                spec, params, Xs, Ys, args.epochs, args.lr, specs=specs,
                **common)
        train_s = time.time() - t0
    else:
        # segments, each followed by a checkpoint of the whole battery
        carry = resume["carry"] if resume else None
        if carry is not None:
            carry = dict(carry, opt_state=_to(carry["opt_state"], device))
        done = resume["epochs_done"] if resume else 0
        train_s = resume["train_s"] if resume else 0.0
        curve_parts = resume["curves"] if resume else []
        saves = 0
        while done < args.epochs:
            n = min(args.ckpt_each, args.epochs - done)
            t0 = time.time()
            params, cv, carry = ms.train_multiseed_minibatch(
                spec, params, Xs, Ys, n, args.lr, specs=specs, carry=carry,
                return_state=True, **common)
            train_s += time.time() - t0
            done += n
            curve_parts.append(cv)
            if writer:
                tmp = args.ckpt + ".tmp"
                torch.save({"meta": ckpt_meta, "epochs_done": done,
                            "train_s": train_s, "flow_spec": flow_spec,
                            "params": _to(params, "cpu"),
                            "carry": dict(carry, opt_state=_to(
                                carry["opt_state"], "cpu")),
                            "curves": curve_parts}, tmp)
                os.replace(tmp, args.ckpt)  # atomic: never a torn checkpoint
            if mesh is not None and mesh.world > 1:
                torch.distributed.barrier()
            print(f"checkpoint: {done}/{args.epochs} epochs -> {args.ckpt} "
                  f"({train_s:.1f}s trained)", flush=True)
            saves += 1
            if args.ckpt_stop_after and saves >= args.ckpt_stop_after:
                print("ckpt_stop_after: simulated crash", flush=True)
                raise SystemExit(75)
        curves = {k: np.concatenate([c[k] for c in curve_parts], axis=0)
                  for k in curve_parts[0]}
    calls.append((RG.LAUNCHES, RG.BWD_LAUNCHES))

    if args.save_curves and writer:
        # (T, R) from training, stored (R, T)
        elbo = np.asarray(curves["elbo"]).T
        np.save(args.save_curves, elbo)
        print(f"saved per-seed ELBO curves {elbo.shape} -> {args.save_curves}")

    if spec.has_bn_flow:
        # the hypernets' batch-norm statistics per replica, from its own
        # training inputs, before any evaluation (as the Trainer does)
        params = ms.stack_trees([
            M.finalize_batch_norm(spec, ms.unstack_tree(params, r), Xs[r])
            for r in range(R)])

    reports = []

    def report(tag, fully_bayesian):
        metrics = ms.eval_multiseed(spec, params, cell.X_test, cell.Y_test,
                                    cell.Y_std,
                                    S_test=args.S_test,
                                    fully_bayesian=fully_bayesian,
                                    mesh=mesh, device=device)
        calls.append((RG.LAUNCHES, RG.BWD_LAUNCHES))
        lines = []

        def say(line):
            print(line)
            lines.append(line)

        if is_class:
            nll = -metrics["logL"]
            acc = metrics["acc"]
            say(f"\n== {tag} {args.dataset} M={args.num_inducing} "
                f"{R}-seed classification battery: {args.epochs} epochs "
                f"({hold} held) in {train_s:.1f}s ==")
            for i, sd in enumerate(seeds):
                say(f"seed {sd:2d}: NLL {nll[i]:.4f}  acc {acc[i]:.4f}")
            say(f"mean +- std: NLL {nll.mean():.4f} +- {nll.std():.4f}   "
                f"acc {acc.mean():.4f} +- {acc.std():.4f}")
            out = replica_outliers(nll)
            flagged = [seeds[i] for i in np.nonzero(out["flags"])[0]]
            if flagged:
                say("OUTLIER replicas (|robust z| > 5): "
                    + ", ".join(f"seed {sd}" for sd in flagged))
            record = {
                "model": tag, "dataset": args.dataset,
                "M": args.num_inducing, "seeds": seeds,
                "arch": ((args.arch or "table")
                         if args.model != "SVGP" else None),
                "epochs": args.epochs, "hold": hold,
                "train_s": round(train_s, 2),
                "nll": [round(float(v), 4) for v in nll],
                "acc": [round(float(v), 4) for v in acc],
                "nll_mean": round(float(nll.mean()), 4),
                "acc_mean": round(float(acc.mean()), 4),
                "outlier_seeds": flagged}
        else:
            nll = -metrics["logL"].mean(axis=-1)    # per seed, mean over Dy
            rmse = metrics["rmse"].mean(axis=-1)
            say(f"\n== {tag} {args.dataset} M={args.num_inducing} "
                f"{R}-seed battery: {args.epochs} epochs in {train_s:.1f}s "
                f"({R * args.epochs / train_s:.0f} effective steps/s) ==")
            for i, s in enumerate(seeds):
                say(f"seed {s:2d}: NLL {nll[i]:.3f}  RMSE {rmse[i]:.3f}  "
                    f"coverage {metrics['coverage'][i].mean():.3f}")
            say(f"mean +- std: NLL {nll.mean():.3f} +- {nll.std():.3f}   "
                f"RMSE {rmse.mean():.3f} +- {rmse.std():.3f}")
            out = replica_outliers(nll)
            flagged = [seeds[i] for i in np.nonzero(out["flags"])[0]]
            if flagged:
                # a bad basin that trains as well as the healthy mode; the
                # measured fix is another training rng stream
                say(f"OUTLIER replicas (|robust z| > 5 vs median "
                    f"{out['median']:.3f}, MAD {out['mad']:.3f}): "
                    + ", ".join(f"seed {s} (z {out['z'][seeds.index(s)]:+.1f})"
                                for s in flagged)
                    + f" — rerun with --seeds {','.join(map(str, flagged))} "
                    "--train_seed 1 (see PARITY.md naval study)")
            record = {
                "model": tag, "dataset": args.dataset,
                "M": args.num_inducing, "seeds": seeds,
                "arch": ((args.arch or "table")
                         if args.model in ("TGP", "ID_TGP")
                         or (args.model == "DGP" and args.dgp_flow)
                         else None),
                "batch": ("full" if args.batch_size >= N_tr
                          else args.batch_size),
                "epochs": args.epochs, "train_s": round(train_s, 2),
                "natgrad": args.natgrad,
                "natgrad_warmup": args.natgrad_warmup,
                "nll": [round(float(v), 4) for v in nll],
                "rmse": [round(float(v), 4) for v in rmse],
                "nll_mean": round(float(nll.mean()), 4),
                "rmse_mean": round(float(rmse.mean()), 4),
                "outlier_seeds": flagged}
        if args.out and writer:
            with open(args.out, "a") as f:
                f.write(json.dumps(record) + "\n")
        reports.append((tag, metrics, lines, record))

    if args.model == "ID_TGP":
        vi = args.nnet_inference == "mean_field_gaussian"
        report("ID_TGP_VI(PE)" if vi else "ID_TGP(PE)", False)
        report("ID_TGP_VI(BA)" if vi else "ID_TGP(BA)", True)
    elif args.model == "WGP":
        report(f"WGP({args.warp_arch})", False)
    elif args.model == "DGP":
        report(f"DGP-{args.layers}" + ("+flow" if args.dgp_flow else ""),
               False)
    else:
        report(args.model, False)

    deltas = [tuple(b - a for a, b in zip(c0, c1))
              for c0, c1 in zip(calls, calls[1:])]
    kernel_calls = {"train": deltas[0]}
    kernel_calls.update((f"eval{i}" if i else "eval", d)
                        for i, d in enumerate(deltas[1:]))
    return Battery(reports=reports, params=params, curves=curves,
                   seeds=seeds, train_s=train_s, kernel_calls=kernel_calls)


def main(argv=None):
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
