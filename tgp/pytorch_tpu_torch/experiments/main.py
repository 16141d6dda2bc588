"""The experiment CLI of the port, for SVGP, TGP, ID_TGP, WGP and DGP:

    python -m tgp.pytorch_tpu_torch.experiments.main \\
        --model {SVGP,TGP,ID_TGP,WGP,DGP} --dataset <name> \\
        --train_test_seed_split S --num_inducing M [--epochs E] \\
        [--precision fp64|fp32] [--platform gpu|cpu] \\
        [--nnet_inference MC_dropout|mean_field_gaussian] \\
        [--warp_arch SAL|log_exp|StepTanhL] [--warp_terms K] \\
        [--fast_solves] [--solve_precision highest|high|default] \\
        [--solve_warmup_epochs E] [--plateau_guard [warn|raise|recover]] \\
        [--natgrad GAMMA [--natgrad_warmup K] [--natgrad_force]] \\
        [--layers L] [--dgp_flow] [--S_train S] [--checkpoint_dir DIR] \
        [--rng_impl threefry2x32|rbg] [--mesh DPxTY]

It takes the flags of the repo's `experiments/main.py` (the JAX package's
CLI) and does what that CLI does for these models: the UCI split, k-means
inducing points, the dataset's flow architecture from the paper's tables
(Step* archs fitted to the identity first; ID_TGP's SAL blocks with
hypernets fitted to their identity anchors), the same model and init, Adam
for --epochs at --lr (ID_TGP: the nets at weight decay 1e-5), then the test
metrics and the same result line; ID_TGP prints a second, `BAYESIAN FLOW`
line for the fully-Bayesian evaluation (S_test hypernet draws).  WGP is the
warped GP: SVGP's model with a learnable observation warp T in the
likelihood (SAL(1); `log_exp`, y plus K softplus terms, inverted by
Newton's method; or StepTanhL(1, K) with y added, fitted to the identity
over the targets' range first).
The solve levers are the JAX CLI's: `--fast_solves` (L^{-1} formed once,
then GEMMs), `--solve_precision` (the factor's applications in fp32 on the
card: three TF32 passes for 'high', one bf16 pass for 'default'),
`--solve_warmup_epochs`
(that many epochs at trsm/'highest' first, then the requested mode with
the Adam moments carried), and `--plateau_guard` (the Trainer's stall
detector; fast solves at a reduced precision without a warm-up turn on its
`recover` action by default, with a WARNING line).  `--natgrad GAMMA`
trains q(U) by natural gradients of that size after each Adam step on the
rest (`train/natgrad.py`; a Step* arch refuses GAMMA above 0.3 without
`--natgrad_force`), `--natgrad_warmup K` ramping GAMMA over the first K
steps.  DGP is the deep TGP (`models/deep.py`): `--layers` - 1 inner
layers Dx wide with the identity mean, then the output layer, trained by
doubly-stochastic VI on `--S_train` paths and evaluated on `--S_test`;
`--dgp_flow` puts the dataset's table flow on the output layer (a deep
TGP; not the Step* archs).  It prints `DGP-L[+flow]` in the result line
and refuses the levers the JAX CLI refuses for it (--natgrad, the solve
levers, --mesh, --plateau_guard).
Defaults are the paper's: batch 10000, 15000 epochs, lr 0.01, noise 0.05,
lengthscale and output scale 2, q(U) variance 1e-5, whitened, fp64 with 100
quadrature points, S_test 100.

`--checkpoint_dir DIR` writes the trained parameters to DIR/step_<epochs>
(`train/checkpoint.py`) before the evaluation, as the JAX CLI does.
`--dataset` takes the bundled UCI tables and, when their files are under
the data root (`TGP_DATA_ROOT`), airline and year (`data/large.py`); a
dataset over 512 MB trains through the Trainer's host loop.

`--precision bf16` keeps the parameters in fp32 and gives the Gram cross
term bf16 operands (`config.py`), with the JAX CLI's warning that full-bf16
training is unstable; `--rng_impl rbg` picks the second seed derivation of
the Trainer's generator.  `--mesh DPxTY` trains on a dp x ty mesh of ranks
(`parallel/mesh.py`), one process a device, started by
`python -m torch.distributed.run --nproc_per_node DP*TY -m
tgp.pytorch_tpu_torch.experiments.main ...` (a 1x1 mesh runs in a plain
process); only rank 0 prints and writes.

It runs on the card (`--platform gpu`, the default) or, when asked, on the
CPU; without a card and without `--platform cpu` it exits non-zero.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import time

import numpy as np
import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="TGP on the GPU (PyTorch port)")
    p.add_argument("--model", required=True,
                   choices=["SVGP", "TGP", "ID_TGP", "WGP", "DGP"],
                   help="DGP is the deep TGP (--layers, --dgp_flow, "
                        "--S_train)")
    p.add_argument("--layers", type=int, default=2, help="DGP depth")
    p.add_argument("--dgp_flow", action="store_true")
    p.add_argument("--S_train", type=int, default=1)
    p.add_argument("--warp_arch", default="SAL",
                   choices=["SAL", "log_exp", "StepTanhL"],
                   help="WGP's observation warp: SAL(1), log_exp (y + K "
                        "softplus terms) or StepTanhL (K tanh steps + y, "
                        "identity-fitted)")
    p.add_argument("--warp_terms", type=int, default=3,
                   help="log_exp terms / StepTanhL steps K")
    p.add_argument("--dataset", required=True)
    p.add_argument("--train_test_seed_split", required=True, type=int)
    p.add_argument("--num_inducing", required=True, type=int)
    p.add_argument("--epochs", type=int, default=15000)
    p.add_argument("--lr", type=float, default=0.01)
    p.add_argument("--batch_size", type=int, default=10000)
    p.add_argument("--precision", default="fp64",
                   choices=["fp64", "fp32", "bf16"])
    p.add_argument("--nnet_inference", default=None,
                   choices=[None, "MC_dropout", "mean_field_gaussian"],
                   help="ID_TGP's hypernet inference (default: the table's "
                        "MC_dropout; mean_field_gaussian sets dropout to 0)")
    p.add_argument("--rng_impl", default="threefry2x32",
                   choices=["threefry2x32", "rbg"])
    p.add_argument("--platform", default="gpu", choices=["gpu", "cpu"],
                   help="gpu (the default) needs a CUDA device")
    p.add_argument("--S_test", type=int, default=100)
    p.add_argument("--verbose_each", type=int, default=100)
    p.add_argument("--checkpoint_dir", default=None)
    p.add_argument("--train_seed", type=int, default=0,
                   help="seed of the Trainer's generator (dropout masks, VI "
                        "noise, evaluation samples)")
    p.add_argument("--fast_solves", action="store_true")
    p.add_argument("--solve_precision", default="highest",
                   choices=["highest", "high", "default"])
    p.add_argument("--solve_warmup_epochs", type=int, default=0)
    p.add_argument("--plateau_guard", nargs="?", const="warn", default=None,
                   choices=["warn", "raise", "recover"])
    p.add_argument("--natgrad", type=float, default=None, metavar="GAMMA")
    p.add_argument("--natgrad_force", action="store_true")
    p.add_argument("--natgrad_warmup", type=int, default=None, metavar="K")
    p.add_argument("--mesh", default=None, metavar="DPxTY")
    return p.parse_args(argv)


def refusal(args):
    """The message for a malformed option, or None."""
    if args.mesh is not None:
        try:
            parse_mesh(args.mesh)
        except ValueError:
            return f"--mesh takes DPxTY, e.g. 4x2 (got {args.mesh!r})"
    return None


def parse_mesh(text):
    """'DPxTY' -> (dp, ty)."""
    dp, ty = (int(v) for v in text.lower().split("x"))
    return dp, ty


BF16_WARNING = (
    "WARNING: full-bf16 TRAINING is measured unstable in the JAX package "
    "(power M=100 NaNs every parameter group by epoch ~2000 on its TPU); the "
    "nan_guard will stop the run when it happens.  For a reduced-precision "
    "lever use --precision fp32 with --solve_precision high|default.")


@dataclasses.dataclass
class Run:
    """What `run` did: `metrics` is what the JAX CLI's `run` returns
    (`Trainer.compute_metrics()`); the rest is for checking and timing."""

    metrics: dict
    trainer: object
    Z0: np.ndarray
    #: the identity fit of a Step* arch, or of WGP's StepTanhL warp: (flow
    #: spec, fitted params, MSE)
    identity_fit: tuple | None
    train_s: float
    line: str
    #: Gram kernel calls while training and while evaluating ("eval"; for
    #: ID_TGP also "eval_bayes", the fully-Bayesian evaluation, and
    #: "anchor_fit"), each (forward launches, backward calls), read from
    #: `ops.rbf_gram`
    kernel_calls: dict
    #: ID_TGP's hypernet fit to the anchors: (output 0's fitted flow
    #: params, the loss of its last step), and its seconds
    anchor_fit: tuple | None = None
    anchor_fit_s: float = 0.0
    #: ID_TGP's fully-Bayesian metrics and result line
    metrics_bayes: dict | None = None
    line_bayes: str | None = None


def dgp_refusal(args):
    """The message for a lever the JAX CLI refuses with --model DGP, or
    None (JAX `experiments/main.py:155-170`)."""
    if args.natgrad:
        return ("--natgrad needs a single-layer q(U); the deep stack keeps "
                "Adam on q (train/natgrad.py guard)")
    if args.fast_solves or args.solve_precision != "highest":
        return ("--fast_solves/--solve_precision are not wired into the DGP "
                "layer specs (measured guidance covers shallow models only)")
    if args.mesh or args.plateau_guard:
        return ("--mesh/--plateau_guard are not wired into the DGP path "
                "(battery.py --model DGP --mesh shards the seed axis if that "
                "is what you need)")
    return None


def run(args) -> Run:
    msg = (dgp_refusal(args) if args.model == "DGP" else None) or refusal(args)
    if msg:
        raise SystemExit(msg)
    if args.mesh is None:
        return _run(args, None)
    from ..parallel import multihost

    dp, ty = parse_mesh(args.mesh)
    mesh = multihost.join_mesh(dp, ty, args.platform,
                               "tgp.pytorch_tpu_torch.experiments.main")
    try:
        # only rank 0 prints
        with (contextlib.redirect_stdout(io.StringIO()) if mesh.rank
              else contextlib.nullcontext()):
            print(f"==== training on a {dp}x{ty} (dp x ty) device mesh ====",
                  flush=True)
            return _run(args, mesh)
    finally:
        multihost.shutdown()


def _run(args, mesh) -> Run:
    from .. import config as cfg
    from ..data import kmeans_centers, return_dataset
    from ..flows import generators as G
    from ..flows.core import IDENTITY_SPEC, spec_from_list
    from ..flows.initializers import (fit_flow_to_identity,
                                      fit_hypernet_to_anchors)
    from ..likelihoods.gaussian import LikelihoodSpec
    from ..ops.transforms import np_inv_softplus
    from ..models import tgp as M
    from ..ops import kernels as K, rbf_gram as R
    from ..train import Trainer
    from ..train.checkpoint import save_checkpoint
    from ..weights import tree_map
    from . import flow_arch as FA
    from .exp_config import return_hyperparams

    cfg.set_precision(args.precision)
    cfg.set_rng_impl(args.rng_impl)
    if args.precision == "bf16":
        print(BF16_WARNING, flush=True)
    if mesh is not None:
        device = mesh.device
    elif args.platform == "cpu":
        device = torch.device("cpu")
    elif torch.cuda.is_available():
        device = cfg.default_device()
    else:
        raise SystemExit("no CUDA device is available; pass --platform cpu "
                         "to run on the CPU")

    # ---- data and the inducing points ------------------------------------
    loaders, dc = return_dataset(args.dataset, args.batch_size, None,
                                 seed=args.train_test_seed_split,
                                 options={"shuffle_train": True})
    Dy, Dx = dc["Dy"], dc["Dx"]
    Z0 = kmeans_centers(dc["X_tr"], args.num_inducing, n_init=10,
                        seed=cfg.config_seed)
    if args.model == "DGP":
        return run_dgp(args, loaders, dc, Z0, device)

    # ---- flow architecture -------------------------------------------------
    hp = return_hyperparams("SVGP" if args.model == "WGP" else args.model,
                            args.dataset)
    if args.nnet_inference and args.model == "ID_TGP":
        hp["flow_inference"] = args.nnet_inference
        if args.nnet_inference == "mean_field_gaussian":
            hp["flow_DR"] = 0.0             # VI nets have no dropout
    flow_spec, flow_inits, fit = IDENTITY_SPEC, None, None
    if args.model == "ID_TGP":
        flow_kwargs = dict(
            input_dependent=True, input_dim=Dx,
            num_hidden_layers=hp["flow_num_hidden_layers"],
            batch_norm=hp["flow_BN"], dropout=hp["flow_DR"],
            hidden_dim=hp["flow_hidden_dim"],
            hidden_activation=hp["flow_hidden_act"],
            inference=hp["flow_inference"])
        np.random.seed(cfg.config_seed)
        flow_spec, flow_inits = spec_from_list(G.SAL(
            hp["num_blocks"],
            **{k: v for k, v in flow_kwargs.items() if v is not None}))
    elif args.model == "TGP":
        arch, nb, ns = hp["flow_arch"], hp["num_blocks"], hp["num_steps"]
        if FA.is_step_arch(arch):
            print("==== running identity-fit flow initializer ====", flush=True)
            y = dc["Y_tr"]
            fit = fit_flow_to_identity(
                FA.make_step_gen(arch, nb, ns),
                float(y.min()) - 1.0, float(y.max()) + 1.0,
                num_restarts=1, num_epochs=2000, device=device)
            flow_spec = fit[0]
            print(f"initializer MSE {fit[2]:.3e}", flush=True)
        else:
            np.random.seed(cfg.config_seed)
            flow_spec, flow_inits = FA.build_point_flow(arch, nb)

    # ---- likelihood, kernel, model -------------------------------------------
    warp_inits = None
    if args.model == "SVGP":
        lik = LikelihoodSpec("gaussian", Dy, noise_is_shared=False)
    elif args.model == "WGP":
        np.random.seed(cfg.config_seed)
        if args.warp_arch == "SAL":
            warp_spec, _ = spec_from_list(G.SAL(1))    # identity at init
        elif args.warp_arch == "log_exp":
            # T(y) = y + sum_k a_k softplus(b_k (y + c_k)): per-term slope
            # 1/K, offsets over [-1, 1]; T^{-1} by Newton's method
            Kt = args.warp_terms
            warp_spec, warp_inits = spec_from_list([("log_exp", {
                "add_init_f0": True,
                "init_a": [float(np_inv_softplus(1.0 / Kt))] * Kt,
                "init_b": [float(np_inv_softplus(1.0))] * Kt,
                "init_c": np.linspace(-1.0, 1.0, Kt).tolist()})])
        else:
            # StepTanhL with y added (a bijection of R), fitted to the
            # identity over the targets' range
            print("==== identity-fitting the StepTanhL warp ====", flush=True)
            y = dc["Y_tr"]
            fit = fit_flow_to_identity(
                lambda: G.StepTanhL(1, args.warp_terms, add_f0=True),
                float(y.min()) - 1.0, float(y.max()) + 1.0,
                num_restarts=1, num_epochs=2000, device=device)
            warp_spec = fit[0]
            print(f"warp identity-fit MSE {fit[2]:.3e}", flush=True)
        lik = LikelihoodSpec("warped", Dy, noise_is_shared=False,
                             quad_points=cfg.quad_points, warp_flow=warp_spec)
    else:
        lik = LikelihoodSpec("gaussian_flow", Dy, noise_is_shared=False,
                             quad_points=cfg.quad_points)
    spec = M.TGPSpec(Dy=Dy, Dx=Dx, M=args.num_inducing, N=float(dc["N_tr"]),
                     kernel=K.from_name("scale_rbf"), likelihood=lik,
                     flow=flow_spec, mean="zero", whiten=True,
                     fast_solves=args.fast_solves,
                     solve_precision=args.solve_precision)
    params = M.init_tgp_params(
        spec, dc["X_tr"], Z0, variance_scale=1e-5, mean_scale=0.0,
        kernel_init={"length_scale": 2.0, "kernel_scale": 2.0},
        noise_init=0.05, flow_inits=flow_inits, warp_inits=warp_inits,
        device=device)
    if fit is not None and args.model == "WGP":
        params["likelihood"]["warp"] = fit[1]
    elif fit is not None:
        params["flow"] = tree_map(lambda x: torch.stack([x] * Dy), fit[1])

    # ---- ID_TGP: the hypernets fitted to their anchors -----------------------
    anchor_fit, anchor_s, specs = None, 0.0, None
    if args.model == "ID_TGP":
        print("==== fitting hypernets to identity anchors (2000 epochs) ====",
              flush=True)
        t0, fit_calls = time.time(), (R.LAUNCHES, R.BWD_LAUNCHES)
        batches = [b for b, _ in loaders[0]]
        fp0 = tree_map(lambda x: x[0], params["flow"])   # outputs equal at init
        anchor_fit = fit_hypernet_to_anchors(flow_spec, fp0, batches,
                                             num_epochs=2000, noise_var=0.0)
        anchor_s = time.time() - t0
        fit_calls = tuple(b - a for a, b in zip(fit_calls, (R.LAUNCHES,
                                                            R.BWD_LAUNCHES)))
        params["flow"] = tree_map(lambda x: torch.stack([x] * Dy),
                                  anchor_fit[0])
        print(f"hypernet init loss {anchor_fit[1]:.3e}", flush=True)
        specs = [[args.lr, 1e-5, "net_"], [args.lr, 0.0, "flow"]]

    # ---- train and evaluate --------------------------------------------------
    warmup, spec_final = 0, spec
    if args.solve_warmup_epochs > 0 and (
            spec.fast_solves or spec.solve_precision != "highest"):
        # the warm-up at trsm/'highest', then the requested solve mode with
        # the Adam moments carried across the swap
        warmup = min(args.solve_warmup_epochs, args.epochs)
        spec = dataclasses.replace(spec, fast_solves=False,
                                   solve_precision="highest")
    trainer = Trainer(spec, params, loaders, dc["Y_std"], S_test=args.S_test,
                      seed=args.train_seed, mesh=mesh, device=device)
    plateau_action = args.plateau_guard
    if (spec_final.fast_solves and spec_final.solve_precision != "highest"
            and warmup == 0 and not plateau_action):
        plateau_action = "recover"
        print("WARNING: --fast_solves with --solve_precision="
              f"{spec_final.solve_precision} and no --solve_warmup_epochs "
              "reproduces a measured early-plateau stall at mid M "
              "(PARITY.md).  Enabling the plateau guard (action='recover') "
              "by default; pass --solve_warmup_epochs 3000 or "
              "--plateau_guard warn to override.", flush=True)
    if plateau_action:
        trainer.plateau_guard = {"window": 2000, "min_rel_improve": 1e-4,
                                 "max_fraction": 0.5,
                                 "action": plateau_action}
    natgrad = dict(natgrad_gamma=args.natgrad,
                   natgrad_warmup=args.natgrad_warmup,
                   natgrad_force=args.natgrad_force)
    calls0 = (R.LAUNCHES, R.BWD_LAUNCHES)
    t0 = time.time()
    if warmup:
        print(f"==== solve warmup: {warmup} epochs at trsm/'highest' ====")
        trainer.train(warmup, args.lr, "adam",
                      optimisation_schedule=([1.0], [specs]),
                      verbose_each=args.verbose_each, **natgrad)
        trainer.spec = spec_final
    if args.epochs - warmup > 0:
        trainer.train(args.epochs - warmup, args.lr, "adam",
                      optimisation_schedule=([1.0], [specs]),
                      verbose_each=args.verbose_each, **natgrad)
    train_time = time.time() - t0
    calls = [(R.LAUNCHES, R.BWD_LAUNCHES)]
    if args.checkpoint_dir and (mesh is None or mesh.rank == 0):
        save_checkpoint(args.checkpoint_dir, trainer.params, step=args.epochs)
    m = trainer.compute_metrics()
    calls.append((R.LAUNCHES, R.BWD_LAUNCHES))

    test = m["test"]
    print("\n=====================================")
    print("== Results obtained after training ==")
    print("=====================================")
    tag = "POINT ESTIMATE FLOW" if args.model == "ID_TGP" else args.model
    line = (f"Dataset {args.dataset}, M {args.num_inducing}, {tag}, "
            f"Test NLL {-test['logL'][0]:.3f}, Test RMSE {test['rmse'][0]:.3f} "
            f"({train_time:.1f}s train)")
    print(line, flush=True)
    m_ba = line_ba = None
    if args.model == "ID_TGP":
        trainer.fully_bayesian = True
        m_ba = trainer.compute_metrics()
        calls.append((R.LAUNCHES, R.BWD_LAUNCHES))
        test = m_ba["test"]
        line_ba = (f"Dataset {args.dataset}, M {args.num_inducing}, "
                   f"BAYESIAN FLOW, Test NLL {-test['logL'][0]:.3f}, "
                   f"Test RMSE {test['rmse'][0]:.3f}")
        print(line_ba, flush=True)

    def diff(i):
        return tuple(b - a for a, b in zip(calls[i], calls[i + 1]))

    kernel_calls = {"train": tuple(b - a for a, b in zip(calls0, calls[0])),
                    "eval": diff(0)}
    if m_ba is not None:
        kernel_calls.update(eval_bayes=diff(1), anchor_fit=fit_calls)
    return Run(metrics=m, trainer=trainer, Z0=Z0, identity_fit=fit,
               train_s=train_time, line=line, kernel_calls=kernel_calls,
               anchor_fit=anchor_fit, anchor_fit_s=anchor_s,
               metrics_bayes=m_ba, line_bayes=line_ba)


def run_dgp(args, loaders, dc, Z0, device) -> Run:
    """The deep (T)GP protocol (JAX `experiments/main.py:136-219`):
    --layers - 1 inner SVGP layers Dx wide with the identity mean, then the
    output layer (Gaussian, or the dataset's table flow with --dgp_flow),
    the inducing locations propagated through the stack, Adam for --epochs,
    then the test metrics and the `DGP-L[+flow]` result line."""
    from .. import config as cfg
    from ..flows.core import IDENTITY_SPEC
    from ..likelihoods.gaussian import LikelihoodSpec
    from ..models import tgp as M
    from ..models.deep import DeepTGPSpec, init_deep_params, layer_spec
    from ..ops import kernels as K, rbf_gram as R
    from ..train import Trainer
    from ..train.checkpoint import save_checkpoint
    from . import flow_arch as FA

    Dy, Dx = dc["Dy"], dc["Dx"]
    kernel = K.from_name("scale_rbf")
    flow_spec, flow_inits = IDENTITY_SPEC, None
    if args.dgp_flow:
        np.random.seed(cfg.config_seed)
        arch, nb, _ = FA.resolve_tgp_arch(args.dataset)
        if FA.is_step_arch(arch):
            raise SystemExit("--dgp_flow supports the non-step table archs "
                             "(identity-fit of step warps inside a deep "
                             "stack is untested)")
        flow_spec, flow_inits = FA.build_point_flow(arch, nb)
        lik = LikelihoodSpec("gaussian_flow", Dy, noise_is_shared=False,
                             quad_points=cfg.quad_points)
    else:
        lik = LikelihoodSpec("gaussian", Dy, noise_is_shared=False)
    inner = [layer_spec(Dx, Dx, args.num_inducing, float(dc["N_tr"]), kernel,
                        whiten=True)
             for _ in range(args.layers - 1)]
    last = M.TGPSpec(Dy=Dy, Dx=Dx, M=args.num_inducing, N=float(dc["N_tr"]),
                     kernel=kernel, likelihood=lik, flow=flow_spec,
                     mean="zero", whiten=True)
    spec = DeepTGPSpec(layers=tuple(inner) + (last,), S_train=args.S_train,
                       S_test=args.S_test)
    params = init_deep_params(
        spec, dc["X_tr"], Z0, variance_scale=1e-5, mean_scale=0.0,
        kernel_init={"length_scale": 2.0, "kernel_scale": 2.0,
                     "noisy_variance": 1e-6},
        noise_init=0.05, flow_inits=flow_inits, device=device)

    trainer = Trainer(spec, params, loaders, dc["Y_std"], S_test=args.S_test,
                      seed=args.train_seed, device=device)
    calls = [(R.LAUNCHES, R.BWD_LAUNCHES)]
    t0 = time.time()
    trainer.train(args.epochs, args.lr, "adam", verbose_each=args.verbose_each)
    train_time = time.time() - t0
    calls.append((R.LAUNCHES, R.BWD_LAUNCHES))
    if args.checkpoint_dir:
        save_checkpoint(args.checkpoint_dir, trainer.params, step=args.epochs)
    m = trainer.compute_metrics()
    calls.append((R.LAUNCHES, R.BWD_LAUNCHES))
    test = m["test"]
    print("\n=====================================")
    print("== Results obtained after training ==")
    print("=====================================")
    tag = f"DGP-{args.layers}" + ("+flow" if args.dgp_flow else "")
    line = (f"Dataset {args.dataset}, M {args.num_inducing}, {tag}, "
            f"Test NLL {-test['logL'][0]:.3f}, Test RMSE {test['rmse'][0]:.3f} "
            f"({train_time:.1f}s train)")
    print(line, flush=True)
    kernel_calls = {k: tuple(b - a for a, b in zip(calls[i], calls[i + 1]))
                    for i, k in enumerate(("train", "eval"))}
    return Run(metrics=m, trainer=trainer, Z0=Z0, identity_fit=None,
               train_s=train_time, line=line, kernel_calls=kernel_calls)


if __name__ == "__main__":
    run(parse_args())
