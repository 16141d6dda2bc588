"""Training loop and evaluation metrics: the torch counterpart of the JAX
package's `train/trainer.py`.

  * A step is eager: the ELBO (one launch of the Gram kernel), its gradient
    by autograd (one call of the Gram's backward kernel), then the grouped
    optimizer applied in place.  Nothing in a step reads a value back to the
    host: the ELBO, ELL and KL of each step stay on the device and a chunk
    of steps fetches them with one copy.
  * Full batch (the training loader yields one batch): the batch goes to the
    device once per phase, and steps run in chunks of
    min(phase epochs, 2000, validate_each), the JAX package's scan chunks.
  * Minibatch: the dataset (up to 512 MB) goes to the device once; each
    epoch draws the loader's permutation, runs the full batches, then the
    remainder batch.  `loss_curve` gets one entry per epoch, the last full
    batch's.
  * The host loop (a dataset over `DEVICE_RESIDENT_BYTES`, or a `track_fn`):
    the loader's batches, the same rows in the same order as the minibatch
    path's, are copied to the device one at a time (a plain synchronous
    copy) and each takes one step; the curves get one entry per step, and
    `track_fn(self)` runs after every step.  The rows stay on the device
    until the curves are read (by the 50-epoch checks, or by `track_fn`).
  * Multi-phase schedules (percentages of the epochs, each with [lr(, wd),
    name] groups); the Adam family's moments carry across phases and train()
    calls while the kind is unchanged.
  * Input-dependent flows: every step's dropout masks or VI noise come from
    the Trainer's one device `torch.Generator`; after training, hypernet
    batch-norm statistics are recalibrated on the training inputs.
    `fully_bayesian` evaluates with S_MC = S_test hypernet draws.
  * Classification (Bernoulli and categorical likelihoods): labels are the
    Y column; evaluation reports logL, accuracy and the calibration
    measures (ECE, MCE, Brier, NLL) instead of rmse and coverage.
  * The plateau guard (`plateau_guard`): at chunk boundaries (full batch)
    or every 50 epochs (minibatch), on the curve already copied there, it
    compares the mean ELBO of the last two windows; its `recover` action
    swaps `self.spec` to trsm/'highest' solves in place, with the
    optimizer's moments and the generator carried across.  A step reads
    `self.spec` afresh, so a spec swapped between `train` calls (the CLI's
    solve warm-up) keeps the optimizer state too.

  * Natural gradients (`natgrad_gamma`, `train/natgrad.py`): q_mu and q_L
    leave the optimizer; each step's one backward also gives dELBO/d(m, S),
    and a natural-gradient step on q(U) follows the optimizer's.  Its
    halving test reads one boolean back per step.  `natgrad_warmup` ramps
    gamma over the first K natgrad steps; the step counter carries across
    train() calls while natgrad stays on.
  * A deep TGP (`models.deep.DeepTGPSpec`, params {"layers": [...]}) trains
    and evaluates through the same paths: a step is one launch of the Gram
    kernel's forward and one backward call a layer, an evaluation batch one
    launch a layer (the log-likelihood, the moments and the samples share
    one propagation of the inputs).

  * L-BFGS (`opt="lbfgs"`, `train/lbfgs.py`): full batch only, no
    schedules, no natgrad; an iteration is one value-and-gradient and one
    per line-search trial, each one launch of the Gram kernel's forward and
    one backward call a rbf leaf, with the generator restarted at the
    phase's state for each (one fixed draw a phase).  The line search reads
    two scalars back at its start and each trial.
  * Checkpoints (`save`, `restore`, `train/checkpoint.py`): a restored
    Trainer continues the run bit for bit.  `eval_device = "cpu"` computes
    the metrics on the host CPU, with the draws still from the generator.

  * Meshes (`mesh=`, `parallel/mesh.py`): one rank a device, each with the
    whole parameter tree and the whole batch; a step's Grams, solves and
    KL run on the rank's (rows, outputs) block, the likelihood on the
    gathered marginals, and the GP leaves' gradients are summed over the
    split axes (`parallel.mesh.value_and_grad`), so every rank holds the
    same parameters after each step, on every path (full batch, minibatch,
    the host loop, natgrad, L-BFGS).  `compute_metrics` evaluates each
    rank's slice of every batch's rows with draws folded by the rank, and
    sums float64 accumulators over the ranks; rank 0 writes a checkpoint,
    and every rank restores it.
  * The generator's stream follows `config.rng_impl` (`config.make_rng`);
    a checkpoint records it, and `restore` takes it from there.
"""

from __future__ import annotations

import dataclasses
import functools
import os
import time

import numpy as np
import torch

from .. import config as cfg
from ..flows.hypernet import DeviceDraws
from ..models import deep, tgp as tgp_mod
from ..models.tgp import TGPSpec
from ..parallel import mesh as mesh_mod, multihost
from ..weights import tree_leaves, tree_map, tree_unflatten
from . import group_adam as GA, lbfgs as LB
from .checkpoint import load_checkpoint, save_checkpoint, to_device
from .metrics import (calibration_accumulators,
                      calibration_from_accumulators, calibration_measures,
                      inside_95)
from .natgrad import gamma_at, guard_step_arch, natgrad_train_step
from .optimizers import build_grouped_optimizer, lbfgs_optimizer, param_paths


def frozen_param_labels(spec: TGPSpec, params):
    """Bool tree marking leaves excluded from optimisation: the identity-mean
    projection W, hypernet batch-norm statistics, and the anchor scalars
    (a, b, c, d) of a step that owns a hypernet."""
    paths = param_paths(params)
    hyper_prefixes = {p.split("/net_")[0] for p in tree_leaves(paths)
                      if "/net_" in p}

    def is_frozen(path):
        if path.endswith("mean/W"):
            return True
        if path.endswith("/bn/mean") or path.endswith("/bn/var"):
            return True
        return any(path.startswith(pre + "/")
                   and path[len(pre) + 1:] in ("a", "b", "c", "d")
                   for pre in hyper_prefixes)

    return tree_map(is_frozen, paths)


def _global_norm(grads):
    return torch.sqrt(sum(torch.sum(torch.square(g)) for g in grads))


class Trainer:
    """Owns the optimisation loop for one TGP model.

    Args:
      spec, params: the model; params (the port's tree of tensors) are copied
        to `device` in the configured precision as leaves that require grad.
      data_loaders: [train(, valid), test] (`data.DataLoader`s).
      Y_std: (Dy,) de-normalisation of the regressed variable.
      S_test: predictive samples per row for the coverage metric.
      validate_each: epochs between evaluations during training.
      seed: seed of the Trainer's `torch.Generator` (on `device`), which
        every training step's hypernet draws and the evaluation's samples
        come from.
      track_fn: called as track_fn(trainer) after every training step; a
        Trainer with one trains through the host loop.  Reading the curves
        there copies the steps' rows to the host.
      mesh: a `parallel.mesh.Mesh`; every rank builds its Trainer with the
        same arguments, and rank 0's parameters are broadcast to the others.
      device: where training runs; None means the card (raises without
        one), or the mesh's device.
    """

    #: datasets up to this many bytes are kept on the device for minibatch
    #: training; larger ones train through the host loop
    DEVICE_RESIDENT_BYTES = 1 << 29

    def __init__(self, spec: TGPSpec, params, data_loaders, Y_std,
                 S_test: int = 100, validate_each: int = 10 ** 18,
                 seed: int = 0, track_fn=None, mesh=None, device=None):
        tgp_mod.check_spec(spec)
        self.spec = spec
        self.mesh = mesh
        if mesh is not None:
            if device is not None and torch.device(device) != mesh.device:
                raise ValueError(f"device {device} is not the mesh's "
                                 f"{mesh.device}")
            device = mesh.device
        self.device = cfg.resolve_device(device)
        self.dtype = cfg.default_dtype()
        self.params = tree_map(
            lambda t: t.detach().to(self.device, self.dtype, copy=True)
            .requires_grad_(True), params)
        #: the leaves whose gradients a mesh sums (`parallel.mesh.gp_leaves`)
        self._gp_flags = tree_leaves(mesh_mod.gp_leaves(self.params))
        if mesh is not None and mesh.world > 1:
            with torch.no_grad():
                for t in tree_leaves(self.params):
                    t.copy_(multihost.replicate_global(mesh, t.detach()))
        self.train_loader = data_loaders[0]
        self.valid_loader = data_loaders[1] if len(data_loaders) == 3 else None
        self.test_loader = data_loaders[-1] if len(data_loaders) >= 2 else None
        self.Y_std = np.asarray(Y_std, dtype=np.float64).reshape(-1)
        self._Y_std_dev = self._put(self.Y_std)
        self.S_test = S_test
        self.validate_each = validate_each
        self.track_fn = track_fn
        self._gen = cfg.make_rng(seed, self.device)
        #: the stream's implementation (`config.rng_impl` at construction,
        #: or the restored checkpoint's)
        self.rng_impl = cfg.rng_impl
        # ELBO, ELL and KL per step (full batch, the host loop) or per epoch
        # (minibatch), on the host; `_pending` holds (elbo, ell, kld) rows
        # still on the device, appended when a curve is read
        self._curves = ([], [], [])
        self._pending = []
        #: evaluate with S_MC = S_test hypernet draws (MC-dropout or VI
        #: posterior of the flow) instead of the point-estimate flow
        self.fully_bayesian = False
        #: "cpu" computes `compute_metrics` on the host CPU (the reference's
        #: inference_in_cpu, for an S_test that does not fit the card);
        #: None evaluates on `device`
        self.eval_device = None
        #: raise FloatingPointError, naming the non-finite parameters, when
        #: the ELBO goes non-finite (checked per chunk, or every 50 epochs)
        self.nan_guard = True
        #: the early-stall detector, off by default; a dict turns it on:
        #:   {"window": 2000,            # steps per compared window
        #:    "min_rel_improve": 1e-4,   # least relative mean-ELBO gain
        #:    "max_fraction": 0.5,       # checked only this far into train()
        #:    "action": "warn"}          # or "raise" / "recover"
        #: Each firing appends to `plateau_events`.  "recover", on a spec
        #: with fast_solves or a reduced solve_precision, swaps the spec to
        #: trsm/'highest' and goes on; on an all-'highest' spec it warns.
        self.plateau_guard = None
        self.plateau_events = []
        self._recover_pending = False
        self._opt_state_carry = None
        self._opt_state_kind = None
        self._natgrad_gamma = None
        self._natgrad_warmup = None
        self._ng_t = 0          # natgrad steps taken under the warmup ramp

    @property
    def loss_curve(self):
        self._flush()
        return self._curves[0]

    @property
    def ell_curve(self):
        self._flush()
        return self._curves[1]

    @property
    def kld_curve(self):
        self._flush()
        return self._curves[2]

    def _flush(self):
        """Append the pending rows to the curves with one copy."""
        if self._pending:
            rows, self._pending = self._pending, []
            curves = torch.stack(rows).cpu().numpy()
            for curve, col in zip(self._curves, curves.T):
                curve.extend(col)

    # ------------------------------------------------------------------
    def _put(self, a, device=None):
        # numpy's own dtype first, then a cast: `as_tensor(..., dtype=)`
        # converts a float64 array to float32 element by element,
        # milliseconds for one batch of the host loop
        return torch.as_tensor(np.asarray(a)).to(self.dtype).to(
            self.device if device is None else device)

    def _check_finite(self, where: str):
        if not self.nan_guard or not self.loss_curve:
            return
        if np.isfinite(float(self.loss_curve[-1])):
            return
        bad = [path for path, leaf in zip(tree_leaves(param_paths(self.params)),
                                          tree_leaves(self.params))
               if not bool(torch.isfinite(leaf).all())]
        raise FloatingPointError(
            f"non-finite ELBO at {where}; non-finite parameters: {bad or 'none'}"
            f" — consider fp64 precision, a larger Cholesky jitter, or a "
            f"smaller learning rate")

    def _check_plateau(self, ep_done: int, total_epochs: int):
        """The plateau guard's check on the recorded ELBO curve (the JAX
        Trainer's rule and messages)."""
        g = self.plateau_guard
        if not g:
            return
        w = int(g.get("window", 2000))
        if len(self.loss_curve) < 2 * w:
            return
        rec_at = g.get("_recovered_at")
        if rec_at is not None and len(self.loss_curve) < rec_at + 2 * w:
            return          # two fresh windows after a swap before judging
        if ep_done > g.get("max_fraction", 0.5) * total_epochs:
            return
        recent = float(np.mean(np.asarray(self.loss_curve[-w:], np.float64)))
        prev = float(np.mean(np.asarray(self.loss_curve[-2 * w:-w],
                                        np.float64)))
        rel = (recent - prev) / (abs(prev) + 1e-12)
        if rel >= g.get("min_rel_improve", 1e-4):
            return
        event = {"step": len(self.loss_curve), "epoch": ep_done,
                 "rel_improve": rel, "window": w,
                 "elbo_recent": recent, "elbo_prev": prev}
        self.plateau_events.append(event)
        msg = (f"ELBO plateau at epoch {ep_done}/{total_epochs}: mean over "
               f"the last {w} recorded steps improved by {rel:.2e} rel "
               f"(< {g.get('min_rel_improve', 1e-4):.0e}) while only "
               f"{100 * ep_done / total_epochs:.0f}% through training — "
               f"suspicious early stall; try another training rng, "
               f"solve_precision='highest', or --solve_warmup_epochs")
        action = g.get("action", "warn")
        if action == "recover" and (self.spec.fast_solves or
                                    self.spec.solve_precision != "highest"):
            event["action"] = "recover"
            g["_recovered_at"] = len(self.loss_curve)
            self._recover_pending = True
            print(f"RECOVERING: {msg}", flush=True)
            return
        if action == "raise":
            raise RuntimeError(msg)
        print(f"WARNING: {msg}", flush=True)

    def _maybe_recover_spec(self) -> bool:
        """Consume a pending recovery: swap the spec to trsm/'highest' in
        place.  The optimizer state and the generator are untouched, and
        the next step reads the new spec."""
        if not self._recover_pending:
            return False
        self._recover_pending = False
        self.spec = dataclasses.replace(self.spec, fast_solves=False,
                                        solve_precision="highest")
        print("plateau recovery: solves switched to trsm/'highest' with "
              "optimizer moments carried", flush=True)
        return True

    def _value_and_grad(self, params, X, Y, wrt, extra_gp=0):
        """(elbo, ell, kld, grads): the ELBO of params (a tree whose leaves
        are `wrt`, then `extra_gp` GP tensors) and its gradient; on a mesh,
        the rank's block with the gradients summed over its split axes."""
        return mesh_mod.value_and_grad(self.spec, params, X, Y, self._gen,
                                       self.mesh, wrt,
                                       self._gp_flags + [True] * extra_gp)

    def _step(self, step, X, Y):
        """One optimisation step; returns (elbo, ell, kld) on the device."""
        if self._natgrad_gamma is not None:
            g = None
            if self._natgrad_warmup:
                g = float(gamma_at(self._natgrad_gamma, self._natgrad_warmup,
                                   self._ng_t))
                self._ng_t += 1
            out = natgrad_train_step(
                self.spec, step, self._natgrad_gamma,
                lambda p, X, Y, wrt: self._value_and_grad(p, X, Y, wrt,
                                                          extra_gp=2))(
                self.params, X, Y, g)
            return torch.stack(out)
        e, ell, kld, grads = self._value_and_grad(self.params, X, Y,
                                                  tree_leaves(self.params))
        step(grads)
        return torch.stack([e, ell, kld])

    def _record(self, rows):
        """Append the (elbo, ell, kld) rows of a chunk with one copy."""
        self._pending.extend(rows)
        self._flush()

    # ------------------------------------------------------------------
    def train(self, epochs: int, lr_ALL: float, opt: str = "adam",
              optimisation_schedule=None, verbose_each: int = 100,
              clip_norm: float | None = None,
              natgrad_gamma: float | None = None,
              natgrad_warmup: int | None = None,
              natgrad_force: bool = False):
        """Run the optimisation loop.

        optimisation_schedule = (percentages, specifications): percentages of
        `epochs` per phase; each phase's specification is a list of
        [lr(, wd), name] entries (None = all parameters at lr_ALL).
        clip_norm scales the gradients by min(1, clip_norm / (|g| + 1e-12))
        (the global norm over every leaf) before the Adam family's step; for
        'sgd' it is optax's clip_by_global_norm.

        natgrad_gamma > 0 trains q(U) by natural gradients of that size
        (`train/natgrad.py`; a single-layer model only); natgrad_warmup K
        ramps it as gamma * min(1, (t+1)/K) over the natgrad steps t, t
        carried across train() calls and reset by a call without
        natgrad_gamma.  A gamma above 0.3 with a Step* flow is refused
        unless natgrad_force (`natgrad.guard_step_arch`).
        """
        if optimisation_schedule is None:
            optimisation_schedule = ([1.0], [None])
        percentages, specifications = optimisation_schedule
        if abs(sum(percentages) - 1.0) > 1e-9:
            raise ValueError(f"schedule percentages must sum to 1, got {sum(percentages)}")

        frozen = frozen_param_labels(self.spec, self.params)
        if natgrad_warmup is not None and natgrad_gamma is None:
            raise ValueError("natgrad_warmup needs natgrad_gamma")
        if natgrad_warmup is not None and int(natgrad_warmup) < 1:
            raise ValueError(
                f"natgrad_warmup must be >= 1 (got {natgrad_warmup})")
        if natgrad_gamma is None:
            self._ng_t = 0
        else:
            if natgrad_gamma <= 0.0:
                raise ValueError(
                    f"natgrad_gamma must be > 0 (got {natgrad_gamma}); "
                    "gamma=0 would freeze q(U) out of BOTH optimizers — "
                    "pass None to train q(U) with the gradient optimizer")
            if opt == "lbfgs":
                raise NotImplementedError(
                    "natgrad_gamma is not supported with lbfgs (two solvers "
                    "fighting over one objective)")
            if "q_mu" not in self.params:
                raise NotImplementedError(
                    "natgrad_gamma needs a single-layer q(U) at "
                    "params['q_mu'/'q_L']; deep stacks keep Adam on q")
            guard_step_arch(self.spec, natgrad_gamma, force=natgrad_force)
            # q(U) leaves the gradient optimizer: the natural-gradient step
            # after each of its steps updates it
            paths = param_paths(self.params)
            frozen = tree_unflatten(paths, [
                bool(f) or p.endswith("q_mu") or p.endswith("q_L")
                for f, p in zip(tree_leaves(frozen), tree_leaves(paths))])
        self._natgrad_gamma = natgrad_gamma
        self._natgrad_warmup = (int(natgrad_warmup)
                                if natgrad_warmup is not None else None)
        ep_done = 0
        ve = self.validate_each if self.validate_each else 10 ** 18
        full_batch = len(self.train_loader) == 1 and self.track_fn is None
        ds = self.train_loader.dataset
        host_loop = (self.track_fn is not None or ds.X.nbytes + ds.Y.nbytes
                     > self.DEVICE_RESIDENT_BYTES)
        for per, specs in zip(percentages, specifications):
            phase_epochs = int(epochs * per)
            if opt == "lbfgs":
                # a full solver with its own line search: full batch only,
                # no parameter groups
                if specs is not None:
                    raise NotImplementedError(
                        "lbfgs does not support optimisation schedules")
                if not full_batch:
                    raise NotImplementedError(
                        "lbfgs requires the full-batch path (one batch, no "
                        "track_fn) — its linesearch needs a deterministic "
                        "objective")
                step = self._lbfgs_phase(frozen)
            else:
                step = functools.partial(
                    self._step, self._build_phase_optimizer(
                        specs, lr_ALL, opt, frozen, clip_norm))
            run = (self._run_full_batch if full_batch else
                   self._run_host_loop if host_loop else self._run_minibatch)
            ep_done = run(step, phase_epochs, epochs, ep_done, ve, verbose_each)
        if self.spec.has_bn_flow:
            # the hypernets' batch-norm statistics for evaluation, from the
            # training inputs; written into the leaves the optimizer holds
            new = tgp_mod.finalize_batch_norm(self.spec, self.params,
                                              self.train_loader.dataset.X)
            with torch.no_grad():
                for old, t in zip(tree_leaves(self.params), tree_leaves(new)):
                    if t is not old:
                        old.copy_(t)
        return self

    def _run_full_batch(self, step, phase_epochs, epochs, ep_done, ve,
                        verbose_each):
        """Runs `step(X, Y) -> (elbo, ell, kld)` phase_epochs times."""
        X, Y = next(iter(self.train_loader))
        Xd, Yd = self._put(X), self._put(Y)
        # chunk boundaries align to validate_each, as evaluation stops a chunk
        chunk = int(min(phase_epochs, 2000, ve))
        done = 0
        t0 = time.time()
        while done < phase_epochs:
            n = min(chunk, phase_epochs - done,
                    ve - (ep_done % ve) if ve <= epochs else chunk)
            self._record([step(Xd, Yd) for _ in range(n)])
            prev_ep = ep_done
            done += n
            ep_done += n
            self._check_finite(f"epoch {ep_done}")
            self._check_plateau(ep_done, epochs)
            self._maybe_recover_spec()
            if verbose_each:
                base = len(self.loss_curve) - ep_done
                m = (prev_ep // verbose_each + 1) * verbose_each
                while m <= ep_done:
                    print(f"| epoch {m}/{epochs}  ELBO "
                          f"{float(self.loss_curve[base + m - 1]):.4f} "
                          f"({(time.time() - t0) / done * 1e3:.2f}ms/ep)")
                    m += verbose_each
            if ve <= epochs and ep_done % ve == 0:
                print(f"|   eval @ {ep_done}: {self.compute_metrics()}")
        return ep_done

    def _run_minibatch(self, step, phase_epochs, epochs, ep_done, ve,
                       verbose_each):
        ds = self.train_loader.dataset
        MB = self.train_loader.batch_size
        Xd, Yd = self._put(ds.X), self._put(ds.Y)
        n = ds.X.shape[0]
        n_batches, rem = divmod(n, MB)
        t0 = time.time()
        pending = []        # each epoch's last full-batch row, on the device
        for ep in range(phase_epochs):
            perm = (self.train_loader._rng.permutation(n)
                    if self.train_loader.shuffle else np.arange(n))
            perm = torch.from_numpy(perm).to(self.device)
            for b in range(n_batches):
                ids = perm[b * MB:(b + 1) * MB]
                last = step(Xd[ids], Yd[ids])
            if rem:
                # the remainder batch (the reference's drop_last=False)
                ids = perm[n - rem:]
                step(Xd[ids], Yd[ids])
            pending.append(last)
            ep_done += 1
            check = ep_done % 50 == 0
            show = bool(verbose_each) and ep_done % verbose_each == 0
            evaluate = ve <= epochs and ep_done % ve == 0
            if check or show or evaluate or ep == phase_epochs - 1:
                self._record(pending)
                pending = []
            if check:
                self._check_finite(f"epoch {ep_done}")
                self._check_plateau(ep_done, epochs)
                self._maybe_recover_spec()
            if show:
                print(f"| epoch {ep_done}/{epochs}  "
                      f"ELBO {float(self.loss_curve[-1]):.4f} "
                      f"({(time.time() - t0) / (ep + 1) * 1e3:.2f}ms/ep)")
            if evaluate:
                print(f"|   eval @ {ep_done}: {self.compute_metrics()}")
        return ep_done

    def _run_host_loop(self, step, phase_epochs, epochs, ep_done, ve,
                       verbose_each):
        """The JAX Trainer's host loop: each of the loader's batches is
        copied to the device and takes one step, then `track_fn(self)`.
        The finite, plateau, verbose and evaluation checks run at the JAX
        loop's epochs (evaluation every `validate_each` epochs)."""
        t0 = time.time()
        for ep in range(phase_epochs):
            for X, Y in self.train_loader:
                self._pending.append(step(self._put(X), self._put(Y)))
                if self.track_fn is not None:
                    self.track_fn(self)
            ep_done += 1
            if ep_done % 50 == 0:
                self._flush()
                self._check_finite(f"epoch {ep_done}")
                self._check_plateau(ep_done, epochs)
                self._maybe_recover_spec()
            if verbose_each and ep_done % verbose_each == 0:
                e, ell, kld = (float(c[-1]) for c in (
                    self.loss_curve, self.ell_curve, self.kld_curve))
                print(f"| epoch {ep_done}/{epochs}  ELBO {e:.4f} ELL "
                      f"{ell:.4f} KLD {kld:.4f} "
                      f"({(time.time() - t0) / max(ep, 1):.3f}s/ep)")
            if self.validate_each and ep_done % self.validate_each == 0:
                print(f"|   eval @ {ep_done}: {self.compute_metrics()}")
        self._flush()
        return ep_done

    def _lbfgs_phase(self, frozen):
        """The L-BFGS phase's iteration, `step(X, Y) -> (elbo, ell, kld)`
        at the iteration's start (JAX `Trainer._make_lbfgs_scan`).

        The objective must be one function for the line search: every
        evaluation of the phase (an iteration's start and each trial)
        restarts the Trainer's generator from its state at the phase's
        start, so a stochastic model draws the same masks at each, and the
        stream ends one evaluation's draws on, as JAX's one key a phase
        leaves it.  Frozen leaves get zero gradients, so the directions never
        move them.  The solver's state carries across chunks and starts
        afresh each phase; a spec swapped by the plateau guard's recovery is
        read at the next evaluation."""
        opt = lbfgs_optimizer()
        leaves = tree_leaves(self.params)
        keep = [not f for f in tree_leaves(frozen)]
        gen_state = self._gen.get_state()
        self._opt_state_kind = "lbfgs"
        self._opt_state_carry = opt.init(LB.flatten(leaves))

        def objective(pp, X, Y):
            self._gen.set_state(gen_state)
            return self._value_and_grad(tree_unflatten(self.params, pp), X,
                                        Y, pp)

        def step(X, Y):
            def value_and_grad(flat):
                pp = [t.detach().requires_grad_(True)
                      for t in LB.unflatten(flat, leaves)]
                e, _, _, grads = objective(pp, X, Y)
                return -e, LB.flatten(grads)

            e, ell, kld, grads = objective(leaves, X, Y)
            g = LB.flatten([gg if k else torch.zeros_like(gg)
                            for gg, k in zip(grads, keep)])
            updates, self._opt_state_carry = opt.update(
                g, self._opt_state_carry, LB.flatten(leaves), value=-e,
                grad=g, value_and_grad_fn=value_and_grad)
            with torch.no_grad():
                for p, u in zip(leaves, LB.unflatten(updates, leaves)):
                    p.add_(u)
            return torch.stack([e, ell, kld])

        return step

    def _build_phase_optimizer(self, specs, lr_ALL, opt, frozen,
                               clip_norm=None):
        """The phase's step: a function of the gradients (a list in
        `tree_leaves` order) that updates the parameters in place.

        The Adam family keeps its state across phases and train() calls
        while the kind is unchanged (a parameter first activated in a later
        phase starts with fresh moments); another kind starts afresh.  'sgd'
        is stateless.
        """
        leaves = tree_leaves(self.params)
        if opt in GA.KINDS:
            lr_t, wd_t, act_t = (tree_leaves(t) for t in GA.annotations_from_specs(
                self.params, specs, lr_ALL, frozen_labels=frozen,
                # the reference runs torch.optim.AdamW with its defaults, so
                # wd=0.01 applies to every group that does not set it
                default_wd=0.01 if opt == "adam_W" else 0.0))
            if not (isinstance(self._opt_state_carry, GA.GroupAdamState)
                    and self._opt_state_kind == opt):
                self._opt_state_carry = GA.init_state(self.params)
            self._opt_state_kind = opt
            state = self._opt_state_carry

            def step(grads):
                if clip_norm is not None:
                    scale = torch.clamp(clip_norm / (_global_norm(grads) + 1e-12),
                                        max=1.0)
                    grads = [g * scale for g in grads]
                GA.update(grads, state, leaves, lr_t, wd_t, act_t, kind=opt)

            return step

        self._opt_state_kind = opt
        self._opt_state_carry = None
        update, _ = build_grouped_optimizer(self.params, specs, lr_ALL, opt,
                                            frozen_labels=frozen)

        def step(grads):
            if clip_norm is not None:
                gnorm = _global_norm(grads)
                grads = [torch.where(gnorm < clip_norm, g, g / gnorm * clip_norm)
                         for g in grads]
            with torch.no_grad():
                for p, u in zip(leaves, tree_leaves(update(grads, leaves))):
                    p.add_(u)

        return step

    # ------------------------------------------------------------------
    # Checkpoints
    # ------------------------------------------------------------------
    def save(self, path: str, step: int | None = None,
             async_save: bool = False):
        """Checkpoint the whole training state to `<path>/step_<step>`
        (default: the length of the ELBO curve): the parameters, the carried
        optimizer state and its kind, the generator's state and the kind of
        device it lives on, the training loader's shuffle stream,
        `fully_bayesian`, natgrad's warmup position and the stream's
        implementation; enough for `restore` to continue a run bit for bit.
        On a mesh rank 0 writes the whole tree (every rank holds it) and
        every rank waits for the file; the write is then synchronous."""
        extra = {"generator": self._gen.get_state(),
                 "generator_device": self.device.type,
                 "rng_impl": self.rng_impl,
                 "fully_bayesian": bool(self.fully_bayesian),
                 # a fresh loader would replay the first epoch's permutation
                 "loader_state": self.train_loader._rng.bit_generator.state,
                 "ng_t": int(self._ng_t),
                 "opt_kind": self._opt_state_kind}
        step = len(self.loss_curve) if step is None else step
        if self.mesh is None:
            return save_checkpoint(path, self.params, step=step,
                                   opt_state=self._opt_state_carry,
                                   extra=extra, async_save=async_save)
        final = None
        if self.mesh.rank == 0:
            final = save_checkpoint(path, self.params, step=step,
                                    opt_state=self._opt_state_carry,
                                    extra=extra)
        if self.mesh.world > 1:
            torch.distributed.barrier()
        return final or os.path.join(os.path.abspath(path), f"step_{step}")

    def restore(self, path: str, step: int | None = None):
        """Load a checkpoint written by `save` into this Trainer, every
        tensor on its device; returns the checkpoint's step.  A generator's
        state goes only into a generator on the same kind of device, so a
        checkpoint from another kind raises ValueError."""
        params, opt_state, step, extra = load_checkpoint(path, step)
        kind = extra["generator_device"]
        if kind != self.device.type:
            raise ValueError(
                f"the checkpoint's generator state comes from a {kind} "
                f"generator and cannot seed this Trainer's "
                f"{self.device.type} generator; restore it into a Trainer "
                f"on {kind}")
        self.params = to_device(params, self.device, self.dtype)
        for t in tree_leaves(self.params):
            t.requires_grad_(True)
        self._opt_state_carry = to_device(opt_state, self.device)
        self._opt_state_kind = extra["opt_kind"]
        self._gen.set_state(extra["generator"])
        self.rng_impl = extra.get("rng_impl", "threefry2x32")
        self.fully_bayesian = extra["fully_bayesian"]
        self.train_loader._rng.bit_generator.state = extra["loader_state"]
        self._ng_t = extra["ng_t"]
        return step

    # ------------------------------------------------------------------
    # Evaluation
    # ------------------------------------------------------------------
    @torch.no_grad()
    def _eval_batch(self, X, Y, ev=None):
        """(log p(Y|X) (Dy,), predictive mean (Dy, MB), whether each Y lies
        inside its 95% band of S_test predictive samples (Dy, MB)).  Two
        `marginal_qf` calls: the log-likelihood's and the one that the
        moments and the samples share.  `ev` is `_evaluation()`'s (by
        default, this call's).

        Classification: (log p(Y|X) (1,), class probabilities (MB, C), None),
        with the same two calls; one predictive sample is drawn, as the JAX
        Trainer draws it (JAX `train/trainer.py:888-895`), and not read.

        A deep TGP propagates the inputs once, along max(spec.S_test,
        S_test) paths (one `marginal_qf` a layer), and the log-likelihood,
        the moments (spec.S_test paths each) and the S_test samples share
        them."""
        ev = ev or self._evaluation()
        spec, params, rng = self.spec, ev["params"], ev["rng"]
        is_class = spec.likelihood.is_classification
        fb = dict(S_MC=self.S_test if self.fully_bayesian else 1,
                  fully_bayesian=self.fully_bayesian, rng=rng)
        if deep.is_deep(spec):
            X_in = X
            qf = deep.propagate(spec, params, X, rng,
                                max(spec.S_test, self.S_test))
            log_p = tgp_mod.test_log_likelihood(
                spec, params, X, Y, ev["Y_std"], qf=qf, **fb)
        else:
            log_p = tgp_mod.test_log_likelihood(
                spec, params, X, Y, ev["Y_std"], **fb)
            X_in = tgp_mod._ensure_3d(spec, X)
            qf = tgp_mod.marginal_qf(spec, params, X_in)
        m1 = tgp_mod.predictive_distribution(spec, params, X_in, qf=qf, **fb)[0]
        samples = tgp_mod.sample_predictive(
            spec, params, X_in, 1 if is_class else self.S_test, rng,
            self.fully_bayesian, qf=qf)[0]
        if is_class:
            return log_p, m1, None
        return log_p, m1, inside_95(samples, Y.T, dim=1)

    def _evaluation(self):
        """Where evaluation runs: the Trainer's device, or the host CPU when
        `eval_device == "cpu"`, with the parameters copied there and the
        draws still from the Trainer's generator on its device
        (`hypernet.DeviceDraws`)."""
        if self.eval_device not in (None, "cpu"):
            raise ValueError(f"eval_device must be None or 'cpu', got "
                             f"{self.eval_device!r}")
        if self.eval_device is None or self.device.type == "cpu":
            return {"device": self.device, "params": self.params,
                    "rng": self._gen, "Y_std": self._Y_std_dev}
        cpu = torch.device("cpu")
        return {"device": cpu, "params": to_device(self.params, cpu),
                "rng": DeviceDraws(self._gen),
                "Y_std": self._Y_std_dev.to(cpu)}

    def _batches(self, loader, ev):
        """(X, Y, ev) of each batch of `loader` that this rank evaluates:
        every batch on one rank; on a mesh of ranks the rank's slice of every
        batch's rows (`np.array_split` over the ranks), with its draws from
        a generator seeded by one draw of the Trainer's generator, in
        lockstep on every rank, folded with the rank (the JAX package's
        `fold_in(rng, process)`)."""
        for X, Y in loader:
            if not multihost.is_multihost(self.mesh):
                yield X, Y, ev
                continue
            gen = self._gen
            s = int(torch.randint(0, 2 ** 62, (1,), generator=gen,
                                  device=gen.device))
            rows = np.array_split(np.arange(np.shape(X)[0]),
                                  self.mesh.world)[self.mesh.rank]
            if rows.size == 0:
                continue
            g = torch.Generator(device=gen.device).manual_seed(
                cfg.stream_seed(s * self.mesh.world + self.mesh.rank, "rbg"))
            yield (np.asarray(X)[rows], np.asarray(Y)[rows],
                   dict(ev, rng=g if isinstance(ev["rng"], torch.Generator)
                        else DeviceDraws(g)))

    def _class_metrics_for_loader(self, loader, ev):
        """logL (1,), accuracy and calibration over a loader (JAX
        `train/trainer.py:911-967`); on a mesh, float64 sums over the
        ranks."""
        ElogL, correct, tot = np.zeros(1), 0.0, 0
        all_probs, all_labels = [], []
        for X, Y, ev_b in self._batches(loader, ev):
            log_p, probs, _ = self._eval_batch(self._put(X, ev["device"]),
                                               self._put(Y, ev["device"]),
                                               ev_b)
            probs = probs.cpu().numpy()
            labels = np.asarray(Y).reshape(-1)
            ElogL[0] += log_p.cpu().numpy().sum()
            correct += (np.argmax(probs, axis=-1) == labels).sum()
            all_probs.append(probs)
            all_labels.append(labels)
            tot += X.shape[0]
        if multihost.is_multihost(self.mesh):
            calib = (calibration_accumulators(np.concatenate(all_probs),
                                              np.concatenate(all_labels))
                     if all_probs else calibration_accumulators(
                         np.zeros((0, 2)), np.zeros(0, dtype=int)))
            vec = multihost.psum_across_processes(
                self.mesh, np.concatenate([ElogL, [correct, tot], calib]))
            return {"logL": vec[:1] / vec[2], "acc": vec[1] / vec[2],
                    "calibration": calibration_from_accumulators(vec[3:])}
        return {"logL": ElogL / tot, "acc": correct / tot,
                "calibration": calibration_measures(
                    np.concatenate(all_probs), np.concatenate(all_labels))}

    def _metrics_for_loader(self, loader, ev=None):
        ev = ev or self._evaluation()
        if self.spec.likelihood.is_classification:
            return self._class_metrics_for_loader(loader, ev)
        Dy = self.spec.Dy
        ElogL, sq_err, coverage = np.zeros(Dy), np.zeros(Dy), np.zeros(Dy)
        tot = 0
        for X, Y, ev_b in self._batches(loader, ev):
            log_p, m1, inside = self._eval_batch(
                self._put(X, ev["device"]), self._put(Y, ev["device"]), ev_b)
            ElogL += log_p.cpu().numpy()
            sq_err += np.sum((m1.cpu().numpy() - np.asarray(Y).T) ** 2, axis=-1)
            coverage += inside.sum(dim=-1).cpu().numpy()
            tot += X.shape[0]
        if multihost.is_multihost(self.mesh):
            vec = multihost.psum_across_processes(
                self.mesh, np.concatenate([ElogL, sq_err, coverage, [tot]]))
            ElogL, sq_err, coverage = vec[:Dy], vec[Dy:2 * Dy], vec[2 * Dy:-1]
            tot = vec[-1]
        return {"logL": ElogL / tot, "rmse": self.Y_std * np.sqrt(sq_err / tot),
                "coverage": coverage / tot}

    def compute_metrics(self):
        """Full-split metrics for train/valid/test: logL, rmse and coverage
        per output, or for classification logL, acc and calibration.  With
        `eval_device = "cpu"` they are computed on the host CPU; on a mesh
        each rank evaluates its slice of the rows (`_batches`) and every
        rank returns the same sums."""
        ev = self._evaluation()
        res = {"train": self._metrics_for_loader(self.train_loader, ev)}
        if self.valid_loader is not None:
            res["valid"] = self._metrics_for_loader(self.valid_loader, ev)
        if self.test_loader is not None:
            res["test"] = self._metrics_for_loader(self.test_loader, ev)
        return res
