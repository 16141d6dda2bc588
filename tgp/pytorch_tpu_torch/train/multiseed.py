"""Multi-seed batteries: R independent replicas advanced as one model, the
port of the JAX package's `train/multiseed.py`.

The reference runs each (dataset, model) cell as ten serial launches, one
per train/test split seed.  Here the seed axis is a `torch.func.vmap` axis
over the model's own functions: R replicas, each with its own split's data,
z-scoring, k-means inducing points and parameters, take one step together.
The Gram kernels fold the mapped axis into their output axis
(`ops/rbf_gram.py`), so a battery step launches each kernel as often as
one replica's step does: once forward and once backward per rbf leaf,
whatever R is.

Semantics: R separate `Trainer`s.  Parameters are stacked on a leading R
axis (`stack_trees`); the loss is the sum of the replicas' ELBOs, whose
gradient is each replica's own; the grouped Adam family
(`train/group_adam.py`) on a stacked leaf is per-replica Adam, since every
update is elementwise.  Replica r draws from its own `torch.Generator`
seeded seed + r on the device, as `Trainer(seed=seed + r)` does: the draws
are made per replica outside the map and stacked
(`flows.hypernet.ReplicaGenerators`).  A minibatch battery shuffles each
replica with its own numpy PCG64(seed + 7919 (r + 1)) stream, the JAX
battery's, through a full-batch-then-remainder epoch as the Trainer's.

Nothing inside a chunk of steps reads a value back: the (elbo, ell, kld)
rows stay on the device and a chunk fetches them with one copy.

On a mesh (`mesh=`, `parallel/mesh.py`) the replica axis is cut over 'dp'
(`_Shard`): R is padded to a multiple of dp with copies of the last replica
(its parameters, data, optimizer state and generator seed, so a copy's run
is bitwise the replica's), each rank trains its block of replicas through
the same map, and the parameters, curves, optimizer state and generator
states are gathered to every rank (an all_reduce of zero-filled buffers over
dp) and cut back to R.  A minibatch battery's shuffle streams advance for
every replica on every rank, so no rank needs another's.

With `spec.remat`, `marginal_qf` and the warp are checkpointed, as in the
JAX battery.  torch's checkpoint cannot run inside `torch.func.vmap` (a
saved tensor escapes the map), so the mapped ELBO is cut into mapped calls
(`_Battery._elbo_map_remat`): the moments of q(f), the warp's nodes, the
warp, then the ELL and the KL terms, and `models/tgp.py::_remat` wraps the
whole first and third.  Each call runs the plain map's operations, and the
recompute replays the replicas' draws from their generators' states, so a
step gives the plain step's losses and gradients bit for bit and leaves the
generators where a plain step does; it launches the Gram kernel's forward
twice and its backward once a rbf leaf, whatever R is.

L-BFGS is refused, as the JAX battery refuses it: a full solver with its
own line search does not compose with the battery's optimizer.
"""

from __future__ import annotations

import time

import numpy as np
import torch
import torch.distributed as dist

from .. import config as cfg
from ..flows.hypernet import ReplicaGenerators
from ..models import deep, tgp as tgp_mod
from ..ops.linalg import mapped_replicas
from ..weights import tree_leaves, tree_map, tree_unflatten
from . import group_adam as GA
from .metrics import inside_95
from .natgrad import gamma_at, guard_step_arch, natgrad_multiseed_step
from .optimizers import LBFGS_REFUSAL, build_grouped_optimizer, param_paths
from .trainer import frozen_param_labels


class _Shard:
    """A battery's R replicas on a mesh: padded to R_pad, a multiple of dp,
    with copies of the last replica; this rank's block of them (`index`,
    the replica each local one is or copies); and the gathers back.
    Without a mesh every replica is local and nothing moves."""

    def __init__(self, mesh, R: int):
        self.mesh, self.R = mesh, R
        dp = 1 if mesh is None else mesh.dp
        self.R_pad = R + (-R) % dp
        per = self.R_pad // dp
        lo = 0 if mesh is None else mesh.dp_index * per
        self.index = [min(r, R - 1) for r in range(lo, lo + per)]
        self.lo = lo

    @property
    def active(self) -> bool:
        return self.mesh is not None

    def take(self, x):
        """The local replicas of x (leading axis R)."""
        if not self.active or x is None:
            return x
        return x[torch.as_tensor(self.index) if torch.is_tensor(x)
                 else np.asarray(self.index)]

    def take_carry(self, carry):
        if not self.active or carry is None:
            return carry
        st = carry["opt_state"]
        if isinstance(st, GA.GroupAdamState):
            st = GA.GroupAdamState(list(st.count), [self.take(t) for t in st.mu],
                                   [self.take(t) for t in st.nu])
        return dict(carry, opt_state=st,
                    rngs=[carry["rngs"][i] for i in self.index])

    def gather(self, t):
        """A local (per, ...) tensor as the (R, ...) whole on every rank."""
        if not self.active:
            return t
        if self.mesh.dp > 1:
            buf = t.new_zeros((self.R_pad,) + tuple(t.shape[1:]))
            buf[self.lo:self.lo + t.shape[0]] = t
            dist.all_reduce(buf, group=self.mesh.group(("dp",)))
            t = buf
        return t[:self.R]

    def gather_np(self, a):
        """`gather` of a host array whose axis 1 holds the replicas."""
        if not self.active:
            return a
        t = torch.as_tensor(np.ascontiguousarray(np.moveaxis(a, 1, 0)),
                            dtype=torch.float64).to(self.mesh.device)
        return np.moveaxis(self.gather(t).cpu().numpy(), 0, 1)

    def gather_state(self, state):
        if not self.active:
            return state
        st = state["opt_state"]
        if isinstance(st, GA.GroupAdamState):
            st = GA.GroupAdamState(list(st.count),
                                   [self.gather(t) for t in st.mu],
                                   [self.gather(t) for t in st.nu])
        rngs = torch.stack(state["rngs"]).to(self.mesh.device, torch.int64)
        rngs = self.gather(rngs).to("cpu", torch.uint8)
        return dict(state, opt_state=st, rngs=list(rngs))


def stack_trees(trees):
    """Stack a list of identically-structured params trees on a new leading
    axis."""
    stacked = [torch.stack(ls) for ls in zip(*map(tree_leaves, trees))]
    return tree_unflatten(trees[0], stacked)


def unstack_tree(tree, r):
    """Replica r of a stacked tree."""
    return tree_map(lambda leaf: leaf[r], tree)


def clip_by_global_norm_per_replica(max_norm: float):
    """The global-norm clip of each replica's slice of the stacked
    gradients (a list of leaves, each (R, ...)): scale 1 where a replica's
    norm is below max_norm, else max_norm / norm (optax's
    clip_by_global_norm per replica; one shared norm would couple them)."""

    def clip(grads):
        R = grads[0].shape[0]
        sq = sum(torch.sum(torch.square(g).reshape(R, -1), dim=-1)
                 for g in grads)
        norm = torch.sqrt(sq)
        scale = torch.where(norm < max_norm, 1.0, max_norm / norm)
        return [g * scale.reshape((R,) + (1,) * (g.ndim - 1)) for g in grads]

    return clip


class _Optimizer:
    """The battery's optimizer on the stacked leaves: `init(leaves)` its
    state, `update(grads, state, leaves)` a step in place."""

    def __init__(self, kind, update, clip):
        self.kind, self._update, self._clip = kind, update, clip

    def init(self, leaves):
        return GA.init_state(leaves) if self.kind in GA.KINDS else None

    def update(self, grads, state, leaves):
        if self._clip is not None:
            grads = self._clip(grads)
        self._update(grads, state, leaves)


def _optimizer(spec, params_stack, opt: str, lr: float, clip_norm,
               specs=None, extra_frozen=None) -> _Optimizer:
    """The optimizer of the stacked tree.  Parameter-group specs and frozen
    labels go by path, and every transform is elementwise, so the single
    model's machinery applies to the stacked tree as it is and equals
    per-replica groups.  The Adam family is always the grouped one
    (`train/group_adam.py`, torch `add_param_group` semantics), so every
    call's state can carry into the next (the hold-kernel protocol's
    phases); 'sgd' is the stateless grouped SGD.  `clip_norm` clips each
    replica's gradients first (`clip_by_global_norm_per_replica`)."""
    if opt == "lbfgs":
        raise NotImplementedError(LBFGS_REFUSAL)
    frozen = frozen_param_labels(spec, params_stack)
    if extra_frozen is not None:
        frozen = tree_unflatten(frozen, [
            bool(a) or bool(b) for a, b in zip(tree_leaves(frozen),
                                               tree_leaves(extra_frozen))])
    clip = (clip_by_global_norm_per_replica(clip_norm)
            if clip_norm is not None else None)
    if opt in GA.KINDS:
        lr_t, wd_t, act_t = (tree_leaves(t) for t in GA.annotations_from_specs(
            params_stack, specs, lr, frozen_labels=frozen,
            default_wd=0.01 if opt == "adam_W" else 0.0))

        def update(grads, state, leaves):
            GA.update(grads, state, leaves, lr_t, wd_t, act_t, kind=opt)

        return _Optimizer(opt, update, clip)
    sgd, _ = build_grouped_optimizer(params_stack, specs or [], lr, opt,
                                     frozen_labels=frozen)
    paths = param_paths(params_stack)

    @torch.no_grad()
    def update(grads, state, leaves):
        ups = sgd(tree_unflatten(paths, grads), tree_unflatten(paths, leaves))
        for p, u in zip(leaves, tree_leaves(ups)):
            p.add_(u)

    return _Optimizer(opt, update, clip)


def _resolve_carry(optimizer, leaves, carry, R, seeds, device, opt=None,
                   clip_norm=None):
    """(opt_state, generators) for a battery call: fresh (one generator a
    replica, from `config.make_rng(seeds[r])` on `device`), or carried from
    an earlier call's return_state=True result, so that the moments and
    the draws go on across protocol phases (torch keep_parameter_groups
    semantics).

    The Adam family shares one state layout, so the carry records the
    optimizer kind and the clip; a mismatch raises rather than reading the
    moments under another rule."""
    if carry is None:
        return optimizer.init(leaves), [cfg.make_rng(s, device) for s in seeds]
    for key, want in (("opt_kind", opt), ("clip_norm", clip_norm)):
        if key in carry and carry[key] != want:
            raise ValueError(
                f"carried optimizer state was produced with "
                f"{key}={carry[key]!r} but this call uses {want!r} — use the "
                "same opt/clip_norm in every phase, or pass carry=None to "
                "reset moments deliberately")
    state = carry["opt_state"]
    adam = optimizer.kind in GA.KINDS
    if adam != isinstance(state, GA.GroupAdamState) or adam and [
            t.shape for t in state.mu] != [t.shape for t in leaves]:
        raise ValueError(
            "carried optimizer state does not match this call's optimizer "
            "structure — use the same opt/clip_norm in every phase")
    gens = []
    for st in carry["rngs"]:
        g = torch.Generator(device=device)
        g.set_state(st)
        gens.append(g)
    if len(gens) != R:
        raise ValueError(f"carried {len(gens)} generators for {R} replicas")
    return state, gens


def _check_replica_axis(params_stack, R):
    """Every leaf must be replica-stacked (leading axis R, as `stack_trees`
    makes it); a real error, not an assert."""
    for leaf in tree_leaves(params_stack):
        if leaf.ndim < 1 or leaf.shape[0] != R:
            raise ValueError(
                f"params_stack leaf shape {tuple(leaf.shape)} lacks the "
                f"leading replica axis R={R}; build stacks with stack_trees")


def _natgrad_extras(params_stack, natgrad_gamma):
    """(extra_frozen, want_ng): q(U) leaves leave the gradient optimizer
    when natural-gradient VI is on (see train/natgrad.py)."""
    if natgrad_gamma is None:
        return None, False
    if natgrad_gamma <= 0.0:
        raise ValueError(
            f"natgrad_gamma must be > 0 (got {natgrad_gamma}); gamma=0 would "
            "freeze q(U) out of BOTH optimizers — pass None to train q(U) "
            "with the gradient optimizer")
    if "q_mu" not in params_stack:
        raise NotImplementedError(
            "natgrad_gamma needs a single-layer q(U) at params['q_mu'/'q_L']; "
            "deep stacks keep Adam on q")
    paths = param_paths(params_stack)
    return tree_map(lambda q: q.endswith("q_mu") or q.endswith("q_L"),
                    paths), True


class _Battery:
    """What every call shares: the stacked parameters on the device (leaves
    that require grad), the data, the optimizer and its state, the
    generators, and the mapped ELBO."""

    def __init__(self, spec, params_stack, X_stack, Y_stack, opt, lr,
                 clip_norm, specs, carry, seeds, natgrad_gamma, natgrad_force,
                 device):
        tgp_mod.check_spec(spec)
        self.spec = spec
        self.R = R = X_stack.shape[0]
        _check_replica_axis(params_stack, R)
        self.device = cfg.resolve_device(device)
        self.dtype = cfg.default_dtype()
        self.X = self._put(X_stack)
        # class labels go in as floats, as the Trainer puts them
        self.Y = self._put(Y_stack)
        self.params = tree_map(
            lambda t: torch.as_tensor(t).detach().to(
                self.device, self.dtype, copy=True).requires_grad_(True),
            params_stack)
        self.leaves = tree_leaves(self.params)
        ng_frozen, use_ng = _natgrad_extras(self.params, natgrad_gamma)
        if use_ng:
            guard_step_arch(spec, natgrad_gamma, force=natgrad_force)
        self.optimizer = _optimizer(spec, self.params, opt, lr, clip_norm,
                                    specs, extra_frozen=ng_frozen)
        self.state, gens = _resolve_carry(self.optimizer, self.leaves, carry,
                                          R, seeds, self.device, opt=opt,
                                          clip_norm=clip_norm)
        self.rngs = ReplicaGenerators(gens)
        self.token = torch.arange(R, device=self.device)
        self.ng_step = (natgrad_multiseed_step(
            spec, lambda g: self.optimizer.update(g, self.state, self.leaves),
            natgrad_gamma) if use_ng else None)

    def _put(self, a):
        return torch.as_tensor(np.asarray(a), dtype=self.dtype).to(self.device)

    def _map(self, fn, *args):
        with mapped_replicas(self.R):
            return torch.func.vmap(fn)(*args)

    def elbo_map(self, params, X, Y):
        """(elbo, ell, kld), each (R,): the ELBO of every replica on its
        own batch, as one mapped call (a deep spec has no remat)."""
        if getattr(self.spec, "remat", False):
            return self._elbo_map_remat(params, X, Y)
        return self._map(lambda p, x, y, tok: tgp_mod.elbo(
            self.spec, p, x, y, self.rngs.bind(tok)), params, X, Y, self.token)

    def _elbo_map_remat(self, params, X, Y):
        """`elbo_map` with `spec.remat`: `tgp.elbo` cut into mapped calls,
        `marginal_qf`'s and the warp's each under one checkpoint."""
        spec, tok, rngs = self.spec, self.token, self.rngs

        def qf(p, x):
            mu, var, prior = tgp_mod._marginal_qf(
                spec, p, tgp_mod._ensure_3d(spec, x), diagonal=True)
            return mu, var, prior or ()     # the map takes tensors only

        def parts(p, y, t):
            return tgp_mod._ell_parts(spec, p["likelihood"], y, rngs.bind(t))

        def nodes(p, y, m, v, t):
            return parts(p, y, t)[0](m, v)

        def warp(p, x, f, t):
            return tgp_mod._make_warp(
                spec, p, tgp_mod._ensure_3d(spec, x), rngs.bind(t),
                stochastic=True, train=True)(f)

        mu, var, prior = tgp_mod._remat(lambda P, X: self._map(qf, P, X),
                                        None, params, X)
        fk = ()
        if tgp_mod._ell_parts(spec, None, None, rngs) is not None:
            fk = self._map(nodes, params, Y, mu, var, tok)
            if spec.has_flow:
                fk = tgp_mod._remat(
                    lambda P, X, F: self._map(warp, P, X, F, tok),
                    rngs, params, X, fk)

        def tail(p, x, y, m, v, pr, f, t):
            kl = torch.sum(tgp_mod.kld_qu(spec, p, pr or None))
            ell = (parts(p, y, t)[1](f) if isinstance(f, torch.Tensor) else
                   tgp_mod._plain_ell(spec, p["likelihood"], y, m, v))
            return tgp_mod._elbo_sum(spec, p, x.shape[0], ell, kl)

        return self._map(tail, params, X, Y, mu, var, prior, fk, tok)

    def step(self, X, Y, g=None):
        """One optimisation step of every replica: (3, R) on the device."""
        if self.ng_step is not None:
            return self.ng_step(self.params, X, Y, self.elbo_map, g)
        e, ell, kld = self.elbo_map(self.params, X, Y)
        grads = torch.autograd.grad(-e.sum(), self.leaves, allow_unused=True,
                                    materialize_grads=True)
        self.optimizer.update(grads, self.state, self.leaves)
        return torch.stack([e.detach(), ell.detach(), kld.detach()])

    def result(self):
        return tree_map(lambda t: t.detach(), self.params)

    def state_dict(self, opt, clip_norm, **extra):
        return {"opt_state": self.state,
                "rngs": [g.get_state() for g in self.rngs.gens],
                "opt_kind": opt, "clip_norm": clip_norm, **extra}


class _Curves:
    """The per-step (or per-epoch) rows of a battery, fetched a chunk at a
    time, with the JAX battery's non-finite check and verbose lines."""

    def __init__(self, epochs, verbose_each, R):
        self.epochs, self.verbose_each, self.R = epochs, verbose_each, R
        self.parts = {"elbo": [], "ell": [], "kld": []}
        self.t0 = time.time()

    def add(self, rows, prev, done, timing=False):
        arr = torch.stack(rows).cpu().numpy()                # (n, 3, R)
        for i, k in enumerate(("elbo", "ell", "kld")):
            self.parts[k].append(arr[:, i, :])
        last = self.parts["elbo"][-1][-1]
        if not np.isfinite(last).all():
            bad = np.where(~np.isfinite(last))[0]
            raise FloatingPointError(
                f"non-finite ELBO at epoch {done} in replicas {bad.tolist()}")
        if self.verbose_each:
            e_np = self.parts["elbo"][-1]
            m = (prev // self.verbose_each + 1) * self.verbose_each
            while m <= done:
                row = e_np[m - prev - 1]
                rate = (f" ({(time.time() - self.t0) / done * 1e3:.1f}ms/ep)"
                        if timing else "")
                print(f"| epoch {m}/{self.epochs}  ELBO "
                      f"[{row.min():.3f} .. {row.max():.3f}] over {self.R} "
                      f"seeds{rate}")
                m += self.verbose_each

    def result(self):
        return {k: np.concatenate(v, axis=0) for k, v in self.parts.items()}


def train_multiseed(spec, params_stack, X_stack, Y_stack, epochs: int,
                    lr: float, opt: str = "adam", seed: int = 0,
                    chunk: int = 2000, clip_norm=None, verbose_each: int = 0,
                    specs=None, mesh=None, carry=None,
                    return_state: bool = False, natgrad_gamma=None,
                    natgrad_warmup=None, natgrad_force: bool = False,
                    device=None):
    """Train R replicas full batch for `epochs` steps.

    Args:
      params_stack: params tree with leading R axis (`stack_trees`), one
        replica per split seed; copied to `device` in the configured
        precision.
      X_stack: (R, N, Dx); Y_stack: (R, N, Dy), or (R, N) class labels.
      carry / return_state: multi-phase protocols (hold-kernel) pass the
        previous call's returned state dict, so that the optimizer moments,
        the generators and the natgrad warmup ramp go on across the
        boundary; a run split into carried calls is bitwise the single run.
      natgrad_gamma / natgrad_warmup / natgrad_force: natural gradients on
        each replica's q(U), as the Trainer's.
      mesh: a `parallel.mesh.Mesh`; each rank trains its block of the
        replicas, and every rank returns the whole result.
      device: None is the card, or the mesh's device.
    Returns (params_stack, curves[, state]): curves a dict of (epochs, R)
    arrays (elbo, ell, kld), the Trainer's loss_curve per replica.
    """
    if natgrad_warmup is not None and natgrad_gamma is None:
        raise ValueError("natgrad_warmup needs natgrad_gamma")
    sh = _Shard(mesh, X_stack.shape[0])
    b = _Battery(spec, tree_map(sh.take, params_stack), sh.take(X_stack),
                 sh.take(Y_stack), opt, lr, clip_norm, specs,
                 sh.take_carry(carry), [int(seed) + r for r in sh.index],
                 natgrad_gamma, natgrad_force,
                 mesh.device if mesh is not None else device)
    # the warmup ramp's step count rides the state dict across calls
    ng_t = int(carry.get("ng_t", 0)) if isinstance(carry, dict) else 0
    curves = _Curves(epochs, verbose_each, b.R)
    done = 0
    while done < epochs:
        n = min(chunk, epochs - done)
        gs = [None] * n
        if natgrad_warmup is not None:
            gs = [float(g) for g in gamma_at(natgrad_gamma, natgrad_warmup,
                                             np.arange(ng_t, ng_t + n))]
            ng_t += n
        rows = [b.step(b.X, b.Y, g) for g in gs]
        prev, done = done, done + n
        curves.add(rows, prev, done)
    return _finish(sh, b, curves, return_state, opt, clip_norm, ng_t=ng_t)


def _finish(sh, b, curves, return_state, opt, clip_norm, **extra):
    """A call's (params_stack, curves[, state]), gathered over the mesh."""
    params = tree_map(sh.gather, b.result())
    cv = {k: sh.gather_np(v) for k, v in curves.result().items()}
    if return_state:
        return params, cv, sh.gather_state(b.state_dict(opt, clip_norm,
                                                        **extra))
    return params, cv


def train_multiseed_minibatch(spec, params_stack, X_stack, Y_stack,
                              epochs: int, lr: float, batch_size: int,
                              opt: str = "adam", seed: int = 0,
                              clip_norm=None, verbose_each: int = 0,
                              specs=None, mesh=None, carry=None,
                              return_state: bool = False,
                              natgrad_gamma=None, natgrad_warmup=None,
                              natgrad_force: bool = False, device=None):
    """Minibatch-SVI battery: each replica shuffles its own split with its
    own generator, numpy PCG64(seed + 7919 (r + 1)), and an epoch is its
    full batches then the remainder batch (the reference's drop_last=False),
    as the Trainer's minibatch path; the per-epoch curve entry is the last
    full batch's.  The (C, R, N) permutations of a chunk of epochs go to
    the device at once, and the curves come back once a chunk.  With
    batch_size >= N this is `train_multiseed`.  `natgrad_warmup` is
    full-batch only, as in the JAX battery."""
    R, N = X_stack.shape[0], X_stack.shape[1]
    MB = int(batch_size)
    if MB >= N:
        return train_multiseed(spec, params_stack, X_stack, Y_stack, epochs,
                               lr, opt=opt, seed=seed, clip_norm=clip_norm,
                               verbose_each=verbose_each, specs=specs,
                               mesh=mesh, carry=carry,
                               return_state=return_state,
                               natgrad_gamma=natgrad_gamma,
                               natgrad_warmup=natgrad_warmup,
                               natgrad_force=natgrad_force, device=device)
    if natgrad_warmup is not None:
        raise NotImplementedError(
            "natgrad_warmup is full-batch-only in the batteries (the "
            "Trainer's minibatch path supports it)")
    sh = _Shard(mesh, R)
    b = _Battery(spec, tree_map(sh.take, params_stack), sh.take(X_stack),
                 sh.take(Y_stack), opt, lr, clip_norm, specs,
                 sh.take_carry(carry), [int(seed) + r for r in sh.index],
                 natgrad_gamma, natgrad_force,
                 mesh.device if mesh is not None else device)
    n_batches, rem = divmod(N, MB)
    gens = [np.random.Generator(np.random.PCG64(seed + 7919 * (r + 1)))
            for r in range(R)]
    if carry is not None and "gen_states" in carry:
        for g, st in zip(gens, carry["gen_states"]):
            g.bit_generator.state = st
    local = torch.as_tensor(sh.index)
    rows_of = torch.arange(b.R, device=b.device)[:, None]

    def batch(ids):                                      # ids (R, B)
        return b.X[rows_of, ids], b.Y[rows_of, ids]

    # epochs per upload of permutations, capped at ~64 MB of int64 indices
    chunk = max(1, min((1 << 23) // max(R * N, 1), 200, epochs))
    curves = _Curves(epochs, verbose_each, R)
    done = 0
    while done < epochs:
        n = min(chunk, epochs - done)
        perms = torch.from_numpy(np.stack(
            [np.stack([g.permutation(N) for g in gens]) for _ in range(n)])
        )[:, local].to(b.device)                         # (n, R, N)
        rows = []
        for perm in perms:
            for i in range(n_batches):
                last = b.step(*batch(perm[:, i * MB:(i + 1) * MB]))
            if rem:
                b.step(*batch(perm[:, N - rem:]))
            rows.append(last)
        prev, done = done, done + n
        curves.add(rows, prev, done, timing=True)
    return _finish(sh, b, curves, return_state, opt, clip_norm,
                   gen_states=[g.bit_generator.state for g in gens])


@torch.no_grad()
def eval_multiseed(spec, params_stack, X_stack, Y_stack, Y_std_stack,
                   S_test: int = 100, seed: int = 1234,
                   fully_bayesian: bool = False, mesh=None, device=None):
    """Per-replica test metrics (the Trainer's `compute_metrics`
    definitions) of the whole test set, as one mapped call.  Replica r's
    draws come from a generator seeded seed + r, in the order of the
    Trainer's evaluation batch (`Trainer._eval_batch`): the log-likelihood,
    then the moments and the S_test samples, which share one `marginal_qf`
    (one propagation for a deep TGP).  So a call makes 2 forward launches a
    rbf leaf and no backward.

    Returns numpy arrays: logL (R, Dy) (per point), rmse (R, Dy)
    (Y_std-rescaled), coverage (R, Dy) for regression; logL (R,) and acc
    (R,) for classification.  On a mesh each rank evaluates its block of
    the replicas and every rank returns the whole.
    """
    tgp_mod.check_spec(spec)
    device = cfg.resolve_device(mesh.device if mesh is not None else device)
    dtype = cfg.default_dtype()
    _check_replica_axis(params_stack, X_stack.shape[0])
    sh = _Shard(mesh, X_stack.shape[0])
    params_stack = tree_map(sh.take, params_stack)
    X_stack, Y_stack = sh.take(X_stack), sh.take(Y_stack)
    Y_std_stack = sh.take(np.asarray(Y_std_stack))
    R = X_stack.shape[0]

    def put(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype).to(device)

    params = tree_map(lambda t: torch.as_tensor(t).to(device, dtype),
                      params_stack)
    X, Y, Y_std = put(X_stack), put(Y_stack), put(Y_std_stack)
    is_class = spec.likelihood.is_classification
    rngs = ReplicaGenerators([cfg.make_rng(int(seed) + r, device)
                              for r in sh.index])

    def one(p, X, Y, Y_std, tok):
        gen = rngs.bind(tok)
        n = X.shape[0]
        fb = dict(S_MC=S_test if fully_bayesian else 1,
                  fully_bayesian=fully_bayesian, rng=gen)
        if deep.is_deep(spec):
            X_in = X
            qf = deep.propagate(spec, p, X, gen, max(spec.S_test, S_test))
            log_p = tgp_mod.test_log_likelihood(spec, p, X, Y, Y_std, qf=qf,
                                                **fb)
        else:
            log_p = tgp_mod.test_log_likelihood(spec, p, X, Y, Y_std, **fb)
            X_in = tgp_mod._ensure_3d(spec, X)
            qf = tgp_mod.marginal_qf(spec, p, X_in)
        m1 = tgp_mod.predictive_distribution(spec, p, X_in, qf=qf, **fb)[0]
        if is_class:
            acc = torch.mean((torch.argmax(m1, dim=-1)
                              == Y.reshape(-1)).to(dtype))
            return {"logL": torch.sum(log_p) / n, "acc": acc}
        samples = tgp_mod.sample_predictive(spec, p, X_in, S_test, gen,
                                            fully_bayesian, qf=qf)[0]
        rmse = Y_std * torch.sqrt(torch.mean(torch.square(m1 - Y.T), dim=-1))
        cover = torch.mean(inside_95(samples, Y.T, dim=1).to(dtype), dim=-1)
        return {"logL": log_p / n, "rmse": rmse, "coverage": cover}

    with mapped_replicas(R):
        out = torch.func.vmap(one)(params, X, Y, Y_std,
                                   torch.arange(R, device=device))
    return {k: sh.gather(v).cpu().numpy() for k, v in out.items()}
