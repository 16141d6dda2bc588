"""dp x ty meshes of ranks: the port of the JAX package's
`parallel/mesh.py`.

  * 'dp' — data parallel: each rank computes q(f)'s marginals on its block
    of a batch's rows.
  * 'ty' — output parallel: each rank owns Dy / ty of the independent
    output GPs, with their inducing points, q(U), kernel and mean.

A rank is one process with one device (`parallel/multihost.py`), and the
axes' groups come from `torch.distributed.device_mesh.init_device_mesh`,
laid out rank-major as the JAX package's process-major mesh: rank r sits at
(r // ty, r % ty).

In the JAX package jit keeps the math global and the shardings only place
it.  Here a rank computes only its share, so the decomposition is written
out, and it is exact: `value_and_grad` hands `models/tgp.elbo` the rank's
block (`_Block`), which cuts the GP part and joins it across the mesh.

  * the Grams, K_zz's Cholesky, the solves and KL(q(U) || p(U)) run on the
    rank's (rows, outputs) block;
  * the marginals and that KL are gathered to every rank of the split axes
    (one collective), and the likelihood (the flow, its hypernets' draws
    and batch statistics, the categorical softmax, which couples the
    outputs) runs on the whole batch on every rank: each rank draws what
    the run without a mesh draws, from the Trainer's generator, which
    stays in lockstep;
  * the expected log-likelihood is scaled by N over the global batch size;
    the KL is counted once, by the ranks of dp index 0 (each for its
    outputs);
  * the gradients of the GP leaves (`gp_leaves`: Z, q(U), the kernel and
    the mean) are summed over the split axes: a leaf replicated over ty
    gathers every rank's share, and a ty-cut leaf's block is non-zero only
    on the ranks of its ty index, so its sum is over dp.  The flow's and
    the likelihood's leaves get the same whole gradient on every rank and
    are not summed;
  * a batch whose rows do not divide dp is computed whole by every dp rank
    and summed over ty only, so it is not counted dp times; outputs that do
    not divide ty are computed whole by every ty rank (the JAX rule below).

So every rank holds the same parameters after each step.  A deep TGP on a
mesh is computed whole on every rank.

`param_sharding` keeps JAX's rule (a leading axis equal to Dy and divisible
by ty is cut over 'ty', everything else replicated) and decides by meaning
where the shape alone would mislead: only the GP leaves are cut.  The
flow's per-output stacks and the likelihood's per-output leaves also lead
with Dy, but the likelihood runs after the gather on every rank, so they
are replicated.  Every rank stores the whole tree either way; the labels
say which block a rank computes with, and a step cuts its outputs by them
(and its rows by `batch_sharding`, where they divide dp).

Collectives: every gather is an all_reduce of a zero-filled buffer in which
each rank writes its block, so the same code runs under gloo on the CPU,
gloo on a shared card (whose CUDA tensors it only broadcasts and reduces)
and NCCL.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from ..models import deep, tgp as tgp_mod
from ..weights import tree_leaves, tree_map, tree_unflatten
from . import multihost

#: the GP leaves of a params tree, with the spec flag that shares each
#: over the outputs
_GP_KEYS = {"Z": "Z_is_shared", "q_mu": "q_U_is_shared",
            "q_L": "q_U_is_shared", "kernel": "K_is_shared",
            "mean": "mean_is_shared"}


@dataclasses.dataclass(frozen=True)
class Sharding:
    """Where a tensor's work lies on a mesh: `axis` 'dp' (its leading axis
    cut into per-rank row blocks), 'ty' (its leading output axis cut over
    ty) or None (replicated)."""

    axis: str | None = None


class Mesh:
    """A (dp, ty) mesh of ranks: this rank's coordinates, device and axis
    groups."""

    def __init__(self, dp: int, ty: int, device_mesh, device):
        self.dp, self.ty = int(dp), int(ty)
        self.shape = {"dp": self.dp, "ty": self.ty}
        self.world = self.dp * self.ty
        self.device_mesh = device_mesh
        self.device = device
        self.rank = dist.get_rank()
        self.dp_index, self.ty_index = divmod(self.rank, self.ty)
        self._groups = {("dp",): device_mesh.get_group("dp"),
                        ("ty",): device_mesh.get_group("ty"),
                        ("dp", "ty"): dist.group.WORLD}

    def group(self, axes):
        """The process group of the ranks that differ along `axes`."""
        return self._groups[tuple(axes)]

    def __repr__(self):
        return (f"Mesh(dp={self.dp}, ty={self.ty}, rank={self.rank}, "
                f"device={self.device})")


def make_mesh(dp: int = 1, ty: int = 1, devices=None) -> Mesh:
    """The (dp, ty) mesh over the process group's ranks; dp * ty must equal
    the number of ranks (one device each).  `devices`, if given, must be
    this rank's device alone (the JAX signature's device list)."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    if dp * ty != n:
        raise ValueError(f"dp*ty = {dp * ty} != device count {n} (one "
                         f"device a rank)")
    dev = multihost.device()
    if devices is not None and [torch.device(d) for d in devices] != [dev]:
        raise ValueError(f"a rank's mesh holds its own device {dev}, got "
                         f"{devices}")
    from torch.distributed.device_mesh import init_device_mesh

    dm = init_device_mesh(dev.type, (dp, ty), mesh_dim_names=("dp", "ty"))
    return Mesh(dp, ty, dm, dev)


def batch_sharding(mesh: Mesh) -> Sharding:
    """Batches: the leading (row) axis over 'dp'."""
    return Sharding("dp")


def replicate(mesh: Mesh) -> Sharding:
    return Sharding(None)


def gp_leaves(params):
    """Bool tree: True for the GP leaves (Z, q_mu, q_L, the kernel's and
    the mean's), whose gradients a mesh sums over its split axes."""
    return {k: tree_map(lambda _: k in _GP_KEYS, v) for k, v in params.items()}


def param_sharding(spec, params, mesh: Mesh):
    """Sharding tree of a params tree: the GP leaves with a leading axis
    equal to Dy, divisible by ty > 1 and not shared over the outputs are
    'ty'; every other leaf is replicated (see the module's docstring)."""
    ty, Dy = mesh.shape["ty"], getattr(spec, "Dy", None)

    def label(key, tree):
        cut = (key in _GP_KEYS and ty > 1 and Dy is not None
               and Dy % ty == 0 and not getattr(spec, _GP_KEYS[key]))
        return tree_map(lambda x: Sharding("ty") if (
            cut and x.ndim >= 1 and x.shape[0] == Dy) else replicate(mesh),
            tree)

    if deep.is_deep(spec):
        return tree_map(lambda _: replicate(mesh), params)
    return {k: label(k, v) for k, v in params.items()}


def shard_batch(mesh: Mesh, *arrays):
    """A batch as a mesh step takes it: the whole batch on the rank's
    device in the configured precision (the likelihood reads every row on
    every rank); the step cuts each rank's rows (`local_rows`) for the
    marginals itself.  Rows that do not divide dp are computed whole by
    every dp rank."""
    from .. import config as cfg

    out = tuple(torch.as_tensor(a).to(cfg.default_dtype()).to(mesh.device)
                for a in arrays)
    return out if len(out) > 1 else out[0]


class _Join(torch.autograd.Function):
    """A rank's (outputs, rows) block of the marginals mu, var into the
    whole (Dy, B) on every rank of `group`, and its KL summed over them: one
    all_reduce of a zero-filled buffer with each rank's block in its slot.
    The backward hands the rank its block of the whole's cotangent, without
    communication: every rank computes the same function of the whole,
    whose gradient counts once."""

    @staticmethod
    def forward(ctx, mu, var, kl, shape, index, group):
        n = shape[0] * shape[1]
        buf = mu.new_zeros(2 * n + 1)
        whole_mu, whole_var = buf[:n].view(shape), buf[n:2 * n].view(shape)
        whole_mu[index] = mu
        whole_var[index] = var
        buf[-1] = kl
        dist.all_reduce(buf, group=group)
        ctx.index = index
        return whole_mu, whole_var, buf[-1]

    @staticmethod
    def backward(ctx, g_mu, g_var, g_kl):
        return g_mu[ctx.index], g_var[ctx.index], g_kl, None, None, None


@dataclasses.dataclass(frozen=True)
class _Block:
    """A rank's share of a batch's GP part, as `models/tgp.elbo` takes it
    (`block=`): its rows (`batch_sharding`, where they divide dp) and its
    outputs (the leaves `param_sharding` labels 'ty'), the split axes, and
    whether it counts the KL (the ranks of dp index 0, each for its
    outputs)."""

    mesh: Mesh
    labels: dict
    shape: tuple
    rows: slice
    outs: slice
    axes: tuple
    count_kl: bool

    def cut(self, spec, params, X):
        """(spec, params, X3) of the block: the spec's Dy and the 'ty'
        leaves cut to the outputs, X to the rows."""
        if "dp" in self.axes:
            X = multihost.global_batch(self.mesh, X)
        if "ty" in self.axes:
            spec = dataclasses.replace(spec, Dy=len(range(spec.Dy)[self.outs]))
            params = tree_unflatten(params, [
                t[self.outs] if lab.axis == "ty" else t
                for t, lab in zip(tree_leaves(params),
                                  tree_leaves(self.labels))])
        return spec, params, tgp_mod._ensure_3d(spec, X)

    def join(self, mu, var, kl):
        """The whole marginals and the mesh's KL on every rank."""
        if not self.count_kl:
            kl = torch.zeros_like(kl)
        return _Join.apply(mu, var, kl, self.shape, (self.outs, self.rows),
                           self.mesh.group(self.axes))


def _block(spec, params, mesh: Mesh | None, n_rows: int):
    """This rank's `_Block` of a batch of n_rows, or None where it computes
    the whole batch: without a mesh, for a deep TGP, and where neither the
    rows nor the outputs are cut."""
    if mesh is None or deep.is_deep(spec):
        return None
    labels = param_sharding(spec, params, mesh)
    row_axis = batch_sharding(mesh).axis
    split_rows = mesh.shape[row_axis] > 1 and n_rows % mesh.shape[row_axis] == 0
    split_outs = any(lab.axis == "ty" for lab in tree_leaves(labels))
    if not (split_rows or split_outs):
        return None
    rows, outs = slice(None), slice(None)
    if split_rows:
        rows = slice(*multihost.local_rows(n_rows, mesh))
    if split_outs:
        per = spec.Dy // mesh.ty
        outs = slice(mesh.ty_index * per, (mesh.ty_index + 1) * per)
    axes = ((row_axis,) if split_rows else ()) + (("ty",) if split_outs else ())
    return _Block(mesh, labels, (spec.Dy, n_rows), rows, outs, axes,
                  not split_rows or mesh.dp_index == 0)


def value_and_grad(spec, params, X, Y, rng, mesh: Mesh | None, wrt, reduce):
    """The ELBO of the batch (X, Y) and its gradient with respect to the
    tensors `wrt`: (elbo, ell, kld, grads), the values detached.  On a mesh
    the rank computes its block (the module's docstring), the values are
    the whole batch's and equal on every rank, and grads[i] is summed over
    the split axes where reduce[i]: a collective, which every rank calls in
    lockstep.  Without one (mesh None) it is `models/tgp.elbo` and its
    gradient."""
    block = _block(spec, params, mesh, X.shape[0])
    e, ell, kld = tgp_mod.elbo(spec, params, X, Y, rng, block=block)
    grads = list(torch.autograd.grad(-e, wrt, allow_unused=True,
                                     materialize_grads=True))
    if block is not None:
        idx = [i for i, r in enumerate(reduce) if r]
        flat = torch.cat([grads[i].reshape(-1) for i in idx])
        dist.all_reduce(flat, group=mesh.group(block.axes))
        at = 0
        for i in idx:
            n = grads[i].numel()
            grads[i] = flat[at:at + n].reshape(grads[i].shape)
            at += n
    return e.detach(), ell.detach(), kld.detach(), grads


def make_sharded_train_step(spec, optimizer, mesh: Mesh):
    """A train step on the mesh: step(params, opt_state, X, Y, rng) ->
    (params, opt_state, (elbo, ell, kld)), with X, Y the whole batch on
    every rank (`shard_batch`), `rng` the generator of the draws and
    `optimizer` a `torch.optim.Optimizer` over `tree_leaves(params)`, which
    it steps in place with the mesh's gradients (`opt_state` is passed
    through; the optimizer keeps its state)."""

    def step(params, opt_state, X, Y, rng):
        leaves = tree_leaves(params)
        e, ell, kld, grads = value_and_grad(spec, params, X, Y, rng, mesh,
                                            leaves,
                                            tree_leaves(gp_leaves(params)))
        for p, g in zip(leaves, grads):
            p.grad = g
        optimizer.step()
        optimizer.zero_grad(set_to_none=True)
        return params, opt_state, (e, ell, kld)

    return step
