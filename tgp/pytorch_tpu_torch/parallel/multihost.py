"""Multi-process training of the port: joining the ranks, and what a rank
reads and writes of the global state (the JAX package's
`parallel/multihost.py`).

In torch one process owns one device, so the JAX package's two tiers, the
mesh of a process's devices and the cluster of processes, are one tier
here: a mesh of dp x ty devices is dp x ty ranks, each a process that
`initialize` joins to the others.  What the JAX package pins of the tier is
kept: every rank holds the same global state after each step, a batch is
cut into per-rank row blocks, the parameters never are, and metric
accumulators cross the ranks in float64.

  * `initialize(...)`        joins the process group: gloo for
                             `platform="cpu"`, NCCL on the card; an explicit
                             `backend="gloo"` lets several ranks share one
                             card (gloo reduces CUDA tensors), and is never
                             picked unless asked for.
  * `global_mesh(dp, ty)`    the (dp, ty) mesh over every rank.
  * `local_rows(n, mesh)`    the [start, stop) rows of this rank's dp block.
  * `global_batch(mesh, *a)` this rank's block of each array's rows, on its
                             device.
  * `fetch_params(tree)`     host copies of the parameters (each rank holds
                             the whole tree).
  * `psum_across_processes`  a float64 sum over every rank.
  * `replicate_global`       a host tree on every rank's device, rank 0's
                             values.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from .. import config as cfg
from ..weights import tree_map

_DEVICE = None      # this rank's device, set by `initialize`


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None, platform: str | None = None,
               backend: str | None = None,
               local_device_count: int | None = None) -> None:
    """Join the process group of `num_processes` ranks as rank
    `process_id`.

    `coordinator_address` is an init method ("tcp://host:port",
    "file:///path/store") or a bare "host:port" (tcp); None reads the
    environment that `python -m torch.distributed.run` sets (RANK,
    WORLD_SIZE, MASTER_ADDR, MASTER_PORT).  `platform` "cpu" puts the rank
    on the CPU under gloo; "gpu" (the default) on card LOCAL_RANK (or
    `process_id`) modulo the cards present, under NCCL, which needs a card
    a rank: more ranks on a host than cards raise ValueError before NCCL
    would.  `backend="gloo"` on the card lets ranks share one.
    `local_device_count` above 1 raises: a torch rank owns one device.
    """
    global _DEVICE
    if local_device_count is not None and int(local_device_count) > 1:
        raise ValueError(
            f"local_device_count={local_device_count}: a torch rank owns one "
            "device; start one process a device instead")
    if coordinator_address is None:
        init_method = "env://"
        num_processes = int(os.environ["WORLD_SIZE"]
                            if num_processes is None else num_processes)
        process_id = int(os.environ["RANK"]
                         if process_id is None else process_id)
    else:
        init_method = (coordinator_address if "://" in coordinator_address
                       else f"tcp://{coordinator_address}")
        if num_processes is None or process_id is None:
            raise ValueError("num_processes and process_id are needed with a "
                             "coordinator_address")
    platform = platform or "gpu"
    if platform == "cpu":
        backend = backend or "gloo"
        device = torch.device("cpu")
    elif platform == "gpu":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass "
                               "platform='cpu' to join on the CPU")
        backend = backend or "nccl"
        cards = torch.cuda.device_count()
        here = int(os.environ.get("LOCAL_WORLD_SIZE", num_processes))
        if backend == "nccl" and here > cards:
            raise ValueError(
                f"{here} ranks on this host but {cards} CUDA device(s): NCCL "
                f"needs a device a rank; pass backend='gloo' to share cards")
        local = int(os.environ.get("LOCAL_RANK", process_id))
        device = torch.device("cuda", local % cards)
        torch.cuda.set_device(device)
    else:
        raise ValueError(f"unknown platform {platform!r} (expected 'cpu' or "
                         "'gpu')")
    dist.init_process_group(backend, init_method=init_method,
                            world_size=int(num_processes),
                            rank=int(process_id))
    _DEVICE = device


def device() -> torch.device:
    """This rank's device (set by `initialize`)."""
    if _DEVICE is None:
        raise RuntimeError("the process group is not initialised; call "
                           "parallel.multihost.initialize first")
    return _DEVICE


def shutdown() -> None:
    """Leave the process group (every rank calls it)."""
    global _DEVICE
    if dist.is_initialized():
        dist.destroy_process_group()
    _DEVICE = None


def join_mesh(dp: int, ty: int, platform: str, module: str):
    """The (dp, ty) mesh of a CLI run: the process group that
    `python -m torch.distributed.run --nproc_per_node dp*ty -m module`
    started (its environment), or, for a 1x1 mesh in a plain process, a
    group of one rank.  A mesh of more ranks without that launcher raises
    SystemExit naming the command."""
    import tempfile

    n = dp * ty
    if int(os.environ.get("WORLD_SIZE", "1")) == n and "RANK" in os.environ:
        initialize(platform=platform)
    elif n == 1:
        store = os.path.join(tempfile.mkdtemp(prefix="tgp-mesh-"), "store")
        initialize(f"file://{store}", 1, 0, platform=platform)
    else:
        raise SystemExit(
            f"a {dp}x{ty} mesh is {n} ranks, one process each: launch with "
            f"python -m torch.distributed.run --nproc_per_node {n} -m "
            f"{module} ... (with the same flags)")
    return global_mesh(dp, ty)


def global_mesh(dp: int | None = None, ty: int = 1):
    """The (dp, ty) mesh over every rank of the process group, laid out
    rank-major as `make_mesh` lays it (dp defaults to world / ty)."""
    from .mesh import make_mesh

    n = dist.get_world_size() if dist.is_initialized() else 1
    return make_mesh(n // ty if dp is None else dp, ty)


def is_multihost(mesh) -> bool:
    """True when `mesh` spans more than one process."""
    return mesh is not None and mesh.world > 1


def local_rows(n_rows: int, mesh) -> tuple[int, int]:
    """[start, stop) of the rows this rank owns when (n_rows, ...) arrays
    are cut over the mesh's 'dp' axis (the ranks of one dp index, which
    differ in their ty index, own the same rows)."""
    dp = mesh.shape["dp"]
    if n_rows % dp:
        raise ValueError(f"{n_rows} rows not divisible by dp={dp}")
    per = n_rows // dp
    return mesh.dp_index * per, (mesh.dp_index + 1) * per


def global_batch(mesh, *arrays):
    """This rank's `local_rows` block of each array (every rank passes the
    same full batch; a mesh step cuts its rows so), on its device in the
    configured precision: a tensor there already is sliced, not copied."""
    out = []
    for a in arrays:
        lo, hi = local_rows(a.shape[0], mesh)
        out.append(torch.as_tensor(a)[lo:hi].to(cfg.default_dtype()).to(
            mesh.device))
    return out[0] if len(out) == 1 else tuple(out)


def fetch_params(tree):
    """Host numpy copies of a parameter tree.  Every rank holds the whole
    tree (a mesh cuts the outputs' work, not the parameters), so no rank
    needs another's."""
    return tree_map(lambda t: t.detach().cpu().numpy().copy(), tree)


def psum_across_processes(mesh, vec):
    """The sum over every rank of a host vector, in float64 (metric
    accumulators of large sums lose ~1e-7 relative in float32).  A
    collective: every rank calls it in lockstep."""
    vec = np.atleast_1d(np.asarray(vec, np.float64))
    if mesh.world == 1:
        return vec
    t = torch.as_tensor(vec).to(mesh.device)
    dist.all_reduce(t)
    return t.cpu().numpy()


def replicate_global(mesh, tree):
    """A tree of host arrays or tensors as tensors on this rank's device,
    with rank 0's values on every rank (every rank must pass the same
    structure and shapes)."""

    def put(x):
        t = (x.detach().clone() if torch.is_tensor(x)
             else torch.as_tensor(np.asarray(x))).to(mesh.device)
        if mesh.world > 1:
            dist.broadcast(t, src=0)
        return t

    return tree_map(put, tree)
