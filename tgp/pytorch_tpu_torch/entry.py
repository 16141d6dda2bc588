"""Entry points of the port: the flagship TGP's ELBO and the multi-rank
dry run, the counterparts of `__graft_entry__.py::_flagship`, `entry` and
`dryrun_multichip`.

    python -m tgp.pytorch_tpu_torch.entry      # on the card; prints the ELBO
    python -c "from tgp.pytorch_tpu_torch import entry; \
        entry.dryrun_multichip(4)"             # 4 CPU ranks under gloo
"""

from __future__ import annotations

import dataclasses
import shutil
import tempfile

import numpy as np
import torch

from . import config as cfg, weights
from .likelihoods.gaussian import LikelihoodSpec
from .models import tgp as tgp_mod


def _flagship(device=None, Dy=1, Dx=4, M=64, N=512, quad=100):
    """The flagship model (a 2-block SAL flow, a scale-RBF ARD kernel, 100
    Gauss-Hermite nodes) at N=512, M=64 on seeded random data: (spec,
    params, X, Y) with X (N, Dx) and Y (N, Dy) numpy arrays in the
    configured precision."""
    rng = np.random.RandomState(0)
    X = rng.randn(N, Dx)
    Y = rng.randn(N, Dy)
    spec = weights.flagship_spec(N, Dx=Dx, M=M, quad=quad)
    if Dy != 1:
        spec = dataclasses.replace(spec, Dy=Dy, likelihood=LikelihoodSpec(
            "gaussian_flow", Dy, quad_points=quad))
    params = weights.flagship_init(spec, X, variance_scale=1e-5, device=device)
    np_dt = np.float64 if cfg.default_dtype() == torch.float64 else np.float32
    return spec, params, X.astype(np_dt), Y.astype(np_dt)


def entry(device=None):
    """(fn, example_args): the ELBO of the flagship at N=512, M=64, with
    fn(params, X, Y) -> the ELBO as a 0-d tensor."""
    spec, params, X, Y = _flagship(device=device)

    def fn(params, X, Y):
        return tgp_mod.elbo(spec, params, X, Y)[0]

    dev = params["Z"].device
    return fn, (params, torch.from_numpy(X).to(dev), torch.from_numpy(Y).to(dev))


def dryrun_multichip(n_devices: int) -> dict:
    """Train the flagship on an n_devices mesh of CPU ranks under gloo
    (`parallel/launch.py`) and check it against the run without a mesh:
    one sharded step (dp x ty, ty = 2 where n is even); a 50-epoch fp64
    Trainer segment and its evaluation equal to the unsharded ones; a
    checkpoint saved and restored on the mesh continuing bit for bit; and a
    battery sharded by seed.  Raises on a failed check; returns rank 0's
    numbers."""
    from .parallel.launch import run_ranks

    if n_devices < 2:
        # a one-rank "mesh" exercises no sharding at all
        raise ValueError(
            f"dryrun_multichip needs n_devices >= 2, got {n_devices}")
    out = run_ranks(n_devices, "tgp.pytorch_tpu_torch.entry:_dryrun_rank",
                    platform="cpu", timeout=900)
    if len({(r["params_md5"], r["elbo"]) for r in out}) != 1:
        raise AssertionError(f"ranks disagree: {out}")
    r = out[0]
    print(f"dryrun_multichip ok: mesh dp={r['dp']} ty={r['ty']}, "
          f"ELBO={r['elbo']:.4f}, 50-step segment + sharded eval + ckpt "
          f"resume all match unsharded")
    return r


def _dryrun_rank():
    """A rank of `dryrun_multichip` (in a process that joined the group)."""
    import hashlib

    from . import parallel
    from .data.batching import ArrayDataset, DataLoader
    from .parallel import multihost
    from .train import Trainer, multiseed as ms
    from .weights import tree_leaves

    prev = cfg.precision()
    n = torch.distributed.get_world_size()
    ty = 2 if n % 2 == 0 else 1
    dp = n // ty
    Dy, MB = 2 * ty, 8 * dp
    mesh = parallel.make_mesh(dp=dp, ty=ty)
    dev = mesh.device
    try:
        cfg.set_precision("fp32")
        spec, params, X, Y = _flagship(dev, Dy=Dy, Dx=3, M=8, N=MB, quad=16)
        Y = np.tile(Y[:, :1], (1, Dy))
        leaves = tree_leaves(params)
        for t in leaves:
            t.requires_grad_(True)
        opt = torch.optim.Adam(leaves, lr=1e-2)
        step = parallel.make_sharded_train_step(spec, opt, mesh)
        Xs, Ys = parallel.shard_batch(mesh, X, Y)
        _, _, (elbo, _, _) = step(params, None, Xs, Ys,
                                  cfg.make_rng(0, dev))
        if not torch.isfinite(elbo):
            raise AssertionError("the sharded step's ELBO is not finite")

        # the seed axis over dp: R = n replicas
        spec1, params1, X1, Y1 = _flagship(dev, Dy=1, Dx=3, M=8, N=32,
                                           quad=8)
        R = n
        stack = ms.stack_trees([params1] * R)
        _, curves = ms.train_multiseed(
            spec1, stack, np.broadcast_to(X1, (R,) + X1.shape),
            np.broadcast_to(Y1, (R,) + Y1.shape), epochs=2, lr=1e-2,
            mesh=mesh)
        if not np.isfinite(curves["elbo"]).all():
            raise AssertionError("the sharded battery is not finite")

        # a 50-epoch fp64 segment against the run without a mesh, its
        # evaluation, and a checkpoint resumed on the mesh
        cfg.set_precision("fp64")
        spec2, params2, X2, Y2 = _flagship("cpu", Dy=Dy, Dx=3, M=8, N=MB,
                                           quad=16)
        Y2 = np.tile(Y2[:, :1], (1, Dy))

        def make_trainer(mesh_):
            loaders = [DataLoader(ArrayDataset(X2, Y2), MB, seed=3),
                       DataLoader(ArrayDataset(X2, Y2), MB, shuffle=False)]
            return Trainer(spec2, params2, loaders, Y_std=np.ones(Dy),
                           S_test=8, seed=3, mesh=mesh_, device=dev)

        tr_ref, tr_sh = make_trainer(None), make_trainer(mesh)
        tr_ref.train(50, 0.03, "adam", verbose_each=0)
        tr_sh.train(50, 0.03, "adam", verbose_each=0)
        for a, b in zip(tree_leaves(tr_ref.params), tree_leaves(tr_sh.params)):
            np.testing.assert_allclose(b.detach().cpu().numpy(),
                                       a.detach().cpu().numpy(),
                                       rtol=1e-6, atol=1e-7)
        m_ref = tr_ref.compute_metrics()["test"]
        m_sh = tr_sh.compute_metrics()["test"]
        for k in ("logL", "rmse"):
            np.testing.assert_allclose(m_sh[k], m_ref[k], rtol=1e-5, atol=1e-6)
        ck = tempfile.mkdtemp(prefix="dryrun-ckpt-") if mesh.rank == 0 else ""
        ck = _broadcast_path(mesh, ck)
        tr_sh.save(ck)
        tr_new = make_trainer(mesh)
        tr_new.restore(ck)
        tr_sh.train(10, 0.03, "adam", verbose_each=0)
        tr_new.train(10, 0.03, "adam", verbose_each=0)
        for a, b in zip(tree_leaves(tr_sh.params), tree_leaves(tr_new.params)):
            if not torch.equal(a, b):
                raise AssertionError("the resumed run is not bitwise")
        torch.distributed.barrier()
        if mesh.rank == 0:
            shutil.rmtree(ck, ignore_errors=True)
        flat = np.concatenate([multihost.fetch_params(t).ravel()
                               for t in tree_leaves(tr_sh.params)])
        return dict(dp=dp, ty=ty, elbo=float(elbo),
                    params_md5=hashlib.md5(flat.tobytes()).hexdigest())
    finally:
        cfg.set_precision(prev)


def _broadcast_path(mesh, path: str) -> str:
    """Rank 0's `path` on every rank (a directory that rank 0 made)."""
    obj = [path]
    if mesh.world > 1:
        torch.distributed.broadcast_object_list(obj, src=0)
    return obj[0]


if __name__ == "__main__":
    fn, args = entry()
    print("entry ok, ELBO =", float(fn(*args)))
