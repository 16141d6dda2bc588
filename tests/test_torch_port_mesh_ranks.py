"""The ranks' side of `test_torch_port_mesh.py` and `test_torch_port_rng.py`:
functions that `parallel.launch.run_ranks` calls in each rank's process
(which joined a gloo group on the CPU).  It imports only the port, and holds
no tests.

The parent writes each case's inputs (the port's spec as a dict, the params
as numpy arrays, the data) to `inputs.pt` in a work directory; rank 0 writes
what the ranks computed to `results.pt` there, and every rank returns an md5
of each case's parameters, so that the parent can check that the ranks
hold the same bits.
"""

import hashlib
import os

import numpy as np
import torch

from tgp.pytorch_tpu_torch import config as cfg, weights
from tgp.pytorch_tpu_torch.data import ArrayDataset, DataLoader
from tgp.pytorch_tpu_torch.parallel import make_mesh, mesh as pmesh
from tgp.pytorch_tpu_torch.train import Trainer, multiseed as ms


def md5(tensors) -> str:
    flat = [np.ascontiguousarray(t.detach().cpu().numpy()).tobytes()
            for t in tensors]
    return hashlib.md5(b"".join(flat)).hexdigest()


def host(tensors):
    return [t.detach().cpu().numpy().copy() for t in tensors]


def trainer(case, mesh, device="cpu"):
    """The Trainer of a case: full batch or minibatch at case["batch"],
    trained case["epochs"] epochs of Adam at case["lr"] (natgrad gamma
    case["natgrad"] when given)."""
    spec = weights.spec_from_dict(case["spec"])
    params = weights.params_from_jax(case["params"], device=device)
    X, Y = case["X"], case["Y"]
    Xte, Yte = case.get("Xte", X), case.get("Yte", Y)
    loaders = [DataLoader(ArrayDataset(X, Y), case["batch"],
                          seed=case["loader_seed"]),
               DataLoader(ArrayDataset(Xte, Yte), case["batch"],
                          shuffle=False)]
    tr = Trainer(spec, params, loaders, Y_std=np.ones(Y.shape[1]),
                 S_test=case["S_test"], seed=case["seed"], mesh=mesh,
                 device=None if mesh is not None else device)
    tr.train(case["epochs"], case["lr"], "adam", verbose_each=0,
             natgrad_gamma=case.get("natgrad"))
    return tr


def run_case(case, mesh, device="cpu"):
    """What a case computes, with or without a mesh: a dict of host arrays
    and the md5 of its parameters."""
    cfg.set_precision(case["precision"])
    kind = case["kind"]
    spec = weights.spec_from_dict(case["spec"])
    dev = mesh.device if mesh is not None else torch.device(device)
    dt = cfg.default_dtype()
    X = torch.as_tensor(case["X"], dtype=dt, device=dev)
    Y = torch.as_tensor(case["Y"], dtype=dt, device=dev)
    if kind in ("elbo", "grads"):
        params = weights.params_from_jax(case["params"], device=dev)
        leaves = weights.tree_leaves(params)
        for t in leaves:
            t.requires_grad_(True)
        if mesh is None:
            from tgp.pytorch_tpu_torch.models import tgp as PM
            e = PM.elbo(spec, params, X, Y)[0]
            g = torch.autograd.grad(e, leaves)
            e = e.detach()
        else:
            e, _, _, g = pmesh.value_and_grad(
                spec, params, X, Y, None, mesh, leaves,
                weights.tree_leaves(pmesh.gp_leaves(params)))
            g = [-t for t in g]
        return {"elbo": float(e), "grads": host(g)}, md5(g)
    if kind == "step":
        params = weights.params_from_jax(case["params"], device=dev)
        leaves = weights.tree_leaves(params)
        for t in leaves:
            t.requires_grad_(True)
        opt = torch.optim.Adam(leaves, lr=case["lr"])
        step = (pmesh.make_sharded_train_step(spec, opt, mesh)
                if mesh is not None else None)
        if step is None:
            from tgp.pytorch_tpu_torch.models import tgp as PM
            e = PM.elbo(spec, params, X, Y)[0]
            for p, g in zip(leaves, torch.autograd.grad(-e, leaves)):
                p.grad = g
            opt.step()
        else:
            step(params, None, X, Y, None)
        return {"params": host(leaves)}, md5(leaves)
    tr = trainer(case, mesh, device)
    out = {"params": host(weights.tree_leaves(tr.params)),
           "loss_curve": np.asarray(tr.loss_curve, np.float64)}
    if case.get("metrics"):
        out["metrics"] = tr.compute_metrics()
    return out, md5(weights.tree_leaves(tr.params))


def cluster(workdir):
    """Every case of `inputs.pt` on its mesh of this group's ranks; meshes
    are made in the order the cases list them, on every rank."""
    cases = torch.load(os.path.join(workdir, "inputs.pt"),
                       weights_only=False)
    meshes, results, md5s = {}, {}, {}
    for name, case in cases.items():
        shape = tuple(case["mesh"])
        if shape not in meshes:
            meshes[shape] = make_mesh(*shape)
        results[name], md5s[name] = run_case(case, meshes[shape])
    if torch.distributed.get_rank() == 0:
        torch.save(results, os.path.join(workdir, "results.pt"))
    return md5s


def battery_on_mesh(workdir, dp):
    """`train_multiseed` of `inputs.pt`'s stack on a dp x 1 mesh, under the
    rng impl it names; rank 0 writes params and curves."""
    d = torch.load(os.path.join(workdir, "inputs.pt"), weights_only=False)
    cfg.set_precision(d["precision"])
    cfg.set_rng_impl(d["rng_impl"])
    mesh = make_mesh(dp, 1)
    spec = weights.spec_from_dict(d["spec"])
    params, curves = ms.train_multiseed(spec, d["params"], d["X"], d["Y"],
                                        epochs=d["epochs"], lr=d["lr"],
                                        seed=d["seed"], mesh=mesh)
    leaves = weights.tree_leaves(params)
    if mesh.rank == 0:
        torch.save({"params": host(leaves), "curves": curves},
                   os.path.join(workdir, "results.pt"))
    return md5(leaves)
