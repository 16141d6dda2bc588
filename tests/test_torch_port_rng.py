"""`config.set_rng_impl('rbg')` in the port: the five cases of the JAX
package's `tests/test_rng_impl.py`, on the CPU.

The port's generators are `torch.Generator`s (`config.make_rng`):
'threefry2x32' seeds one with the seed itself, 'rbg' with a second fixed
derivation of it (`config.stream_seed`).  What the JAX tests pin holds
here: the impl plumbs through the Trainer, a checkpoint resumes bit for bit
and carries the impl, the init is the same under both (and the JAX
package's, on its seeded numpy inputs, at rtol 1e-12), the streams differ
and train to the same class of result, and the battery runs, on a mesh
too: R=3 padded to dp=2 x 2 ranks (`test_torch_port_mesh_ranks.py`) equal
to the battery without a mesh at the JAX test's rtol 1e-6, atol 1e-8, with
the pad cut out.
"""

from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from tgp.pytorch_tpu.flows import generators as G, spec_from_list
from tgp.pytorch_tpu.likelihoods import LikelihoodSpec
from tgp.pytorch_tpu.models import serialization as jser, tgp as JM
from tgp.pytorch_tpu.ops import kernels as K

from tgp.pytorch_tpu_torch import config as cfg, weights
from tgp.pytorch_tpu_torch.data import ArrayDataset, DataLoader
from tgp.pytorch_tpu_torch.models.serialization import spec_to_dict
from tgp.pytorch_tpu_torch.parallel import launch
from tgp.pytorch_tpu_torch.train import Trainer
from tgp.pytorch_tpu_torch.train.multiseed import stack_trees, train_multiseed

TESTS = str(Path(__file__).resolve().parent)


@pytest.fixture(autouse=True)
def _state():
    prev = cfg.precision()
    cfg.set_precision("fp64")
    yield
    cfg.set_precision(prev)
    cfg.set_rng_impl("threefry2x32")


@pytest.fixture
def rbg():
    cfg.set_rng_impl("rbg")
    try:
        yield
    finally:
        cfg.set_rng_impl("threefry2x32")


def _id_problem(N=40, Dx=3, M=5):
    """The JAX test's tiny MC-dropout ID_TGP (its train step draws dropout
    masks every epoch): (JAX params as numpy, port spec, X, Y)."""
    rng = np.random.RandomState(0)
    X, Y = rng.randn(N, Dx), rng.randn(N, 1)
    np.random.seed(0)
    fspec, finits = spec_from_list(
        G.SAL(1, input_dependent=True, input_dim=Dx, num_hidden_layers=1,
              dropout=0.25, hidden_dim=4, hidden_activation="relu",
              inference="MC_dropout"))
    spec = JM.TGPSpec(Dy=1, Dx=Dx, M=M, N=float(N),
                      kernel=K.from_name("scale_rbf"),
                      likelihood=LikelihoodSpec("gaussian_flow", 1,
                                                quad_points=8),
                      flow=fspec)
    params = JM.init_tgp_params(spec, X, X[:M], flow_inits=finits)
    params = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64),
                                    params)
    return params, weights.spec_from_dict(jser.spec_to_dict(spec)), X, Y


def _trainer(params_np, spec, X, Y, seed):
    loaders = [DataLoader(ArrayDataset(X, Y), 64, seed=0),
               DataLoader(ArrayDataset(X, Y), 64, shuffle=False)]
    return Trainer(spec, weights.params_from_jax(params_np, device="cpu"),
                   loaders, Y_std=np.ones(1), S_test=5, seed=seed,
                   device="cpu")


def test_make_rng_impls():
    g = cfg.make_rng(3, "cpu")
    assert isinstance(g, torch.Generator) and g.initial_seed() == 3
    cfg.set_rng_impl("rbg")
    try:
        g = cfg.make_rng(3, "cpu")
        assert g.initial_seed() == cfg.stream_seed(3, "rbg") != 3
        torch.bernoulli(torch.full((3,), 0.5), generator=g)   # usable
    finally:
        cfg.set_rng_impl("threefry2x32")
    with pytest.raises(ValueError):
        cfg.set_rng_impl("pcg64")


def test_rbg_trainer_runs_and_resumes_bit_exact(rbg, tmp_path):
    params, spec, X, Y = _id_problem()
    tr_a = _trainer(params, spec, X, Y, seed=7)
    assert tr_a.rng_impl == "rbg"
    tr_a.train(10, 0.02, "adam", verbose_each=0)
    assert np.isfinite(float(tr_a.loss_curve[-1]))
    tr_a.train(10, 0.02, "adam", verbose_each=0)

    tr_b = _trainer(params, spec, X, Y, seed=7)
    tr_b.train(10, 0.02, "adam", verbose_each=0)
    tr_b.save(str(tmp_path))
    cfg.set_rng_impl("threefry2x32")     # the impl comes from the checkpoint
    tr_c = _trainer(params, spec, X, Y, seed=999)   # restore must overwrite
    assert tr_c.rng_impl == "threefry2x32"
    tr_c.restore(str(tmp_path))
    assert tr_c.rng_impl == "rbg"
    tr_c.train(10, 0.02, "adam", verbose_each=0)
    for a, b in zip(weights.tree_leaves(tr_a.params),
                    weights.tree_leaves(tr_c.params)):
        assert torch.equal(a, b)


def test_rbg_differs_from_threefry_but_same_init():
    """Same seed, different impl: the same init (and the JAX package's),
    but other dropout streams, and so other trained parameters."""
    params, spec, X, Y = _id_problem()
    tr_t = _trainer(params, spec, X, Y, seed=7)
    cfg.set_rng_impl("rbg")
    try:
        tr_r = _trainer(params, spec, X, Y, seed=7)
    finally:
        cfg.set_rng_impl("threefry2x32")
    for a, b, c in zip(weights.tree_leaves(tr_t.params),
                       weights.tree_leaves(tr_r.params),
                       jax.tree_util.tree_leaves(params)):
        assert torch.equal(a, b)
        np.testing.assert_allclose(a.detach().numpy(), c, rtol=1e-12)
    tr_t.train(10, 0.02, "adam", verbose_each=0)
    tr_r.train(10, 0.02, "adam", verbose_each=0)
    assert np.isfinite(float(tr_r.loss_curve[-1]))
    la = np.asarray(tr_t.loss_curve, dtype=np.float64)
    lb = np.asarray(tr_r.loss_curve, dtype=np.float64)
    assert not np.allclose(la, lb)      # different streams
    assert abs(la[-1] - lb[-1]) < 0.2 * abs(la[-1]) + 10.0  # same class


def _stack(params, spec, X, Y, R=3):
    stack = stack_trees([weights.params_from_jax(params, device="cpu")] * R)
    return (stack, np.broadcast_to(X, (R,) + X.shape).copy(),
            np.broadcast_to(Y, (R,) + Y.shape).copy())


def test_rbg_multiseed_battery(rbg):
    params, spec, X, Y = _id_problem()
    stack, Xs, Ys = _stack(params, spec, X, Y)
    params_stack, curves = train_multiseed(spec, stack, Xs, Ys, epochs=5,
                                           lr=0.02, seed=11, device="cpu")
    assert np.isfinite(np.asarray(curves["elbo"])).all()
    for leaf in weights.tree_leaves(params_stack):
        assert torch.isfinite(leaf).all()


def test_rbg_multiseed_battery_on_mesh(rbg, tmp_path):
    """R=3 over dp=2 (padded to 4 with a copy of the last replica, its
    data and its generator's seed), against the battery without a mesh."""
    params, spec, X, Y = _id_problem()
    stack, Xs, Ys = _stack(params, spec, X, Y)
    p_ref, c_ref = train_multiseed(spec, stack, Xs, Ys, epochs=5, lr=0.02,
                                   seed=11, device="cpu")
    torch.save(dict(precision="fp64", rng_impl="rbg",
                    spec=spec_to_dict(spec),
                    params=weights.tree_map(lambda t: t.detach(), stack),
                    X=Xs, Y=Ys, epochs=5, lr=0.02, seed=11),
               tmp_path / "inputs.pt")
    md5s = launch.run_ranks(2, "test_torch_port_mesh_ranks:battery_on_mesh",
                            {"workdir": str(tmp_path), "dp": 2},
                            platform="cpu", timeout=300, workdir=str(tmp_path),
                            env={"PYTHONPATH": TESTS})
    assert md5s[0] == md5s[1]
    got = torch.load(tmp_path / "results.pt", weights_only=False)
    assert got["curves"]["elbo"].shape == (5, 3)     # the pad cut out
    np.testing.assert_allclose(got["curves"]["elbo"], c_ref["elbo"],
                               rtol=1e-6)
    for a, b in zip(got["params"], weights.tree_leaves(p_ref)):
        np.testing.assert_allclose(a, b.numpy(), rtol=1e-6, atol=1e-8)
