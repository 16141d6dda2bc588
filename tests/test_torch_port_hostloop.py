"""The Trainer's host loop, `track_fn` and `spec.remat` against the JAX
package, on the CPU, fp64.

  * `tests/test_minibatch_path.py` mirrored: the port's host loop
    (`DEVICE_RESIDENT_BYTES = 0`) against its device-resident minibatch
    path (the same rows in the same order through the same ops: bitwise,
    beside JAX's rtol 5e-5, atol 1e-6), and against the JAX Trainer's host
    loop at rtol 1e-8, atol 1e-10 (the per-step curves, the metrics, the
    flagship's parameters; `tests/test_minibatch_path.py`'s model's
    parameters at 10x their measured gap);
  * `track_fn`: called once a step, with no read of the device forced;
    the JAX Trainer with the same `track_fn` on one batch (the host loop
    there too) at rtol 1e-8, atol 1e-10; a host-loop run resumed from a
    checkpoint bitwise the uninterrupted one; L-BFGS refused with the JAX
    message;
  * `tests/test_remat.py` mirrored: the ELBO with remat against the plain
    one at JAX's rtol 1e-12, the gradients at rtol 1e-9, atol 1e-12, and
    both bitwise within the port; against the JAX package's remat ELBO and
    gradient at rtol 1e-8, atol 1e-10; an ID_TGP Trainer step with remat
    bitwise a plain one, its generator left where a plain step leaves it.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tgp.pytorch_tpu.data.batching import ArrayDataset as JDataset, \
    DataLoader as JLoader
from tgp.pytorch_tpu.flows import generators as jG, spec_from_list as j_spec
from tgp.pytorch_tpu.likelihoods import LikelihoodSpec as JLik
from tgp.pytorch_tpu.models import serialization as jser, tgp as JM
from tgp.pytorch_tpu.ops import kernels as jK
from tgp.pytorch_tpu.train import Trainer as JTrainer

from tgp.pytorch_tpu_torch import config as pcfg, weights
from tgp.pytorch_tpu_torch.data import ArrayDataset, DataLoader
from tgp.pytorch_tpu_torch.models import tgp as PM
from tgp.pytorch_tpu_torch.train import Trainer
import test_torch_port_train as _train_mod

F64 = dict(rtol=1e-8, atol=1e-10)


@pytest.fixture(autouse=True)
def _port_state():
    prev, dt, nt = pcfg.precision(), torch.get_default_dtype(), \
        torch.get_num_threads()
    pcfg.set_precision("fp64")
    torch.set_num_threads(1)
    yield
    pcfg.set_precision(prev)
    torch.set_num_threads(nt)
    assert torch.get_default_dtype() == dt


def _equal_trees(a, b):
    la, lb = weights.tree_leaves(a), weights.tree_leaves(b)
    assert len(la) == len(lb) > 0
    for x, y in zip(la, lb):
        assert torch.equal(x.detach(), y.detach())


def _close_to_jax(tr_p, tr_j, ctol, ptol):
    """Curves at `ctol`, parameters at `ptol`."""
    for attr in ("loss_curve", "ell_curve", "kld_curve"):
        np.testing.assert_allclose(np.asarray(getattr(tr_p, attr)),
                                   [float(v) for v in getattr(tr_j, attr)],
                                   err_msg=attr, **ctol)
    jl = jax.tree_util.tree_leaves_with_path(tr_j.params)
    pl = weights.tree_leaves(tr_p.params)
    assert len(jl) == len(pl)
    for (path, a), b in zip(jl, pl):
        np.testing.assert_allclose(b.detach().numpy(), np.asarray(a),
                                   err_msg=jax.tree_util.keystr(path), **ptol)


# ---------------------------------------------------------------------------
# the host loop
# ---------------------------------------------------------------------------

def _setup(flow=False):
    """`tests/test_minibatch_path.py::_setup` (70 rows, Dx=3, M=5, batch
    32: two full batches and a tail of 6); `flow` adds SAL(1) through 10
    GH nodes."""
    rng = np.random.RandomState(0)
    X = rng.randn(70, 3)
    Y = rng.randn(70, 1)
    kw = dict(likelihood=JLik("gaussian", 1))
    inits = None
    if flow:
        np.random.seed(0)
        fspec, inits = j_spec(jG.SAL(1))
        kw = dict(likelihood=JLik("gaussian_flow", 1, quad_points=10),
                  flow=fspec)
    spec = JM.TGPSpec(Dy=1, Dx=3, M=5, N=70.0,
                      kernel=jK.from_name("scale_rbf"), **kw)
    params = jax.tree_util.tree_map(np.asarray, JM.init_tgp_params(
        spec, X, X[:5], flow_inits=inits))
    return spec, params, X, Y


def _trainer(pkg, batch=32, flow=False, resident=True, seed=1, **kw):
    spec, pn, X, Y = _setup(flow)
    if pkg == "jax":
        tr = JTrainer(spec, jax.tree_util.tree_map(jnp.asarray, pn),
                      [JLoader(JDataset(X, Y), batch, seed=3),
                       JLoader(JDataset(X, Y), 32, shuffle=False)],
                      Y_std=np.ones(1), S_test=10, seed=seed, **kw)
    else:
        tr = Trainer(weights.spec_from_dict(jser.spec_to_dict(spec)),
                     weights.params_from_jax(pn, device="cpu"),
                     [DataLoader(ArrayDataset(X, Y), batch, seed=3),
                      DataLoader(ArrayDataset(X, Y), 32, shuffle=False)],
                     Y_std=np.ones(1), S_test=10, seed=seed, device="cpu",
                     **kw)
    if not resident:
        tr.DEVICE_RESIDENT_BYTES = 0        # force the host loop
    return tr


@pytest.mark.parametrize("flow", [False, True], ids=["svgp", "sal"])
def test_device_path_matches_host_loop(flow):
    p_dev = _trainer("port", flow=flow)
    p_dev.train(5, 0.05, "adam", verbose_each=0)
    p_host = _trainer("port", flow=flow, resident=False)
    p_host.train(5, 0.05, "adam", verbose_each=0)
    for a, b in zip(weights.tree_leaves(p_dev.params),
                    weights.tree_leaves(p_host.params)):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   rtol=5e-5, atol=1e-6)
    _equal_trees(p_dev.params, p_host.params)
    # the device path keeps each epoch's last full batch; the host loop
    # every step (2 full batches and the tail an epoch)
    assert len(p_dev.loss_curve) == 5 and len(p_host.loss_curve) == 15
    np.testing.assert_array_equal(p_dev.loss_curve, p_host.loss_curve[1::3])


def _flagship_pair(batch):
    """The port's and the JAX Trainer on 300 power rows with the flagship's
    perturbed init (`tests/test_torch_port_train.py::_trainers`), with the
    host loop forced."""
    tr_p, tr_j = _train_mod._trainers(300, batch)
    tr_p.DEVICE_RESIDENT_BYTES = tr_j.DEVICE_RESIDENT_BYTES = 0
    return tr_p, tr_j


@pytest.mark.parametrize("case", ["flagship", "prior_init"])
def test_host_loop_matches_the_jax_host_loop(case):
    """The flagship: 3 epochs of 2 batches of 128 and a tail of 44, curves,
    parameters and metrics at rtol 1e-8, atol 1e-10.  `prior_init` is
    `tests/test_minibatch_path.py`'s model, q(U) at the whitened prior: the
    ELBO's gradient in Z is a cancellation there, which the two packages
    round differently, and Adam's normalisation turns that into a step of
    lr times the relative rounding (measured on the CPU in fp64 after 5
    epochs: parameters at most 4.1e-8 apart at lr 0.05, 2.3e-9 at lr 0.01,
    about as far already after the first epoch).  So it runs at lr 0.01,
    its curves and metrics held at rtol 1e-8, atol 1e-10 and its
    parameters at rtol 1e-8, atol 2.5e-8 (10x that gap)."""
    if case == "flagship":
        tr_p, tr_j = _flagship_pair(128)
        epochs, lr, steps, ptol = 3, 0.01, 9, F64
    else:
        tr_p = _trainer("port", flow=True, resident=False)
        tr_j = _trainer("jax", flow=True, resident=False)
        epochs, lr, steps, ptol = 5, 0.01, 15, dict(rtol=1e-8, atol=2.5e-8)
    tr_p.train(epochs, lr, "adam", verbose_each=0)
    tr_j.train(epochs, lr, "adam", verbose_each=0)
    assert len(tr_p.loss_curve) == len(tr_j.loss_curve) == steps
    _close_to_jax(tr_p, tr_j, F64, ptol)
    mp, mj = tr_p.compute_metrics(), tr_j.compute_metrics()
    for k in ("logL", "rmse"):
        np.testing.assert_allclose(mp["test"][k], mj["test"][k], **F64)


def test_track_fn_runs_once_a_step_without_a_read():
    """One call after every step; a track_fn that reads nothing leaves
    every step's row on the device (pending), one that reads the curves
    sees them grow by one a step (`tests/test_plateau_recovery.py`'s use)."""
    pending, lengths = [], []
    tr = _trainer("port", track_fn=lambda t: pending.append(len(t._pending)))
    tr.train(4, 0.05, "adam", verbose_each=0)
    assert pending == list(range(1, 13))
    assert len(tr.loss_curve) == 12 and not tr._pending
    tr2 = _trainer("port", track_fn=lambda t: lengths.append(
        len(t.loss_curve)))
    tr2.train(4, 0.05, "adam", verbose_each=0)
    assert lengths == list(range(1, 13))
    np.testing.assert_array_equal(tr.loss_curve, tr2.loss_curve)


def test_track_fn_matches_the_jax_trainer():
    """A track_fn sends a one-batch loader through the host loop in both
    packages: 6 steps of the flagship at rtol 1e-8, atol 1e-10."""
    seen_p, seen_j = [], []
    tr_p, tr_j = _flagship_pair(10000)
    tr_p.track_fn = lambda t: seen_p.append(1)
    tr_j.track_fn = lambda t: seen_j.append(len(t.loss_curve))
    tr_p.train(6, 0.01, "adam", verbose_each=0)
    tr_j.train(6, 0.01, "adam", verbose_each=0)
    assert len(seen_p) == 6 and seen_j == list(range(1, 7))
    _close_to_jax(tr_p, tr_j, F64, F64)


def test_host_loop_resumes_bit_for_bit(tmp_path):
    """Interrupt after 3 of 6 epochs, restore into a fresh Trainer (another
    seed on purpose), continue: the same bits as the uninterrupted run
    (parameters, curves, generator, shuffle position)."""
    calls = []
    mk = lambda seed=1: _trainer("port", flow=True, resident=False,  # noqa: E731
                                 seed=seed, track_fn=lambda t: calls.append(1))
    a = mk()
    a.train(3, 0.05, "adam", verbose_each=0)
    a.train(3, 0.05, "adam", verbose_each=0)
    b = mk()
    b.train(3, 0.05, "adam", verbose_each=0)
    b.save(str(tmp_path))
    c = mk(seed=99)
    assert c.restore(str(tmp_path)) == 9
    c.train(3, 0.05, "adam", verbose_each=0)
    _equal_trees(a.params, c.params)
    np.testing.assert_array_equal(a.loss_curve[9:], c.loss_curve)
    assert torch.equal(a._gen.get_state(), c._gen.get_state())
    assert (a.train_loader._rng.bit_generator.state
            == c.train_loader._rng.bit_generator.state)
    assert len(calls) == 18 + 9 + 9


def test_lbfgs_with_a_track_fn_is_refused_as_jax_refuses_it():
    msgs = []
    for pkg in ("port", "jax"):
        tr = _trainer(pkg, batch=100, track_fn=lambda t: None)
        with pytest.raises(NotImplementedError) as e:
            tr.train(3, 0.0, "lbfgs", verbose_each=0)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and "track_fn" in msgs[0]


# ---------------------------------------------------------------------------
# remat
# ---------------------------------------------------------------------------

def _remat_case():
    """`tests/test_remat.py`'s model: SAL(2), Dx=3, M=8, 32 GH nodes."""
    np.random.seed(0)
    N, Dx = 60, 3
    X = np.random.randn(N, Dx)
    Y = np.random.randn(N, 1)
    fspec, finits = j_spec(jG.SAL(2))
    spec = JM.TGPSpec(Dy=1, Dx=Dx, M=8, N=float(N),
                      kernel=jK.from_name("scale_rbf"),
                      likelihood=JLik("gaussian_flow", 1, quad_points=32),
                      flow=fspec)
    params = JM.init_tgp_params(spec, X, X[:8], flow_inits=finits)
    return spec, params, X, Y


def _port_value_and_grad(spec, params, X, Y):
    leaves = weights.tree_leaves(params)
    e = PM.elbo(spec, params, torch.as_tensor(X), torch.as_tensor(Y))[0]
    return e.detach(), torch.autograd.grad(-e, leaves, allow_unused=True,
                                           materialize_grads=True)


def test_remat_matches_plain():
    spec_j, pj, X, Y = _remat_case()
    spec = weights.spec_from_dict(jser.spec_to_dict(spec_j))
    params = weights.tree_map(lambda t: t.requires_grad_(True),
                              weights.params_from_jax(pj, device="cpu"))
    e0, g0 = _port_value_and_grad(spec, params, X, Y)
    e1, g1 = _port_value_and_grad(dataclasses.replace(spec, remat=True),
                                  params, X, Y)
    np.testing.assert_allclose(float(e0), float(e1), rtol=1e-12)
    for a, b in zip(g0, g1):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-9,
                                   atol=1e-12)
        assert torch.equal(a, b)
    assert torch.equal(e0, e1)
    # against the JAX package's remat ELBO and its gradient
    spec_jr = dataclasses.replace(spec_j, remat=True)
    Xj, Yj = jnp.asarray(X), jnp.asarray(Y)
    ej = JM.elbo(spec_jr, pj, Xj, Yj)[0]
    gj = jax.grad(lambda p: -JM.elbo(spec_jr, p, Xj, Yj)[0])(pj)
    np.testing.assert_allclose(float(e1), float(ej), **F64)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(gj), g1):
        np.testing.assert_allclose(b.numpy(), np.asarray(a),
                                   err_msg=jax.tree_util.keystr(path), **F64)


@pytest.mark.parametrize("inference", ["MC_dropout", "mean_field_gaussian"])
def test_remat_id_tgp_step_replays_the_draws(inference):
    """An ID_TGP step with remat: the recompute replays the dropout masks
    or VI noise drawn in the forward, so the step is bitwise a plain one
    and the generator ends where a plain step leaves it."""
    rng = np.random.RandomState(0)
    X, Y = rng.randn(40, 3), rng.randn(40, 1)
    np.random.seed(0)
    from tgp.pytorch_tpu_torch.flows import generators as G, spec_from_list
    from tgp.pytorch_tpu_torch.likelihoods import LikelihoodSpec
    from tgp.pytorch_tpu_torch.ops import kernels as K
    fspec, finits = spec_from_list(G.SAL(
        1, input_dependent=True, input_dim=3, hidden_dim=5,
        dropout=0.3 if inference == "MC_dropout" else 0.0,
        inference=inference))
    spec = PM.TGPSpec(Dy=1, Dx=3, M=5, N=40.0,
                      kernel=K.from_name("scale_rbf"),
                      likelihood=LikelihoodSpec("gaussian_flow", 1,
                                                quad_points=16), flow=fspec)
    assert spec.has_stochastic_flow
    params = PM.init_tgp_params(spec, X, X[:5], flow_inits=finits,
                                device="cpu")
    trs = []
    for remat in (False, True):
        tr = Trainer(dataclasses.replace(spec, remat=remat), params,
                     [DataLoader(ArrayDataset(X, Y), 64, seed=0)],
                     np.ones(1), seed=5, device="cpu")
        tr.train(3, 0.02, "adam", verbose_each=0)
        trs.append(tr)
    _equal_trees(trs[0].params, trs[1].params)
    np.testing.assert_array_equal(trs[0].loss_curve, trs[1].loss_curve)
    assert torch.equal(trs[0]._gen.get_state(), trs[1]._gen.get_state())
