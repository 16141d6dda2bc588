"""The port's training slice against the JAX package, on the CPU, fp64.

Inputs come from numpy seeds and go through both packages; parameters pass
between them as numpy arrays (`weights.params_to_numpy`,
`weights.params_from_jax`).  Tolerances:
  * functions (the KLs, the ELLs, the flagship ELBO) in value and gradient:
    rtol 1e-8, atol 1e-10 — the same float64 math on both sides, only the
    order of sums differs;
  * the grouped Adam family: rtol 1e-10 (elementwise; only the rounding of
    a few scalar operations differs);
  * Trainer runs (40 full-batch steps of adam or sgd, or 3 minibatch
    epochs): the ELBO,
    ELL and KL curves at rtol 1e-13, the final parameters at atol 1e-11, and
    logL and RMSE of the trained model at rtol 1e-13.  Each is 10x the
    largest gap measured with torch on 1, 3 and all threads (9.8e-15
    relative, 4.7e-13 absolute on parameters of order 1, 1.1e-15
    relative), rounded up to a power of ten, and tighter than rtol 1e-7,
    atol 1e-9.  Coverage comes from other random streams than JAX's, so it
    is held within 3 binomial standard errors;
  * the input-dependent options (a fully-Bayesian evaluation, a flow with
    batch-norm hypernets trained 6 steps), with the JAX package's masks
    replayed: rtol 1e-8, atol 1e-10; the batch-norm flow's parameters at
    atol 2.7e-8 (10x the measured gap: the biases that feed batch norm have
    a gradient of rounding noise beside their weight decay).
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tgp.pytorch_tpu.data.batching import ArrayDataset as JDataset, \
    DataLoader as JLoader
from tgp.pytorch_tpu.flows import generators as jG, spec_from_list as j_spec_from_list
from tgp.pytorch_tpu.likelihoods import LikelihoodSpec as JLik
from tgp.pytorch_tpu.likelihoods import gaussian as jgauss
from tgp.pytorch_tpu.models import serialization as jser, tgp as JM
from tgp.pytorch_tpu.ops import kernels as jK
from tgp.pytorch_tpu.ops import linalg as jlinalg
from tgp.pytorch_tpu.train import Trainer as JTrainer
from tgp.pytorch_tpu.train import metrics as jmetrics
from tgp.pytorch_tpu.train import group_adam as JGA
from tgp.pytorch_tpu.train import optimizers as jopt
from tgp.pytorch_tpu.train.trainer import frozen_param_labels as j_frozen
import __graft_entry__

from tgp.pytorch_tpu_torch import bench, config as pcfg, entry, weights
from tgp.pytorch_tpu_torch.data import ArrayDataset, DataLoader, return_dataset
from tgp.pytorch_tpu_torch.likelihoods import gaussian as pgauss
from tgp.pytorch_tpu_torch.models import tgp as PM
from tgp.pytorch_tpu_torch.ops import linalg as plinalg
from tgp.pytorch_tpu_torch.train import Trainer, group_adam as GA, metrics
from tgp.pytorch_tpu_torch.train import optimizers as popt
from tgp.pytorch_tpu_torch.train.trainer import frozen_param_labels

F64 = dict(rtol=1e-8, atol=1e-10)
CURVES = dict(rtol=1e-13, atol=0)
PARAMS = dict(rtol=0, atol=1e-11)
METRICS = dict(rtol=1e-13, atol=0)
BN_TRAIN = dict(rtol=1e-8, atol=2.7e-8)
M_SMALL, N_SMALL, Q_SMALL = 16, 512, 20


@pytest.fixture(autouse=True)
def _port_state():
    """Port precision fp64 for the test; torch's default dtype untouched."""
    prev, dt = pcfg.precision(), torch.get_default_dtype()
    pcfg.set_precision("fp64")
    yield
    pcfg.set_precision(prev)
    assert torch.get_default_dtype() == dt


def t64(a):
    """A float64 tensor that owns its memory: the in-place optimizer must
    not write into arrays that JAX reads."""
    return torch.tensor(np.asarray(a, np.float64))


def close(port, ref, **tol):
    np.testing.assert_allclose(port.detach().cpu().numpy(), np.asarray(ref),
                               **(tol or F64))


def close_trees(port, ref, **tol):
    pl, rl = weights.tree_leaves(port), weights.tree_leaves(ref)
    assert len(pl) == len(rl) > 0
    for p, r in zip(pl, rl):
        close(p, r, **tol)


def _power():
    return return_dataset("power", 10000, seed=1)[1]


def _specs(N, M, quad, min_var=1e-8):
    """The flagship's spec in both packages: SAL 2, scale-RBF ARD, whitened
    q(U), the gaussian_flow likelihood, Dy=1, Dx=4."""
    fspec, _ = j_spec_from_list(jG.SAL(2))
    spec_j = JM.TGPSpec(Dy=1, Dx=4, M=M, N=float(N),
                        kernel=jK.from_name("scale_rbf"),
                        likelihood=JLik("gaussian_flow", 1, quad_points=quad),
                        flow=fspec, min_var=min_var)
    spec_p = dataclasses.replace(weights.flagship_spec(N, M=M, quad=quad),
                                 min_var=min_var)
    return spec_j, spec_p


def _perturbed(spec_p, X, seed=0):
    """The flagship's init perturbed (so that q(U), the flow and the kernel
    are not at their identities): the port's params and their numpy copy."""
    pp = weights.flagship_params(spec_p, X, seed=seed, device="cpu")
    return pp, weights.params_to_numpy(pp)


# ---------------------------------------------------------------------------
# the objective's pieces: value and gradient
# ---------------------------------------------------------------------------

def _grad_case(which, rng):
    """(port fn, jax fn, numpy inputs) for one piece of the ELBO; each fn
    maps its inputs to an array whose weighted sum is differentiated."""
    Dy, M, MB = 2, 7, 9
    spec_j, spec_p = _specs(50, M, 12)
    m = rng.randn(Dy, M)
    L = np.tril(rng.randn(Dy, M, M)) * 0.3 + np.eye(M)
    Y, mu = rng.randn(Dy, MB), rng.randn(Dy, MB)
    var = rng.rand(Dy, MB) + 0.1
    lvn = np.log(rng.rand(Dy, 1) + 0.05)
    lik_p = pgauss.LikelihoodSpec("gaussian_flow", Dy, quad_points=12)
    lik_j = JLik("gaussian_flow", Dy, quad_points=12)
    if which == "kl_whitened":
        return plinalg.kl_whitened, jlinalg.kl_whitened, (m, L)
    if which == "kld_qu":
        sp = dataclasses.replace(spec_p, Dy=Dy)
        sj = dataclasses.replace(spec_j, Dy=Dy)
        return ((lambda m, L: PM.kld_qu(sp, {"q_mu": m, "q_L": L})),
                (lambda m, L: JM.kld_qu(sj, {"q_mu": m, "q_L": L})), (m, L))
    if which == "gaussian_ell":
        return ((lambda lv, Y, mu, var: pgauss.gaussian_ell(
                    lik_p, {"log_var_noise": lv}, Y, mu, var)),
                (lambda lv, Y, mu, var: jgauss.gaussian_ell(
                    lik_j, {"log_var_noise": lv}, Y, mu, var)),
                (lvn, Y, mu, var))
    # gaussian_flow_ell through the SAL 2 flow, with perturbed flow params
    fa, fb = 0.3 * rng.randn(2, 4)

    def flow(a, b, like):
        return [{"a": like(a[k]), "b": like(b[k])} for k in range(4)]

    def port(lv, Y, mu, var, a, b):
        sp = dataclasses.replace(spec_p, Dy=Dy, flow_is_shared=True)
        warp = PM._make_warp(sp, {"flow": flow(a, b, lambda x: x)})
        return pgauss.gaussian_flow_ell(lik_p, {"log_var_noise": lv}, Y, mu,
                                        var, warp)

    def ref(lv, Y, mu, var, a, b):
        sj = dataclasses.replace(spec_j, Dy=Dy, flow_is_shared=True)
        warp = JM._make_warp(sj, {"flow": flow(a, b, lambda x: x)},
                             jnp.zeros((Dy, MB, 4)), None, stochastic=True,
                             train=True)
        return jgauss.gaussian_flow_ell(lik_j, {"log_var_noise": lv}, Y, mu,
                                        var, warp)

    return port, ref, (lvn, Y, mu, var, 1.0 + fa, fb)


@pytest.mark.parametrize("which", ["kl_whitened", "kld_qu", "gaussian_ell",
                                   "gaussian_flow_ell"])
def test_objective_pieces_match_jax_in_value_and_gradient(which):
    rng = np.random.RandomState(11)
    port, ref, inputs = _grad_case(which, rng)
    w = rng.randn(2)
    val_j = ref(*map(jnp.asarray, inputs))
    grads_j = jax.grad(lambda *a: jnp.sum(ref(*a) * w),
                       argnums=tuple(range(len(inputs))))(
        *map(jnp.asarray, inputs))
    leaves = [t64(a).requires_grad_(True) for a in inputs]
    val_p = port(*leaves)
    assert val_p.shape == (2,)
    close(val_p, val_j)
    (val_p * t64(w)).sum().backward()
    for leaf, g in zip(leaves, grads_j):
        close(leaf.grad, g)


def test_kl_whitened_floors_the_log_by_dtype():
    # a zero on the raw diagonal: the floor keeps the KL and its gradient
    # finite, 1e-30 in fp64 and 1e-12 in fp32, as in the JAX package
    m, L = np.zeros((1, 3)), np.diag([1.0, 0.0, 2.0])[None]
    for dt, floor in ((np.float64, 1e-30), (np.float32, 1e-12)):
        Lt = torch.as_tensor(L.astype(dt)).requires_grad_(True)
        kl = plinalg.kl_whitened(torch.as_tensor(m.astype(dt)), Lt)
        kl.sum().backward()
        assert torch.isfinite(kl).all() and torch.isfinite(Lt.grad).all()
        want = 0.5 * (-(np.log(1.0 + floor) + np.log(floor) + np.log(4.0 + floor))
                      + 5.0 - 3.0)
        np.testing.assert_allclose(float(kl.detach()), want, rtol=1e-6)


def test_flagship_elbo_at_full_width_matches_jax_value_and_grad():
    # all 8611 power training rows, M=100, 100 GH nodes, fp64; the objective
    # is the ELBO per row, so that its gradient is O(1) and atol 1e-10 means
    # what it means for the values (the summed ELBO's gradient reaches 1e4)
    d = _power()
    X, Y = d["X_tr"], d["Y_tr"]
    N = X.shape[0]
    spec_j, spec_p = _specs(N, 100, 100)
    pp, pn = _perturbed(spec_p, X)
    Xj, Yj = jnp.asarray(X), jnp.asarray(Y)
    (ej, (ellj, kldj)), gj = jax.jit(jax.value_and_grad(
        lambda p: (lambda e, ell, kld: (e / N, (ell, kld)))(
            *JM.elbo(spec_j, p, Xj, Yj)), has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, pn))
    pp = weights.tree_map(lambda t: t.clone().requires_grad_(True), pp)
    e, ell, kld = PM.elbo(spec_p, pp, t64(X), t64(Y))
    close(e / N, ej)
    close(ell, ellj)
    close(kld, kldj)
    (e / N).backward()
    paths = weights.tree_leaves(popt.param_paths(pp))
    for path, leaf, ref in zip(paths, weights.tree_leaves(pp),
                               jax.tree_util.tree_leaves(gj)):
        assert leaf.grad is not None, path
        assert np.abs(np.asarray(ref)).max() > 0, path     # every leaf is live
        close(leaf.grad, ref)
    assert {"Z", "q_mu", "q_L", "kernel/raw_outputscale",
            "kernel/child/raw_lengthscale", "likelihood/log_var_noise",
            "flow/0/a", "flow/3/b"} <= set(paths)


def test_entry_matches_graft_entry():
    fn_p, args_p = entry.entry(device="cpu")
    fn_j, args_j = __graft_entry__.entry()
    close(fn_p(*args_p), fn_j(*args_j))
    close_trees(args_p[0], args_j[0])


# ---------------------------------------------------------------------------
# grouped Adam, paths and annotations
# ---------------------------------------------------------------------------

def _tree(rng):
    return {"kernel": {"child": {"raw_lengthscale": rng.randn(1, 4)},
                       "raw_outputscale": rng.randn(1)},
            "q_mu": rng.randn(1, 5), "Z": rng.randn(1, 5, 4),
            "flow": [{"a": rng.randn(), "b": rng.randn()},
                     {"a": rng.randn(), "b": rng.randn()}],
            "likelihood": {"log_var_noise": rng.randn(1, 1)}, "mean": {}}


def test_param_paths_and_labels_match_jax():
    tree = _tree(np.random.RandomState(0))
    pt = weights.tree_map(t64, tree)
    jt = jax.tree_util.tree_map(jnp.asarray, tree)
    assert popt.param_paths(pt) == jopt.param_paths(jt)
    assert "kernel/child/raw_lengthscale" in weights.tree_leaves(
        popt.param_paths(pt))
    specs = [[0.0, "q_mu"], [0.05, 1e-4, "flow/1"], [0.02, "kernel"]]
    # frozen leaves: an identity-mean W, hypernet anchors and BN statistics
    hyper = {"mean": {"W": np.eye(2)},
             "flow": [{"a": 0.1, "b": 0.2, "net_a": {"w": np.ones(3)},
                       "bn": {"mean": np.zeros(3), "var": np.ones(3)}},
                      {"a": 0.3}]}
    for t in (tree, hyper):
        pt = weights.tree_map(t64, t)
        jt = jax.tree_util.tree_map(jnp.asarray, t)
        fr_p, fr_j = frozen_param_labels(None, pt), j_frozen(None, jt)
        assert fr_p == fr_j
        for kind, dwd in (("adam", 0.0), ("adam_W", 0.01)):
            got = GA.annotations_from_specs(pt, specs, 0.01, fr_p, dwd)
            want = JGA.annotations_from_specs(jt, specs, 0.01, fr_j, dwd)
            assert got == want, kind
        _, labels = popt.build_grouped_optimizer(pt, specs, 0.01, "sgd", fr_p)
        _, jlabels = jopt.build_grouped_optimizer(jt, specs, 0.01, "sgd", fr_j)
        assert labels == jlabels
    assert frozen_param_labels(None, weights.tree_map(t64, hyper)) == {
        "mean": {"W": True},
        "flow": [{"a": True, "b": True, "net_a": {"w": False},
                  "bn": {"mean": True, "var": True}}, {"a": False}]}


def _adam_run(kind, steps=12):
    """12 steps of the Adam family on both sides.  Phase 1 (steps 0-5):
    Z inactive (not yet added), q_mu at lr 0, flow/1 frozen through the
    labels; phase 2: Z added with a fresh count.  Gradients from a seed."""
    rng = np.random.RandomState(3)
    tree = _tree(rng)
    grads = [weights.tree_map(lambda a: rng.randn(*np.shape(a)), tree)
             for _ in range(steps)]
    frozen = weights.tree_map(lambda _: False, tree)
    frozen["flow"][1] = {"a": True, "b": True}
    phases = [[[0.0, "q_mu"], [0.0, "Z"], [0.05, 1e-3, "flow"]],
              [[0.0, "q_mu"], [0.02, 0.1, "Z"]]]
    dwd = 0.01 if kind == "adam_W" else 0.0

    pt = weights.tree_map(t64, tree)
    state = GA.init_state(pt)
    jt = jax.tree_util.tree_map(jnp.asarray, tree)
    jstate = JGA.init_state(jt)
    for i, g in enumerate(grads):
        specs = phases[i >= steps // 2]
        ann = GA.annotations_from_specs(pt, specs, 0.01, frozen, dwd)
        GA.update(weights.tree_map(t64, g), state, pt, *ann, kind=kind)
        jann = JGA.annotations_from_specs(jt, specs, 0.01, frozen, dwd)
        upd, jstate = JGA.update(jax.tree_util.tree_map(jnp.asarray, g),
                                 jstate, jt, *jann, kind=kind)
        jt = jax.tree_util.tree_map(lambda a, u: a + u, jt, upd)
    return tree, pt, jt, state, jstate


@pytest.mark.parametrize("kind", ["adam", "adam_W", "adam_R"])
def test_group_adam_matches_jax(kind):
    tree, pt, jt, state, jstate = _adam_run(kind)
    close_trees(pt, jt, rtol=1e-10, atol=0)
    assert state.count == [int(c) for c in jax.tree_util.tree_leaves(jstate.count)]
    counts = dict(zip(weights.tree_leaves(popt.param_paths(pt)), state.count))
    assert counts["q_mu"] == counts["flow/1/a"] == 0          # never active
    assert counts["Z"] == 6 and counts["flow/0/a"] == 12       # fresh in phase 2
    np.testing.assert_array_equal(pt["q_mu"].numpy(), tree["q_mu"])
    np.testing.assert_array_equal(pt["flow"][1]["a"].numpy(), tree["flow"][1]["a"])
    if kind == "adam_R":
        # Z's six steps end at rho_t = 5.99 (a step) after rho_t = 4.99 (none)
        assert not np.allclose(pt["Z"].numpy(), tree["Z"])


def test_adam_R_takes_no_step_below_rho_5_unlike_torch_radam():
    # rho_t < 5 for t <= 5: the reference's RAdam (degenerated_to_sgd=False)
    # leaves the parameter where it is, weight decay included;
    # torch.optim.RAdam takes an SGD step there
    rng = np.random.RandomState(4)
    w0 = rng.randn(5)
    grads = [rng.randn(5) for _ in range(7)]
    p = {"w": t64(w0)}
    st = GA.init_state(p)
    tw = t64(w0).requires_grad_(True)
    topt = torch.optim.RAdam([tw], lr=0.05, weight_decay=0.1)
    for t, g in enumerate(grads, start=1):
        GA.update({"w": t64(g)}, st, p, {"w": 0.05}, {"w": 0.1}, {"w": True},
                  kind="adam_R")
        tw.grad = t64(g)
        topt.step()
        if t <= 5:
            np.testing.assert_array_equal(p["w"].numpy(), w0)
            assert not np.allclose(tw.detach().numpy(), w0)
        else:
            assert not np.allclose(p["w"].numpy(), w0)
    assert not np.allclose(p["w"].numpy(), tw.detach().numpy())


# ---------------------------------------------------------------------------
# the Trainer against the JAX Trainer
# ---------------------------------------------------------------------------

def _trainers(n_rows, batch, seed=3):
    """The port's and the JAX Trainer on the same power rows, init, loader
    seed and test split (M=16, 20 GH nodes)."""
    loaders, d = return_dataset("power", 10000, seed=1)
    X, Y = d["X_tr"][:n_rows], d["Y_tr"][:n_rows]
    Xte, Yte = loaders[-1].dataset.X, loaders[-1].dataset.Y
    spec_j, spec_p = _specs(n_rows, M_SMALL, Q_SMALL)
    pp, pn = _perturbed(spec_p, X, seed=1)
    tr_p = Trainer(spec_p, pp,
                   [DataLoader(ArrayDataset(X, Y), batch, seed=seed),
                    DataLoader(ArrayDataset(Xte, Yte), 10000, shuffle=False)],
                   d["Y_std"], S_test=100, seed=0, device="cpu")
    tr_j = JTrainer(spec_j, jax.tree_util.tree_map(jnp.asarray, pn),
                    [JLoader(JDataset(X, Y), batch, seed=seed),
                     JLoader(JDataset(Xte, Yte), 10000, shuffle=False)],
                    d["Y_std"], S_test=100, seed=0)
    return tr_p, tr_j


def _compare_trained(tr_p, tr_j):
    for curve in ("loss_curve", "ell_curve", "kld_curve"):
        np.testing.assert_allclose(np.asarray(getattr(tr_p, curve)),
                                   np.asarray(getattr(tr_j, curve)), **CURVES)
    close_trees(tr_p.params, tr_j.params, **PARAMS)
    mp, mj = tr_p.compute_metrics(), tr_j.compute_metrics()
    for split, n in (("train", len(tr_p.train_loader.dataset)),
                     ("test", len(tr_p.test_loader.dataset))):
        for k in ("logL", "rmse"):
            np.testing.assert_allclose(mp[split][k], mj[split][k], **METRICS)
        c = mj[split]["coverage"]
        assert np.all(np.abs(mp[split]["coverage"] - c)
                      <= 3 * np.sqrt(c * (1 - c) / n)), (split, mp, mj)


@pytest.mark.parametrize("opt, lr, phase1", [
    ("adam", 0.01, None),
    # sgd: the kernel's group with L2 weight decay in the first phase, a
    # small global lr (an sgd step is lr times the clipped gradient)
    ("sgd", 1e-4, [[1e-3, 0.1, "kernel"]])])
def test_trainer_full_batch_matches_jax_trainer(opt, lr, phase1):
    # 40 epochs in two phases (flow frozen in the second), with the gradient
    # clipped (its global norm is above 100 on these rows at the start)
    tr_p, tr_j = _trainers(N_SMALL, 10000)
    kw = dict(optimisation_schedule=([0.5, 0.5], [phase1, [[0.0, "flow"]]]),
              verbose_each=0, clip_norm=100.0)
    tr_p.train(40, lr, opt, **kw)
    tr_j.train(40, lr, opt, **kw)
    assert len(tr_p.loss_curve) == 40
    assert np.isfinite(tr_p.loss_curve).all()
    assert tr_p.loss_curve[-1] > tr_p.loss_curve[0]
    _compare_trained(tr_p, tr_j)


def test_trainer_minibatch_matches_jax_trainer():
    # 300 rows in batches of 128: 2 full batches and a remainder of 44 per
    # epoch, shuffled by the loader's PCG64 stream on both sides
    tr_p, tr_j = _trainers(300, 128)
    tr_p.train(3, 0.01, "adam", verbose_each=0)
    tr_j.train(3, 0.01, "adam", verbose_each=0)
    assert len(tr_p.loss_curve) == len(tr_j.loss_curve) == 3
    _compare_trained(tr_p, tr_j)


def test_metrics_match_jax():
    rng = np.random.RandomState(8)
    samples, Y, mean = rng.randn(200, 3, 50), rng.randn(3, 50), rng.randn(3, 50)
    assert metrics.coverage_95(t64(samples), t64(Y)) == pytest.approx(
        jmetrics.coverage_95(samples, Y), abs=1e-15)
    assert metrics.rmse(t64(mean), t64(Y), 2.5) == pytest.approx(
        jmetrics.rmse(mean, Y, 2.5), rel=1e-14)


def test_flagship_trainer_is_bench_jax_config():
    # bench.py::bench_jax's spec and init, built by the JAX package
    tr = bench.flagship_trainer(device="cpu")
    X = _power()["X_tr"]
    spec_j, spec_p = _specs(X.shape[0], 100, 100)
    assert tr.spec == spec_p and len(tr.train_loader) == 1
    _, finits = j_spec_from_list(jG.SAL(2))
    pj = JM.init_tgp_params(
        spec_j, X, X[:100].copy(), variance_scale=1e-5,
        kernel_init={"length_scale": 2.0, "kernel_scale": 2.0},
        noise_init=0.05, flow_inits=finits)
    close_trees(tr.params, pj, rtol=0, atol=0)


def test_bench_runs_the_trainer_full_batch_path(monkeypatch):
    monkeypatch.setattr(bench, "CHUNK", 2)
    monkeypatch.setattr(bench, "WINDOWS", 1)
    tr = _small_trainer()
    assert bench.bench(tr) > 0 and len(tr.loss_curve) == 6
    assert np.isfinite(tr.loss_curve).all()


# ---------------------------------------------------------------------------
# guards
# ---------------------------------------------------------------------------

def _small_trainer(**kw):
    d = _power()
    X, Y = d["X_tr"][:40], d["Y_tr"][:40]
    spec = weights.flagship_spec(40, M=4, quad=8)
    params = kw.pop("params", None) or weights.flagship_params(
        spec, X, seed=0, device="cpu")
    return Trainer(spec, params, [DataLoader(ArrayDataset(X, Y), 64)],
                   d["Y_std"], device="cpu", **kw)


def _mesh_option(tmp_path):
    from tgp.pytorch_tpu_torch.parallel import make_mesh, multihost

    multihost.initialize(f"file://{tmp_path}/store", 1, 0, platform="cpu")
    try:
        plain, meshed = _small_trainer(), _small_trainer(mesh=make_mesh(1, 1))
        plain.train(3, 0.01, verbose_each=0)
        meshed.train(3, 0.01, verbose_each=0)
        for a, b in zip(weights.tree_leaves(plain.params),
                        weights.tree_leaves(meshed.params)):
            assert torch.equal(a, b)
        assert meshed.loss_curve == plain.loss_curve
    finally:
        multihost.shutdown()


def test_trainer_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has a card; the default device is valid here")
    d = _power()
    spec = weights.flagship_spec(40, M=4, quad=8)
    params = weights.flagship_params(spec, d["X_tr"][:40], seed=0, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(spec, params, [DataLoader(ArrayDataset(d["X_tr"], d["Y_tr"]), 64)],
                d["Y_std"])


def _id_trainers(**flow_kw):
    """The port's and the JAX Trainer on 200 power rows with an
    input-dependent SAL(1) flow (hypernets 4 -> 5 -> 1), M=8, 10 GH nodes,
    from the JAX package's init; the test split's first 300 rows."""
    loaders, d = return_dataset("power", 10000, seed=1)
    X, Y = d["X_tr"][:200], d["Y_tr"][:200]
    Xte, Yte = loaders[-1].dataset.X[:300], loaders[-1].dataset.Y[:300]
    fspec, finits = j_spec_from_list(jG.SAL(1, input_dependent=True,
                                            input_dim=4, hidden_dim=5,
                                            **flow_kw))
    spec_j = JM.TGPSpec(Dy=1, Dx=4, M=8, N=200.0,
                        kernel=jK.from_name("scale_rbf"),
                        likelihood=JLik("gaussian_flow", 1, quad_points=10),
                        flow=fspec)
    pj = JM.init_tgp_params(spec_j, X, X[:8], flow_inits=finits,
                            kernel_init={"length_scale": 2.0, "kernel_scale": 2.0},
                            dtype=jnp.float64)
    pn = jax.tree_util.tree_map(np.asarray, pj)
    spec_p = weights.spec_from_dict(jser.spec_to_dict(spec_j))
    tr_p = Trainer(spec_p, weights.params_from_jax(pn, device="cpu"),
                   [DataLoader(ArrayDataset(X, Y), 10000, seed=3),
                    DataLoader(ArrayDataset(Xte, Yte), 10000, shuffle=False)],
                   d["Y_std"], S_test=20, seed=0, device="cpu")
    tr_j = JTrainer(spec_j, jax.tree_util.tree_map(jnp.asarray, pn),
                    [JLoader(JDataset(X, Y), 10000, seed=3),
                     JLoader(JDataset(Xte, Yte), 10000, shuffle=False)],
                    d["Y_std"], S_test=20, seed=0)
    return tr_p, tr_j


def _id_option_matches_jax(option, monkeypatch):
    """The two input-dependent options, ported: a fully-Bayesian evaluation
    (S_MC = S_test = 20 MC-dropout draws) and the training of a flow with
    batch-norm hypernets (6 full-batch steps, the nets at weight decay 1e-5,
    then the statistics recalibrated), against the JAX Trainer, the JAX
    Trainer's masks replayed to the port in program order
    (`test_torch_port_hypernet.JaxOrderReplay`)."""
    from test_torch_port_hypernet import JaxOrderReplay

    if option == "fully_bayesian":
        tr_p, tr_j = _id_trainers(dropout=0.3, hidden_activation="tanh")
    else:
        tr_p, tr_j = _id_trainers(dropout=0.3, batch_norm=1,
                                  num_hidden_layers=2)
    replay = JaxOrderReplay().patch(monkeypatch)
    # on the real ID tree the anchors and the BN statistics are frozen
    fp, fj = (weights.tree_leaves(f(tr.spec, tr.params)) for f, tr in
              ((frozen_param_labels, tr_p), (j_frozen, tr_j)))
    assert fp == [bool(x) for x in fj] and sum(fp) == (10 if option == "bn_flow"
                                                     else 2)
    if option == "bn_flow":
        specs = ([1.0], [[[0.01, 1e-5, "net_"], [0.01, 0.0, "flow"]]])
        bn0 = tr_p.params["flow"][0]["net_a"]["layers"][0]["bn"]["var"].clone()
        for tr in (tr_j, tr_p):         # JAX first: the port replays its masks
            tr.train(6, 0.01, "adam", optimisation_schedule=specs,
                     verbose_each=0)
            replay.seal()
        for curve in ("loss_curve", "ell_curve", "kld_curve"):
            np.testing.assert_allclose(np.asarray(getattr(tr_p, curve)),
                                       np.asarray(getattr(tr_j, curve)), **F64)
        # A bias that feeds batch norm has a gradient of 0 but for rounding,
        # beside its weight decay's 1e-5 * b: Adam turns the rounding into
        # steps of lr * 1e-8 or so, which the batch means follow and the
        # rest of the model picks up (Z and q_L to 1.9e-9).  Every leaf is
        # held at 10x the largest measured gap, 2.7e-9.
        paths = weights.tree_leaves(popt.param_paths(tr_p.params))
        for path, a, b in zip(paths, weights.tree_leaves(tr_p.params),
                              weights.tree_leaves(tr_j.params)):
            close(a, b, err_msg=path, **BN_TRAIN)
        bn = tr_p.params["flow"][0]["net_a"]["layers"][0]["bn"]
        assert not torch.equal(bn["var"], bn0) and bn["var"].requires_grad
    tr_p.fully_bayesian = tr_j.fully_bayesian = option == "fully_bayesian"
    mj = tr_j.compute_metrics()
    replay.seal()
    mp = tr_p.compute_metrics()
    for split in ("train", "test"):
        for k in ("logL", "rmse"):
            np.testing.assert_allclose(mp[split][k], mj[split][k], **F64)
    # every draw replayed: a site a net and layer in each program (bn_flow:
    # the training step's 2 x 2; fully_bayesian: 3 passes x 2 nets for each
    # of the two loaders' programs)
    assert replay.queue == []
    assert replay.sites == (4 if option == "bn_flow" else 12)


def _classification_matches_jax():
    """A Bernoulli TGP (SAL(1) flow, M=8, 20 GH nodes) on 120 synthetic rows
    trained by the port's Trainer and by the JAX Trainer for 10 epochs, the
    kernel held for the first 5, gradients clipped at norm 100: the curves,
    every parameter, and logL, accuracy and the calibration measures of
    `compute_metrics` at rtol 1e-8 (no draw is read: the predictive
    samples are not used by the classification metrics)."""
    rs = np.random.RandomState(0)
    N = 120
    X = rs.randn(N, 2)
    y = (X[:, 0] + 0.3 * rs.randn(N) > 0).astype(np.float64).reshape(-1, 1)
    js, ji = j_spec_from_list(jG.SAL(1))
    spec_j = JM.TGPSpec(Dy=1, Dx=2, M=8, N=float(N),
                        kernel=jK.from_name("scale_rbf"),
                        likelihood=JLik("bernoulli", 1, quad_points=20), flow=js)
    pj = JM.init_tgp_params(spec_j, X, X[:8], flow_inits=ji)
    spec_p = weights.spec_from_dict(jser.spec_to_dict(spec_j))
    pp = weights.params_from_jax(jax.tree_util.tree_map(np.asarray, pj),
                                 device="cpu", dtype=torch.float64)
    tr_j = JTrainer(spec_j, pj, [JLoader(JDataset(X, y), N, seed=0),
                                 JLoader(JDataset(X, y), N, shuffle=False)],
                    Y_std=np.ones(1), S_test=10)
    tr_p = Trainer(spec_p, pp, [DataLoader(ArrayDataset(X, y), N, seed=0),
                                DataLoader(ArrayDataset(X, y), N, shuffle=False)],
                   np.ones(1), S_test=10, device="cpu")
    for tr in (tr_j, tr_p):
        tr.train(10, 0.01, "adam", verbose_each=0, clip_norm=100.0,
                 optimisation_schedule=([0.5, 0.5], [[[0.0, "kernel"]], None]))
    for attr in ("loss_curve", "ell_curve", "kld_curve"):
        np.testing.assert_allclose(np.asarray(getattr(tr_p, attr)),
                                   [float(v) for v in getattr(tr_j, attr)], **F64)
    for a, b in zip(weights.tree_leaves(tr_p.params),
                    jax.tree_util.tree_leaves(tr_j.params)):
        close(a, b)
    mp, mj = tr_p.compute_metrics(), tr_j.compute_metrics()
    for split in ("train", "test"):
        assert mp[split].keys() == mj[split].keys() == {"logL", "acc",
                                                        "calibration"}
        np.testing.assert_allclose(mp[split]["logL"], mj[split]["logL"], **F64)
        assert mp[split]["acc"] == mj[split]["acc"]
        for k, v in mj[split]["calibration"].items():
            np.testing.assert_allclose(mp[split]["calibration"][k], v, **F64)


@pytest.mark.parametrize("option", [
    "natgrad_gamma", "natgrad_warmup", "lbfgs", "mesh", "save", "restore",
    "eval_device", "plateau_guard", "remat", "fully_bayesian", "bn_flow",
    "classification", "track_fn", "large_dataset", "dataset"])
def test_trainer_options_of_the_ported_items_run(option, monkeypatch,
                                                 tmp_path):
    """Each Trainer option that once raised for its ROADMAP item (13, 16,
    18-21) runs: briefly here, held against the JAX package where the
    comment names the test."""
    if option in ("lbfgs", "save", "restore", "eval_device"):
        # items 19 and 20's L-BFGS, checkpoints and eval_device are ported
        # (held in tests/test_torch_port_lbfgs.py and _runtime.py)
        return _ported_runtime_option(option, tmp_path)
    if option in ("fully_bayesian", "bn_flow"):
        # item 13 is ported: these two now hold the result against JAX
        return _id_option_matches_jax(option, monkeypatch)
    if option == "classification":
        # item 16 is ported: a Bernoulli Trainer holds the JAX one
        return _classification_matches_jax()
    if option == "plateau_guard":
        # item 18 is ported: the guard fires on the recorded curve (held
        # against the JAX Trainer in tests/test_torch_port_plateau.py)
        tr = _small_trainer()
        tr.plateau_guard = {"window": 10, "min_rel_improve": 1e9,
                            "max_fraction": 1.0}
        tr.train(30, 0.01, verbose_each=0)
        c = np.asarray(tr.loss_curve, np.float64)
        want = (c[-10:].mean() - c[-20:-10].mean()) / abs(c[-20:-10].mean())
        assert [e["epoch"] for e in tr.plateau_events] == [30]
        np.testing.assert_allclose(tr.plateau_events[0]["rel_improve"], want,
                                   rtol=1e-12)
        return
    if option == "mesh":
        # item 20's meshes are ported (held against the JAX package in
        # tests/test_torch_port_mesh.py): a 1x1 mesh trains bitwise as the
        # Trainer without one
        return _mesh_option(tmp_path)
    if option in ("remat", "track_fn", "large_dataset"):
        # item 21 is ported (held against the JAX package in
        # tests/test_torch_port_hostloop.py)
        return _item21_option(option)
    if option == "dataset":
        # item 20's large corpora are ported: a table that is not in the
        # repo raises the JAX loader's actionable FileNotFoundError
        with pytest.raises(FileNotFoundError, match="airline corpus missing"):
            return_dataset("airline", 100)
        return
    if option in ("natgrad_gamma", "natgrad_warmup"):
        # natural gradients are ported (held against the JAX Trainer in
        # tests/test_torch_port_natgrad.py): q(U) moves by them alone
        tr = _small_trainer()
        hyper = {k: v.detach().clone() for k, v in tr.params.items()
                 if torch.is_tensor(v)}
        warm = dict(natgrad_warmup=3) if option == "natgrad_warmup" else {}
        tr.train(2, 0.0, natgrad_gamma=1.0, verbose_each=0, **warm)
        assert np.isfinite(np.asarray(tr.loss_curve, np.float64)).all()
        assert tr._ng_t == (2 if warm else 0)
        for k in ("q_mu", "q_L"):
            assert not torch.equal(tr.params[k], hyper[k])
        assert torch.equal(tr.params["Z"], hyper["Z"])


def _item21_option(option):
    """remat trains bit for bit as the plain spec does; a track_fn runs once
    a step; a dataset over DEVICE_RESIDENT_BYTES trains through the host
    loop, bit for bit as the device-resident minibatch path."""
    plain = _small_trainer()
    if option == "large_dataset":
        plain.train_loader = DataLoader(ArrayDataset(
            plain.train_loader.dataset.X, plain.train_loader.dataset.Y), 16)
    plain.train(2, 0.01, verbose_each=0)
    calls = []
    tr = _small_trainer(track_fn=(lambda t: calls.append(1))
                        if option == "track_fn" else None)
    if option == "remat":
        tr.spec = dataclasses.replace(tr.spec, remat=True)
    if option == "large_dataset":
        tr.train_loader = DataLoader(ArrayDataset(
            tr.train_loader.dataset.X, tr.train_loader.dataset.Y), 16)
        tr.DEVICE_RESIDENT_BYTES = 100
    tr.train(2, 0.01, verbose_each=0)
    for a, b in zip(weights.tree_leaves(plain.params),
                    weights.tree_leaves(tr.params)):
        if option == "track_fn":
            # the host loop draws the loader's order each epoch (full batch
            # keeps the first): the same rows, summed in another order
            np.testing.assert_allclose(a.detach().numpy(),
                                       b.detach().numpy(), **F64)
        else:
            assert torch.equal(a, b)
    if option == "track_fn":
        assert len(calls) == 2
    # 40 rows in batches of 16: 3 steps an epoch, one curve entry each
    assert len(tr.loss_curve) == (6 if option == "large_dataset" else 2)


def _ported_runtime_option(option, tmp_path):
    """L-BFGS trains; save writes a checkpoint that restore reads back into
    a fresh Trainer bit for bit; eval_device="cpu" evaluates as the default
    does."""
    tr = _small_trainer()
    if option == "lbfgs":
        tr.train(2, 0.01, "lbfgs", verbose_each=0)
        assert len(tr.loss_curve) == 2
        assert np.isfinite(np.asarray(tr.loss_curve, np.float64)).all()
        assert tr._opt_state_kind == "lbfgs"
        return
    if option in ("save", "restore"):
        tr.train(2, 0.01, verbose_each=0)
        path = tr.save(str(tmp_path))
        fresh = _small_trainer(seed=5)
        assert fresh.restore(str(tmp_path)) == 2 and path.endswith("step_2")
        for a, b in zip(weights.tree_leaves(tr.params),
                        weights.tree_leaves(fresh.params)):
            assert torch.equal(a, b)
        assert torch.equal(tr._gen.get_state(), fresh._gen.get_state())
        return
    want = tr.compute_metrics()
    tr = _small_trainer()
    tr.eval_device = "cpu"
    got = tr.compute_metrics()
    for k in ("logL", "rmse", "coverage"):
        np.testing.assert_array_equal(got["train"][k], want["train"][k])


def test_nan_guard_raises_and_names_the_parameters():
    d = _power()
    spec = weights.flagship_spec(40, M=4, quad=8)
    params = weights.flagship_params(spec, d["X_tr"][:40], seed=0, device="cpu")
    params["q_mu"] = params["q_mu"] * float("nan")
    tr = _small_trainer(params=params)
    with pytest.raises(FloatingPointError, match=r"non-finite parameters: .*q_mu"):
        tr.train(3, 0.01, verbose_each=0)
    assert len(tr.loss_curve) == 3
