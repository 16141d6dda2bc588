"""Meshes of ranks in the port (`parallel/`, `Trainer(mesh=)`, the CLI's
`--mesh`) against the port without a mesh and against the JAX package, on
the CPU: ranks are processes joined under gloo through a FileStore
(`parallel/launch.py`, one math thread each; the ranks' side is
`test_torch_port_mesh_ranks.py`).

The cases mirror the JAX package's `tests/test_sharding.py` (4),
`tests/test_trainer_mesh.py` (5) and `tests/test_multihost.py` (3), and
`__graft_entry__.py::dryrun_multichip`, with at most 4 ranks where JAX uses
8 virtual devices: dp=4 where it takes dp=8, dp=2 x ty=2 where it takes
2 x 4, and an indivisible batch of 62 rows over dp=4 (JAX: 60 over 8).  All
the cases of one mesh run in one cluster of 4 ranks, started once for this
file.  The inputs are the JAX package's seeded models and data, given to
both packages.  Tolerances are the JAX tests' own:
  * a sharded ELBO at rtol 1e-10, its gradients and one Adam step at rtol
    1e-8, atol 1e-10 (fp64);
  * 50 full-batch epochs at rtol 1e-7, atol 1e-8; 10 minibatch epochs (30
    steps) at rtol 1e-6, atol 1e-7; sharded metrics at rtol 1e-6.  The
    mesh against the port without one lands within 1e-14.  Against the JAX
    Trainer the trained parameters are held at rtol 1e-6, atol 1e-6: the
    two packages without a mesh already differ by up to 8.7e-8 on these
    models (Z of the Dy=4 model after 50 epochs: Adam steps an entry whose
    gradient is rounding noise by about lr with the noise's sign), beyond
    JAX's atol of 1e-8, so 10x that gap, rounded up, holds them;
  * the multi-process runs (fp32, 40 epochs): the same bits on every rank,
    and the ELBO within rtol 2e-3 of the run without a mesh, logL and RMSE
    within 5e-3 and coverage within 0.1.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import optax
import pytest
import torch

from tgp.pytorch_tpu.data.batching import ArrayDataset as JDataset, \
    DataLoader as JLoader
from tgp.pytorch_tpu.flows import generators as G, spec_from_list
from tgp.pytorch_tpu.likelihoods import LikelihoodSpec
from tgp.pytorch_tpu.models import serialization as jser, tgp as JM
from tgp.pytorch_tpu.ops import kernels as K
from tgp.pytorch_tpu.train import Trainer as JTrainer

from tgp.pytorch_tpu_torch import config as pcfg, entry
from tgp.pytorch_tpu_torch.models import serialization as pser
from tgp.pytorch_tpu_torch.parallel import launch, mesh as pmesh, multihost
from tgp.pytorch_tpu_torch.train.optimizers import param_paths

import test_torch_port_mesh_ranks as ranks

TESTS = str(Path(__file__).resolve().parent)
REPO = str(Path(TESTS).parent)
RANKS_ENV = {"PYTHONPATH": TESTS}
F64_GRAD = dict(rtol=1e-8, atol=1e-10)


@pytest.fixture(autouse=True)
def _state():
    prev = pcfg.precision()
    yield
    pcfg.set_precision(prev)


def _np(tree):
    return jax.tree_util.tree_map(lambda x: np.array(x, copy=True), tree)


def _model(Dy=1, flow=None, N=64):
    """test_sharding.py's and test_trainer_mesh.py's model: (spec, params,
    X, Y), JAX's, params and data as numpy."""
    rng = np.random.RandomState(0)
    X, Y = rng.randn(N, 3), rng.randn(N, Dy)
    fspec, finits, lik = JM.IDENTITY_SPEC, None, "gaussian"
    if flow is not None:
        fspec, finits = spec_from_list(flow)
        lik = "gaussian_flow"
    spec = JM.TGPSpec(Dy=Dy, Dx=3, M=8, N=float(N),
                      kernel=K.from_name("scale_rbf"),
                      likelihood=LikelihoodSpec(lik, Dy, quad_points=32),
                      flow=fspec)
    return spec, _np(JM.init_tgp_params(spec, X, X[:8], flow_inits=finits)), \
        X, Y


def _multihost_model(Dy=1):
    """test_multihost.py's model and data (fp32, N=256, SAL(1))."""
    rng = np.random.RandomState(0)
    N = 256
    X = np.asarray(rng.randn(N, 3), np.float32)
    W = rng.randn(3, Dy)
    Y = np.asarray(np.sinh(0.8 * X @ W) + 0.1 * rng.randn(N, Dy), np.float32)
    Xte = np.asarray(rng.randn(64, 3), np.float32)
    Yte = np.asarray(np.sinh(0.8 * Xte @ W) + 0.1 * rng.randn(64, Dy),
                     np.float32)
    np.random.seed(0)
    fspec, finits = spec_from_list(G.SAL(1))
    spec = JM.TGPSpec(Dy=Dy, Dx=3, M=8, N=float(N),
                      kernel=K.from_name("scale_rbf"),
                      likelihood=LikelihoodSpec("gaussian_flow", Dy,
                                                quad_points=20),
                      flow=fspec)
    params = JM.init_tgp_params(
        spec, X, X[:8].copy(), variance_scale=1e-5,
        kernel_init={"length_scale": 2.0, "kernel_scale": 2.0},
        noise_init=0.05, flow_inits=finits)
    return spec, _np(params), X, Y, Xte, Yte


def _case(kind, model, mesh, precision="fp64", **kw):
    spec, params, X, Y = model[:4]
    dt = np.float64 if precision == "fp64" else np.float32
    params = jax.tree_util.tree_map(lambda a: np.asarray(a, dt), params)
    case = dict(kind=kind, spec=pser.spec_to_dict(
        pser.spec_from_dict(jser.spec_to_dict(spec))), jspec=spec,
        params=params, X=X, Y=Y, mesh=mesh, precision=precision,
        batch=X.shape[0], loader_seed=2, seed=2, S_test=10, lr=0.05)
    if len(model) > 4:
        case.update(Xte=model[4], Yte=model[5])
    case.update(kw)
    return case


def _cases():
    mh = _multihost_model()
    mh_kw = dict(precision="fp32", loader_seed=7, seed=3, epochs=40,
                 lr=0.01, S_test=100, metrics=True)
    return {
        # tests/test_sharding.py
        "elbo_dp": _case("elbo", _model(), (4, 1)),
        "grads_dp": _case("grads", _model(flow=G.SAL(1)), (4, 1)),
        "elbo_ty": _case("elbo", _model(Dy=4), (2, 2)),
        "step": _case("step", _model(), (4, 1), lr=0.01),
        # tests/test_trainer_mesh.py
        "full_dp": _case("train", _model(flow=G.SAL(1)), (4, 1), epochs=50),
        "full_dp_ty": _case("train", _model(Dy=4), (2, 2), epochs=50),
        "minibatch_dp": _case("train", _model(N=96, flow=G.SAL(1)), (4, 1),
                              batch=32, epochs=10),
        "indivisible": _case("train", _model(N=62), (4, 1), epochs=10),
        "eval_dp": _case("train", _model(flow=G.SAL(1)), (4, 1), epochs=20,
                         metrics=True),
        # tests/test_multihost.py
        "mh_dp": _case("train", mh, (4, 1), **mh_kw),
        "mh_dp_ty": _case("train", _multihost_model(Dy=2), (2, 2), **mh_kw),
        "mh_natgrad": _case("train", mh, (4, 1), natgrad=1.0, **mh_kw),
    }


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    """The cases on a cluster of 4 ranks, and each case without a mesh in
    this process: (cases, mesh results, unsharded results, ranks' md5s)."""
    work = tmp_path_factory.mktemp("mesh")
    cases = _cases()
    torch.save({k: {kk: vv for kk, vv in c.items() if kk != "jspec"}
                for k, c in cases.items()}, work / "inputs.pt")
    md5s = launch.run_ranks(4, "test_torch_port_mesh_ranks:cluster",
                            {"workdir": str(work)}, platform="cpu",
                            timeout=600, workdir=str(work), env=RANKS_ENV)
    results = torch.load(work / "results.pt", weights_only=False)
    ref = {k: ranks.run_case(c, None) for k, c in cases.items()}
    return cases, results, ref, md5s


def _jax_trainer(case):
    from tgp.pytorch_tpu import config as jcfg
    prev = jcfg.precision()
    jcfg.set_precision(case["precision"])
    try:
        X, Y = case["X"], case["Y"]
        Xte, Yte = case.get("Xte", X), case.get("Yte", Y)
        loaders = [JLoader(JDataset(X, Y), case["batch"],
                           seed=case["loader_seed"]),
                   JLoader(JDataset(Xte, Yte), case["batch"], shuffle=False)]
        tr = JTrainer(case["jspec"], _np(case["params"]), loaders,
                      Y_std=np.ones(Y.shape[1]), S_test=case["S_test"],
                      seed=case["seed"])
        tr.train(case["epochs"], case["lr"], "adam", verbose_each=0,
                 natgrad_gamma=case.get("natgrad"))
        return tr, (tr.compute_metrics() if case.get("metrics") else None)
    finally:
        jcfg.set_precision(prev)


def _same_bits_on_every_rank(md5s, name):
    assert len({m[name] for m in md5s}) == 1, name


def _leaves_close(got, want, **tol):
    want = jax.tree_util.tree_leaves(want)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, np.asarray(b), **tol)


# --------------------------------------------------------------------------
# tests/test_sharding.py
# --------------------------------------------------------------------------

def test_dp_sharded_elbo_matches_single_device(cluster):
    cases, res, ref, md5s = cluster
    c = cases["elbo_dp"]
    e_j = float(JM.elbo(c["jspec"], c["params"], c["X"], c["Y"])[0])
    np.testing.assert_allclose(res["elbo_dp"]["elbo"], e_j, rtol=1e-10)
    np.testing.assert_allclose(res["elbo_dp"]["elbo"], ref["elbo_dp"][0]
                               ["elbo"], rtol=1e-10)


def test_dp_sharded_grads_match(cluster):
    cases, res, ref, md5s = cluster
    c = cases["grads_dp"]
    g_j = jax.grad(lambda p: JM.elbo(c["jspec"], p, c["X"], c["Y"])[0])(
        c["params"])
    _leaves_close(res["grads_dp"]["grads"], g_j, **F64_GRAD)
    _leaves_close(res["grads_dp"]["grads"], ref["grads_dp"][0]["grads"],
                  **F64_GRAD)
    _same_bits_on_every_rank(md5s, "grads_dp")


def test_ty_sharded_multioutput_matches(cluster):
    cases, res, ref, md5s = cluster
    c = cases["elbo_ty"]
    e_j = float(JM.elbo(c["jspec"], c["params"], c["X"], c["Y"])[0])
    np.testing.assert_allclose(res["elbo_ty"]["elbo"], e_j, rtol=1e-10)
    _same_bits_on_every_rank(md5s, "elbo_ty")


def test_sharded_train_step_runs_and_matches(cluster):
    cases, res, ref, md5s = cluster
    c = cases["step"]
    opt = optax.adam(c["lr"])
    p = c["params"]
    g = jax.grad(lambda pp: -JM.elbo(c["jspec"], pp, c["X"], c["Y"])[0])(p)
    u, _ = opt.update(g, opt.init(p), p)
    p_ref = optax.apply_updates(p, u)
    _leaves_close(res["step"]["params"], p_ref, **F64_GRAD)
    _leaves_close(res["step"]["params"], ref["step"][0]["params"],
                  **F64_GRAD)
    _same_bits_on_every_rank(md5s, "step")


# --------------------------------------------------------------------------
# tests/test_trainer_mesh.py
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name, tol", [
    ("full_dp", dict(rtol=1e-7, atol=1e-8)),
    ("full_dp_ty", dict(rtol=1e-7, atol=1e-8)),
    ("minibatch_dp", dict(rtol=1e-6, atol=1e-7)),
    ("indivisible", dict(rtol=1e-7, atol=1e-8))])
def test_trainer_on_a_mesh_matches_unsharded(cluster, name, tol):
    """Full batch over dp and over dp x ty, minibatch over dp, and a batch
    of 62 rows that does not divide dp=4 (computed whole by every rank and
    not counted four times)."""
    cases, res, ref, md5s = cluster
    jtr, _ = _jax_trainer(cases[name])
    _leaves_close(res[name]["params"], ref[name][0]["params"], **tol)
    _leaves_close(res[name]["params"], jtr.params, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(res[name]["loss_curve"],
                               np.asarray(jtr.loss_curve, np.float64),
                               rtol=tol["rtol"])
    _same_bits_on_every_rank(md5s, name)


def test_sharded_eval_metrics_match(cluster):
    cases, res, ref, md5s = cluster
    _, m_j = _jax_trainer(cases["eval_dp"])
    m_sh, m_ref = res["eval_dp"]["metrics"]["test"], ref["eval_dp"][0][
        "metrics"]["test"]
    for k in ("logL", "rmse"):
        np.testing.assert_allclose(m_sh[k], m_j["test"][k], rtol=1e-6)
        np.testing.assert_allclose(m_sh[k], m_ref[k], rtol=1e-6)


# --------------------------------------------------------------------------
# tests/test_multihost.py
# --------------------------------------------------------------------------

def _multihost_checks(cluster, name):
    cases, res, ref, md5s = cluster
    _same_bits_on_every_rank(md5s, name)
    got = res[name]
    assert np.isfinite(got["loss_curve"]).all()
    np.testing.assert_allclose(got["loss_curve"][-1],
                               ref[name][0]["loss_curve"][-1], rtol=2e-3)
    return got["metrics"]["test"], ref[name][0]["metrics"]["test"]


def test_multi_process_cluster_matches_single_process(cluster):
    m, m_ref = _multihost_checks(cluster, "mh_dp")
    jtr, m_j = _jax_trainer(cluster[0]["mh_dp"])
    np.testing.assert_allclose(cluster[1]["mh_dp"]["loss_curve"][-1],
                               float(jtr.loss_curve[-1]), rtol=2e-3)
    for want in (m_ref, m_j["test"]):
        np.testing.assert_allclose(m["logL"], want["logL"], rtol=5e-3,
                                   atol=5e-3)
        np.testing.assert_allclose(m["rmse"], want["rmse"], rtol=5e-3)
        np.testing.assert_allclose(m["coverage"], want["coverage"], atol=0.1)


def test_layered_dp_ty_cluster(cluster):
    m, _ = _multihost_checks(cluster, "mh_dp_ty")
    assert np.isfinite(m["logL"]).all()


def test_natgrad_on_a_multi_process_cluster(cluster):
    _multihost_checks(cluster, "mh_natgrad")
    jtr, _ = _jax_trainer(cluster[0]["mh_natgrad"])
    np.testing.assert_allclose(cluster[1]["mh_natgrad"]["loss_curve"][-1],
                               float(jtr.loss_curve[-1]), rtol=2e-3)


# --------------------------------------------------------------------------
# the dry run, the mesh's rules, the CLI
# --------------------------------------------------------------------------

def test_dryrun_multichip_on_two_ranks():
    out = entry.dryrun_multichip(2)
    assert out["dp"] == 1 and out["ty"] == 2 and np.isfinite(out["elbo"])
    with pytest.raises(ValueError, match="n_devices >= 2"):
        entry.dryrun_multichip(1)


def test_mesh_rules_without_a_process_group():
    with pytest.raises(ValueError, match="dp\\*ty = 2 != device count 1"):
        pmesh.make_mesh(2, 1)
    with pytest.raises(ValueError, match="a torch rank owns one device"):
        multihost.initialize("file:///nonexistent", 1, 0, platform="cpu",
                             local_device_count=4)


def test_run_ranks_asks_for_the_card_by_default(monkeypatch):
    """`run_ranks` without `platform` asks for the card: without one it
    raises before it starts a rank, and does not fall back to gloo on the
    CPU."""
    import inspect

    assert inspect.signature(launch.run_ranks).parameters[
        "platform"].default == "gpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def no_rank(*a, **k):
        raise AssertionError("a rank was started")

    monkeypatch.setattr(launch.subprocess, "Popen", no_rank)
    with pytest.raises(RuntimeError, match="no CUDA device.*platform='cpu'"):
        launch.run_ranks(2, "test_torch_port_mesh_ranks:cluster")


def test_param_sharding_cuts_the_gp_leaves_by_meaning():
    """JAX's rule (a leading axis equal to Dy, divisible by ty) on the GP
    leaves; the per-output flow and likelihood leaves, which the likelihood
    reads after the gather on every rank, are replicated."""
    from tgp.pytorch_tpu_torch import weights

    spec, params, X, Y = _model(Dy=4, flow=G.SAL(1))
    pspec = weights.spec_from_dict(jser.spec_to_dict(spec))
    pp = weights.params_from_jax(params, device="cpu")

    class FakeMesh:
        shape = {"dp": 2, "ty": 2}

    labels = pmesh.param_sharding(pspec, pp, FakeMesh())
    flat = dict(zip(weights.tree_leaves(param_paths(pp)),
                    weights.tree_leaves(labels)))
    for path, lab in flat.items():
        gp = path.split("/")[0] in ("Z", "q_mu", "q_L", "kernel", "mean")
        assert lab.axis == ("ty" if gp else None), path
    assert any(p.startswith("flow") for p in flat)


def test_cli_mesh_2x1_under_torch_distributed_run(tmp_path):
    """`--mesh 2x1` on two ranks started by torch.distributed.run prints
    the result line of the run without a mesh (its NLL and RMSE); without
    the launcher it exits naming the command."""
    argv = ["--model", "SVGP", "--dataset", "boston",
            "--train_test_seed_split", "1", "--num_inducing", "5",
            "--epochs", "20", "--platform", "cpu", "--verbose_each", "0",
            "--precision", "fp64"]
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    mod = ["-m", "tgp.pytorch_tpu_torch.experiments.main"]
    one = subprocess.run([sys.executable, *mod, *argv], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    two = subprocess.run([sys.executable, "-m", "torch.distributed.run",
                          "--standalone", "--nproc_per_node", "2", *mod,
                          *argv, "--mesh", "2x1"], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert one.returncode == 0 and two.returncode == 0, two.stderr[-3000:]

    def line(out):
        return [ln for ln in out.splitlines()
                if ln.startswith("Dataset ")][-1].rsplit(" (", 1)[0]

    assert line(two.stdout) == line(one.stdout)
    assert two.stdout.count("Dataset ") == 1          # rank 0 prints
    assert "2x1 (dp x ty) device mesh" in two.stdout
    bare = subprocess.run([sys.executable, *mod, *argv, "--mesh", "2x1"],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=300)
    assert bare.returncode != 0
    assert "torch.distributed.run --nproc_per_node 2" in bare.stderr
