"""The port's library surface against the JAX package's, on the CPU:

  * every name that a JAX package `__init__` exports (the lazy top-level
    API, `models`, `ops`, `flows`, `likelihoods`, `train`, `data`) resolves
    in the port's counterpart, and the JAX examples' import lines, with
    `pytorch_tpu` replaced by `pytorch_tpu_torch`, import;
  * `svgp_spec` equals JAX's field for field (through `spec_to_dict`);
  * `TGP`'s five methods against JAX `TGP` on the same numpy-seeded inputs
    and parameters (`weights.params_from_jax`), in fp64; the posterior
    samples' normals are the port's, handed to JAX;
  * the examples (`examples.quickstart`, `examples.deep_tgp`) at
    `--platform cpu` and a few epochs: the quickstart's checkpoint reads
    back bitwise, its metrics (fp64, M=10) and the deep example's SVGP
    baseline against the same steps through the JAX functions (logL and
    RMSE: no draws; coverage draws from each package's own stream), the
    deep layer, whose draws differ between the packages, finite.
Values at rtol 1e-8, atol 1e-10 (the same float64 math on both sides).
"""

import ast
import importlib
import inspect
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tgp.pytorch_tpu import config as jcfg
from tgp.pytorch_tpu import data as jdata
from tgp.pytorch_tpu.flows import generators as jG, spec_from_list as j_spec
from tgp.pytorch_tpu.likelihoods import LikelihoodSpec as JLik
from tgp.pytorch_tpu.models import serialization as jser, tgp as JM
from tgp.pytorch_tpu.ops import kernels as jK
from tgp.pytorch_tpu.train import Trainer as JTrainer

from tgp.pytorch_tpu_torch import config as pcfg, weights
from tgp.pytorch_tpu_torch.examples import deep_tgp as pdeep_ex
from tgp.pytorch_tpu_torch.examples import quickstart as pquick
from tgp.pytorch_tpu_torch.likelihoods import LikelihoodSpec
from tgp.pytorch_tpu_torch.models import serialization as pser, tgp as PM
from tgp.pytorch_tpu_torch.ops import kernels as pK
from tgp.pytorch_tpu_torch.train.checkpoint import load_checkpoint

from test_torch_port_large import jax_native_parser

REPO = Path(__file__).resolve().parents[1]
F64 = dict(rtol=1e-8, atol=1e-10)


@pytest.fixture(autouse=True)
def _port_state():
    prev, jprev, dt = pcfg.precision(), jcfg.precision(), torch.get_default_dtype()
    pcfg.set_precision("fp64")
    yield
    pcfg.set_precision(prev)
    if jcfg.precision() != jprev:
        jcfg.set_precision(jprev)
    assert torch.get_default_dtype() == dt


def close(port, ref, **tol):
    port = port.detach().cpu().numpy() if torch.is_tensor(port) else port
    np.testing.assert_allclose(np.asarray(port, np.float64),
                               np.asarray(ref, np.float64), **(tol or F64))


def to_port(tree):
    return weights.params_from_jax(jax.tree_util.tree_map(np.asarray, tree),
                                   device="cpu", dtype=torch.float64)


# ---------------------------------------------------------------------------
# the names
# ---------------------------------------------------------------------------

SUBPACKAGES = ["", "models", "ops", "flows", "likelihoods", "train", "data"]


def exported_names(init_py: Path):
    """The names a package `__init__` binds: what it imports, defines and
    assigns, and the names its lazy `__getattr__` compares against."""
    names = set()
    for node in ast.parse(init_py.read_text()).body:
        if isinstance(node, ast.ImportFrom):
            names |= {a.asname or a.name for a in node.names}
        elif isinstance(node, ast.Assign):
            names |= {t.id for t in node.targets if isinstance(t, ast.Name)}
        elif isinstance(node, ast.FunctionDef) and node.name == "__getattr__":
            for cmp in ast.walk(node):
                if isinstance(cmp, ast.Compare):
                    names |= {c.value for c in ast.walk(cmp)
                              if isinstance(c, ast.Constant)
                              and isinstance(c.value, str)}
        elif isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
    return names - {"__getattr__"}


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_every_jax_export_resolves_in_the_port(sub):
    path = REPO / "tgp" / "pytorch_tpu" / sub / "__init__.py"
    names = exported_names(path)
    assert names, path
    mod = "." + sub if sub else ""
    jmod = importlib.import_module("tgp.pytorch_tpu" + mod)
    pmod = importlib.import_module("tgp.pytorch_tpu_torch" + mod)
    for name in sorted(names):
        ours = getattr(pmod, name)
        assert callable(ours) == callable(getattr(jmod, name)), name
    if not sub:
        assert {"TGPSpec", "TGP", "svgp_spec", "init_tgp_params", "Trainer",
                "Predictor", "return_dataset", "kmeans_centers",
                "LikelihoodSpec"} <= names


@pytest.mark.parametrize("example", ["quickstart.py", "deep_tgp.py"])
def test_the_jax_examples_import_lines_import_from_the_port(example):
    """Each `from tgp.pytorch_tpu... import ...` of a JAX example, with the
    package renamed, imports, and binds only port objects."""
    tree = ast.parse((REPO / "examples" / example).read_text())
    lines = [n for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)
             and (n.module or "").startswith("tgp.pytorch_tpu")]
    assert lines
    for node in lines:
        node.module = node.module.replace("tgp.pytorch_tpu",
                                          "tgp.pytorch_tpu_torch", 1)
        scope = {}
        exec(compile(ast.Module([node], []), example, "exec"), scope)
        for name in (a.asname or a.name for a in node.names):
            assert inspect.getmodule(scope[name]).__name__.startswith(
                "tgp.pytorch_tpu_torch"), name


@pytest.mark.parametrize("kw", [{}, {"flow_is_shared": True, "whiten": False}],
                         ids=["defaults", "overrides"])
def test_svgp_spec_matches_jax(kw):
    common = dict(Dy=2, Dx=3, M=5, N=40.0, **kw)
    want = jser.spec_to_dict(JM.svgp_spec(
        kernel=jK.from_name("scale_rbf"), likelihood=JLik("gaussian", 2),
        **common))
    got = pser.spec_to_dict(PM.svgp_spec(
        kernel=pK.from_name("scale_rbf"),
        likelihood=LikelihoodSpec("gaussian", 2), **common))
    assert got == want
    assert PM.svgp_spec(kernel=pK.from_name("rbf"),
                        likelihood=LikelihoodSpec("gaussian", 1), Dy=1, Dx=1,
                        M=2, N=1.0).has_flow is False


# ---------------------------------------------------------------------------
# TGP, the stateful wrapper
# ---------------------------------------------------------------------------

def wrapped_models(N=30, Dx=3, M=6):
    """(JAX TGP, port TGP, X, Y, Y_std): a SAL(1) TGP through the
    quadrature, its parameters moved off the init by seeded noise."""
    rs = np.random.RandomState(4)
    X = rs.randn(N, Dx)
    Y = np.sinh(X @ rs.randn(Dx, 1)) + 0.1 * rs.randn(N, 1)
    np.random.seed(0)
    flow, finits = j_spec(jG.SAL(1))
    spec_j = JM.TGPSpec(Dy=1, Dx=Dx, M=M, N=float(N),
                        kernel=jK.from_name("scale_rbf"),
                        likelihood=JLik("gaussian_flow", 1, quad_points=10),
                        flow=flow)
    pj = JM.init_tgp_params(spec_j, X, X[:M].copy(), variance_scale=1e-2,
                            kernel_init={"length_scale": 2.0,
                                         "kernel_scale": 2.0},
                            noise_init=0.05, flow_inits=finits)
    pj = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rs.randn(*np.shape(a)), pj)
    spec_p = weights.spec_from_dict(jser.spec_to_dict(spec_j))
    return (JM.TGP(spec_j, jax.tree_util.tree_map(jnp.asarray, pj)),
            PM.TGP(spec_p, to_port(pj)), X, Y, np.array([1.7]))


def jax_normals_from(monkeypatch, arrays):
    """The JAX model's `jax.random.normal` returns `arrays` in turn."""
    queue = list(arrays)

    class Random:
        @staticmethod
        def normal(key, shape, dtype=jnp.float64):
            a = queue.pop(0)
            assert a.shape == tuple(shape)
            return jnp.asarray(a, dtype)

        def __getattr__(self, name):
            return getattr(jax.random, name)

    class Jax:
        random = Random()

        def __getattr__(self, name):
            return getattr(jax, name)

    monkeypatch.setattr(JM, "jax", Jax())


@pytest.mark.parametrize("method", ["elbo", "marginal_qf",
                                    "predictive_distribution",
                                    "test_log_likelihood",
                                    "sample_predictive"])
def test_tgp_methods_match_jax(monkeypatch, method):
    jt, pt, X, Y, Ys = wrapped_models()
    Xj, Yj, Ysj = jnp.asarray(X), jnp.asarray(Y), jnp.asarray(Ys)
    Xp, Yp, Ysp = (torch.as_tensor(a) for a in (X, Y, Ys))
    S = 4
    if method == "sample_predictive":
        g = torch.Generator().manual_seed(7)
        eps, noise = (torch.randn((S, 1, X.shape[0]), generator=g,
                                  dtype=torch.float64) for _ in range(2))
        jax_normals_from(monkeypatch, [eps.numpy(), noise.numpy()])
    calls = {
        "elbo": ((Xj, Yj), (Xp, Yp), {}),
        "marginal_qf": ((Xj,), (Xp,), {}),
        "predictive_distribution": ((Xj,), (Xp,), {}),
        "test_log_likelihood": ((Xj, Yj, Ysj), (Xp, Yp, Ysp),
                                {"reduce": False}),
        "sample_predictive": ((Xj, S, jax.random.PRNGKey(2)),
                              (Xp, S, torch.Generator().manual_seed(7)), {}),
    }
    ja, pa, kw = calls[method]
    want = getattr(jt, method)(*ja, **kw)
    got = getattr(pt, method)(*pa, **kw)
    if method == "test_log_likelihood":
        want, got = (want,), (got,)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        close(a, b)
    # the wrapper is the functional call on its spec and params
    if method == "sample_predictive":
        pa = (Xp, S, torch.Generator().manual_seed(7))
    plain = getattr(PM, method)(pt.spec, pt.params, *pa, **kw)
    for a, b in zip(got, plain if isinstance(plain, tuple) else (plain,)):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the examples
# ---------------------------------------------------------------------------

def test_quickstart_main_runs_and_its_checkpoint_reads_back(monkeypatch,
                                                            tmp_path, capsys):
    """`main` at --platform cpu (the example's fp32, M=50): the JAX
    example's printed lines, finite metrics and prediction, and the
    checkpoint (under the working directory) read back bitwise."""
    monkeypatch.chdir(tmp_path)
    res = pquick.main(["--platform", "cpu", "--epochs", "3"])
    out = capsys.readouterr().out.splitlines()
    assert [line.split(":")[0] for line in out] == [
        "test", "checkpoint", "predictive mean", "95% band low   ",
        "95% band high  "]
    assert res["checkpoint"] == str(tmp_path / pquick.CHECKPOINT_DIR
                                    / "step_3")
    assert res["trainer"].params["q_mu"].dtype == torch.float32
    assert res["trainer"].params["Z"].shape == (1, 50, 13)
    for v in res["metrics"]["test"].values():
        assert np.all(np.isfinite(v))
    for k in ("mean", "lower", "upper"):
        assert res["prediction"][k].shape == (1, 10)
        assert np.all(np.isfinite(res["prediction"][k]))
    params, _, step, extra = load_checkpoint(str(tmp_path /
                                                 pquick.CHECKPOINT_DIR))
    assert step == 3
    for a, b in zip(weights.tree_leaves(params),
                    weights.tree_leaves(res["trainer"].params)):
        assert torch.equal(a, b.detach())
    assert pser.spec_from_json(extra["spec"]) == res["spec"]
    assert json.loads(extra["spec"]) == pser.spec_to_dict(res["spec"])


def to_jax(tree):
    return weights.tree_map(lambda t: jnp.asarray(t.detach().cpu().numpy()),
                            tree)


def same_inputs(port_tree, jax_tree):
    """Two parameter trees equal leaf for leaf (the same init)."""
    jl = jax.tree_util.tree_leaves(jax_tree)
    pl = weights.tree_leaves(port_tree)
    assert len(jl) == len(pl) > 0
    for a, b in zip(pl, jl):
        close(a, b)


def jax_metrics(spec, params, loaders, Y_std, S_test):
    """The JAX Trainer's `compute_metrics` of `params` (no training)."""
    return JTrainer(spec, to_jax(params), loaders, Y_std,
                    S_test=S_test).compute_metrics()


def test_quickstart_matches_the_jax_quickstart(tmp_path):
    """The quickstart's run in fp64 at M=10 for 20 epochs: its Z0, spec and
    initial params are the JAX quickstart's steps 1-2 (k-means with
    n_init=10, the SAL(2) init), and its metrics on both splits are the
    JAX Trainer's `compute_metrics` of the trained params (logL and RMSE;
    coverage draws from each package's stream).  The trajectories are not
    held step for step here: at this init Adam turns gradients of rounding
    size into steps (8.5e-8 in the flow after one epoch); the Trainer
    against the JAX Trainer is `test_torch_port_train.py`'s."""
    jax_native_parser()
    epochs, M = 20, 10
    res = pquick.run(epochs, "cpu", num_inducing=M, precision="fp64",
                     checkpoint_dir=str(tmp_path / "ck"), verbose_each=0)
    jcfg.set_precision("fp64")
    loaders, dc = jdata.return_dataset("boston", 10000, None, seed=1)
    np.random.seed(0)
    flow, finits = j_spec(jG.SAL(2))
    spec = JM.TGPSpec(Dy=dc["Dy"], Dx=dc["Dx"], M=M, N=float(dc["N_tr"]),
                      kernel=jK.from_name("scale_rbf"),
                      likelihood=JLik("gaussian_flow", dc["Dy"],
                                      quad_points=100), flow=flow)
    params = JM.init_tgp_params(
        spec, dc["X_tr"], jdata.kmeans_centers(dc["X_tr"], M, n_init=10),
        variance_scale=1e-5,
        kernel_init={"length_scale": 2.0, "kernel_scale": 2.0},
        noise_init=0.05, flow_inits=finits)
    assert pser.spec_to_dict(res["spec"]) == jser.spec_to_dict(spec)
    same_inputs(res["params"], params)
    for k in ("X_tr", "Y_tr", "Y_std", "Y_mean"):
        np.testing.assert_array_equal(res["data"][k], dc[k])
    assert np.all(np.isfinite(res["trainer"].loss_curve))
    jm = jax_metrics(spec, res["trainer"].params, loaders, dc["Y_std"], 100)
    for split in ("train", "test"):
        for k in ("logL", "rmse"):
            close(res["metrics"][split][k], jm[split][k])
        assert np.all((res["metrics"][split]["coverage"] >= 0)
                      & (res["metrics"][split]["coverage"] <= 1))


def test_deep_example_runs_and_its_svgp_matches_jax(capsys):
    """`main` at --platform cpu for 20 epochs: the JAX example's three
    lines; the shallow SVGP's initial params are the JAX example's, and
    its test logL and RMSE the JAX Trainer's `compute_metrics` of its
    trained params (at this init Adam turns Z's gradient of rounding size
    into a step of either sign, so the packages' runs part at the second
    epoch); the deep layer (its draws differ between the packages)
    finite."""
    epochs = 20
    res = pdeep_ex.main(["--platform", "cpu", "--epochs", str(epochs)])
    out = capsys.readouterr().out.splitlines()
    assert [line[:13] for line in out[:2]] == ["shallow SVGP ",
                                               "2-layer deep "]
    for v in res["deep"]["metrics"].values():
        assert np.all(np.isfinite(v))
    assert np.all(np.isfinite(res["deep"]["trainer"].loss_curve))
    jcfg.set_precision("fp64")
    from tgp.pytorch_tpu.data.batching import ArrayDataset, DataLoader
    X, Y, Xte, Yte = pdeep_ex.data()
    spec = JM.TGPSpec(Dy=1, Dx=1, M=16, N=float(X.shape[0]),
                      kernel=jK.from_name("scale_rbf"),
                      likelihood=JLik("gaussian", 1))
    same_inputs(res["shallow"]["params"],
                JM.init_tgp_params(spec, X, X[::10][:16],
                                   variance_scale=1e-5))
    loaders = [DataLoader(ArrayDataset(X, Y), 200, seed=0),
               DataLoader(ArrayDataset(Xte, Yte), 200, shuffle=False)]
    want = jax_metrics(spec, res["shallow"]["trainer"].params, loaders, np.ones(1),
                       50)["test"]
    for k in ("logL", "rmse"):
        close(res["shallow"]["metrics"][k], want[k])
