"""The PyTorch port's `serve.Predictor` against the JAX package's, on the
CPU, fp64, plus the port's guards: it imports no JAX, and its entry points
never fall back to the CPU.

Moments and log-densities: rtol 1e-8, atol 1e-10 (same float64 math on both
sides; only the order of sums differs).  Samples and bands come from other
random streams than JAX's, so they are held to the JAX moments within their
Monte Carlo error.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tgp.pytorch_tpu.models import tgp as JM
from tgp.pytorch_tpu.serve import Predictor as JPredictor
from tgp.pytorch_tpu.ops import kernels as jK
from tgp.pytorch_tpu.likelihoods import LikelihoodSpec as JLik
from tgp.pytorch_tpu.flows import generators as jG, spec_from_list

from tgp.pytorch_tpu_torch import config as pcfg, weights
from tgp.pytorch_tpu_torch.serve import Predictor

F64 = dict(rtol=1e-8, atol=1e-10)
REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "tgp" / "pytorch_tpu_torch"


@pytest.fixture(autouse=True)
def _port_state():
    prev, dt = pcfg.precision(), torch.get_default_dtype()
    pcfg.set_precision("fp64")
    yield
    pcfg.set_precision(prev)
    assert torch.get_default_dtype() == dt


@pytest.fixture(scope="module")
def model():
    """Flagship structure (SAL 2, scale-RBF, whitened q(U)) at Dx=3, M=9."""
    rng = np.random.RandomState(0)
    X = rng.randn(40, 3)
    spec_p = weights.flagship_spec(40, Dx=3, M=9, quad=40)
    prev = pcfg.precision()
    pcfg.set_precision("fp64")
    pp = weights.flagship_params(spec_p, X, seed=2, device="cpu")
    pcfg.set_precision(prev)
    fspec, _ = spec_from_list(jG.SAL(2))
    spec_j = JM.TGPSpec(Dy=1, Dx=3, M=9, N=40.0, kernel=jK.from_name("scale_rbf"),
                        likelihood=JLik("gaussian_flow", 1, quad_points=40),
                        flow=fspec)
    pj = weights.tree_map(lambda t: jnp.asarray(t.numpy()), pp)
    Xq = rng.randn(70, 3)
    Yq = rng.randn(70, 1)
    return spec_j, pj, spec_p, pp, Xq, Yq


KW = dict(Y_std=2.0, Y_mean=1.0, buckets=(16, 64))


@pytest.mark.parametrize("n", [10, 50])
def test_moments_match_jax_predictor_with_padding(model, n):
    spec_j, pj, spec_p, pp, Xq, _ = model
    oj = JPredictor(spec_j, pj, **KW).predict(Xq[:n], quantiles=None)
    op = Predictor(spec_p, pp, device="cpu", **KW).predict(Xq[:n], quantiles=None)
    assert set(op) == set(oj) == {"mean", "var"}
    for k in oj:
        assert op[k].shape == (1, n)
        np.testing.assert_allclose(op[k], oj[k], **F64)


@pytest.mark.parametrize("n", [10, 50])
def test_log_prob_matches_jax_predictor(model, n):
    spec_j, pj, spec_p, pp, Xq, Yq = model
    lj = JPredictor(spec_j, pj, **KW).log_prob(Xq[:n], Yq[:n])
    lp = Predictor(spec_p, pp, device="cpu", **KW).log_prob(Xq[:n], Yq[:n])
    assert lp.shape == (1,)
    np.testing.assert_allclose(lp, lj, **F64)


def test_samples_within_monte_carlo_error_of_jax_moments(model):
    spec_j, pj, spec_p, pp, Xq, _ = model
    S = 5000
    oj = JPredictor(spec_j, pj, **KW).predict(Xq[:12], quantiles=None)
    op = Predictor(spec_p, pp, device="cpu", seed=1, **KW).predict(
        Xq[:12], samples=S)
    y = op["samples"]
    assert y.shape == (1, S, 12)
    assert np.all(np.abs(y.mean(1) - oj["mean"]) < 5 * np.sqrt(oj["var"] / S))
    c = y - y.mean(1, keepdims=True)
    se_var = np.sqrt(((c ** 4).mean(1) - oj["var"] ** 2).clip(0) / S)
    assert np.all(np.abs(y.var(1) - oj["var"]) < 6 * se_var)
    # the band is the samples' own linear-interpolation quantiles
    np.testing.assert_allclose(op["lower"], np.quantile(y, 0.025, axis=1), **F64)
    np.testing.assert_allclose(op["upper"], np.quantile(y, 0.975, axis=1), **F64)


def test_bands_within_monte_carlo_error_of_jax_bands(model):
    # both bands are 200-sample quantile estimates from independent streams;
    # each 2.5% quantile estimate has a standard error of about
    # sqrt(p(1-p)/S)/pdf(q) ~ 0.19 sd, so their gap is held to 6 x 0.27 sd
    # per point and to 6 x 0.27 sd / sqrt(n) on average
    spec_j, pj, spec_p, pp, Xq, _ = model
    oj = JPredictor(spec_j, pj, **KW).predict(Xq[:60])
    op = Predictor(spec_p, pp, device="cpu", **KW).predict(Xq[:60])
    np.testing.assert_allclose(op["mean"], oj["mean"], **F64)
    sd = np.sqrt(oj["var"])
    for k in ("lower", "upper"):
        gap = (op[k] - oj[k]) / sd
        assert np.all(np.abs(gap) < 6 * 0.27)
        assert abs(gap.mean()) < 6 * 0.27 / np.sqrt(60)
    assert np.all(op["lower"] <= op["mean"]) and np.all(op["mean"] <= op["upper"])


def test_streams_are_distinct_and_reproducible(model):
    _, _, spec_p, pp, Xq, _ = model
    a = Predictor(spec_p, pp, device="cpu", seed=5, **KW)
    b = Predictor(spec_p, pp, device="cpu", seed=5, **KW)
    a1, a2 = (a.predict(Xq[:8], samples=20)["samples"] for _ in range(2))
    b1 = b.predict(Xq[:8], samples=20)["samples"]
    np.testing.assert_array_equal(a1, b1)
    assert not np.allclose(a1, a2)


def test_map_equals_sequential_predict(model):
    _, _, spec_p, pp, Xq, _ = model
    reqs = [Xq[:5], Xq[5:40], Xq[40:70]]
    seq = Predictor(spec_p, pp, device="cpu", seed=3, **KW)
    par = Predictor(spec_p, pp, device="cpu", seed=3, **KW)
    for samples in (0, 30):
        want = [seq.predict(r, samples=samples) for r in reqs]
        got = par.map(reqs, samples=samples)
        for w, g in zip(want, got):
            assert w.keys() == g.keys()
            for k in w:
                np.testing.assert_array_equal(g[k], w[k])


def test_bad_requests_raise(model):
    _, _, spec_p, pp, Xq, _ = model
    pred = Predictor(spec_p, pp, device="cpu", **KW)
    with pytest.raises(ValueError, match="empty"):
        pred.predict(Xq[:0])
    with pytest.raises(ValueError, match="largest bucket"):
        pred.predict(np.zeros((65, 3)))
    with pytest.raises(ValueError, match="quantiles"):
        pred.predict(Xq[:3], quantiles=(0.1, 0.5, 0.9))
    # fully_bayesian is ported: on a flow that draws nothing it answers as
    # the point predictor does
    fb = Predictor(spec_p, pp, device="cpu", fully_bayesian=True, **KW)
    pt = Predictor(spec_p, pp, device="cpu", **KW)
    a, b = (p.predict(Xq[:5], quantiles=None) for p in (fb, pt))
    for k in ("mean", "var"):
        np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("name", ["sal_mc", "sal_vi"])
def test_fully_bayesian_predictor_matches_jax(monkeypatch, name):
    """`Predictor(fully_bayesian=True)` on an ID TGP (Dy=2) against the JAX
    Predictor: moments and log-densities with the JAX Predictor's hypernet
    draws replayed to the port (`test_torch_port_hypernet.JaxOrderReplay`);
    with the port's own draws, samples and bands within their Monte Carlo
    error of the mixture."""
    from test_torch_port_hypernet import JaxOrderReplay, id_model

    spec_j, spec_p, pj, pp, X, Y, _ = id_model(name)
    kw = dict(Y_std=[2.0, 0.5], Y_mean=[1.0, -1.0], buckets=(16, 64), S_MC=8,
              fully_bayesian=True)
    replay = JaxOrderReplay().patch(monkeypatch)
    pj_ = JPredictor(spec_j, pj, **kw)
    pp_ = Predictor(spec_p, pp, device="cpu", **kw)

    def jax_then_port(call):
        out_j = call(pj_)
        replay.seal()
        return out_j, call(pp_)

    oj, op = jax_then_port(lambda p: p.predict(X[:10], quantiles=None))
    for k in ("mean", "var"):
        assert op[k].shape == (2, 10)
        np.testing.assert_allclose(op[k], oj[k], **F64)
    lj, lp = jax_then_port(lambda p: p.log_prob(X[:10], Y[:10]))
    np.testing.assert_allclose(lp, lj, **F64)
    assert replay.queue == [] and replay.sites > 0
    monkeypatch.undo()              # the port's own draws from here on
    if name != "sal_mc":
        # the VI nets' samples are heavy-tailed at this init; they are held
        # exactly against JAX's with replayed draws in
        # test_torch_port_hypernet
        return
    # samples, one flow draw each, around the mixture of as many draws
    S = 4000
    out = pp_.predict(X[:10], samples=S)
    mix = Predictor(spec_p, pp, device="cpu", **dict(kw, S_MC=S)).predict(
        X[:10], quantiles=None)
    s = out["samples"]
    assert s.shape == (2, S, 10)
    assert np.all(np.abs(s.mean(1) - mix["mean"]) <= 4 * np.sqrt(2 * s.var(1) / S))
    assert np.all(out["lower"] < out["upper"])


# ---------------------------------------------------------------------------
# guards
# ---------------------------------------------------------------------------

def test_default_device_raises_without_cuda(model):
    _, _, spec_p, pp, _, _ = model
    if torch.cuda.is_available():
        pytest.skip("this host has a card; the default device is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Predictor(spec_p, pp)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        weights.params_from_jax({"a": np.zeros(2)})


def test_port_imports_no_jax_in_a_fresh_process():
    code = (
        "import importlib, pkgutil, sys\n"
        "import tgp.pytorch_tpu_torch as P\n"
        "names = [m.name for m in pkgutil.walk_packages(P.__path__, P.__name__ + '.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'tgp.pytorch_tpu' or m.startswith('tgp.pytorch_tpu.')]\n"
        "assert len(names) >= 12, names\n"
        "assert not bad, bad\n"
        "print('ok', len(names))\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok")


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_sources_import_no_jax():
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 12 and files[-1].exists()
    for f in files:
        for mod in _imports(f):
            root = mod.split(".")[0]
            assert root != "jax", f"{f} imports {mod}"
            assert mod != "tgp.pytorch_tpu" and not mod.startswith(
                "tgp.pytorch_tpu."), f"{f} imports {mod}"
            assert mod != "tgp", f"{f} imports {mod}"
