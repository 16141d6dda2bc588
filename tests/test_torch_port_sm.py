"""The port's spectral-mixture forecast (`experiments/sm_timeseries.py`)
and its periodogram (`ops/spectral.py`) against the JAX package's
(`benchmarks/sm_timeseries.py`, `ops/spectral.py`), on the CPU, fp64.

  * `estimate_spectral_density` on the series of the JAX package's
    `tests/test_sm_timeseries.py` and on the forecast's full series;
  * the forecast for 'scale_rbf', 'spectral_mixture' and 'sm' at the JAX
    test's small size (288 hours, M=16, 30 epochs): the detected periods
    and the printed record but its times; the ELBO at the start at rtol
    1e-8, atol 1e-10, and its gradient within 1e-8 of the largest entry;
    after 30 epochs, the curves, every trained parameter (relative to its
    largest entry) and the forecast NLL and RMSE.

The 30-epoch runs are held at rtol 1e-8, atol 1e-10 ('spectral_mixture',
whose largest gap was 1.8e-11) or at 10x the gaps measured on a CPU
(`TRAJECTORY_LIMITS`).  'sm' parts by 1.1e-8 in q_L: the
port's own run from a start scaled by (1 + 1e-15) parts from the unscaled
one by 3.0e-8 there, so the gap is the trajectory's.  'scale_rbf' is
ill-conditioned on this series: 16 evenly spaced inducing points at
lengthscale 2 give K_zz a condition number of 4e18 (1e-8 jitter), Z's
gradient at the start is 1e-9 of the largest entry and made of rounding
(it differs by 36% between the packages), and Adam steps each coordinate
of Z by the learning rate with that rounding's sign; the curves part by
5e-7 after one step and 4.7e-5 after 30.
"""

import sys
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import tgp.pytorch_tpu.train as jtrain
from tgp.pytorch_tpu import config as jcfg
from tgp.pytorch_tpu.models import tgp as JM
from tgp.pytorch_tpu.ops.spectral import estimate_spectral_density as j_esd

from tgp.pytorch_tpu_torch import config as pcfg, weights
from tgp.pytorch_tpu_torch.experiments import sm_timeseries as psm
from tgp.pytorch_tpu_torch.models import tgp as PM
from tgp.pytorch_tpu_torch.train.optimizers import param_paths
from tgp.pytorch_tpu_torch.ops.spectral import estimate_spectral_density

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "benchmarks"))
import sm_timeseries as jsm       # noqa: E402

F64 = dict(rtol=1e-8, atol=1e-10)
#: 10x the largest gaps measured after 30 epochs (the curves relative, the
#: leaves relative to their largest entry, NLL and RMSE absolute)
TRAJECTORY_LIMITS = {
    "sm": dict(curve=3.6e-8, nll=2.8e-7, rmse=3.8e-8, leaves=1.2e-7),
    "scale_rbf": dict(curve=4.7e-4, nll=8.3e-3, rmse=4.4e-4, leaves={
        "Z": 2.3e-2, "kernel/child/raw_lengthscale": 5.9e-5,
        "kernel/raw_outputscale": 5.5e-6, "likelihood/log_var_noise": 2.6e-6,
        "q_L": 1.2e-1, "q_mu": 1.9e-2}),
}


@pytest.fixture(autouse=True)
def _port_state():
    prev, jprev, dt = pcfg.precision(), jcfg.precision(), torch.get_default_dtype()
    nt = torch.get_num_threads()
    pcfg.set_precision("fp64")
    torch.set_num_threads(1)        # small eager ops; the workers share the cores
    yield
    torch.set_num_threads(nt)
    pcfg.set_precision(prev)
    if jcfg.precision() != jprev:
        jcfg.set_precision(jprev)
    assert torch.get_default_dtype() == dt


def close(port, ref, **tol):
    port = port.detach().cpu().numpy() if torch.is_tensor(port) else port
    np.testing.assert_allclose(np.asarray(port, np.float64),
                               np.asarray(ref, np.float64), **(tol or F64))


def test_series_and_periodogram_match():
    # the JAX package's tests/test_sm_timeseries.py series (288 hours, a
    # daily harmonic), and the forecast's full series (8 weeks)
    rng = np.random.RandomState(0)
    t = np.arange(288, dtype=np.float64)
    y = 1.5 * np.sin(2 * np.pi * t / 24.0 + 0.7) + 0.25 * rng.randn(288)
    full = psm.make_series()
    np.testing.assert_array_equal(np.concatenate(full, axis=1),
                                  np.concatenate(jsm.make_series(), axis=1))
    for x, yy, prom in ((t[:240], y[:240], 1.0),
                        (full[0][:, 0], full[1][:, 0], 1.0),
                        (full[0][:, 0], full[1][:, 0], 1000.0)):
        got = estimate_spectral_density(x, yy, prominence=prom,
                                        return_power=True)
        want = j_esd(x, yy, prominence=prom, return_power=True)
        assert [len(g) for g in got] == [len(w) for w in want]
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    assert estimate_spectral_density(t, y)[1] == j_esd(t, y)[1]


@pytest.mark.parametrize("kernel", psm.KERNELS)
def test_forecast_matches_the_jax_benchmark(monkeypatch, capsys, kernel):
    seen = {}

    class Caught(jtrain.Trainer):
        def __init__(self, spec, params, *a, **k):
            # the JAX Trainer donates its params: keep a host copy
            seen["init"] = jax.tree_util.tree_map(np.array, params)
            super().__init__(spec, params, *a, **k)
            seen["trainer"] = self

        def compute_metrics(self):
            seen["metrics"] = super().compute_metrics()
            return seen["metrics"]

    monkeypatch.setattr(jtrain, "Trainer", Caught)
    make = jsm.make_series
    monkeypatch.setattr(jsm, "make_series", lambda: make(288))
    jcfg.set_precision("fp64")
    rec_j = jsm.run(kernel, 30, M_ind=16)
    jout = capsys.readouterr().out
    res = psm.run(kernel, 30, M_ind=16, n_hours=288, device="cpu")
    pout = capsys.readouterr().out
    assert pout == jout                    # the detected periods, if any
    for k in ("kernel", "epochs", "M", "components"):
        assert res.record[k] == rec_j[k]
    jt, pt = seen["trainer"], res.trainer
    assert pt.spec.kernel.kind == jt.spec.kernel.kind

    # the ELBO and its gradient at the start
    X, Y = pt.train_loader.dataset.X, pt.train_loader.dataset.Y
    spec_j, p0 = jt.spec, seen["init"]
    ej, gj = jax.jit(jax.value_and_grad(lambda p: JM.elbo(
        spec_j, p, jnp.asarray(X), jnp.asarray(Y))[0]))(p0)
    leaves = weights.params_from_jax(p0, device="cpu", dtype=torch.float64)
    leaves = weights.tree_map(lambda t: t.requires_grad_(True), leaves)
    ep = PM.elbo(pt.spec, leaves, torch.tensor(X), torch.tensor(Y))[0]
    close(ep, ej)
    gp = torch.autograd.grad(ep, weights.tree_leaves(leaves),
                             allow_unused=True, materialize_grads=True)
    gj = jax.tree_util.tree_leaves(gj)
    top = max(float(np.abs(g).max()) for g in gj)
    for a, b in zip(gp, gj):
        close(a, b, rtol=0, atol=1e-8 * top)

    # 30 epochs
    lim = TRAJECTORY_LIMITS.get(kernel)
    for attr in ("loss_curve", "ell_curve", "kld_curve"):
        want = np.asarray([float(v) for v in getattr(jt, attr)])
        got = np.asarray(getattr(pt, attr))
        if lim is None:
            close(got, want)
        else:
            assert np.abs(got - want).max() <= lim["curve"] * np.abs(want).max()
    names = weights.tree_leaves(param_paths(pt.params))
    jl = jax.tree_util.tree_leaves(jt.params)
    pl = weights.tree_leaves(pt.params)
    assert len(jl) == len(pl) == len(names) > 0
    for name, a, b in zip(names, pl, jl):
        if lim is None:
            close(a, b)
            continue
        b = np.asarray(b)
        leaf = lim["leaves"] if np.isscalar(lim["leaves"]) else lim["leaves"][name]
        gap = np.abs(a.detach().numpy() - b).max() / np.abs(b).max()
        assert gap <= leaf, (name, gap)
    for k in ("logL", "rmse"):
        got, want = res.metrics[k], seen["metrics"]["test"][k]
        if lim is None:
            close(got, want)
        else:
            assert np.abs(got - want).max() <= lim["nll" if k == "logL" else k]
