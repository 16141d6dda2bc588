"""The port's plateau guard, its recovery, the solve warm-up and the CLI's
solve levers, against the JAX package on the CPU, fp64.

  * the guard's five cases of the JAX package's
    `tests/test_trainer_plateau.py` (boston, M=5, minibatches of 100), the
    firing one held against the JAX Trainer's event and curves;
  * `recover` (`tests/test_plateau_recovery.py`): a full-batch run that
    swaps to trsm/'highest' at its first check repeats, bit for bit, a
    manual run that swaps the spec at the same epoch (on the CPU every
    solve mode computes the same thing), and the JAX Trainer's recovery
    run at rtol 1e-8; the minibatch path; 'recover' on an all-'highest'
    spec only warns;
  * the warm-up swap (`tests/test_fast_solves.py:69`): 8 epochs at
    trsm/'highest', the spec swapped, 12 more repeat 20 epochs at
    fast/'high' (the Adam moments carried; trsm and the GEMMs against
    L^{-1} round differently, so at rtol 1e-8, atol 1e-10);
  * the CLI against the JAX CLI (`experiments/main.py`) on boston SVGP,
    M=5, 20 epochs, with the four levers: the curves, the parameters, the
    metrics and the printed lines at rtol 1e-8, atol 1e-10.
"""

import dataclasses
import sys
from pathlib import Path

import numpy as np
import jax
import pytest
import torch

import tgp.pytorch_tpu.train as jtrain
from tgp.pytorch_tpu import config as jcfg
from tgp.pytorch_tpu.data.batching import ArrayDataset as JDataset, \
    DataLoader as JLoader
from tgp.pytorch_tpu.data.registry import return_dataset as j_return_dataset
from tgp.pytorch_tpu.flows import generators as jG, spec_from_list as j_spec_from_list
from tgp.pytorch_tpu.likelihoods import LikelihoodSpec as JLik
from tgp.pytorch_tpu.models import serialization as jser, tgp as JM
from tgp.pytorch_tpu.ops import kernels as jK
from tgp.pytorch_tpu.train import Trainer as JTrainer

from tgp.pytorch_tpu_torch import config as pcfg, weights
from tgp.pytorch_tpu_torch.data import (ArrayDataset, DataLoader,
                                        kmeans_centers, return_dataset)
from tgp.pytorch_tpu_torch.experiments import main as pmain
from tgp.pytorch_tpu_torch.train import Trainer

from test_torch_port_large import jax_native_parser

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "experiments"))
import main as jmain              # noqa: E402

F64 = dict(rtol=1e-8, atol=1e-10)


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


def same_leaves(a, b):
    la, lb = weights.tree_leaves(a), weights.tree_leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))


def close_to_jax(tr_p, tr_j):
    for attr in ("loss_curve", "ell_curve", "kld_curve"):
        close(np.asarray(getattr(tr_p, attr)),
              [float(v) for v in getattr(tr_j, attr)])
    jl = jax.tree_util.tree_leaves(tr_j.params)
    pl = weights.tree_leaves(tr_p.params)
    assert len(jl) == len(pl) > 0
    for a, b in zip(pl, jl):
        close(a, b)


# ---------------------------------------------------------------------------
# the guard (the JAX package's tests/test_trainer_plateau.py)
# ---------------------------------------------------------------------------

def boston_svgp(batch=100):
    """(port spec, params, loaders, Y_std, JAX spec, params, loaders): SVGP
    on boston split 1, M=5 k-means centers, Gaussian likelihood."""
    jax_native_parser()
    loaders, dc = return_dataset("boston", batch, None, seed=1)
    Z0 = kmeans_centers(dc["X_tr"], 5, n_init=2)
    spec_j = JM.svgp_spec(Dy=1, Dx=dc["Dx"], M=5, N=float(dc["N_tr"]),
                          kernel=jK.from_name("scale_rbf"),
                          likelihood=JLik("gaussian", 1, quad_points=16))
    pj = JM.init_tgp_params(spec_j, dc["X_tr"], Z0, variance_scale=1e-5,
                            noise_init=0.05)
    spec_p = weights.spec_from_dict(jser.spec_to_dict(spec_j))
    pp = weights.params_from_jax(jax.tree_util.tree_map(np.asarray, pj),
                                 device="cpu", dtype=torch.float64)
    jl = j_return_dataset("boston", batch, None, seed=1)[0]
    return spec_p, pp, loaders, dc["Y_std"], spec_j, pj, jl


GUARD_CASES = {
    "fires": ({"window": 20, "min_rel_improve": 1e9, "max_fraction": 1.0,
               "action": "warn"}, 120),
    "silent_when_improving": ({"window": 20, "min_rel_improve": -1e9,
                               "max_fraction": 1.0}, 120),
    "raise": ({"window": 20, "min_rel_improve": 1e9, "max_fraction": 1.0,
               "action": "raise"}, 120),
    "ignores_late_flat_tail": ({"window": 20, "min_rel_improve": 1e9,
                                "max_fraction": 0.1}, 120),
    "default_off": (None, 60),
}


@pytest.mark.parametrize("name", sorted(GUARD_CASES))
def test_plateau_guard_cases(name, capsys):
    guard, epochs = GUARD_CASES[name]
    spec_p, pp, loaders, Y_std, spec_j, pj, jl = boston_svgp()
    tr = Trainer(spec_p, pp, loaders, Y_std, S_test=8, device="cpu")
    tr.plateau_guard = dict(guard) if guard else None
    if name == "raise":
        with pytest.raises(RuntimeError, match="plateau"):
            tr.train(epochs, 0.01, "adam", verbose_each=0)
        return
    tr.train(epochs, 0.01, "adam", verbose_each=0)
    if name != "fires":
        assert tr.plateau_events == []
        return
    # the checks run every 50 epochs on the minibatch path: 50 and 100
    assert [e["epoch"] for e in tr.plateau_events] == [50, 100]
    ev = tr.plateau_events[0]
    assert ev["window"] == 20 and np.isfinite(ev["rel_improve"])
    assert "WARNING: ELBO plateau at epoch 50/120" in capsys.readouterr().out
    tr_j = JTrainer(spec_j, pj, jl, Y_std, S_test=8)
    tr_j.plateau_guard = dict(guard)
    tr_j.train(epochs, 0.01, "adam", verbose_each=0)
    close_to_jax(tr, tr_j)
    assert len(tr_j.plateau_events) == len(tr.plateau_events)
    for a, b in zip(tr.plateau_events, tr_j.plateau_events):
        assert a.keys() == b.keys() and a["epoch"] == b["epoch"]
        for k in ("rel_improve", "elbo_recent", "elbo_prev"):
            close(a[k], b[k])


# ---------------------------------------------------------------------------
# recovery and the warm-up (the JAX package's tests/test_plateau_recovery.py
# and tests/test_fast_solves.py)
# ---------------------------------------------------------------------------

def sal_model(M=16, N=96, quad=16):
    rng = np.random.RandomState(0)
    X, Y = rng.randn(N, 3), rng.randn(N, 1)
    fspec, finits = j_spec_from_list(jG.SAL(1))
    spec_j = JM.TGPSpec(Dy=1, Dx=3, M=M, N=float(N),
                        kernel=jK.from_name("scale_rbf"),
                        likelihood=JLik("gaussian_flow", 1, quad_points=quad),
                        flow=fspec)
    pj = JM.init_tgp_params(spec_j, X, X[:M], flow_inits=finits,
                            variance_scale=0.3)
    spec_p = weights.spec_from_dict(jser.spec_to_dict(spec_j))
    pp = weights.params_from_jax(jax.tree_util.tree_map(np.asarray, pj),
                                 device="cpu", dtype=torch.float64)
    return spec_j, spec_p, pj, pp, X, Y


def sal_loaders(X, Y, batch=None, jax_side=False):
    ds = (JDataset if jax_side else ArrayDataset)(X, Y)
    b = batch or len(ds)
    L = JLoader if jax_side else DataLoader
    return (L(ds, b, shuffle=False), L(ds, b, shuffle=False))


ALWAYS_FIRE = {"window": 2, "min_rel_improve": 1e9, "max_fraction": 1.0,
               "action": "recover"}


def test_recovery_full_batch_repeats_the_manual_swap():
    spec_j, spec_p, pj, pp, X, Y = sal_model()
    fast = dataclasses.replace(spec_p, fast_solves=True, solve_precision="high")
    tr = Trainer(fast, pp, sal_loaders(X, Y), np.ones(1), seed=0, device="cpu")
    tr.plateau_guard = dict(ALWAYS_FIRE)
    tr.validate_each = 4          # chunks of 4: the first check at epoch 4
    tr.train(20, 0.01, "adam", verbose_each=0)
    assert tr.plateau_events and tr.plateau_events[0]["action"] == "recover"
    assert tr.plateau_events[0]["epoch"] == 4
    assert not tr.spec.fast_solves and tr.spec.solve_precision == "highest"
    assert len(tr.loss_curve) == 20 and np.isfinite(tr.loss_curve).all()
    assert all("action" not in e for e in tr.plateau_events[1:])

    tr2 = Trainer(fast, pp, sal_loaders(X, Y), np.ones(1), seed=0,
                  device="cpu")
    tr2.train(4, 0.01, "adam", verbose_each=0)
    tr2.spec = dataclasses.replace(fast, fast_solves=False,
                                   solve_precision="highest")
    tr2.train(16, 0.01, "adam", verbose_each=0)
    assert same_leaves(tr.params, tr2.params)
    assert np.array_equal(tr.loss_curve, tr2.loss_curve)

    fast_j = dataclasses.replace(spec_j, fast_solves=True,
                                 solve_precision="high")
    tr_j = JTrainer(fast_j, pj, sal_loaders(X, Y, jax_side=True), np.ones(1),
                    seed=0)
    tr_j.plateau_guard = dict(ALWAYS_FIRE)
    tr_j.validate_each = 4
    tr_j.train(20, 0.01, "adam", verbose_each=0)
    close_to_jax(tr, tr_j)
    assert [e["epoch"] for e in tr.plateau_events] == \
        [e["epoch"] for e in tr_j.plateau_events]
    assert [e.get("action") for e in tr.plateau_events] == \
        [e.get("action") for e in tr_j.plateau_events]


def test_recovery_minibatch_path():
    _, spec_p, _, pp, X, Y = sal_model()
    fast = dataclasses.replace(spec_p, fast_solves=True, solve_precision="high")
    tr = Trainer(fast, pp, sal_loaders(X, Y, batch=32), np.ones(1), seed=0,
                 device="cpu")
    tr.plateau_guard = {"window": 10, "min_rel_improve": 1e9,
                        "max_fraction": 1.0, "action": "recover"}
    tr.train(80, 0.01, "adam", verbose_each=0)   # checks at epoch 50
    assert tr.plateau_events and tr.plateau_events[0]["action"] == "recover"
    assert tr.plateau_events[0]["epoch"] == 50
    assert not tr.spec.fast_solves and tr.spec.solve_precision == "highest"
    assert len(tr.loss_curve) == 80 and np.isfinite(tr.loss_curve).all()


def test_guard_warns_when_the_spec_is_already_highest():
    _, spec_p, _, pp, X, Y = sal_model()
    tr = Trainer(spec_p, pp, sal_loaders(X, Y), np.ones(1), seed=0,
                 device="cpu")
    tr.plateau_guard = dict(ALWAYS_FIRE)
    tr.validate_each = 4
    tr.train(8, 0.01, "adam", verbose_each=0)
    assert tr.plateau_events
    assert all("action" not in e for e in tr.plateau_events)
    assert tr.spec is spec_p


def test_solve_warmup_swap_repeats_a_single_spec_run():
    _, spec_p, _, pp, X, Y = sal_model(M=32, quad=32)
    fast = dataclasses.replace(spec_p, fast_solves=True, solve_precision="high")
    tr = Trainer(fast, pp, sal_loaders(X, Y), np.ones(1), seed=0, device="cpu")
    tr.train(20, 0.01, "adam")
    tr2 = Trainer(spec_p, pp, sal_loaders(X, Y), np.ones(1), seed=0,
                  device="cpu")
    tr2.train(8, 0.01, "adam")
    state = tr2._opt_state_carry
    tr2.spec = fast
    tr2.train(12, 0.01, "adam")
    assert tr2._opt_state_carry is state          # the moments carried
    # trsm and the L^{-1} GEMMs round differently: held at rtol 1e-8
    for a, b in zip(weights.tree_leaves(tr.params),
                    weights.tree_leaves(tr2.params)):
        close(a, b.detach())


# ---------------------------------------------------------------------------
# the CLI's solve levers against the JAX CLI
# ---------------------------------------------------------------------------

ARGV = ["--model", "SVGP", "--dataset", "boston", "--train_test_seed_split",
        "1", "--num_inducing", "5", "--epochs", "20", "--platform", "cpu",
        "--verbose_each", "0"]
LEVERS = {
    "warmup": ["--fast_solves", "--solve_precision", "high",
               "--solve_warmup_epochs", "8"],
    "guard_recover": ["--plateau_guard", "recover"],
    "default_guard": ["--fast_solves", "--solve_precision", "default"],
}


@pytest.mark.parametrize("name", sorted(LEVERS))
def test_cli_levers_match_the_jax_cli(monkeypatch, capsys, name):
    argv = ARGV + LEVERS[name]
    seen = {}

    class Caught(jtrain.Trainer):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            seen["trainer"] = self

    monkeypatch.setattr(jtrain, "Trainer", Caught)
    jax_native_parser()
    mj = jmain.run(jmain.parse_args(argv))
    jout = capsys.readouterr().out
    res = pmain.run(pmain.parse_args(argv))
    pout = capsys.readouterr().out

    def lines(out):
        keep = ("WARNING", "==== solve warmup", "Dataset ")
        return [ln.rsplit(" (", 1)[0] for ln in out.splitlines()
                if ln.startswith(keep)]

    assert lines(pout) == lines(jout)
    assert any(ln.startswith("WARNING") for ln in lines(pout)) == \
        (name == "default_guard")
    jt, pt = seen["trainer"], res.trainer
    assert pt.plateau_guard == jt.plateau_guard
    assert (pt.spec.fast_solves, pt.spec.solve_precision) == \
        (jt.spec.fast_solves, jt.spec.solve_precision)
    close_to_jax(pt, jt)
    for split in ("train", "test"):
        for k in ("logL", "rmse"):
            close(res.metrics[split][k], mj[split][k])
