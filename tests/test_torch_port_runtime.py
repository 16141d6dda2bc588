"""A run's runtime in the port, on the CPU in fp64: checkpoints
(`train/checkpoint.py`), the Trainer's `save`/`restore` and `eval_device`,
the CLI's `--checkpoint_dir`, `utils/logging.py`, `utils/profiling.py` and
the sweep runner (`experiments/sweep.py`).

  * `tests/test_checkpoint_and_entry.py`'s checkpoint cases on the port: the
    roundtrip, the asynchronous roundtrip, a custom structure (the grouped
    Adam state, the L-BFGS state), a Trainer resumed mid-run bit for bit
    (full batch, minibatch, ID_TGP's dropout draws, L-BFGS), `latest_step`
    skipping unfinished writes, natgrad's warmup position;
  * a checkpoint's generator refuses a Trainer on another kind of device;
  * `eval_device="cpu"` equals the default evaluation bit for bit, on the
    host path too (parameters copied, draws from the Trainer's generator
    through `hypernet.DeviceDraws`);
  * `--checkpoint_dir` writes `step_<epochs>` with the run's parameters;
  * `MetricLogger` and `export_curves` write what the JAX package's write;
    `trace` writes a Chrome trace, `step_timer` times each call;
  * one sweep cell (SVGP, boston, M=5, 20 epochs) against the JAX runner's
    `run_one`: every metric at rtol 1e-8 but the coverages, which come from
    other random streams than JAX's and are held within 3 binomial standard
    errors; the runner's refusals and its error records.
"""

import importlib.util
import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from tgp.pytorch_tpu.utils import logging as jlogging

from tgp.pytorch_tpu_torch import config as pcfg, weights
from tgp.pytorch_tpu_torch.data import ArrayDataset, DataLoader
from tgp.pytorch_tpu_torch.experiments import main as pmain, sweep as psweep
from tgp.pytorch_tpu_torch.flows import generators as G, spec_from_list
from tgp.pytorch_tpu_torch.likelihoods import LikelihoodSpec
from tgp.pytorch_tpu_torch.models import tgp as PM
from tgp.pytorch_tpu_torch.ops import kernels as K
from tgp.pytorch_tpu_torch.train import Trainer, group_adam as GA
from tgp.pytorch_tpu_torch.train import checkpoint as C
from tgp.pytorch_tpu_torch.train.lbfgs import LBFGSState
from tgp.pytorch_tpu_torch.utils import MetricLogger, step_timer, trace
from tgp.pytorch_tpu_torch.utils.logging import export_curves

REPO = Path(__file__).resolve().parents[1]


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
        assert torch.equal(x.detach().cpu(), y.detach().cpu())


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def test_checkpoint_roundtrip(tmp_path):
    params = {"a": torch.arange(4.0), "nested": [{"W": torch.eye(3)}]}
    C.save_checkpoint(str(tmp_path), params, step=10, extra={"lr": 0.01})
    C.save_checkpoint(str(tmp_path), params, step=20)
    assert C.latest_step(str(tmp_path)) == 20
    p, opt, step, extra = C.load_checkpoint(str(tmp_path), step=10)
    _equal_trees(p, params)
    assert opt is None and extra["lr"] == 0.01 and step == 10


def test_checkpoint_async_save_roundtrip(tmp_path):
    params = {"a": torch.arange(6.0), "b": {"W": torch.eye(2)}}
    C.save_checkpoint(str(tmp_path), params, step=3, async_save=True)
    # the save took its copy: later writes to the tensors do not reach it
    params["a"].add_(1.0)
    C.wait_for_checkpoints()
    p, _, step, _ = C.load_checkpoint(str(tmp_path))
    assert step == 3
    assert torch.equal(p["a"], torch.arange(6.0))


def test_checkpoint_preserves_custom_structure(tmp_path):
    from tgp.pytorch_tpu_torch.train.optimizers import lbfgs_optimizer
    params = {"a": torch.arange(4.0), "b": {"W": torch.eye(2)}}
    state = GA.init_state(params)
    state.count[1] = 7
    C.save_checkpoint(str(tmp_path), params, step=1, opt_state=state)
    _, opt, _, _ = C.load_checkpoint(str(tmp_path), step=1)
    assert isinstance(opt, GA.GroupAdamState) and opt.count == [0, 7]
    for a, b in zip(state.mu + state.nu, opt.mu + opt.nu):
        assert torch.equal(a, b)
    lb = lbfgs_optimizer().init(torch.arange(3.0))
    C.save_checkpoint(str(tmp_path), params, step=2, opt_state=lb)
    _, opt, _, _ = C.load_checkpoint(str(tmp_path), step=2)
    assert isinstance(opt, LBFGSState)
    assert opt.lbfgs.diff_params_memory.shape == (15, 3)
    assert opt.linesearch.learning_rate == 1.0


def test_latest_step_ignores_unfinished_writes(tmp_path):
    """A crashed or unfinished write leaves `step_<N>.tmp-...` beside the
    finished ones; resume must skip it."""
    C.save_checkpoint(str(tmp_path), {"a": torch.zeros(2)}, step=5)
    (tmp_path / "step_10.tmp-123-1").write_bytes(b"torn")
    os.makedirs(tmp_path / "step_12.orbax-checkpoint-tmp-1717171717")
    assert C.latest_step(str(tmp_path)) == 5
    assert C.load_checkpoint(str(tmp_path))[2] == 5
    assert C.latest_step(str(tmp_path / "none")) is None
    with pytest.raises(FileNotFoundError):
        C.load_checkpoint(str(tmp_path / "none"))


def _sal_trainer(seed=7, batch=64, N=40, flow_kw=None, M=5, quad=16, **kw):
    """`tests/test_checkpoint_and_entry.py`'s resume model in the port:
    SAL(1) (flow_kw: its hypernets), Dx=3, M=5, 16 GH nodes."""
    rng = np.random.RandomState(0)
    X, Y = rng.randn(N, 3), rng.randn(N, 1)
    np.random.seed(0)
    fspec, finits = spec_from_list(G.SAL(1, **(flow_kw or {})))
    spec = PM.TGPSpec(Dy=1, Dx=3, M=M, N=float(N),
                      kernel=K.from_name("scale_rbf"),
                      likelihood=LikelihoodSpec("gaussian_flow", 1,
                                                quad_points=quad), flow=fspec)
    params = PM.init_tgp_params(spec, X, X[:M], flow_inits=finits,
                                device="cpu")
    return Trainer(spec, params,
                   [DataLoader(ArrayDataset(X, Y), batch, seed=0),
                    DataLoader(ArrayDataset(X, Y), 64, shuffle=False)],
                   np.ones(1), S_test=5, seed=seed, device="cpu", **kw)


ID_FLOW = dict(input_dependent=True, input_dim=3, hidden_dim=5, dropout=0.3)


@pytest.mark.parametrize("opt, batch, flow_kw", [
    pytest.param("adam", 64, None, id="full_batch"),
    pytest.param("adam", 16, None, id="minibatch"),
    pytest.param("adam", 64, ID_FLOW, id="id_tgp"),
    pytest.param("lbfgs", 64, ID_FLOW, id="lbfgs"),
])
def test_trainer_resume_mid_run_bit_exact(tmp_path, opt, batch, flow_kw):
    """Interrupt at epoch 20 of 40, restore into a fresh Trainer (another
    seed on purpose), continue: the parameters equal the uninterrupted
    two-call run's bit for bit (optimizer state, generator and shuffle
    stream all round-trip)."""
    n, lr = (5, 0.0) if opt == "lbfgs" else (20, 0.02)
    tr_a = _sal_trainer(batch=batch, flow_kw=flow_kw)
    tr_a.train(n, lr, opt, verbose_each=0)
    tr_a.train(n, lr, opt, verbose_each=0)

    tr_b = _sal_trainer(batch=batch, flow_kw=flow_kw)
    tr_b.train(n, lr, opt, verbose_each=0)
    path = tr_b.save(str(tmp_path))
    assert os.path.basename(path) == f"step_{len(tr_b.loss_curve)}"
    tr_c = _sal_trainer(seed=999, batch=batch, flow_kw=flow_kw)
    assert tr_c.restore(str(tmp_path)) == len(tr_b.loss_curve)
    assert tr_c._opt_state_kind == opt
    tr_c.train(n, lr, opt, verbose_each=0)

    _equal_trees(tr_a.params, tr_c.params)
    np.testing.assert_array_equal(tr_a.loss_curve[n:], tr_c.loss_curve)
    assert torch.equal(tr_a._gen.get_state(), tr_c._gen.get_state())
    assert all(t.requires_grad for t in weights.tree_leaves(tr_c.params))


def test_trainer_resume_preserves_natgrad_warmup_position(tmp_path):
    """save() carries the natgrad warmup step: a restored run replaying the
    gamma ramp from t=0 would leave the uninterrupted trajectory."""
    kw = dict(verbose_each=0, natgrad_gamma=0.7, natgrad_warmup=16)
    mk = lambda: _sal_trainer(seed=3, N=32, M=4, quad=12)   # noqa: E731
    tr_a = mk()
    tr_a.train(8, 0.02, "adam", **kw)      # the ramp half-way
    tr_a.train(8, 0.02, "adam", **kw)
    tr_b = mk()
    tr_b.train(8, 0.02, "adam", **kw)
    tr_b.save(str(tmp_path))
    tr_c = mk()
    tr_c.restore(str(tmp_path))
    assert tr_c._ng_t == 8
    tr_c.train(8, 0.02, "adam", **kw)
    _equal_trees(tr_a.params, tr_c.params)


def test_restore_refuses_a_generator_of_another_device_kind(tmp_path):
    tr = _sal_trainer()
    tr.train(2, 0.02, verbose_each=0)
    tr.save(str(tmp_path), step=2)
    params, opt_state, step, extra = C.load_checkpoint(str(tmp_path), 2)
    extra["generator_device"] = "cuda"
    C.save_checkpoint(str(tmp_path), params, step=3, opt_state=opt_state,
                      extra=extra)
    fresh = _sal_trainer(seed=1)
    gen0 = fresh._gen.get_state()
    with pytest.raises(ValueError, match="cuda generator.*cpu generator"):
        fresh.restore(str(tmp_path), step=3)
    assert torch.equal(fresh._gen.get_state(), gen0)
    assert fresh.restore(str(tmp_path), step=2) == 2


# ---------------------------------------------------------------------------
# eval_device
# ---------------------------------------------------------------------------

def _class_trainer():
    rs = np.random.RandomState(2)
    X = rs.randn(40, 3)
    Y = (X[:, :1] > 0).astype(np.float64)
    spec = PM.TGPSpec(Dy=1, Dx=3, M=4, N=40.0, kernel=K.from_name("scale_rbf"),
                      likelihood=LikelihoodSpec("bernoulli", 1, quad_points=8))
    params = PM.init_tgp_params(spec, X, X[:4], device="cpu")
    return Trainer(spec, params, [DataLoader(ArrayDataset(X, Y), 64, seed=0),
                                  DataLoader(ArrayDataset(X, Y), 64,
                                             shuffle=False)],
                   np.ones(1), S_test=5, seed=4, device="cpu")


def _metrics_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], dict):
            _metrics_equal(a[k], b[k])
        else:
            np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("model", ["sal", "id_tgp_bayes", "bernoulli"])
def test_eval_device_cpu_equals_the_default(monkeypatch, model):
    """On a CPU Trainer `eval_device="cpu"` is the default evaluation; the
    host path of a card Trainer (the parameters copied, the draws made by
    the Trainer's generator and moved) is too, bit for bit, and leaves the
    generator where the default leaves it."""
    def trained():
        flow_kw = ID_FLOW if model == "id_tgp_bayes" else None
        tr = (_class_trainer() if model == "bernoulli"
              else _sal_trainer(flow_kw=flow_kw))
        tr.train(3, 0.02, verbose_each=0)
        tr.fully_bayesian = model == "id_tgp_bayes"
        return tr

    ref = trained()
    want = ref.compute_metrics()
    tr = trained()
    tr.eval_device = "cpu"
    _metrics_equal(tr.compute_metrics(), want)
    host = trained()
    host.eval_device = "cpu"
    # a Trainer whose device is not the host's takes the host path
    monkeypatch.setattr(host, "device", torch.device("meta"))
    ev = host._evaluation()
    assert ev["device"].type == "cpu" and ev["rng"].gen is host._gen
    _metrics_equal(host.compute_metrics(), want)
    assert torch.equal(host._gen.get_state(), ref._gen.get_state())
    host.eval_device = "gpu"
    with pytest.raises(ValueError, match="eval_device"):
        host.compute_metrics()


# ---------------------------------------------------------------------------
# the CLI, logging, profiling
# ---------------------------------------------------------------------------

def test_cli_checkpoint_dir_writes_the_trained_parameters(tmp_path):
    res = pmain.run(pmain.parse_args([
        "--model", "SVGP", "--dataset", "boston", "--train_test_seed_split",
        "1", "--num_inducing", "5", "--epochs", "20", "--platform", "cpu",
        "--verbose_each", "0", "--checkpoint_dir", str(tmp_path)]))
    assert C.latest_step(str(tmp_path)) == 20
    params, opt_state, step, extra = C.load_checkpoint(str(tmp_path))
    assert step == 20 and opt_state is None and extra == {}
    _equal_trees(params, res.trainer.params)


def test_metric_logger_and_export_curves_write_what_jax_writes(tmp_path,
                                                                capsys):
    recs = {}
    for name, mod in (("port", None), ("jax", jlogging)):
        log = (MetricLogger if mod is None else mod.MetricLogger)(
            str(tmp_path / f"{name}.jsonl"), print_every=2)
        for i in range(3):
            log.log(elbo=torch.tensor(-1.5 * i, dtype=torch.float64),
                    lr=np.float32(0.01), tag="x")
        log.close()
        recs[name] = [json.loads(ln) for ln in
                      (tmp_path / f"{name}.jsonl").read_text().splitlines()]
    assert capsys.readouterr().out.count("'step': 2") == 2
    for a, b in zip(recs["port"], recs["jax"]):
        a.pop("t"), b.pop("t")
        assert a == b
    assert len(recs["port"]) == 3 and recs["port"][2]["elbo"] == -3.0

    tr = _sal_trainer()
    tr.train(3, 0.02, verbose_each=0)
    export_curves(tr, str(tmp_path / "port.npz"))
    jlogging.export_curves(tr, str(tmp_path / "jax.npz"))
    a, b = np.load(tmp_path / "port.npz"), np.load(tmp_path / "jax.npz")
    for k in ("elbo", "ell", "kld"):
        np.testing.assert_array_equal(a[k], b[k])
    np.testing.assert_array_equal(a["elbo"], tr.loss_curve)


def test_trace_writes_a_chrome_trace_and_step_timer_times_calls(tmp_path):
    with trace(str(tmp_path / "prof")):
        torch.ones(64, 64) @ torch.ones(64, 64)
    events = json.loads((tmp_path / "prof" / "trace.json").read_text())
    assert any("mm" in e.get("name", "") for e in events["traceEvents"])
    timed = step_timer(lambda x: x + 1)
    assert [timed(i) for i in range(3)] == [1, 2, 3]
    assert len(timed.times) == 3 and timed.mean >= 0.0


# ---------------------------------------------------------------------------
# the sweep runner
# ---------------------------------------------------------------------------

def _jax_sweep():
    spec = importlib.util.spec_from_file_location(
        "jax_sweep", REPO / "experiments" / "sweep.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_sweep_cell_matches_the_jax_runner():
    cell = ("SVGP", "boston", 1, 5, 20, "fp64", "regression")
    want = _jax_sweep().run_one(*cell)
    got = psweep.run_one(*cell, device="cpu")
    assert got.keys() == want.keys()
    for k, v in want.items():
        if k == "train_s":
            continue
        if k.endswith("_coverage"):
            n = 455 if k.startswith("train") else 51     # boston's split
            assert abs(got[k] - v) <= 3 * np.sqrt(v * (1 - v) / n), k
        elif isinstance(v, float):
            np.testing.assert_allclose(got[k], v, rtol=1e-8, err_msg=k)
        else:
            assert got[k] == v, k


def test_sweep_refuses_missing_tables_and_records_errors(tmp_path,
                                                         monkeypatch, capsys):
    with pytest.raises(SystemExit, match="year.*airline"):
        psweep.main(["--suite", "large", "--platform", "cpu"])
    with pytest.raises(SystemExit, match="avila"):
        psweep.main(["--suite", "classification", "--platform", "cpu"])

    def fails(*a, **k):
        raise FloatingPointError("non-finite ELBO at epoch 50")

    monkeypatch.setattr(psweep, "run_one", fails)
    out = tmp_path / "grid.jsonl"
    recs = psweep.main(["--models", "SVGP", "TGP", "--datasets", "boston",
                        "--seeds", "1", "--num_inducing", "5", "--epochs",
                        "2", "--platform", "cpu", "--out", str(out)])
    lines = [json.loads(ln) for ln in out.read_text().splitlines()]
    assert lines == recs and len(recs) == 2
    assert recs[0] == {"model": "SVGP", "dataset": "boston", "seed": 1,
                       "M": 5, "error": "FloatingPointError: non-finite "
                                        "ELBO at epoch 50"}
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="no CUDA device"):
            psweep.main(["--datasets", "boston"])
