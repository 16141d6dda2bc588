"""The port's experiment CLI for `--model ID_TGP` against the JAX package's
(`experiments/main.py`), on the CPU in fp64: boston split 1, M=5, 20
epochs, `--S_test 10`.

In the first two cases both CLIs' boston ID_TGP row is patched to dropout
0 (a deterministic flow); in every case the port starts from the JAX CLI's
initial hypernet leaves (the JAX package draws them from threefry keys).
Both CLIs' anchor fits run 300 of their 2000 epochs in the first case and
500 in the other two.  At dropout 0 the fit's Adam trajectory turns chaotic
between epochs 350 and 400 on an 8-core x86 CPU (the onset moves from one
machine to another), where a rounding gap of 1e-15 grows 1.4x a step: the
JAX package moved by 1e-15 at its start parts from itself as far as the
port parts from it (`tools/anchor_fit_onset.py`: 3.0e-9 and 4.2e-9 of a
leaf's largest entry at epoch 400; 1.9e-15 between the packages at 300);
`chip_smoke.py` runs the whole fit.  The other two cases stay within
1.4e-14 of each other through epoch 500.  The VI case
(`--nnet_inference mean_field_gaussian`) samples its nets, and the port
replays the JAX CLI's noise (`JaxOrderReplay`), so the anchor fit, the
training steps and the fully-Bayesian evaluation see the same noise.
Compared at rtol 1e-8, atol 1e-10: the anchor fit's leaves and loss, the
ELBO, ELL and KL curves, every final parameter, logL and RMSE of both
result lines, and the printed lines but the training time.

The third case keeps the table's dropout 0.5 and replays the JAX CLI's
masks through the anchor fit, the training steps and the fully-Bayesian
evaluation.  Its anchor fit and first ELBO are held at rtol 1e-8; the rest
at `TABLE_DROPOUT`.  The gradient of the affine step's shift at the first
training step is rounding noise (1.4e-9 against 1.2e4 for its scale, as
the standardised Y has mean 0; the JAX package alone moves it by 3e-4 of
itself between its jitted and eager ELBO), and Adam's first step turns
that noise into a step of up to lr.  The trajectory after it answers that
kick linearly: the port on 8 torch threads sits 2.3e-7 from itself on 1
thread on the ELBO curve, 2.3e-9 on the KL curve, 1.4e-5 of a leaf's
largest entry on the parameters and 2.6e-7 on the metrics, and the port on
1 thread 2.9x as far from the JAX CLI on every one (whose reruns repeat
to the last bit).  `TABLE_DROPOUT` is 10x the thread gaps.
"""

import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import tgp.pytorch_tpu.flows.initializers as jinit
import tgp.pytorch_tpu.train as jtrain
from tgp.pytorch_tpu import config as jcfg
from tgp.pytorch_tpu.models import tgp as JM

from tgp.pytorch_tpu_torch import config as pcfg, weights
from tgp.pytorch_tpu_torch.experiments import exp_config as PEC, main as pmain
from tgp.pytorch_tpu_torch.flows import initializers as pinit
from tgp.pytorch_tpu_torch.models import tgp as PM

from test_torch_port_hypernet import JaxOrderReplay
from test_torch_port_large import jax_native_parser

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "experiments"))
import exp_config as JEC          # noqa: E402
import main as jmain              # noqa: E402

F64 = dict(rtol=1e-8, atol=1e-10)
# the ELBO/ELL curves, the KL curve and the metrics relative to each entry;
# a parameter leaf relative to its largest entry
TABLE_DROPOUT = dict(curve=2.4e-6, kld=2.3e-8, leaf=1.5e-4, metric=2.6e-6)
ARGV = ["--model", "ID_TGP", "--dataset", "boston", "--train_test_seed_split",
        "1", "--num_inducing", "5", "--epochs", "20", "--S_test", "10",
        "--platform", "cpu", "--verbose_each", "0"]


@pytest.fixture(autouse=True)
def _port_state():
    prev, jprev, dt = pcfg.precision(), jcfg.precision(), torch.get_default_dtype()
    nt = torch.get_num_threads()
    yield
    pcfg.set_precision(prev)
    if jcfg.precision() != jprev:
        jcfg.set_precision(jprev)
    torch.set_num_threads(nt)
    assert torch.get_default_dtype() == dt


def close(port, ref, **tol):
    port = port.detach().cpu().numpy() if torch.is_tensor(port) else port
    np.testing.assert_allclose(np.asarray(port, np.float64),
                               np.asarray(ref, np.float64), **(tol or F64))


def result_lines(out):
    """The two result lines, the first without its training time."""
    lines = [ln for ln in out.splitlines() if ln.startswith("Dataset ")]
    assert len(lines) == 2
    return [lines[0].rsplit(" (", 1)[0], lines[1]]


@pytest.mark.parametrize("inference, dropout, fit_epochs", [
    pytest.param("MC_dropout", 0.0, 300, id="MC_dropout"),
    pytest.param("mean_field_gaussian", 0.0, 500, id="mean_field_gaussian"),
    pytest.param("MC_dropout", None, 500, id="MC_dropout-table_dropout"),
])
def test_id_tgp_cli_matches_the_jax_cli(monkeypatch, capsys, inference,
                                        dropout, fit_epochs):
    argv = ARGV + ["--nnet_inference", inference]
    if dropout is not None:
        for table in (JEC.HYPERPARAMS, PEC.HYPERPARAMS):
            monkeypatch.setitem(table[("ID_TGP", "boston")], "flow_DR",
                                dropout)
    replay = JaxOrderReplay().patch(monkeypatch)

    # the JAX CLI, with its init, anchor fit, Trainer and metrics caught
    seen = {"metrics": []}

    class Caught(jtrain.Trainer):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            seen["trainer"] = self

        def compute_metrics(self):
            seen["metrics"].append(super().compute_metrics())
            return seen["metrics"][-1]

    def wrap(mod, name, **fixed):
        fn = getattr(mod, name)

        def inner(*a, **k):
            out = fn(*a, **dict(k, **fixed))
            # host copies: the JAX Trainer donates the arrays it is given
            seen[name] = jax.tree_util.tree_map(
                lambda x: np.array(x) if hasattr(x, "shape") else x, out)
            return out
        monkeypatch.setattr(mod, name, inner)

    monkeypatch.setattr(jtrain, "Trainer", Caught)
    wrap(jinit, "fit_hypernet_to_anchors", num_epochs=fit_epochs)
    wrap(JM, "init_tgp_params")
    jax_native_parser()
    jmain.run(jmain.parse_args(argv))
    jlines = result_lines(capsys.readouterr().out)

    replay.seal()

    # the port's CLI from the JAX CLI's initial flow (hypernets included)
    init = PM.init_tgp_params

    def port_init(*a, **k):
        params = init(*a, **k)
        params["flow"] = weights.params_from_jax(
            seen["init_tgp_params"]["flow"], device=params["Z"].device,
            dtype=params["Z"].dtype)
        return params

    monkeypatch.setattr(PM, "init_tgp_params", port_init)
    fit = pinit.fit_hypernet_to_anchors
    monkeypatch.setattr(pinit, "fit_hypernet_to_anchors",
                        lambda *a, **k: fit(*a, **dict(k, num_epochs=fit_epochs)))
    torch.set_num_threads(1)
    res = pmain.run(pmain.parse_args(argv))
    plines = result_lines(capsys.readouterr().out)
    assert plines == jlines
    assert plines == [res.line.rsplit(" (", 1)[0], res.line_bayes]
    assert "POINT ESTIMATE FLOW" in plines[0] and "BAYESIAN FLOW" in plines[1]

    jt, pt = seen["trainer"], res.trainer
    assert pt.spec.has_input_dependent_flow
    drawing = inference != "MC_dropout" or dropout != 0.0
    assert pt.spec.has_stochastic_flow == drawing
    assert pt.spec.flow[0].hypernet.inference == inference
    # the anchor fit
    jfit, jloss = seen["fit_hypernet_to_anchors"]
    pfit, ploss = res.anchor_fit
    close(ploss, jloss)
    jl, pl = jax.tree_util.tree_leaves(jfit), weights.tree_leaves(pfit)
    assert len(jl) == len(pl) > 4
    for a, b in zip(jl, pl):
        close(b, a)
    lim = TABLE_DROPOUT if dropout is None else None
    # the curves, with the flow KL of the VI nets
    for attr in ("loss_curve", "ell_curve", "kld_curve"):
        got = np.asarray(getattr(pt, attr), np.float64)
        want = np.asarray([float(v) for v in getattr(jt, attr)])
        assert got.shape == want.shape == (20,)
        close(got[0], want[0])
        close(got, want, **(dict(rtol=lim["kld" if attr == "kld_curve"
                                          else "curve"], atol=0)
                            if lim else F64))
    kl_flow = float(PM.flows_kld(pt.spec, pt.params).detach())
    assert (kl_flow > 0) == (inference != "MC_dropout")
    # every parameter
    jl = jax.tree_util.tree_leaves_with_path(jt.params)
    pl = weights.tree_leaves(pt.params)
    assert len(jl) == len(pl)
    for (path, a), b in zip(jl, pl):
        tol = (dict(rtol=0, atol=lim["leaf"] * np.abs(a).max()) if lim
               else F64)
        close(b, a, err_msg=jax.tree_util.keystr(path), **tol)
    # both result lines' metrics
    assert len(seen["metrics"]) == 2
    for mp, mj in zip((res.metrics, res.metrics_bayes), seen["metrics"]):
        for split in ("train", "test"):
            for k in ("logL", "rmse"):
                close(mp[split][k], mj[split][k],
                      **(dict(rtol=lim["metric"], atol=0) if lim else F64))
    assert res.kernel_calls == {"train": (0, 0), "eval": (0, 0),
                                "eval_bayes": (0, 0), "anchor_fit": (0, 0)}
    # every replayed draw was taken: a site a net and layer in the fit's and
    # the training step's programs (VI 3 layers x 2 nets, dropout 1 x 2),
    # three times as many in the fully-Bayesian evaluation's, traced for
    # each loader
    assert replay.queue == []
    sites = 0 if not drawing else 6 if inference != "MC_dropout" else 2
    assert replay.sites == sites * (1 + 1 + 2 * 3)
