"""The port's classification path against the JAX package's, on the CPU in
fp64: the protocol (`experiments/classification_protocol.py` against
`benchmarks/classification_protocol.py`), serving, and the classification
loaders.

The protocol runs binary (Bernoulli, SAL_InvBCL) and 3-class (categorical,
per-class BCL_AL) for TGP and ID_TGP at 24 epochs, with the kernel held
for the first 8 and the gradients clipped at norm 100, as the JAX protocol
runs them.  The categorical likelihood's MC normals and the ID
nets' dropout masks are the JAX run's, replayed in program order
(`JaxOrderReplay`, which here also takes the JAX classification module's
draws); ID_TGP starts from the JAX run's initial nets (threefry draws) and
both anchor fits run 100 of their 2000 epochs.  Compared at rtol 1e-8,
atol 1e-10: Z0, the anchor fit, the ELBO, ELL and KL curves, every final
parameter, logL, accuracy and the calibration measures of each evaluation
(PE, and BA for ID_TGP), and the JSON records but their times.
"""

import pickle
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import tgp.pytorch_tpu.data as jdata
import tgp.pytorch_tpu.flows.initializers as jinit
import tgp.pytorch_tpu.train as jtrain
from tgp.pytorch_tpu.data import uci_classification as jucc
from tgp.pytorch_tpu.likelihoods import classification as jcls
from tgp.pytorch_tpu.models import tgp as JM

from tgp.pytorch_tpu_torch import config as pcfg, weights
from tgp.pytorch_tpu_torch.data import registry as preg
from tgp.pytorch_tpu_torch.data import uci_classification as pucc
from tgp.pytorch_tpu_torch.experiments import classification_protocol as pcp
from tgp.pytorch_tpu_torch.flows import initializers as pinit
from tgp.pytorch_tpu_torch.models import tgp as PM

from test_torch_port_hypernet import JaxOrderReplay

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "benchmarks"))
import classification_protocol as jcp    # noqa: E402

F64 = dict(rtol=1e-8, atol=1e-10)
TIMES = ("train_s", "init_s", "steps_per_sec")


@pytest.fixture(autouse=True)
def _port_state():
    """Port precision fp64 for the test; torch's default dtype, thread
    count and numpy's global RNG state as they were."""
    prev, dt, nt = pcfg.precision(), torch.get_default_dtype(), torch.get_num_threads()
    np_state = np.random.get_state()
    pcfg.set_precision("fp64")
    yield
    pcfg.set_precision(prev)
    torch.set_num_threads(nt)
    np.random.set_state(np_state)
    assert torch.get_default_dtype() == dt


def close(port, ref, **tol):
    port = port.detach().cpu().numpy() if torch.is_tensor(port) else port
    np.testing.assert_allclose(np.asarray(port, np.float64),
                               np.asarray(ref, np.float64), **(tol or F64))


def replay_classification_draws(monkeypatch):
    """`JaxOrderReplay` over the JAX hypernets' and classification
    likelihoods' draws."""
    replay = JaxOrderReplay().patch(monkeypatch)
    monkeypatch.setattr(jcls, "jax", sys.modules[
        "tgp.pytorch_tpu.flows.hypernet"].jax)
    return replay


@pytest.mark.parametrize("model", ["TGP", "ID_TGP"])
@pytest.mark.parametrize("kind", ["binary", "categorical"])
def test_protocol_matches_the_jax_protocol(monkeypatch, kind, model):
    epochs, fit_epochs = 24, 100
    replay = replay_classification_draws(monkeypatch)

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
    wrap(jdata, "kmeans_centers")
    jrecs = jcp.run(kind, epochs, model=model)
    replay.seal()

    init = PM.init_tgp_params

    def port_init(*a, **k):
        # the JAX run's initial nets (threefry draws)
        params = init(*a, **k)
        params["flow"] = weights.params_from_jax(
            seen["init_tgp_params"]["flow"], device="cpu",
            dtype=torch.float64)
        return params

    monkeypatch.setattr(PM, "init_tgp_params", port_init)
    fit = pinit.fit_hypernet_to_anchors
    monkeypatch.setattr(pinit, "fit_hypernet_to_anchors", lambda *a, **k: fit(
        *a, **dict(k, num_epochs=fit_epochs)))
    torch.set_num_threads(1)
    res = pcp.run(kind, epochs, model=model, device="cpu")

    strip = [{k: v for k, v in r.items() if k not in TIMES} for r in jrecs]
    assert [{k: v for k, v in r.items() if k not in TIMES}
            for r in res.records] == strip
    close(res.Z0, seen["kmeans_centers"])
    jt, pt = seen["trainer"], res.trainer
    lik = pt.spec.likelihood
    assert lik.kind == ("bernoulli" if kind == "binary" else "categorical")
    assert pt.spec.Dy == (1 if kind == "binary" else 3)
    assert pt.spec.has_stochastic_flow == (model == "ID_TGP")
    if model == "ID_TGP":
        jfit, jloss = seen["fit_hypernet_to_anchors"]
        pfit, ploss = res.anchor_fit
        close(ploss, jloss)
        jl, pl = jax.tree_util.tree_leaves(jfit), weights.tree_leaves(pfit)
        assert len(jl) == len(pl) > 4
        for a, b in zip(jl, pl):
            close(b, a)
    for attr in ("loss_curve", "ell_curve", "kld_curve"):
        got = np.asarray(getattr(pt, attr), np.float64)
        want = np.asarray([float(v) for v in getattr(jt, attr)])
        assert got.shape == want.shape == (epochs,)
        close(got, want)
    jl = jax.tree_util.tree_leaves_with_path(jt.params)
    pl = weights.tree_leaves(pt.params)
    assert len(jl) == len(pl)
    for (path, a), b in zip(jl, pl):
        close(b, a, err_msg=jax.tree_util.keystr(path))
    assert len(res.metrics) == len(seen["metrics"]) == len(jrecs)
    for mp, mj in zip(res.metrics, seen["metrics"]):
        for split in ("train", "test"):
            assert mp[split].keys() == mj[split].keys() == {
                "logL", "acc", "calibration"}
            assert mp[split]["logL"].shape == (1,)
            close(mp[split]["logL"], mj[split]["logL"])
            close(mp[split]["acc"], mj[split]["acc"])
            for k, v in mj[split]["calibration"].items():
                close(mp[split]["calibration"][k], v, err_msg=k)
    # the Gram kernel's calls were counted (on the CPU no kernel launches)
    assert set(res.kernel_calls) == ({"train", "eval", "eval_bayes"}
                                     if model == "ID_TGP" else {"train", "eval"})
    assert all(v == (0, 0) for v in res.kernel_calls.values())
    # every replayed draw was taken
    assert replay.queue == []
    assert (replay.sites > 0) == (kind == "categorical" or model == "ID_TGP")


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["binary", "categorical"])
def test_predictor_probabilities_with_bucket_padding(monkeypatch, kind):
    """`serve.Predictor` on a classification model (the protocol's flows,
    M=6, from the JAX init moved by seeded noise): requests of 5 and 13
    rows padded to buckets 8 and 32, class probabilities (n, C) and the
    per-request log-probability, against the JAX Predictor on the same
    replayed MC normals."""
    from tgp.pytorch_tpu import serve as jserve
    from tgp.pytorch_tpu.flows import generators as jG, spec_from_list as jsfl
    from tgp.pytorch_tpu.likelihoods import LikelihoodSpec as JLik
    from tgp.pytorch_tpu.models import serialization as jser
    from tgp.pytorch_tpu.ops import kernels as jK
    from tgp.pytorch_tpu_torch import serve as pserve

    replay = replay_classification_draws(monkeypatch)
    X, y = jucc.synthetic_corpus("binary" if kind == "binary" else "multiclass")
    C = 2 if kind == "binary" else 3
    Dy = 1 if kind == "binary" else 3
    np.random.seed(0)
    fspec, finits = jsfl(jG.build_chain(
        "SAL_InvBCL" if kind == "binary" else "BCL_AL", 1))
    lik = (JLik("bernoulli", 1, quad_points=20) if kind == "binary"
           else JLik("categorical", 3, quad_points=8, num_classes=3))
    spec_j = JM.TGPSpec(Dy=Dy, Dx=4, M=6, N=100.0,
                        kernel=jK.from_name("scale_rbf"), likelihood=lik,
                        flow=fspec)
    pj = JM.init_tgp_params(spec_j, X, X[:6], flow_inits=finits)
    pp = weights.perturb_params(weights.params_from_jax(
        jax.tree_util.tree_map(np.asarray, pj), "cpu", torch.float64), seed=3)
    pj = weights.tree_map(lambda t: t.numpy(), pp)
    spec_p = weights.spec_from_dict(jser.spec_to_dict(spec_j))
    Xs, ys = (X[:5], X[100:113]), (y[:5], y[100:113])
    jpred = jserve.Predictor(spec_j, pj, buckets=(8, 32), seed=0)
    jout = [jpred.predict(x) for x in Xs]
    jlp = [jpred.log_prob(x, yy.reshape(-1, 1)) for x, yy in zip(Xs, ys)]
    replay.seal()
    ppred = pserve.Predictor(spec_p, pp, buckets=(8, 32), seed=0, device="cpu")
    pout = [ppred.predict(x) for x in Xs]
    plp = [ppred.log_prob(x, yy.reshape(-1, 1)) for x, yy in zip(Xs, ys)]
    for x, a, b in zip(Xs, jout, pout):
        assert b.keys() == a.keys() == {"probs"}
        assert b["probs"].shape == (x.shape[0], C)
        close(b["probs"], a["probs"])
        close(b["probs"].sum(-1), np.ones(x.shape[0]))
    for a, b in zip(jlp, plp):
        assert b.shape == (1,)
        close(b, a)
    assert replay.queue == []


# ---------------------------------------------------------------------------
# the classification loaders
# ---------------------------------------------------------------------------

def _write_corpora(root):
    """Small synthetic files in the layout of every classification loader,
    with split pickles."""
    rs = np.random.RandomState(0)
    with open(root / "data_banknote_authentication.txt", "w") as f:
        for row in np.c_[rs.randn(30, 4), rs.randint(0, 2, 30)]:
            f.write(",".join(f"{v:.6f}" for v in row) + "\n")
    with open(root / "heart_failure_clinical_records_dataset.csv", "w") as f:
        f.write(",".join(f"c{i}" for i in range(13)) + "\n")
        for row in np.c_[rs.randn(25, 12) * 3 + 1, rs.randint(0, 2, 25)]:
            f.write(",".join(f"{v:.6f}" for v in row) + "\n")
    for name, n in (("data_banknote_authentication", 30),
                    ("heart_failure_clinical_records_dataset", 25),
                    ("movement", 6)):
        perm = np.random.RandomState(1).permutation(n)
        with open(root / f"splits_idx_{name}.pkl", "wb") as f:
            pickle.dump({"seed_1": {"train": perm[: n - 3],
                                    "test": perm[n - 3:]}}, f)
    (root / "avila").mkdir()
    for fname, n in (("avila-tr.txt", 20), ("avila-ts.txt", 8)):
        with open(root / "avila" / fname, "w") as f:
            for i in range(n):
                f.write(",".join(f"{v:.5f}" for v in rs.randn(10))
                        + "," + "ABCDEFGHIWXY"[i % 12] + "\n")
            f.write("\n")
    d = root / "MovementAAL" / "dataset"
    d.mkdir(parents=True)
    with open(d / "MovementAAL_target.csv", "w") as f:
        f.write("#sequence_ID,class_label\n")
        for sid in range(1, 7):
            f.write(f"{sid},{1 if sid % 2 else -1}\n")
    for sid in range(1, 7):
        with open(d / f"MovementAAL_RSS_{sid}.csv", "w") as f:
            f.write("#RSS_anchor1,RSS_anchor2,RSS_anchor3,RSS_anchor4\n")
            for row in rs.randn(5, 4):
                f.write(",".join(f"{v:.4f}" for v in row) + "\n")
    for cname in jucc.ACTIVITY_CLASSES:
        (root / "AReM" / cname).mkdir(parents=True)
        for k in range(2):
            with open(root / "AReM" / cname / f"dataset{k}.csv", "w") as f:
                f.write("# Task: x\n# Columns: time,a,b,c,d,e,f\n")
                for t, row in enumerate(rs.randn(4, 6)):
                    f.write(f"{250 * t}," + ",".join(f"{v:.3f}" for v in row)
                            + "\n")
                f.write("bad,row\n")


@pytest.mark.parametrize("name", ["banknote", "heart", "avila", "movement",
                                  "activity", "synthetic_binary",
                                  "synthetic_multiclass"])
def test_classification_loaders_match_jax(monkeypatch, tmp_path, name):
    """Every loader on synthetic files (the tables are not in the repo) and
    the synthetic corpora, through `return_dataset` (a validation split
    for one): the same arrays and data_config as the JAX package's."""
    from tgp.pytorch_tpu.data import registry as jreg
    _write_corpora(tmp_path)
    for mod in (jucc, pucc):
        monkeypatch.setattr(mod, "_asset_path",
                            lambda task, fname: str(tmp_path / fname))
    val = (3, 2) if name == "heart" else None
    jl, jd = jreg.return_dataset(name, 16, val, seed=1)
    pl, pd = preg.return_dataset(name, 16, val, seed=1)
    assert pd["task"] == jd["task"] == "classification"
    assert pd["Dy"] == jd["Dy"] == jucc.NUM_CLASSES[name]
    for k in ("X_tr", "Y_tr", "Y_std", "Y_mean", "N_tr", "Dx"):
        np.testing.assert_array_equal(pd[k], jd[k], err_msg=k)
    assert len(pl) == len(jl) == (3 if val else 2)
    for a, b in zip(jl, pl):
        np.testing.assert_array_equal(b.dataset.X, a.dataset.X)
        np.testing.assert_array_equal(b.dataset.Y, a.dataset.Y)
    assert set(np.unique(pd["Y_tr"])) <= set(range(pd["Dy"]))


def test_missing_corpus_names_its_file():
    with pytest.raises(FileNotFoundError, match="not present"):
        pucc.load_banknote(1)
    with pytest.raises(FileNotFoundError, match="airline corpus missing"):
        preg.return_dataset("airline", 100)


def test_protocol_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("this host has a card; the default platform is valid here")
    with pytest.raises(SystemExit, match="no CUDA device"):
        pcp.main(["--epochs", "3"])
