"""The port's battery CLI (`python -m tgp.pytorch_tpu_torch.experiments.
battery`) against the repo's `experiments/battery.py` (the JAX package's),
on the CPU in fp64, and its checkpoints and refusals.

  * boston, seeds 1-3, M=5, 20 epochs: SVGP, TGP at a non-step arch
    (`--arch SAL_BCL:1`), the warped GP (`--warp_arch log_exp`), SVGP with
    `--natgrad 1.0`, SVGP in minibatches (`--batch_size 200`), and the
    hold-kernel protocol on `synthetic_binary` (`--hold_kernel_epochs 10`):
    the k-means centers, the ELBO curves (`--save_curves`), the per-seed
    logL and rmse (logL and acc) at rtol 1e-8, the printed per-seed lines
    (coverage's draws differ between the packages, so it is left out) and
    the `--out` record's keys and values (but coverage and train_s);
  * the deep TGP (`--model DGP`), whose draws differ between the packages:
    finite curves and metrics, and its kernel calls;
  * `--ckpt`: a run stopped by `--ckpt_stop_after` and resumed is bitwise
    the uninterrupted run; a checkpoint of another configuration is
    refused, and so is a completed one (as `tests/test_battery_ckpt.py`);
  * `--mesh`, `--rng_impl rbg` and `--precision bf16` run (a mesh of more
    than one rank needs torch.distributed.run, and says so).
No Step* identity fit or ID_TGP anchor fit (2000 eager epochs a seed) runs
here: `chip_smoke.py` runs those on the card.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

from tgp.pytorch_tpu import config as jcfg
from tgp.pytorch_tpu import data as jdata
from tgp.pytorch_tpu.train import multiseed as jms

from tgp.pytorch_tpu_torch import config as pcfg
from tgp.pytorch_tpu_torch.experiments import battery as pbat
from tgp.pytorch_tpu_torch.train import multiseed as pms
from tgp.pytorch_tpu_torch.weights import tree_leaves

from test_torch_port_large import jax_native_parser

EXP = os.path.join(os.path.dirname(__file__), "..", "experiments")
if EXP not in sys.path:
    sys.path.insert(0, EXP)

F64 = dict(rtol=1e-8, atol=1e-10)
BOSTON = ["--dataset", "boston", "--num_inducing", "5", "--seeds", "1-3",
          "--epochs", "20", "--precision", "fp64"]


@pytest.fixture(autouse=True)
def _state():
    prev, jprev = pcfg.precision(), jcfg.precision()
    nt = torch.get_num_threads()
    torch.set_num_threads(1)        # the eager small ops run faster
    yield
    pcfg.set_precision(prev)
    if jcfg.precision() != jprev:
        jcfg.set_precision(jprev)
    torch.set_num_threads(nt)


def seen_wrap(monkeypatch, module, name, seen):
    fn = getattr(module, name)

    def inner(*a, **k):
        out = fn(*a, **k)
        seen.setdefault(name, []).append(out)
        return out

    monkeypatch.setattr(module, name, inner)


def jax_battery(monkeypatch, tmp_path, argv):
    """The JAX battery's main() in this process: its --out records, saved
    curves, k-means centers and evaluation metrics (its loaders on the JAX
    package's native parser, as the port's)."""
    import battery
    jax_native_parser()
    seen = {}
    seen_wrap(monkeypatch, jms, "eval_multiseed", seen)
    seen_wrap(monkeypatch, jdata, "kmeans_centers", seen)
    out, npy = tmp_path / "jax.jsonl", tmp_path / "jax.npy"
    monkeypatch.setattr(sys, "argv", ["battery.py", *argv, "--platform", "cpu",
                                      "--out", str(out),
                                      "--save_curves", str(npy)])
    battery.main()
    return ([json.loads(ln) for ln in out.read_text().splitlines()],
            np.load(npy), seen)


def port_battery(monkeypatch, tmp_path, argv):
    from tgp.pytorch_tpu_torch import data as pdata
    seen = {}
    seen_wrap(monkeypatch, pdata, "kmeans_centers", seen)
    out, npy = tmp_path / "port.jsonl", tmp_path / "port.npy"
    res = pbat.main([*argv, "--platform", "cpu", "--out", str(out),
                     "--save_curves", str(npy)])
    return ([json.loads(ln) for ln in out.read_text().splitlines()],
            np.load(npy), seen, res)


CASES = {
    "svgp": ["--model", "SVGP", *BOSTON],
    "tgp_sal_bcl": ["--model", "TGP", "--arch", "SAL_BCL:1", *BOSTON],
    "wgp_log_exp": ["--model", "WGP", "--warp_arch", "log_exp", *BOSTON],
    "svgp_natgrad": ["--model", "SVGP", "--natgrad", "1.0", *BOSTON],
    "svgp_minibatch": ["--model", "SVGP", "--batch_size", "200", *BOSTON],
    "hold_kernel": ["--model", "SVGP", "--dataset", "synthetic_binary",
                    "--num_inducing", "5", "--seeds", "1-3", "--epochs", "20",
                    "--hold_kernel_epochs", "10", "--precision", "fp64"],
}


@pytest.mark.parametrize("case", list(CASES))
def test_battery_cli_matches_the_jax_battery(monkeypatch, tmp_path, capsys,
                                             case):
    argv = CASES[case]
    recs_j, curves_j, seen_j = jax_battery(monkeypatch, tmp_path, argv)
    out_j = capsys.readouterr().out
    recs_p, curves_p, seen_p, res = port_battery(monkeypatch, tmp_path, argv)
    out_p = capsys.readouterr().out
    for a, b in zip(seen_p["kmeans_centers"], seen_j["kmeans_centers"]):
        np.testing.assert_allclose(a, b, **F64)
    assert curves_p.shape == curves_j.shape == (3, 20)
    np.testing.assert_allclose(curves_p, curves_j, **F64)
    (tag, m_p, lines, rec_p), = res.reports
    m_j = seen_j["eval_multiseed"][0]
    assert set(m_p) == set(m_j)
    for k in m_j:
        if k != "coverage":
            np.testing.assert_allclose(m_p[k], m_j[k], **F64)
    # the printed per-seed lines and the record, but coverage and timing
    strip = (lambda ln: ln.split("  coverage")[0])   # noqa: E731
    seeds_j = [strip(ln) for ln in out_j.splitlines()
               if ln.startswith(("seed ", "mean +- std"))]
    seeds_p = [strip(ln) for ln in out_p.splitlines()
               if ln.startswith(("seed ", "mean +- std"))]
    assert seeds_p == seeds_j and seeds_p == [strip(ln) for ln in lines
                                              if ln.startswith(("seed ",
                                                                "mean"))]
    (rec_j,) = recs_j
    assert [rec_p] == recs_p and list(rec_p) == list(rec_j)
    for k in rec_j:
        if k != "train_s":
            assert rec_p[k] == rec_j[k], k
    assert res.kernel_calls == {"train": (0, 0), "eval": (0, 0)}  # the CPU


def test_dgp_battery_runs_and_is_finite(tmp_path, capsys):
    res = pbat.main(["--model", "DGP", "--layers", "2", *BOSTON,
                     "--platform", "cpu", "--out", str(tmp_path / "d.jsonl")])
    (tag, m, lines, rec), = res.reports
    assert tag == "DGP-2" and rec["model"] == "DGP-2"
    assert np.isfinite(res.curves["elbo"]).all()
    assert res.curves["elbo"].shape == (20, 3)
    assert all(np.isfinite(m[k]).all() for k in m)
    assert m["logL"].shape == (3, 1)
    assert res.kernel_calls == {"train": (0, 0), "eval": (0, 0)}  # the CPU


CKPT = ["--model", "SVGP", "--dataset", "boston", "--num_inducing", "5",
        "--seeds", "1-2", "--epochs", "20", "--batch_size", "256",
        "--platform", "cpu", "--ckpt_each", "10"]


def _ckpt_run(tmp_path, tag, extra=()):
    out = tmp_path / f"{tag}.jsonl"
    res = pbat.main([*CKPT, "--out", str(out), *extra])
    return res, [json.loads(ln) for ln in out.read_text().splitlines()]


def test_battery_ckpt_resume_bitwise(tmp_path):
    """A run stopped after its first 10-epoch segment (exit 75) and resumed
    equals the uninterrupted run bit for bit: parameters, curves and
    metrics (the Adam moments, the generators and the shuffles' PCG64
    states carry across)."""
    ck_a, ck_b = str(tmp_path / "a.pt"), str(tmp_path / "b.pt")
    with pytest.raises(SystemExit) as e:
        _ckpt_run(tmp_path, "a0", ["--ckpt", ck_a, "--ckpt_stop_after", "1"])
    assert e.value.code == 75 and os.path.exists(ck_a)
    res_a, rec_a = _ckpt_run(tmp_path, "a1", ["--ckpt", ck_a])
    res_b, rec_b = _ckpt_run(tmp_path, "b", ["--ckpt", ck_b])
    for a, b in zip(tree_leaves(res_a.params), tree_leaves(res_b.params)):
        assert torch.equal(a, b)
    for k in res_b.curves:
        np.testing.assert_array_equal(res_a.curves[k], res_b.curves[k])
    assert res_a.curves["elbo"].shape == (20, 2)
    for a, b in zip(res_a.reports[0][1].values(), res_b.reports[0][1].values()):
        np.testing.assert_array_equal(a, b)
    assert rec_a[0]["nll"] == rec_b[0]["nll"]


def test_battery_ckpt_refuses_another_config_and_a_completed_one(tmp_path):
    ck = str(tmp_path / "m.pt")
    with pytest.raises(SystemExit):
        _ckpt_run(tmp_path, "m0", ["--ckpt", ck, "--ckpt_stop_after", "1"])
    with pytest.raises(SystemExit, match="different battery config"):
        _ckpt_run(tmp_path, "m1", ["--ckpt", ck, "--lr", "0.02"])
    done = str(tmp_path / "done.pt")
    _, rows = _ckpt_run(tmp_path, "full", ["--ckpt", done])
    with pytest.raises(SystemExit, match="already complete"):
        _ckpt_run(tmp_path, "full", ["--ckpt", done])
    out = tmp_path / "full.jsonl"
    assert len(out.read_text().splitlines()) == len(rows)   # nothing added


@pytest.mark.parametrize("flags", [["--mesh", "2"], ["--rng_impl", "rbg"],
                                   ["--precision", "bf16"]])
def test_battery_runs_the_item_20_flags(flags, tmp_path):
    """Item 20 is ported: each flag runs.  A --mesh of one rank runs in the
    process, bitwise the battery without one; of more ranks, it needs
    torch.distributed.run and names the command.  --rng_impl rbg and
    --precision bf16 train (against the JAX battery in
    tests/test_torch_port_precision.py and _rng.py)."""
    from tgp.pytorch_tpu_torch.ops import kernels as pK

    argv = ["--model", "SVGP", "--dataset", "boston", "--num_inducing", "5",
            "--seeds", "1-2", "--epochs", "5", "--platform", "cpu"]
    plain = pbat.main(argv)
    try:
        if flags[0] == "--mesh":
            with pytest.raises(SystemExit, match="torch.distributed.run "
                               "--nproc_per_node 2"):
                pbat.main(argv + flags)
            got = pbat.main(argv + ["--mesh", "1"])
        else:
            pK.BF16_GRAMS = 0
            got = pbat.main(argv + flags)
            assert (pK.BF16_GRAMS > 0) == (flags[1] == "bf16")
    finally:
        pcfg.set_rng_impl("threefry2x32")
    curves = np.asarray(got.curves["elbo"])
    assert curves.shape == (5, 2) and np.isfinite(curves).all()
    if flags[1] != "bf16":         # SVGP draws nothing: the same run
        np.testing.assert_array_equal(curves, plain.curves["elbo"])


def test_battery_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        pbat.main(["--model", "SVGP", "--dataset", "boston",
                   "--num_inducing", "5"])
    # the battery's own entry point too (on a mesh too: ported, see
    # tests/test_torch_port_rng.py)
    from tgp.pytorch_tpu_torch import weights
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pms.train_multiseed(weights.flagship_spec(2, M=1), {},
                            np.zeros((1, 2, 4)), np.zeros((1, 2, 1)), 1, 0.01)
