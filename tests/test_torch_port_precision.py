"""'bf16' precision in the port against the JAX package, on the CPU.

The JAX package's TPU routes run here with `rbf_gram.INTERPRET = True`: an
rbf Gram of at least 2^18 entries takes its fp32 Pallas kernel, a smaller
one `_sq_dist` with bf16 operands (its `_pallas_ok`).  The port follows the
same rule (`ops/kernels.py`): the large Gram takes the kernel's plain fp32
version on a CPU tensor, the small one the bf16 route, counted by
`kernels.BF16_GRAMS`.  Inputs are seeded numpy arrays given to both.

Tolerances (fp32 and bf16 values; the same function on both sides, only the
order of sums differs):
  * `_sq_dist` in bf16 and a Gram on either side of 2^18: values at 1e-5 of
    the largest entry (measured 3.6e-7; the bf16 rounding itself is
    ~4e-3); gradients the same, but that the cotangent of the bf16
    operands is itself rounded to bf16, so an entry whose fp32 sums fall on
    either side of a rounding boundary differs by one bf16 step (2^-7 of
    itself at most; at most 0.5% of the entries, `close_bf16_grad`);
  * the flagship's ELBO at N=512, M=16 in bf16: 1e-5 relative; its
    gradient by `close_bf16_grad`;
  * trajectories, 10x the largest gap measured against the JAX package
    (one bf16 step of a cotangent, where the packages' sums round apart,
    moves the rest of a run): a 30-epoch bf16 Trainer's curves at rtol
    5e-3 (measured 5.0e-4) and its parameters at 1.3e-2 of each leaf's
    largest entry (q_L 1.26e-3); the CLI (concrete SVGP, kin8nm TGP, 20
    epochs) at rtol 1.1e-3 on the curves (1.07e-4) and 5.1e-3 on logL and
    RMSE (5.04e-4); the battery (concrete SVGP, 2 seeds) at 2.7e-4 (2.6e-5).
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tgp.pytorch_tpu import config as jcfg
from tgp.pytorch_tpu.data.batching import ArrayDataset as JDataset, \
    DataLoader as JLoader
from tgp.pytorch_tpu.models import tgp as JM
from tgp.pytorch_tpu.ops import kernels as jK
from tgp.pytorch_tpu.ops.pallas import rbf_gram as jrbf
from tgp.pytorch_tpu.train import Trainer as JTrainer

from tgp.pytorch_tpu_torch import config as pcfg, weights
from tgp.pytorch_tpu_torch.data import ArrayDataset, DataLoader
from tgp.pytorch_tpu_torch.experiments import battery as pbat, main as pmain
from tgp.pytorch_tpu_torch.models import tgp as PM
from tgp.pytorch_tpu_torch.ops import kernels as pK, rbf_gram as RG
from tgp.pytorch_tpu_torch.train import Trainer

from test_torch_port_large import jax_native_parser

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _bf16():
    """Both packages in bf16, JAX on its TPU routes (Pallas interpreted);
    everything restored after."""
    prev, jprev = pcfg.precision(), jcfg.precision()
    jrbf.INTERPRET = True
    pcfg.set_precision("bf16")
    jcfg.set_precision("bf16")
    yield
    jrbf.INTERPRET = False
    pcfg.set_precision(prev)
    jcfg.set_precision(jprev)


def close_rel(got, want, rel, name=""):
    got = got.detach().cpu().numpy() if torch.is_tensor(got) else got
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-30),
                               err_msg=name)


def close_bf16_grad(got, want, name=""):
    """A gradient through the bf16 operands: its cotangent is rounded to
    bf16, so where the two packages' fp32 sums fall on either side of a
    rounding boundary an entry differs by one bf16 step (2^-7 of itself at
    most).  Held at 1e-5 of the largest entry, with at most 0.5% of the
    entries allowed one bf16 step beyond that."""
    got = got.detach().cpu().numpy() if torch.is_tensor(got) else got
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    tight = 1e-5 * np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=2.0 ** -7, atol=tight,
                               err_msg=name)
    assert (np.abs(got - want) > tight).mean() <= 5e-3, name


def _pair_inputs(Dy, N, M, Dx, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(Dy, N, Dx).astype(np.float32),
            rng.randn(Dy, M, Dx).astype(np.float32),
            rng.randn(Dy, N, M).astype(np.float32))


def test_bf16_sq_dist_and_its_gradients_match_jax():
    X1, X2, w = _pair_inputs(2, 37, 11, 5)

    def jf(a, b):
        return jnp.sum(w * jK._sq_dist(a, b))

    jv = jK._sq_dist(X1, X2)
    jg = jax.grad(jf, argnums=(0, 1))(X1, X2)
    a = torch.tensor(X1, requires_grad=True)
    b = torch.tensor(X2, requires_grad=True)
    pK.BF16_GRAMS = 0
    pv = pK._sq_dist(a, b)
    assert pK.BF16_GRAMS == 1 and pv.dtype == torch.float32
    pg = torch.autograd.grad(torch.sum(torch.as_tensor(w) * pv), (a, b))
    close_rel(pv, jv, 1e-5, "d2")
    for g, h, name in zip(pg, jg, ("dX1", "dX2")):
        close_bf16_grad(g, h, name)
    # the rounding is real: the fp32 distance differs by far more
    d32 = RG.sq_dist(a, b).detach().numpy()
    assert np.abs(d32 - np.asarray(jv)).max() > 1e-4


@pytest.mark.parametrize("N, routed", [(2600, "bf16"), (2700, "kernel")])
def test_gram_on_either_side_of_2_18_matches_jax(N, routed):
    """Dy=1, M=100: K_xz has 260,000 entries (bf16) or 270,000 (the fp32
    kernel's route); K_zz's 10,000 take bf16 either way."""
    spec = jK.from_name("scale_rbf")
    pspec = pK.from_name("scale_rbf")
    X, Z, _ = _pair_inputs(1, N, 100, 4, seed=1)
    jp = jK.init_params(spec, 1, 4, {"length_scale": 1.5,
                                     "kernel_scale": 1.3})
    jp = jax.tree_util.tree_map(np.asarray, jp)
    pp = weights.params_from_jax(jp, device="cpu")
    rng = np.random.RandomState(2)
    wxz = rng.randn(1, N, 100).astype(np.float32)
    wzz = rng.randn(1, 100, 100).astype(np.float32)

    def jloss(p, x, z):
        return (jnp.sum(wxz * jK.gram(spec, p, x, z))
                + jnp.sum(wzz * jK.gram(spec, p, z, z)))

    jkxz = jK.gram(spec, jp, X, Z)
    jkzz = jK.gram(spec, jp, Z, Z)
    jg = jax.grad(jloss, argnums=(0, 1, 2))(jp, X, Z)

    leaves = weights.tree_leaves(pp)
    for t in leaves:
        t.requires_grad_(True)
    x, z = (torch.tensor(a, requires_grad=True) for a in (X, Z))
    pK.BF16_GRAMS = 0
    kxz, kzz = pK.gram_pair(pspec, pp, x, z)
    assert pK.BF16_GRAMS == (2 if routed == "bf16" else 1)
    pK.BF16_GRAMS = 0
    single = pK.gram(pspec, pp, x, z)
    assert pK.BF16_GRAMS == (1 if routed == "bf16" else 0)
    assert torch.equal(single, kxz)
    loss = (torch.sum(torch.as_tensor(wxz) * kxz)
            + torch.sum(torch.as_tensor(wzz) * kzz))
    pg = torch.autograd.grad(loss, leaves + [x, z])
    close_rel(kxz, jkxz, 1e-5, "K_xz")
    close_rel(kzz, jkzz, 1e-5, "K_zz")
    for g, h in zip(pg[:len(leaves)], jax.tree_util.tree_leaves(jg[0])):
        close_bf16_grad(g, h, "d params")
    close_bf16_grad(pg[-2], jg[1], "dX")
    close_bf16_grad(pg[-1], jg[2], "dZ")


def test_fp32_and_fp64_routes_are_unchanged():
    """Outside bf16 every rbf Gram takes the kernel's route, whatever its
    size, and nothing is counted."""
    X, Z, _ = _pair_inputs(1, 50, 10, 3)
    pp = pK.init_params(pK.from_name("scale_rbf"), 1, 3, device="cpu")
    for mode in ("fp32", "fp64"):
        pcfg.set_precision(mode)
        dt = pcfg.default_dtype()
        x, z = torch.tensor(X, dtype=dt), torch.tensor(Z, dtype=dt)
        p = weights.tree_map(lambda t: t.to(dt), pp)
        pK.BF16_GRAMS = 0
        kxz, kzz = pK.gram_pair(pK.from_name("scale_rbf"), p, x, z)
        assert pK.BF16_GRAMS == 0
        ls, ks = pK._rbf_leaf(pK.from_name("scale_rbf"), p, x)
        want = RG.rbf_gram_pair_reference(x / ls, z / ls, ks)
        assert torch.equal(kxz, want[0]) and torch.equal(kzz, want[1])


def test_set_precision_bf16_keeps_tf32_off_and_restores():
    pcfg.set_precision("bf16")
    assert pcfg.default_dtype() == torch.float32
    assert pcfg.matmul_dtype() == torch.bfloat16
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"
    pcfg.set_precision("fp32")
    assert pcfg.matmul_dtype() == torch.float32
    assert torch.get_float32_matmul_precision() == "highest"
    pcfg.set_precision("fp64")
    assert pcfg.matmul_dtype() == pcfg.default_dtype() == torch.float64
    with pytest.raises(ValueError):
        pcfg.set_precision("fp16")


def _flagship(N=512, M=16, quad=20):
    """The flagship at a small size, perturbed, in both packages."""
    rng = np.random.RandomState(0)
    X = rng.randn(N, 4).astype(np.float32)
    Y = (np.sinh(X @ rng.randn(4, 1)) + 0.1 * rng.randn(N, 1)).astype(
        np.float32)
    spec_p = weights.flagship_spec(N, M=M, quad=quad)
    pp = weights.flagship_params(spec_p, X, seed=0, device="cpu")
    return spec_p, _jax_spec(N, M, quad), pp, X, Y


def _jax_spec(N, M, quad):
    from tgp.pytorch_tpu.flows import generators as jG, spec_from_list
    from tgp.pytorch_tpu.likelihoods import LikelihoodSpec as JLik
    fspec, _ = spec_from_list(jG.SAL(2))
    return JM.TGPSpec(Dy=1, Dx=4, M=M, N=float(N),
                      kernel=jK.from_name("scale_rbf"),
                      likelihood=JLik("gaussian_flow", 1, quad_points=quad),
                      flow=fspec)


def test_flagship_elbo_and_gradient_in_bf16_match_jax():
    spec_p, spec_j, pp, X, Y = _flagship()
    pj = weights.params_to_numpy(pp)
    je, jell, jkl = JM.elbo(spec_j, pj, X, Y)
    jg = jax.grad(lambda p: JM.elbo(spec_j, p, X, Y)[0])(pj)
    leaves = weights.tree_leaves(pp)
    for t in leaves:
        t.requires_grad_(True)
    pK.BF16_GRAMS = 0
    e, ell, kl = PM.elbo(spec_p, pp, torch.as_tensor(X), torch.as_tensor(Y))
    assert pK.BF16_GRAMS == 2          # K_xz (8,192) and K_zz (256)
    g = torch.autograd.grad(e, leaves)
    assert np.isfinite(float(e.detach()))
    for got, want, name in ((e, je, "elbo"), (ell, jell, "ell"),
                            (kl, jkl, "kl")):
        close_rel(got, want, 1e-5, name)
    for (path, h), gg in zip(jax.tree_util.tree_leaves_with_path(jg), g):
        close_bf16_grad(gg, h, jax.tree_util.keystr(path))


def test_bf16_trainer_30_epochs_matches_jax():
    spec_p, spec_j, pp, X, Y = _flagship(N=256, M=12, quad=20)
    pj = weights.params_to_numpy(pp)
    jtr = JTrainer(spec_j, jax.tree_util.tree_map(np.copy, pj),
                   [JLoader(JDataset(X, Y), 256, seed=1),
                    JLoader(JDataset(X, Y), 256, shuffle=False)],
                   Y_std=np.ones(1), S_test=5, seed=2)
    jtr.train(30, 0.02, "adam", verbose_each=0)
    ptr = Trainer(spec_p, pp, [DataLoader(ArrayDataset(X, Y), 256, seed=1),
                               DataLoader(ArrayDataset(X, Y), 256,
                                          shuffle=False)],
                  Y_std=np.ones(1), S_test=5, seed=2, device="cpu")
    pK.BF16_GRAMS = 0
    ptr.train(30, 0.02, "adam", verbose_each=0)
    assert pK.BF16_GRAMS == 30 * 2     # both Grams of every step
    for attr in ("loss_curve", "ell_curve", "kld_curve"):
        got = np.asarray(getattr(ptr, attr), np.float64)
        want = np.asarray([float(v) for v in getattr(jtr, attr)])
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, want, rtol=5e-3, err_msg=attr)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(jtr.params),
                            weights.tree_leaves(ptr.params)):
        close_rel(b, a, 1.3e-2, jax.tree_util.keystr(path))


def _jax_cli():
    """The JAX CLI's module, its loaders on the JAX package's native parser
    (as the port's)."""
    sys.path.insert(0, os.path.join(REPO, "experiments"))
    import main as jmain
    jax_native_parser()
    return jmain


@pytest.mark.parametrize("model", ["SVGP", "TGP"])
def test_cli_precision_bf16_matches_the_jax_cli(monkeypatch, capsys, model):
    import tgp.pytorch_tpu.train as jtrain

    # kin8nm's table arch has no Step* (no identity fit)
    argv = ["--model", model,
            "--dataset", "concrete" if model == "SVGP" else "kin8nm",
            "--train_test_seed_split", "1", "--num_inducing", "10",
            "--epochs", "20", "--platform", "cpu", "--verbose_each", "0",
            "--precision", "bf16"]
    seen = {}

    class Caught(jtrain.Trainer):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            seen["trainer"] = self

    monkeypatch.setattr(jtrain, "Trainer", Caught)
    mj = _jax_cli().run(_jax_cli().parse_args(argv))
    jt = seen["trainer"]
    pK.BF16_GRAMS = 0
    res = pmain.run(pmain.parse_args(argv))
    out = capsys.readouterr().out
    assert "full-bf16 TRAINING is measured unstable" in out
    assert pK.BF16_GRAMS > 0 and pcfg.precision() == "bf16"
    pt = res.trainer
    for attr in ("loss_curve", "kld_curve"):
        got = np.asarray(getattr(pt, attr), np.float64)
        want = np.asarray([float(v) for v in getattr(jt, attr)])
        assert got.shape == want.shape == (20,) and np.isfinite(got).all()
        np.testing.assert_allclose(got, want, rtol=1.1e-3, err_msg=attr)
    for split in ("train", "test"):
        for k in ("logL", "rmse"):
            np.testing.assert_allclose(res.metrics[split][k], mj[split][k],
                                       rtol=5.1e-3)


def test_battery_precision_bf16_matches_the_jax_battery(monkeypatch,
                                                        tmp_path):
    sys.path.insert(0, os.path.join(REPO, "experiments"))
    import battery as jbat
    from tgp.pytorch_tpu.train import multiseed as jms

    argv = ["--model", "SVGP", "--dataset", "concrete", "--num_inducing",
            "10", "--seeds", "1-2", "--epochs", "20", "--precision", "bf16",
            "--platform", "cpu"]
    seen = {}
    ev = jms.eval_multiseed

    def caught(*a, **k):
        seen["m"] = ev(*a, **k)
        return seen["m"]

    monkeypatch.setattr(jms, "eval_multiseed", caught)
    npy_j, npy_p = tmp_path / "j.npy", tmp_path / "p.npy"
    monkeypatch.setattr(sys, "argv", ["battery.py", *argv,
                                      "--save_curves", str(npy_j)])
    jax_native_parser()
    jbat.main()
    pK.BF16_GRAMS = 0
    res = pbat.main([*argv, "--save_curves", str(npy_p)])
    assert pK.BF16_GRAMS > 0
    cj, cp = np.load(npy_j), np.load(npy_p)
    assert cp.shape == cj.shape == (2, 20) and np.isfinite(cp).all()
    np.testing.assert_allclose(cp, cj, rtol=2.7e-4)
    (_, m_p, _, _), = res.reports
    for k in ("logL", "rmse"):
        np.testing.assert_allclose(m_p[k], seen["m"][k], rtol=2.7e-4)
