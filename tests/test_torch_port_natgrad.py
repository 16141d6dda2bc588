"""The port's natural-gradient VI (`train/natgrad.py`, the Trainer's natgrad
paths and the CLI's `--natgrad` flags) against the JAX package, on the CPU
in fp64.

  * `natgrad_apply` on seeded (m, L, dm, dS), in the step that needs no
    halving, the one that halves gamma until the new precision is positive
    definite, and the one that never gets there (a no-op);
  * `natgrad_update`: the JAX package's own cases (`tests/test_natgrad.py`:
    one gamma=1 step lands on the conjugate optimum, whitened and not; an
    absurd gamma never NaNs), the step itself held against JAX's;
  * 20 Trainer steps, full batch and minibatch, constant gamma and the
    warmup ramp, against the JAX Trainer; the ramp carried across train()
    calls; the step-arch guard and its override;
  * the CLI's `--natgrad` against the JAX CLI on boston, M=5, 20 epochs.
Values at rtol 1e-8, atol 1e-10 (the same float64 math on both sides).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tgp.pytorch_tpu.data.batching import ArrayDataset as JDataset, \
    DataLoader as JLoader
from tgp.pytorch_tpu.flows import generators as jG, spec_from_list as j_spec
from tgp.pytorch_tpu.likelihoods import LikelihoodSpec as JLik
from tgp.pytorch_tpu.models import serialization as jser, tgp as JM
from tgp.pytorch_tpu.ops import kernels as jK
from tgp.pytorch_tpu.train import Trainer as JTrainer, natgrad as jng
from tgp.pytorch_tpu import config as jcfg

from tgp.pytorch_tpu_torch import config as pcfg, weights
from tgp.pytorch_tpu_torch.data import ArrayDataset, DataLoader
from tgp.pytorch_tpu_torch.experiments import main as pmain
from tgp.pytorch_tpu_torch.models import tgp as PM
from tgp.pytorch_tpu_torch.train import Trainer, natgrad as png

from test_torch_port_cli import jax_run, result_line

F64 = dict(rtol=1e-8, atol=1e-10)


@pytest.fixture(autouse=True)
def _port_state():
    prev, jprev, dt = pcfg.precision(), jcfg.precision(), torch.get_default_dtype()
    nt = torch.get_num_threads()
    pcfg.set_precision("fp64")
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


def to_port(tree):
    return weights.params_from_jax(jax.tree_util.tree_map(np.asarray, tree),
                                   device="cpu", dtype=torch.float64)


def _svgp(N=80, Dx=2, M=12, whiten=True, seed=0):
    """The JAX package's conjugate case (`tests/test_natgrad.py::_svgp`) in
    both packages: (spec_j, spec_p, params_j, params_p, X, Y)."""
    rs = np.random.RandomState(seed)
    X, Y = rs.randn(N, Dx), rs.randn(N, 1)
    spec_j = JM.svgp_spec(Dy=1, Dx=Dx, M=M, N=float(N), whiten=whiten,
                          kernel=jK.from_name("scale_rbf"),
                          likelihood=JLik("gaussian", 1))
    params_j = JM.init_tgp_params(
        spec_j, X, X[:M].copy(), variance_scale=1e-5,
        kernel_init={"length_scale": 2.0, "kernel_scale": 2.0})
    spec_p = weights.spec_from_dict(jser.spec_to_dict(spec_j))
    return spec_j, spec_p, params_j, to_port(params_j), X, Y


# ---------------------------------------------------------------------------
# natgrad_apply, natgrad_update, gamma_at
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case, gamma", [
    ("plain", 0.5), ("halving", 40.0), ("no_op", 1e6)])
def test_natgrad_apply_matches_jax(case, gamma):
    """dS negative definite makes -2 theta2 grow (every gamma is PD); an
    indefinite dS needs gamma halved; a strongly positive one never PD."""
    rs = np.random.RandomState(7)
    nq, M = 2, 5
    Lq = np.tril(0.3 * rs.randn(nq, M, M)) + np.eye(M)
    m = rs.randn(nq, M)
    A = rs.randn(nq, M, M)
    sym = A @ np.swapaxes(A, -1, -2) / M
    dS = {"plain": -sym, "halving": -sym + 0.4 * np.eye(M),
          "no_op": sym + 10.0 * np.eye(M)}[case]
    dm = rs.randn(nq, M)
    spec = dataclasses.make_dataclass("S", [("M", int)])(M)
    pj = {"q_mu": jnp.asarray(m), "q_L": jnp.asarray(Lq), "Z": jnp.zeros(1)}
    want = jng.natgrad_apply(spec, pj, jnp.asarray(dm), jnp.asarray(dS), gamma)
    got = png.natgrad_apply(spec, to_port(pj), torch.tensor(dm),
                            torch.tensor(dS), gamma)
    close(got["q_mu"], want["q_mu"])
    close(got["q_L"], want["q_L"])
    moved = not np.allclose(np.asarray(want["q_mu"]), m)
    assert moved == (case != "no_op")
    if case == "halving":
        # gamma itself fails: the step taken is a halved one
        full = png.natgrad_apply(spec, to_port(pj), torch.tensor(dm),
                                 torch.tensor(dS), gamma, max_halvings=0)
        close(full["q_mu"], m)


@pytest.mark.parametrize("whiten", [True, False])
def test_conjugate_one_step_exact(whiten):
    """One gamma=1 step lands on the optimal q(U), as in the JAX package
    (`tests/test_natgrad.py::test_conjugate_one_step_exact`,
    `test_unwhitened_also_exact`), and equals the JAX package's step."""
    spec_j, spec_p, pj, pp, X, Y = _svgp(
        **({} if whiten else dict(N=60, M=10, seed=1)), whiten=whiten)
    Xj, Yj, Xt, Yt = jnp.asarray(X), jnp.asarray(Y), torch.tensor(X), torch.tensor(Y)
    e0 = float(PM.elbo(spec_p, pp, Xt, Yt)[0])
    p1 = png.natgrad_update(spec_p, pp, Xt, Yt, None, 1.0)
    want = jng.natgrad_update(spec_j, pj, Xj, Yj, None, 1.0)
    close(p1["q_mu"], want["q_mu"])
    close(p1["q_L"], want["q_L"])
    e1 = float(PM.elbo(spec_p, p1, Xt, Yt)[0])
    p2 = png.natgrad_update(spec_p, p1, Xt, Yt, None, 1.0)
    e2 = float(PM.elbo(spec_p, p2, Xt, Yt)[0])
    assert abs(e2 - e1) < 1e-4
    if whiten:
        assert e1 > e0 + 10.0
        leaves = {k: v.detach().clone().requires_grad_(True)
                  for k, v in p2.items() if k in ("q_mu", "q_L")}
        e = PM.elbo(spec_p, dict(p2, **leaves), Xt, Yt)[0]
        g = torch.autograd.grad(e, list(leaves.values()))
        scale = abs(e1) + 1.0
        assert all(float(gi.abs().max()) < 1e-5 * scale for gi in g)


def test_huge_gamma_never_nans():
    spec_j, spec_p, pj, pp, X, Y = _svgp()
    Xt, Yt = torch.tensor(X), torch.tensor(Y)
    p = png.natgrad_update(spec_p, pp, Xt, Yt, None, 1e6)
    want = jng.natgrad_update(spec_j, pj, jnp.asarray(X), jnp.asarray(Y),
                              None, 1e6)
    assert all(bool(torch.isfinite(t).all()) for t in weights.tree_leaves(p))
    assert np.isfinite(float(PM.elbo(spec_p, p, Xt, Yt)[0]))
    close(p["q_mu"], want["q_mu"])
    close(p["q_L"], want["q_L"])


def test_gamma_at_matches_jax():
    t = np.arange(0, 30)
    close(png.gamma_at(0.7, 12, t), jng.gamma_at(0.7, 12, t))
    assert float(png.gamma_at(1.0, 5, 4)) == 1.0


# ---------------------------------------------------------------------------
# the Trainer
# ---------------------------------------------------------------------------

def _trainers(batch, flow=True, N=60, M=6):
    """The port's and the JAX Trainer on one seeded model: Dy=1, Dx=3, a
    SAL(1) flow (or none), M inducing points, 10 GH nodes, a perturbed
    init; training rows in batches of `batch` (N: full batch)."""
    rs = np.random.RandomState(3)
    X, Y = rs.randn(N, 3), rs.randn(N, 1)
    np.random.seed(0)
    fspec, finits = j_spec(jG.SAL(1)) if flow else ((), None)
    kw = dict(flow=fspec) if flow else {}
    spec_j = JM.TGPSpec(Dy=1, Dx=3, M=M, N=float(N),
                        kernel=jK.from_name("scale_rbf"),
                        likelihood=JLik("gaussian_flow" if flow else "gaussian",
                                        1, quad_points=10), **kw)
    spec_p = weights.spec_from_dict(jser.spec_to_dict(spec_j))
    pj = JM.init_tgp_params(spec_j, X, X[:M].copy(), flow_inits=finits)
    pp = weights.perturb_params(to_port(pj), seed=1)
    pn = weights.params_to_numpy(pp)
    loaders = lambda L, D: [L(D(X, Y), batch, seed=2),        # noqa: E731
                            L(D(X[:20], Y[:20]), 100, shuffle=False)]
    tr_p = Trainer(spec_p, pp, loaders(DataLoader, ArrayDataset), np.ones(1),
                   S_test=5, seed=0, device="cpu")
    tr_j = JTrainer(spec_j, jax.tree_util.tree_map(jnp.asarray, pn),
                    loaders(JLoader, JDataset), np.ones(1), S_test=5, seed=0)
    return tr_p, tr_j


def _held(tr_p, tr_j):
    for attr in ("loss_curve", "ell_curve", "kld_curve"):
        close(np.asarray(getattr(tr_p, attr), np.float64),
              [float(v) for v in getattr(tr_j, attr)])
    jl = jax.tree_util.tree_leaves_with_path(tr_j.params)
    pl = weights.tree_leaves(tr_p.params)
    assert len(jl) == len(pl)
    for (path, a), b in zip(jl, pl):
        close(b, a, err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("batch, flow, ng", [
    pytest.param(60, True, dict(natgrad_gamma=1.0), id="full_batch"),
    pytest.param(60, False, dict(natgrad_gamma=1.0), id="full_batch-svgp"),
    pytest.param(60, True, dict(natgrad_gamma=0.5, natgrad_warmup=7),
                 id="full_batch-warmup"),
    pytest.param(16, True, dict(natgrad_gamma=0.3), id="minibatch"),
    pytest.param(16, True, dict(natgrad_gamma=0.5, natgrad_warmup=9),
                 id="minibatch-warmup"),
])
def test_natgrad_trainer_matches_jax(batch, flow, ng):
    """20 full-batch steps (or 5 epochs of 3 batches and a remainder of
    12) of Adam on the hyperparameters and natural gradients on q(U)."""
    tr_p, tr_j = _trainers(batch, flow)
    epochs = 20 if batch == 60 else 5
    for tr in (tr_p, tr_j):
        tr.train(epochs, 0.01, "adam", verbose_each=0, **ng)
    _held(tr_p, tr_j)
    if "natgrad_warmup" in ng:
        assert tr_p._ng_t == tr_j._ng_t == (20 if batch == 60 else 5 * 4)
    mp, mj = tr_p.compute_metrics(), tr_j.compute_metrics()
    close(mp["test"]["logL"], mj["test"]["logL"])
    close(mp["test"]["rmse"], mj["test"]["rmse"])


def test_warmup_carries_across_train_calls():
    """A ramp of K=10 split over two train() calls equals the unsplit run
    bit for bit, and the JAX Trainer's split run; a call without natgrad
    resets the counter.  The full batch is unshuffled: a shuffling loader
    sums its rows in another order in each train() call."""
    whole, _ = _trainers(60)
    split_p, split_j = _trainers(60)
    for tr in (whole, split_p, split_j):
        tr.train_loader.shuffle = False
    whole.train(10, 0.01, verbose_each=0, natgrad_gamma=1.0, natgrad_warmup=10)
    for tr in (split_p, split_j):
        for n in (4, 6):
            tr.train(n, 0.01, verbose_each=0, natgrad_gamma=1.0,
                     natgrad_warmup=10)
    assert split_p._ng_t == split_j._ng_t == 10
    for a, b in zip(weights.tree_leaves(whole.params),
                    weights.tree_leaves(split_p.params)):
        assert torch.equal(a, b)
    assert np.array_equal(np.asarray(whole.loss_curve),
                          np.asarray(split_p.loss_curve))
    _held(split_p, split_j)
    split_p.train(1, 0.01, verbose_each=0)
    assert split_p._ng_t == 0


def _step_spec(warp=False):
    """A TGP with a StepTanhL flow, or a WGP with a StepTanhL warp."""
    from tgp.pytorch_tpu_torch.flows import generators as pG, spec_from_list
    from tgp.pytorch_tpu_torch.likelihoods import LikelihoodSpec as PLik
    from tgp.pytorch_tpu_torch.ops import kernels as pK
    np.random.seed(0)
    step, _ = spec_from_list(pG.StepTanhL(1, 2, add_f0=True))
    if warp:
        return PM.TGPSpec(Dy=1, Dx=3, M=4, N=10.0,
                          kernel=pK.from_name("scale_rbf"),
                          likelihood=PLik("warped", 1, warp_flow=step))
    return PM.TGPSpec(Dy=1, Dx=3, M=4, N=10.0, kernel=pK.from_name("scale_rbf"),
                      likelihood=PLik("gaussian_flow", 1), flow=step)


@pytest.mark.parametrize("warp", [False, True])
def test_step_arch_guard(capsys, warp):
    """gamma above 0.3 with a Step* flow or warp is refused, with the JAX
    package's message; natgrad_force turns it into a warning; 0.3 passes."""
    spec = _step_spec(warp)
    with pytest.raises(ValueError, match="natgrad_force") as got:
        png.guard_step_arch(spec, 1.0)
    with pytest.raises(ValueError) as want:
        jng.guard_step_arch(spec, 1.0)
    assert str(got.value) == str(want.value)
    png.guard_step_arch(spec, 0.3)
    png.guard_step_arch(spec, 1.0, force=True)
    png.warn_if_step_arch(spec, 1.0)
    assert capsys.readouterr().out.count("WARNING (forced)") == 2
    png.guard_step_arch(dataclasses.replace(spec, flow=()) if not warp
                        else _svgp()[1], 1.0)


def test_trainer_natgrad_refusals():
    tr, _ = _trainers(60)
    with pytest.raises(ValueError, match="needs natgrad_gamma"):
        tr.train(1, 0.01, natgrad_warmup=3)
    with pytest.raises(ValueError, match=">= 1"):
        tr.train(1, 0.01, natgrad_gamma=1.0, natgrad_warmup=0)
    with pytest.raises(ValueError, match="must be > 0"):
        tr.train(1, 0.01, natgrad_gamma=0.0)
    with pytest.raises(NotImplementedError, match="lbfgs"):
        tr.train(1, 0.01, "lbfgs", natgrad_gamma=1.0)
    deep = Trainer.__new__(Trainer)
    deep.__dict__.update(tr.__dict__, params={"layers": [tr.params]})
    with pytest.raises(NotImplementedError, match="deep stacks keep Adam"):
        deep.train(1, 0.01, natgrad_gamma=1.0)
    assert tr.loss_curve == []
    # plain lbfgs is ported (tests/test_torch_port_lbfgs.py): it trains
    lb, _ = _trainers(60)
    lb.train(2, 0.0, "lbfgs", verbose_each=0)
    assert len(lb.loss_curve) == 2 and np.isfinite(lb.loss_curve).all()


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

ARGV = ["--dataset", "boston", "--train_test_seed_split", "1",
        "--num_inducing", "5", "--epochs", "20", "--platform", "cpu",
        "--verbose_each", "0"]


@pytest.mark.parametrize("flags", [
    ["--model", "SVGP", "--natgrad", "1.0"],
    ["--model", "TGP", "--natgrad", "0.1", "--natgrad_warmup", "8"],
])
def test_natgrad_cli_matches_the_jax_cli(monkeypatch, capsys, flags):
    """The result line, the curves and every trained parameter (TGP:
    boston's StepTanhL(10, 2), identity-fitted first)."""
    argv = flags + ARGV
    mj, seen = jax_run(monkeypatch, argv)
    jline = result_line(capsys.readouterr().out)
    torch.set_num_threads(1)
    res = pmain.run(pmain.parse_args(argv))
    assert result_line(capsys.readouterr().out) == jline
    jt, pt = seen["trainer"], res.trainer
    _held(pt, jt)
    if "--natgrad_warmup" in flags:
        assert pt._ng_t == jt._ng_t == 20
    for split in ("train", "test"):
        for k in ("logL", "rmse"):
            close(res.metrics[split][k], mj[split][k])
