"""The port's L-BFGS (`train/lbfgs.py`, `train/optimizers.py::
lbfgs_optimizer`, the Trainer's `opt="lbfgs"`) against the JAX package and
optax 0.2.6, on the CPU in fp64.

  * `tests/test_lbfgs.py`'s three cases on the port: the quadratic solved in
    ten iterations, an SVGP fit beyond Adam's at equal steps, the
    refusals;
  * the optimizer against `optax.lbfgs` as the JAX package builds it, on
    the quadratic and on 2-D Rosenbrock (40 iterations): the iterates, the
    accepted stepsizes and the trial counts;
  * `Trainer(opt="lbfgs")` against the JAX Trainer on `test_lbfgs.py`'s
    SVGP and on a perturbed SAL(1) TGP, 30 iterations each: curves and
    leaves at rtol 1e-8, atol 1e-10.  The two part at the rounding level
    from the first iteration and the solver amplifies it: the SVGP's
    ELBO curve passes rtol 1e-8 at iteration 58 (1.7e-8), an entry of its
    q_L at iteration 40; no line-search decision differs in 60 iterations
    (one would part the curves by far more);
  * frozen leaves stay put; a stochastic model (ID_TGP, MC dropout) sees
    one objective at every evaluation of a phase, bit for bit, and its
    generator ends one evaluation's draws on; the evaluations, host reads
    and line-search trials add up;
  * the battery and `make_optimizer` refuse L-BFGS with the JAX message.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tgp.pytorch_tpu.data.batching import ArrayDataset as JDataset, \
    DataLoader as JLoader
from tgp.pytorch_tpu.flows import generators as jG, spec_from_list as j_spec
from tgp.pytorch_tpu.likelihoods import LikelihoodSpec as JLik
from tgp.pytorch_tpu.models import serialization as jser, tgp as JM
from tgp.pytorch_tpu.ops import kernels as jK
from tgp.pytorch_tpu.train import Trainer as JTrainer
from tgp.pytorch_tpu.train import optimizers as jopt

from tgp.pytorch_tpu_torch import config as pcfg, weights
from tgp.pytorch_tpu_torch.data import ArrayDataset, DataLoader
from tgp.pytorch_tpu_torch.flows import generators as G, spec_from_list
from tgp.pytorch_tpu_torch.likelihoods import LikelihoodSpec
from tgp.pytorch_tpu_torch.models import tgp as PM
from tgp.pytorch_tpu_torch.ops import kernels as K
from tgp.pytorch_tpu_torch.train import Trainer, lbfgs as LB, multiseed
from tgp.pytorch_tpu_torch.train import optimizers as popt

F64 = dict(rtol=1e-8, atol=1e-10)


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


# ---------------------------------------------------------------------------
# the optimizer against optax
# ---------------------------------------------------------------------------

A = np.array([[3.0, 0.5], [0.5, 1.0]])
B = np.array([1.0, -2.0])


def _quadratic(x):
    return 0.5 * x @ x.new_tensor(A) @ x - x.new_tensor(B) @ x


def _rosenbrock(x):
    return (100.0 * (x[1:] - x[:-1] ** 2) ** 2 + (1 - x[:-1]) ** 2).sum()


def _torch_vg(f):
    def vg(x):
        x = x.detach().requires_grad_(True)
        v = f(x)
        g, = torch.autograd.grad(v, x)
        return v.detach(), g
    return vg


def _port_run(f, x0, iters):
    opt, vg = popt.lbfgs_optimizer(), _torch_vg(f)
    x = torch.tensor(x0)
    state = opt.init(x)
    out = []
    for _ in range(iters):
        v, g = vg(x)
        u, state = opt.update(g, state, x, value=v, grad=g,
                              value_and_grad_fn=vg)
        x = x + u
        out.append((x.numpy().copy(), float(state.linesearch.learning_rate),
                    state.linesearch.info.num_linesearch_steps))
    return out


def _optax_run(f, x0, iters):
    opt = jopt.lbfgs_optimizer()

    @jax.jit
    def step(x, state):
        v, g = jax.value_and_grad(f)(x)
        u, state = opt.update(g, state, x, value=v, grad=g, value_fn=f)
        return optax.apply_updates(x, u), state

    x = jnp.asarray(x0)
    state = opt.init(x)
    out = []
    for _ in range(iters):
        x, state = step(x, state)
        out.append((np.asarray(x), float(state[-1].learning_rate),
                    int(state[-1].info.num_linesearch_steps)))
    return out


def test_lbfgs_solves_quadratic_in_few_iters():
    x = _port_run(_quadratic, np.zeros(2), 10)[-1][0]
    np.testing.assert_allclose(x, np.linalg.solve(A, B), atol=1e-8)


@pytest.mark.parametrize("f_torch, f_jax, x0, iters", [
    pytest.param(_quadratic, lambda x: 0.5 * x @ A @ x - B @ x,
                 np.zeros(2), 10, id="quadratic"),
    pytest.param(_rosenbrock, _rosenbrock, np.array([-1.2, 1.0]), 40,
                 id="rosenbrock"),
])
def test_lbfgs_matches_optax(f_torch, f_jax, x0, iters):
    port, ref = _port_run(f_torch, x0, iters), _optax_run(f_jax, x0, iters)
    for k, ((xp, lp, np_), (xr, lr, nr)) in enumerate(zip(port, ref)):
        np.testing.assert_allclose(xp, xr, err_msg=f"iteration {k}", **F64)
        np.testing.assert_allclose(lp, lr, rtol=1e-8, err_msg=f"iteration {k}")
        assert np_ == nr, k
    # Rosenbrock's valley makes the line search zoom and grow its steps
    assert len({n for _, _, n in ref}) > 1 or iters == 10


# ---------------------------------------------------------------------------
# the Trainer
# ---------------------------------------------------------------------------

def _svgp(N=48):
    """`tests/test_lbfgs.py::_svgp` in both packages."""
    rng = np.random.RandomState(0)
    X = rng.randn(N, 2)
    Y = np.sin(X[:, :1]) + 0.05 * rng.randn(N, 1)
    spec = JM.TGPSpec(Dy=1, Dx=2, M=8, N=float(N),
                      kernel=jK.from_name("scale_rbf"),
                      likelihood=JLik("gaussian", 1))
    params = jax.tree_util.tree_map(np.asarray,
                                    JM.init_tgp_params(spec, X, X[:8]))
    return spec, params, X, Y, (64, 64)


def _sal_tgp(N=60, M=6):
    """A SAL(1) TGP, Dx=3, 10 GH nodes, its init perturbed."""
    rs = np.random.RandomState(3)
    X, Y = rs.randn(N, 3), rs.randn(N, 1)
    np.random.seed(0)
    fspec, finits = j_spec(jG.SAL(1))
    spec = JM.TGPSpec(Dy=1, Dx=3, M=M, N=float(N),
                      kernel=jK.from_name("scale_rbf"),
                      likelihood=JLik("gaussian_flow", 1, quad_points=10),
                      flow=fspec)
    pj = jax.tree_util.tree_map(np.asarray, JM.init_tgp_params(
        spec, X, X[:M].copy(), flow_inits=finits))
    pp = weights.perturb_params(weights.params_from_jax(pj, device="cpu"), 1)
    return spec, weights.params_to_numpy(pp), X, Y, (100, 100)


def _trainers(case):
    spec_j, pn, X, Y, (b_tr, b_te) = case()
    spec_p = weights.spec_from_dict(jser.spec_to_dict(spec_j))
    mk = lambda L, D: [L(D(X, Y), b_tr, seed=0),          # noqa: E731
                       L(D(X, Y), b_te, shuffle=False)]
    tr_p = Trainer(spec_p, weights.params_from_jax(pn, device="cpu"),
                   mk(DataLoader, ArrayDataset), np.ones(1), S_test=5,
                   device="cpu")
    tr_j = JTrainer(spec_j, jax.tree_util.tree_map(jnp.asarray, pn),
                    mk(JLoader, JDataset), np.ones(1), S_test=5)
    return tr_p, tr_j


@pytest.mark.parametrize("case, iters", [
    pytest.param(_svgp, 30, id="svgp"),
    pytest.param(_sal_tgp, 30, id="sal_tgp")])
def test_lbfgs_trainer_matches_jax(case, iters):
    tr_p, tr_j = _trainers(case)
    tr_p.train(iters, 0.0, "lbfgs", verbose_each=0)
    tr_j.train(iters, 0.0, "lbfgs", verbose_each=0)
    for attr in ("loss_curve", "ell_curve", "kld_curve"):
        np.testing.assert_allclose(np.asarray(getattr(tr_p, attr)),
                                   [float(v) for v in getattr(tr_j, attr)],
                                   err_msg=attr, **F64)
    jl = jax.tree_util.tree_leaves_with_path(tr_j.params)
    pl = weights.tree_leaves(tr_p.params)
    assert len(jl) == len(pl)
    for (path, a), b in zip(jl, pl):
        np.testing.assert_allclose(b.detach().numpy(), np.asarray(a),
                                   err_msg=jax.tree_util.keystr(path), **F64)
    # the last iteration's accepted stepsize and trials, and the carried kind
    st_p, st_j = tr_p._opt_state_carry.linesearch, tr_j._opt_state_carry[-1]
    np.testing.assert_allclose(st_p.learning_rate, float(st_j.learning_rate),
                               rtol=1e-8)
    assert st_p.info.num_linesearch_steps == int(st_j.info.num_linesearch_steps)
    assert tr_p._opt_state_kind == tr_j._opt_state_kind == "lbfgs"


def _port_svgp_trainer(batch=64, **kw):
    spec_j, pn, X, Y, _ = _svgp()
    spec = weights.spec_from_dict(jser.spec_to_dict(spec_j))
    return Trainer(spec, weights.params_from_jax(pn, device="cpu"),
                   [DataLoader(ArrayDataset(X, Y), batch, seed=0),
                    DataLoader(ArrayDataset(X, Y), 64, shuffle=False)],
                   np.ones(1), S_test=5, device="cpu", **kw)


def test_lbfgs_trains_svgp_beyond_adam_at_equal_steps():
    tr_l = _port_svgp_trainer()
    tr_l.train(60, 0.0, "lbfgs", verbose_each=0)
    tr_a = _port_svgp_trainer()
    tr_a.train(60, 0.01, "adam", verbose_each=0)
    assert np.isfinite(tr_l.loss_curve[-1])
    assert tr_l.loss_curve[-1] > tr_a.loss_curve[-1]
    assert np.isfinite(tr_l.compute_metrics()["test"]["logL"]).all()


def test_lbfgs_rejects_schedules_and_minibatch():
    with pytest.raises(NotImplementedError, match="schedule"):
        _port_svgp_trainer().train(
            10, 0.0, "lbfgs", verbose_each=0,
            optimisation_schedule=([1.0], [[[0.01, "kernel"]]]))
    with pytest.raises(NotImplementedError, match="full-batch"):
        _port_svgp_trainer(batch=16).train(10, 0.0, "lbfgs", verbose_each=0)


def _id_tgp_trainer(N=40, M=4):
    """A port-only ID_TGP: SAL(1) with MC-dropout hypernets 2 -> 5 -> 1 (p
    0.3), whose anchors (a, b, c, d) are frozen leaves."""
    rs = np.random.RandomState(5)
    X, Y = rs.randn(N, 2), rs.randn(N, 1)
    np.random.seed(0)
    fspec, finits = spec_from_list(G.SAL(1, input_dependent=True, input_dim=2,
                                         hidden_dim=5, dropout=0.3))
    spec = PM.TGPSpec(Dy=1, Dx=2, M=M, N=float(N),
                      kernel=K.from_name("scale_rbf"),
                      likelihood=LikelihoodSpec("gaussian_flow", 1,
                                                quad_points=8), flow=fspec)
    params = PM.init_tgp_params(spec, X, X[:M], flow_inits=finits,
                                device="cpu")
    return Trainer(spec, params, [DataLoader(ArrayDataset(X, Y), 64, seed=0)],
                   np.ones(1), S_test=4, seed=11, device="cpu")


def test_lbfgs_phase_is_one_objective_and_its_counts_add_up(monkeypatch):
    """ID_TGP draws dropout masks at every evaluation: restarted from the
    phase's state, every evaluation at the same point gives the same value
    and gradient bit for bit, and the stream ends one evaluation's draws on.
    Evaluations = iterations + trials; host reads the same; frozen leaves
    stay put."""
    from tgp.pytorch_tpu_torch.train import trainer as trainer_mod

    tr = _id_tgp_trainer()
    frozen = weights.tree_leaves(trainer_mod.frozen_param_labels(tr.spec,
                                                                 tr.params))
    assert any(frozen)
    before = [p.detach().clone() for p in weights.tree_leaves(tr.params)]
    gen0 = tr._gen.get_state()

    trials, checks, evals = [], [], [0]
    real_update, real_elbo = LB.LBFGS.update, trainer_mod.tgp_mod.elbo

    def update(self, updates, state, params, *, value, grad,
               value_and_grad_fn):
        if not checks:      # the objective at the start point, twice
            checks.append([value_and_grad_fn(params) for _ in range(2)]
                          + [(value, grad)])
        n0 = evals[0]
        out = real_update(self, updates, state, params, value=value,
                          grad=grad, value_and_grad_fn=value_and_grad_fn)
        trials.append(out[1].linesearch.info.num_linesearch_steps)
        assert evals[0] - n0 == trials[-1]
        return out

    def elbo(*args, **kw):
        evals[0] += 1
        return real_elbo(*args, **kw)

    monkeypatch.setattr(LB.LBFGS, "update", update)
    monkeypatch.setattr(trainer_mod.tgp_mod, "elbo", elbo)
    LB.HOST_READS = 0
    tr.train(6, 0.0, "lbfgs", verbose_each=0)

    (v1, g1), (v2, g2), (v0, g0) = checks[0]
    assert torch.equal(v1, v2) and torch.equal(v1, v0)
    assert torch.equal(g1, g2)
    # the start's gradient is the masked one; the two trials' are not
    keep = torch.cat([torch.full((p.numel(),), not f) for p, f in
                      zip(weights.tree_leaves(tr.params), frozen)])
    assert torch.equal(g1[keep], g0[keep])
    n_iter = len(tr.loss_curve)
    assert n_iter == len(trials) == 6 and min(trials) >= 1
    assert evals[0] == n_iter + sum(trials) + 2     # + the two checks
    assert LB.HOST_READS == n_iter + sum(trials)
    for f, a, b in zip(frozen, before, weights.tree_leaves(tr.params)):
        assert torch.equal(a, b.detach()) == f
    # one evaluation's draws on from the phase's start
    ref = _id_tgp_trainer()
    ref._gen.set_state(gen0)
    X, Y = next(iter(ref.train_loader))
    real_elbo(ref.spec, ref.params, ref._put(X), ref._put(Y), ref._gen)
    assert torch.equal(tr._gen.get_state(), ref._gen.get_state())


def test_battery_and_make_optimizer_refuse_lbfgs_with_the_jax_message():
    with pytest.raises(NotImplementedError) as jax_err:
        jopt.make_optimizer("lbfgs", 0.01)
    with pytest.raises(NotImplementedError) as port_err:
        popt.make_optimizer("lbfgs", 0.01)
    assert str(port_err.value) == str(jax_err.value)
    tr = _port_svgp_trainer()
    stack = multiseed.stack_trees([tr.params, tr.params])
    with pytest.raises(NotImplementedError, match="lbfgs is a full solver"):
        multiseed._optimizer(tr.spec, stack, "lbfgs", 0.01, None)
    assert "item 19" not in popt.LBFGS_REFUSAL


def test_lbfgs_in_fp32_keeps_its_scalars_in_fp32():
    """Under the fp32 config the line search's scalars are float32, as
    optax's are where x64 is off."""
    pcfg.set_precision("fp32")
    x0 = np.array([-1.2, 1.0], np.float32)
    opt, vg = popt.lbfgs_optimizer(), _torch_vg(_rosenbrock)
    x = torch.tensor(x0)
    state = opt.init(x)
    for _ in range(5):
        v, g = vg(x)
        u, state = opt.update(g, state, x, value=v, grad=g,
                              value_and_grad_fn=vg)
        x = x + u
    assert x.dtype == torch.float32
    assert isinstance(state.linesearch.learning_rate, np.float32)
    assert isinstance(state.linesearch.value, np.float32)
