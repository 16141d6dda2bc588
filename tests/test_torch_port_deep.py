"""The port's deep TGP (`models/deep.py`, `models/utils.py::
propagate_inducing`, the deep specs' serialization, the Trainer and the
CLI's `--model DGP`) against the JAX package, on the CPU in fp64.

JAX draws the inner layers' normals from threefry keys, which torch cannot
reproduce, so the draws are replayed:
  * eager JAX calls (`Normals`): every normal the JAX deep model or
    `sample_prior` takes comes from one numpy stream, and the port's
    `flows.hypernet._draw` hands out the same values in the same order;
  * the JAX CLI's jitted programs (`SharedDrawReplay`, over
    `test_torch_port_hypernet.JaxOrderReplay`): the JAX Trainer evaluates
    the log-likelihood, the moments and the samples of a batch on three
    propagations from three keys, where the port shares one propagation.
    The JAX evaluation is run here with one key for all three (common
    random numbers), so its three propagations draw the same normals, and
    the port takes each distinct draw once.
Values and gradients at rtol 1e-8, atol 1e-10 (the same float64 math on
both sides).
"""

import dataclasses
import functools
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tgp.pytorch_tpu.flows.hypernet as jhyper
import tgp.pytorch_tpu.models as jmodels
import tgp.pytorch_tpu.train as jtrain
from tgp.pytorch_tpu import config as jcfg
from tgp.pytorch_tpu.flows import generators as jG, spec_from_list as j_spec
from tgp.pytorch_tpu.likelihoods import LikelihoodSpec as JLik
from tgp.pytorch_tpu.models import deep as jdeep, serialization as jser
from tgp.pytorch_tpu.models import tgp as JM, utils as jutils
from tgp.pytorch_tpu.ops import kernels as jK

from tgp.pytorch_tpu_torch import config as pcfg, weights
from tgp.pytorch_tpu_torch.experiments import exp_config as PEC, main as pmain
from tgp.pytorch_tpu_torch.flows import hypernet as phyper
from tgp.pytorch_tpu_torch.models import deep as pdeep, serialization as pser
from tgp.pytorch_tpu_torch.models import tgp as PM, utils as putils

from test_torch_port_hypernet import JaxOrderReplay
from test_torch_port_large import jax_native_parser

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "experiments"))
import exp_config as JEC          # noqa: E402
import main as jmain              # noqa: E402

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


def close_trees(port, ref, **tol):
    jl = jax.tree_util.tree_leaves_with_path(ref)
    pl = weights.tree_leaves(port)
    assert len(jl) == len(pl) > 0
    for (path, a), b in zip(jl, pl):
        close(b, a, err_msg=jax.tree_util.keystr(path), **tol)


def to_port(tree):
    return weights.params_from_jax(jax.tree_util.tree_map(np.asarray, tree),
                                   device="cpu", dtype=torch.float64)


def to_jax(tree):
    return weights.tree_map(lambda t: jnp.asarray(t.detach().numpy()), tree)


class Normals:
    """Standard normals from one numpy stream for the JAX package's eager
    draws (`jax.random.normal` of the modules patched), handed to the
    port's `_draw` in the order they were taken."""

    def __init__(self, seed=0):
        self.rs, self.queue = np.random.RandomState(seed), []

    def patch(self, monkeypatch, *modules):
        replay = self

        def normal(key, shape, dtype=jnp.float64):
            vals = replay.rs.standard_normal(tuple(shape))
            replay.queue.append(vals)
            return jnp.asarray(vals, dtype)

        class Random:
            def __getattr__(self, name):
                return normal if name == "normal" else getattr(jax.random, name)

        class Jax:
            random = Random()

            def __getattr__(self, name):
                return getattr(jax, name)

        for mod in modules:
            monkeypatch.setattr(mod, "jax", Jax())
        monkeypatch.setattr(phyper, "_draw", self.draw)
        return self

    def draw(self, kind, shape, p, generator, dtype, device):
        assert kind == "normal"
        vals = self.queue.pop(0)
        assert vals.shape == tuple(shape)
        return torch.as_tensor(vals, dtype=dtype, device=device)


# ---------------------------------------------------------------------------
# seeded deep models
# ---------------------------------------------------------------------------

def _deep(kind):
    """(spec_j, spec_p, params_j, params_p, X, Y) on 12 seeded rows, Dx=3.

    'dgp2': one inner layer 3 -> 3, a Gaussian output layer, S 2/3;
    'dgp3_flow': inner layers 3 -> 2 (the SVD projection) and 2 -> 2
    unwhitened, a SAL(1) output flow with 10 GH nodes, S 2/4.
    The JAX init, moved by `weights.perturb_params` layer by layer."""
    rs = np.random.RandomState(5)
    N, M = 12, 4
    X, Y = rs.randn(N, 3), rs.randn(N, 1)
    k = jK.from_name("scale_rbf")
    if kind == "dgp2":
        layers = (jdeep.layer_spec(3, 3, M, float(N), k),
                  JM.TGPSpec(Dy=1, Dx=3, M=M, N=float(N), kernel=k,
                             likelihood=JLik("gaussian", 1)))
        S, inits = (2, 3), None
    else:
        np.random.seed(0)
        fspec, inits = j_spec(jG.SAL(1))
        layers = (jdeep.layer_spec(3, 2, M, float(N), k),
                  jdeep.layer_spec(2, 2, M, float(N), k, whiten=False),
                  JM.TGPSpec(Dy=1, Dx=2, M=M, N=float(N), kernel=k, flow=fspec,
                             likelihood=JLik("gaussian_flow", 1, quad_points=10)))
        S = (2, 4)
    spec_j = jdeep.DeepTGPSpec(layers=layers, S_train=S[0], S_test=S[1])
    spec_p = weights.spec_from_dict(jser.spec_to_dict(spec_j))
    pj = jdeep.init_deep_params(spec_j, X, X[:M], flow_inits=inits,
                                kernel_init={"length_scale": 2.0,
                                             "kernel_scale": 2.0})
    pp = to_port(pj)
    pp = {"layers": [weights.perturb_params(p, seed=i)
                     for i, p in enumerate(pp["layers"])]}
    return spec_j, spec_p, to_jax(pp), pp, X, Y


# ---------------------------------------------------------------------------
# propagate_inducing, init_deep_params, the spec's JSON
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("how", ["salimbeni", "sampling", "salimbeni+sampling"])
@pytest.mark.parametrize("dims", [(3, 5), (3, 2), (3, 3)])
def test_propagate_inducing_matches_jax(monkeypatch, how, dims):
    """The three modes at Dy above, below and equal to Dx, the layer's W
    given (as `init_deep_params` gives it) and not."""
    Dx, Dy = dims
    rs = np.random.RandomState(1)
    X, Z = rs.randn(20, Dx), rs.randn(6, Dx)
    spec_j = jdeep.layer_spec(Dx, Dy, 6, 20.0, jK.from_name("scale_rbf"))
    spec_p = weights.spec_from_dict(jser.spec_to_dict(spec_j))
    pj = JM.init_tgp_params(spec_j, X, Z,
                            kernel_init={"length_scale": 1.5,
                                         "kernel_scale": 2.0})
    pp = to_port(pj)
    normals = Normals(3).patch(monkeypatch, jutils)
    for W in (None, jmodels.projection_matrix(Dx, Dy, X)):
        want = jutils.propagate_inducing(spec_j, pj, Z, Dy,
                                         rng=jax.random.PRNGKey(0), how=how,
                                         W=W)
        got = putils.propagate_inducing(spec_p, pp, Z, Dy,
                                        rng=torch.Generator(), how=how, W=W)
        assert got.shape == (6, Dy)
        close(got, want)
    assert normals.queue == []


@pytest.mark.parametrize("kind", ["dgp2", "dgp3_flow"])
def test_init_deep_params_matches_jax(kind):
    spec_j, spec_p, _, _, X, _ = _deep(kind)
    np.random.seed(0)
    inits = None if kind == "dgp2" else j_spec(jG.SAL(1))[1]
    kw = dict(kernel_init={"length_scale": 2.0, "kernel_scale": 2.0},
              variance_scale=1e-5, noise_init=0.05)
    pj = jdeep.init_deep_params(spec_j, X, X[:4], flow_inits=inits, **kw)
    pp = pdeep.init_deep_params(spec_p, X, X[:4], flow_inits=inits,
                                device="cpu", **kw)
    close_trees(pp, pj)
    assert len(pp["layers"]) == len(spec_p.layers)


@pytest.mark.parametrize("kind", ["dgp2", "dgp3_flow"])
def test_deep_spec_json_round_trip(kind):
    spec_j, spec_p = _deep(kind)[:2]
    assert isinstance(spec_p, pdeep.DeepTGPSpec)
    assert pser.spec_to_dict(spec_p) == jser.spec_to_dict(spec_j)
    assert pser.spec_from_json(pser.spec_to_json(spec_p)) == spec_p
    assert pser.spec_from_json(jser.spec_to_json(spec_j)) == spec_p
    assert jser.spec_from_json(pser.spec_to_json(spec_p)) == spec_j


def test_layer_width_mismatch_raises():
    last = _deep("dgp2")[1].layers[-1]                     # Dx=3
    with pytest.raises(ValueError, match="width mismatch"):
        pdeep.DeepTGPSpec(layers=(pdeep.layer_spec(3, 2, 4, 10.0, last.kernel),
                                  last))
    with pytest.raises(NotImplementedError, match="output layers"):
        pdeep.DeepTGPSpec(layers=(dataclasses.replace(
            last, likelihood=dataclasses.replace(last.likelihood,
                                                 kind="bernoulli")),))


# ---------------------------------------------------------------------------
# the model's functions on replayed draws
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["dgp2", "dgp3_flow"])
def test_elbo_value_and_gradient(monkeypatch, kind):
    spec_j, spec_p, pj, pp, X, Y = _deep(kind)
    normals = Normals(0).patch(monkeypatch, jdeep)
    (e, (ell, kld)), g = jax.value_and_grad(
        lambda p: (lambda r: (r[0], r[1:]))(
            jdeep.elbo(spec_j, p, jnp.asarray(X), jnp.asarray(Y),
                       jax.random.PRNGKey(0))), has_aux=True)(pj)
    assert len(normals.queue) == len(spec_j.layers) - 1
    leaves = [t.clone().requires_grad_(True) for t in weights.tree_leaves(pp)]
    pp = weights.tree_unflatten(pp, leaves)
    e_p, ell_p, kld_p = PM.elbo(spec_p, pp, torch.tensor(X), torch.tensor(Y),
                                torch.Generator())
    assert normals.queue == []
    close(e_p, e)
    close(ell_p, ell)
    close(kld_p, kld)
    grads = torch.autograd.grad(e_p, leaves, allow_unused=True,
                                materialize_grads=True)
    close_trees(weights.tree_unflatten(pp, grads), g)


@pytest.mark.parametrize("kind", ["dgp2", "dgp3_flow"])
@pytest.mark.parametrize("reduce", [True, False])
def test_test_log_likelihood(monkeypatch, kind, reduce):
    spec_j, spec_p, pj, pp, X, Y = _deep(kind)
    Normals(1).patch(monkeypatch, jdeep)
    Y_std = np.array([1.7])
    want = jdeep.test_log_likelihood(spec_j, pj, jnp.asarray(X), jnp.asarray(Y),
                                     jnp.asarray(Y_std), rng=jax.random.PRNGKey(0),
                                     reduce=reduce)
    got = PM.test_log_likelihood(spec_p, pp, torch.tensor(X), torch.tensor(Y),
                                 torch.tensor(Y_std), rng=torch.Generator(),
                                 reduce=reduce)
    assert got.shape == want.shape == ((1,) if reduce else (1, 12))
    close(got, want)


@pytest.mark.parametrize("kind", ["dgp2", "dgp3_flow"])
def test_predictive_moments_and_samples(monkeypatch, kind):
    """predictive_distribution (S_test paths), sample_marginal and
    sample_predictive (S=5 paths), each on its own replayed draws; then the
    three sharing one propagation (`prop`), as the Trainer and the
    Predictor run them, equal the three on their own."""
    spec_j, spec_p, pj, pp, X, Y = _deep(kind)
    normals = Normals(2).patch(monkeypatch, jdeep)
    Xj, Xt, key, gen = jnp.asarray(X), torch.tensor(X), jax.random.PRNGKey(0), \
        torch.Generator()
    with torch.no_grad():
        want = jdeep.predictive_distribution(spec_j, pj, Xj, rng=key)
        got = PM.predictive_distribution(spec_p, pp, Xt, rng=gen)
        for a, b in zip(got, want):
            close(a, b)
        want = jdeep.sample_marginal(spec_j, pj, Xj, 5, key)
        got = PM.sample_marginal(spec_p, pp, Xt, 5, gen)
        for a, b in zip(got, want):
            close(a, b)
        assert got[0].shape == (5, 1, 12)
        want = jdeep.sample_predictive(spec_j, pj, Xj, 5, key)
        got = PM.sample_predictive(spec_p, pp, Xt, 5, gen)
        for a, b in zip(got, want):
            close(a, b)
        assert got[0].shape == (1, 5, 12)
        assert normals.queue == []

        # one propagation shared: seeded generators, no replay
        monkeypatch.undo()
        S = spec_p.S_test
        g1, g2 = torch.Generator().manual_seed(4), torch.Generator().manual_seed(4)
        prop = pdeep.propagate(spec_p, pp, Xt, g1, S)
        shared = (pdeep.test_log_likelihood(spec_p, pp, Xt, torch.tensor(Y),
                                            torch.ones(1), prop=prop),
                  pdeep.predictive_distribution(spec_p, pp, Xt, prop=prop)[0],
                  pdeep.sample_predictive(spec_p, pp, Xt, S, g1, prop=prop)[0])
        alone_prop = pdeep.propagate(spec_p, pp, Xt, g2, S)
        alone = (pdeep.test_log_likelihood(spec_p, pp, Xt, torch.tensor(Y),
                                           torch.ones(1), prop=alone_prop),
                 pdeep.predictive_distribution(spec_p, pp, Xt,
                                               prop=alone_prop)[0],
                 pdeep.sample_predictive(spec_p, pp, Xt, S, g2,
                                         prop=alone_prop)[0])
        for a, b in zip(shared, alone):
            assert torch.equal(a, b)
        # a propagation along more paths serves fewer from its first ones
        big = pdeep.propagate(spec_p, pp, Xt, torch.Generator(), 2 * S)
        F, mu, var, _ = pdeep._paths(big, S, 12)
        assert torch.equal(mu, big[1][:, :S * 12]) and F.shape[0] == S * 12
        with pytest.raises(ValueError, match="paths"):
            pdeep._paths(prop, S + 1, 12)


def test_single_layer_deep_equals_shallow_tgp():
    """No inner layers, no draws: the deep ELBO, log-likelihood and moments
    are the shallow model's (`tests/test_deep.py:27`)."""
    spec_j, _, _, pp, X, Y = _deep("dgp3_flow")
    sh = weights.spec_from_dict(jser.spec_to_dict(dataclasses.replace(
        spec_j.layers[-1], Dx=3)))
    p = weights.perturb_params(PM.init_tgp_params(
        sh, X, X[:4], device="cpu"), 3)
    one = pdeep.DeepTGPSpec(layers=(sh,), S_train=1, S_test=1)
    Xt, Yt, deep_p = torch.tensor(X), torch.tensor(Y), {"layers": [p]}
    for a, b in zip(PM.elbo(one, deep_p, Xt, Yt), PM.elbo(sh, p, Xt, Yt)):
        close(a, b)
    close(PM.test_log_likelihood(one, deep_p, Xt, Yt, torch.ones(1)),
          PM.test_log_likelihood(sh, p, Xt, Yt, torch.ones(1)))
    for a, b in zip(PM.predictive_distribution(one, deep_p, Xt),
                    PM.predictive_distribution(sh, p, Xt)):
        close(a, b)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

ARGV = ["--model", "DGP", "--dataset", "boston", "--train_test_seed_split",
        "1", "--num_inducing", "5", "--epochs", "20", "--platform", "cpu",
        "--verbose_each", "0", "--S_test", "10"]


class SharedDrawReplay(JaxOrderReplay):
    """`JaxOrderReplay` whose port side takes each distinct draw once: the
    JAX evaluation's three propagations, from one key, draw equal values,
    which the port's one propagation takes once."""

    def __init__(self):
        super().__init__()
        self.taken = set()

    def port_draw(self, kind, shape, p, generator, dtype, device):
        while hash(self.queue[0][2].tobytes()) in self.taken:
            self.queue.pop(0)
        self.taken.add(hash(self.queue[0][2].tobytes()))
        return super().port_draw(kind, shape, p, generator, dtype, device)


def _common_key_eval(monkeypatch):
    """The JAX Trainer's evaluation batch (`train/trainer.py::_eval_batch`)
    with its log-likelihood, moments and samples given one key."""
    mod = sys.modules["tgp.pytorch_tpu.train.trainer"]

    @functools.partial(jax.jit, static_argnums=(0, 4, 5, 6))
    def eval_batch(spec, params, X, Y, S_MC, fully_bayesian, S_test, Y_std,
                   rng):
        fb = dict(S_MC=S_MC, fully_bayesian=fully_bayesian, rng=rng)
        log_p = JM.test_log_likelihood(spec, params, X, Y, Y_std, **fb)
        m1 = JM.predictive_distribution(spec, params, X, **fb)[0]
        samples = JM.sample_predictive(spec, params, X, S_test, rng,
                                       fully_bayesian=fully_bayesian)[0]
        return log_p, m1, samples

    monkeypatch.setattr(mod, "_eval_batch", eval_batch)


@pytest.mark.parametrize("flags, arch_of", [
    pytest.param(["--layers", "2"], None, id="DGP-2"),
    pytest.param(["--layers", "3"], None, id="DGP-3"),
    pytest.param(["--layers", "2", "--dgp_flow"], "kin8nm", id="DGP-2+flow"),
])
def test_dgp_cli_matches_the_jax_cli(monkeypatch, capsys, flags, arch_of):
    """The result line, the initial and trained parameters, the curves and
    the metrics.  `--dgp_flow` runs boston with kin8nm's table arch
    (InverseBoxCoxL(1)); boston's own, StepTanhL, is refused."""
    argv = ARGV + flags
    if arch_of:
        for table in (JEC.TGP_REGRESSION_SWEEP, PEC.TGP_REGRESSION_SWEEP):
            monkeypatch.setitem(table, "boston", table[arch_of])
    replay = SharedDrawReplay().patch(monkeypatch)
    monkeypatch.setattr(jdeep, "jax", jhyper.jax)
    _common_key_eval(monkeypatch)
    seen = {}

    class Caught(jtrain.Trainer):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            seen["trainer"] = self

    init = jmodels.init_deep_params

    def jax_init(*a, **k):
        seen["init"] = jax.tree_util.tree_map(np.array, init(*a, **k))
        return seen["init"]

    monkeypatch.setattr(jtrain, "Trainer", Caught)
    monkeypatch.setattr(jmodels, "init_deep_params", jax_init)
    jax_native_parser()
    mj = jmain.run(jmain.parse_args(argv))
    jline = capsys.readouterr().out.splitlines()[-1].rsplit(" (", 1)[0]
    replay.seal()

    pinit = pdeep.init_deep_params
    monkeypatch.setattr(pdeep, "init_deep_params", lambda *a, **k: seen.update(
        pinit=pinit(*a, **k)) or seen["pinit"])
    torch.set_num_threads(1)
    res = pmain.run(pmain.parse_args(argv))
    pline = capsys.readouterr().out.splitlines()[-1].rsplit(" (", 1)[0]
    tag = "DGP-" + flags[1] + ("+flow" if arch_of else "")
    assert pline == jline and f", {tag}, " in pline
    assert replay.queue == []

    close_trees(seen["pinit"], seen["init"])
    jt, pt = seen["trainer"], res.trainer
    assert len(pt.spec.layers) == int(flags[1])
    assert pt.spec.has_flow == bool(arch_of)
    for attr in ("loss_curve", "ell_curve", "kld_curve"):
        got = np.asarray(getattr(pt, attr), np.float64)
        want = np.asarray([float(v) for v in getattr(jt, attr)])
        assert got.shape == want.shape == (20,)
        close(got, want)
    close_trees(pt.params, jt.params)
    for split in ("train", "test"):
        for k in ("logL", "rmse", "coverage"):
            close(res.metrics[split][k], mj[split][k])
    assert res.kernel_calls == {"train": (0, 0), "eval": (0, 0)}


@pytest.mark.parametrize("flags", [
    ["--natgrad", "1.0"], ["--fast_solves"], ["--solve_precision", "high"],
    ["--mesh", "4x2"], ["--plateau_guard"], ["--dgp_flow"]])
def test_dgp_cli_refuses_what_the_jax_cli_refuses(flags):
    """The JAX CLI's own DGP refusals, with its messages (boston's table
    arch, StepTanhL, under --dgp_flow)."""
    argv = ARGV + flags
    with pytest.raises(SystemExit) as want:
        jmain.run(jmain.parse_args(argv))
    with pytest.raises(SystemExit) as got:
        pmain.run(pmain.parse_args(argv))
    assert str(got.value) == str(want.value) and str(got.value)
