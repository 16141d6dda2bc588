"""The port's warped and classification likelihoods, the model's branches
that use them, `models/utils.py` and the calibration metrics against the
JAX package, on the CPU in fp64.

Values and gradients at rtol 1e-8, atol 1e-10 (the same float64 math on
both sides).  The warped likelihood's gradient goes through dT/dy, itself
a gradient (second-order autograd in the port, `jax.jvp` under `jax.grad`
in JAX).  The JAX functions run jitted; the categorical likelihood's MC normals and
the hypernets' dropout masks are the JAX package's, replayed in program
order through `flows.hypernet._draw` (`test_torch_port_hypernet.
JaxOrderReplay`, here also over the JAX classification module's draws).  Samples, which neither package can
replay (the port draws them with torch, JAX with threefry), are checked at
the distribution level against the JAX package's moments and
probabilities, within 5 Monte Carlo standard errors.
"""

import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tgp.pytorch_tpu.flows import generators as jG, spec_from_list as j_spec
from tgp.pytorch_tpu.likelihoods import LikelihoodSpec as JLik
from tgp.pytorch_tpu.likelihoods import classification as jcls, warped as jwarp
from tgp.pytorch_tpu.models import serialization as jser, tgp as JM
from tgp.pytorch_tpu.models import utils as jutils
from tgp.pytorch_tpu.ops import kernels as jK
from tgp.pytorch_tpu.train import metrics as jmetrics

from tgp.pytorch_tpu_torch import weights
from tgp.pytorch_tpu_torch.flows.core import spec_from_list as p_spec
from tgp.pytorch_tpu_torch.likelihoods import LikelihoodSpec as PLik
from tgp.pytorch_tpu_torch.likelihoods import classification as pcls
from tgp.pytorch_tpu_torch.likelihoods import warped as pwarp
from tgp.pytorch_tpu_torch.models import tgp as PM, utils as putils
from tgp.pytorch_tpu_torch.train import metrics as pmetrics

from test_torch_port_hypernet import (JaxOrderReplay, _port_state,  # noqa: F401
                                      close, to_jax, to_port)

F64 = dict(rtol=1e-8, atol=1e-10)
T = torch.as_tensor


def replay(monkeypatch):
    """`JaxOrderReplay` over the JAX hypernets' and classification
    likelihoods' draws; `seal()` it after the JAX call."""
    rep = JaxOrderReplay().patch(monkeypatch)
    monkeypatch.setattr(jcls, "jax",
                        sys.modules["tgp.pytorch_tpu.flows.hypernet"].jax)
    return rep


# ---------------------------------------------------------------------------
# the likelihood functions
# ---------------------------------------------------------------------------

def warp_flow(arch):
    """(JAX spec, port spec, numpy params) of a warp, moved from its init
    by seeded noise (a log_exp term's a, b and c, a tanh step's four)."""
    np.random.seed(0)
    if arch == "SAL":
        fl = jG.SAL(1)
    elif arch == "log_exp":
        fl = [("log_exp", {"add_init_f0": True, "init_a": [-1.0, -0.7, -1.3],
                           "init_b": [0.5, 0.3, 0.7],
                           "init_c": [-1.0, 0.0, 1.0]})]
    else:
        fl = jG.StepTanhL(1, 3, add_f0=True)
    np.random.seed(0)
    js, ji = j_spec(fl)
    np.random.seed(0)
    ps, _ = p_spec(fl)
    assert [dataclasses.astuple(s) for s in ps] == \
        [dataclasses.astuple(s) for s in js]
    from tgp.pytorch_tpu.flows.core import init_flow_params
    fp = init_flow_params(js, ji, jax.random.PRNGKey(0), jnp.float64)
    rs = np.random.RandomState(1)
    fp = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.2 * rs.randn(*np.shape(a)), fp)
    return js, ps, fp


def lik_inputs(Dy, MB=9, seed=2):
    rs = np.random.RandomState(seed)
    return (rs.randn(Dy, MB), rs.randn(Dy, MB), rs.uniform(0.1, 1.0, (Dy, MB)),
            np.log(0.1) + 0.2 * rs.randn(Dy, 1))


def grads_j(fn, tree):
    v, g = jax.jit(jax.value_and_grad(fn))(
        jax.tree_util.tree_map(jnp.asarray, tree))
    return v, jax.tree_util.tree_leaves(g)


def grads_p(fn, tree):
    leaves = weights.tree_leaves(tree)
    for t in leaves:
        t.requires_grad_(True)
    v = fn(tree)
    return v, torch.autograd.grad(v, leaves, allow_unused=True,
                                  materialize_grads=True)


@pytest.mark.parametrize("arch", ["SAL", "log_exp", "StepTanhL"])
def test_warped_ell_value_and_gradient(arch):
    """Dy=2: the per-output log-Jacobian and the gradient through dT/dy
    into the warp, the noise, mu and var."""
    js, ps, fp = warp_flow(arch)
    Y, mu, var, lv = lik_inputs(2)
    lj, lp = JLik("warped", 2, warp_flow=js), PLik("warped", 2, warp_flow=ps)
    tree = {"lik": {"log_var_noise": lv, "warp": fp}, "mu": mu, "var": var}

    def fj(t):
        return jnp.sum(jnp.arange(1.0, 3.0) * jwarp.warped_ell(
            lj, t["lik"], jnp.asarray(Y), t["mu"], t["var"], js, t["lik"]["warp"]))

    def fpp(t):
        return torch.sum(torch.arange(1.0, 3.0, dtype=torch.float64) * pwarp.warped_ell(
            lp, t["lik"], T(Y), t["mu"], t["var"], ps, t["lik"]["warp"]))

    vj, gj = grads_j(fj, tree)
    vp, gp = grads_p(fpp, weights.params_from_jax(tree, "cpu", torch.float64))
    close(vp, vj)
    assert len(gj) == len(gp) > 4
    for a, b in zip(gj, gp):
        close(b, a)
    # under no_grad (the Trainer's evaluation) the value is the same
    with torch.no_grad():
        pt = weights.params_from_jax(tree, "cpu", torch.float64)
        close(fpp(pt), vj)


@pytest.mark.parametrize("arch", ["SAL", "log_exp", "StepTanhL"])
def test_warped_moments_and_log_marginal(arch):
    """Moments by quadrature of T^{-1} (Newton's for log_exp and
    StepTanhL), the unwarped moments, and the exact log marginal with a
    random SPD K, in value and in gradient."""
    js, ps, fp = warp_flow(arch)
    Y, mu, var, lv = lik_inputs(2, MB=6)
    lj = JLik("warped", 2, quad_points=20, warp_flow=js)
    lp = PLik("warped", 2, quad_points=20, warp_flow=ps)
    pj = {"log_var_noise": jnp.asarray(lv), "warp": to_jax_tree(fp)}
    pp = weights.params_from_jax({"log_var_noise": lv, "warp": fp}, "cpu",
                                 torch.float64)
    mj = jwarp.warped_moments(lj, pj, jnp.asarray(mu), jnp.asarray(var), js,
                              pj["warp"])
    with torch.no_grad():
        mp = pwarp.warped_moments(lp, pp, T(mu), T(var), ps, pp["warp"])
    for a, b in zip(mj, mp):
        assert np.isfinite(np.asarray(a)).all()
        close(b, a)
    for a, b in zip(jwarp.warped_unwarped_moments(lj, pj, jnp.asarray(mu),
                                                  jnp.asarray(var)),
                    pwarp.warped_unwarped_moments(lp, pp, T(mu), T(var))):
        close(b, a)
    rs = np.random.RandomState(5)
    A = rs.randn(2, 6, 6)
    K = A @ A.transpose(0, 2, 1) / 6 + 0.1 * np.eye(6)
    tree = {"log_var_noise": lv, "warp": fp}

    def fj(t):
        return jnp.sum(jwarp.warped_log_marginal(
            lj, t, jnp.asarray(Y), jnp.asarray(mu), jnp.asarray(K), js, t["warp"]))

    def fpp(t):
        return torch.sum(pwarp.warped_log_marginal(
            lp, t, T(Y), T(mu), T(K), ps, t["warp"]))

    vj, gj = grads_j(fj, tree)
    vp, gp = grads_p(fpp, weights.params_from_jax(tree, "cpu", torch.float64))
    close(vp, vj)
    for a, b in zip(gj, gp):
        close(b, a)


def to_jax_tree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


@pytest.mark.parametrize("flow", ["identity", "SAL_InvBCL"])
def test_bernoulli_ell_and_moments(flow):
    """The ELL on both tails (log_ndtr) and its gradient; the predictive's
    closed form (identity) and quadrature branch (a flow), at fp64 and at
    a far tail where a clipped CDF would lose the gradient."""
    _, mu, var, _ = lik_inputs(1, MB=12)
    mu = mu * 4.0                     # reach |f| ~ 12 on the nodes
    Y = (np.random.RandomState(3).rand(1, 12) > 0.5).astype(np.float64)
    lj, lp = JLik("bernoulli", 1, quad_points=30), PLik("bernoulli", 1,
                                                        quad_points=30)
    if flow == "identity":
        wj, wp, fp = None, None, {}
    else:
        np.random.seed(0)
        js, ji = j_spec(jG.build_chain("SAL_InvBCL", 1))
        np.random.seed(0)
        ps, _ = p_spec(jG.build_chain("SAL_InvBCL", 1))
        from tgp.pytorch_tpu.flows.core import flow_forward as jfwd, init_flow_params
        from tgp.pytorch_tpu_torch.flows.core import flow_forward as pfwd
        rs = np.random.RandomState(4)
        fp = jax.tree_util.tree_map(
            lambda a: np.asarray(a) + 0.1 * rs.randn(*np.shape(a)),
            init_flow_params(js, ji, jax.random.PRNGKey(0), jnp.float64))
        wj = lambda t: (lambda f: jfwd(js, t, f))          # noqa: E731
        wp = lambda t: (lambda f: pfwd(ps, t, f))          # noqa: E731
    tree = {"flow": fp, "mu": mu, "var": var}

    def fj(t):
        w = wj(t["flow"]) if wj else (lambda f: f)
        return jcls.bernoulli_ell(lj, {}, jnp.asarray(Y), t["mu"], t["var"], w)

    def fpp(t):
        w = wp(t["flow"]) if wp else (lambda f: f)
        return pcls.bernoulli_ell(lp, {}, T(Y), t["mu"], t["var"], w)

    vj, gj = grads_j(fj, tree)
    vp, gp = grads_p(fpp, weights.params_from_jax(tree, "cpu", torch.float64))
    close(vp, vj)
    assert all(np.isfinite(b.numpy()).all() for b in gp)
    for a, b in zip(gj, gp):
        close(b, a)
    pj = jcls.bernoulli_moments(
        lj, {}, jnp.asarray(mu), jnp.asarray(var),
        wj(to_jax_tree(fp)) if wj else None, identity_flow=wj is None)
    pt = weights.params_from_jax({"f": fp}, "cpu", torch.float64)["f"]
    pp_ = pcls.bernoulli_moments(lp, {}, T(mu), T(var),
                                 wp(pt) if wp else None,
                                 identity_flow=wp is None)
    assert pp_.shape == (12,)
    close(pp_, pj)


def test_bernoulli_ell_fp32_tails_keep_a_finite_gradient():
    """In fp32 the quadrature nodes reach |f| ~ 13, where a CDF clipped at
    1 - 1e-12 rounds to 1: log_ndtr keeps the ELL and its gradient
    finite, as the JAX package's does."""
    mu = torch.tensor([[9.0, -11.0, 0.5]], requires_grad=True)
    var = torch.tensor([[2.0, 3.0, 0.1]])
    Y = torch.tensor([[0.0, 1.0, 1.0]])
    ell = pcls.bernoulli_ell(PLik("bernoulli", 1, quad_points=50), {}, Y, mu,
                             var, lambda f: f)
    g, = torch.autograd.grad(ell, mu)
    assert torch.isfinite(ell) and torch.isfinite(g).all()
    lj = JLik("bernoulli", 1, quad_points=50)
    vj, gj = jax.value_and_grad(lambda m: jcls.bernoulli_ell(
        lj, {}, jnp.asarray(Y.numpy()), m, jnp.asarray(var.numpy()),
        lambda f: f))(jnp.asarray(mu.detach().numpy(), jnp.float32))
    close(ell, vj, rtol=1e-5, atol=1e-5)
    close(g, gj, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_log_ndtr_derivative_on_both_tails(dtype):
    """`ops.transforms.log_ndtr`'s derivative phi/Phi: the JAX package's
    within rtol 1e-8 in fp64 on [-30, 30], and the asymptote -x (to 1e-6)
    far down the lower tail, where autograd of `torch.special.log_ndtr`
    gives 0 (fp32, x=-1e6) or inf (fp64, x=-1e15); a warped node at the
    fp32 warp clip (1e15) stays finite."""
    from tgp.pytorch_tpu_torch.ops.transforms import log_ndtr

    x = torch.linspace(-30.0, 30.0, 241, dtype=dtype, requires_grad=True)
    g, = torch.autograd.grad(log_ndtr(x).sum(), x)
    close(log_ndtr(x), torch.special.log_ndtr(x).detach().numpy())
    if dtype == torch.float64:
        gj = jax.vmap(jax.grad(jax.scipy.special.log_ndtr))(
            jnp.asarray(x.detach().numpy()))
        close(g, gj)
    far = torch.tensor([-1e15, -1e6, -1e4], dtype=dtype, requires_grad=True)
    gf, = torch.autograd.grad(log_ndtr(far).sum(), far)
    close(gf, -far.detach(), rtol=1e-6, atol=0)
    assert torch.isfinite(gf).all() and torch.isfinite(g).all()


@pytest.mark.parametrize("fn", ["ell", "moments"])
def test_categorical_ell_and_moments_on_replayed_draws(monkeypatch, fn):
    """3 classes, per-class BCL_AL flows (stacked per class), S=16 MC draws
    replayed: the value, and for the ELL its gradient."""
    rep = replay(monkeypatch)
    C, MB, S = 3, 8, 16
    _, mu, var, _ = lik_inputs(C, MB=MB)
    labels = np.random.RandomState(6).randint(0, C, MB).astype(np.float64)
    spec_j, spec_p, pj, pp, _ = model("cat_bcl")
    fp = jax.tree_util.tree_map(np.asarray, pj["flow"])
    lj = JLik("categorical", C, quad_points=S, num_classes=C)
    lp = PLik("categorical", C, quad_points=S, num_classes=C)
    tree = {"flow": fp, "mu": mu, "var": var}
    X3 = np.zeros((C, MB, 2))

    def fj(t):
        w = JM._make_warp(spec_j, dict(pj, flow=t["flow"]), jnp.asarray(X3),
                          None, stochastic=False)
        if fn == "ell":
            return jcls.categorical_ell(lj, {}, jnp.asarray(labels), t["mu"],
                                        t["var"], w, jax.random.PRNGKey(3))
        return jcls.categorical_moments(lj, {}, t["mu"], t["var"], w,
                                        jax.random.PRNGKey(3))

    def fpp(t):
        w = PM._make_warp(spec_p, dict(pp, flow=t["flow"]), T(X3))
        gen = torch.Generator().manual_seed(3)
        if fn == "ell":
            return pcls.categorical_ell(lp, {}, T(labels), t["mu"], t["var"],
                                        w, gen)
        return pcls.categorical_moments(lp, {}, t["mu"], t["var"], w, gen)

    if fn == "ell":
        vj, gj = grads_j(fj, tree)
        rep.seal()
        vp, gp = grads_p(fpp, weights.params_from_jax(tree, "cpu",
                                                      torch.float64))
        close(vp, vj)
        for a, b in zip(gj, gp):
            close(b, a)
    else:
        pj_ = jax.jit(fj)(to_jax_tree(tree))
        rep.seal()
        pp_ = fpp(weights.params_from_jax(tree, "cpu", torch.float64))
        assert pp_.shape == (MB, C)
        close(pp_, pj_)
        close(pp_.sum(-1), np.ones(MB))


# ---------------------------------------------------------------------------
# the model's branches
# ---------------------------------------------------------------------------

ID_KW = dict(input_dependent=True, input_dim=2, hidden_activation="tanh",
             num_hidden_layers=1, hidden_dim=5, dropout=0.5,
             inference="MC_dropout")
MODELS = {
    # name: (likelihood kind, Dy, flow)
    "wgp_sal": ("warped", 2, None),
    "wgp_log_exp": ("warped", 2, None),
    "wgp_steptanhl": ("warped", 2, None),
    "bern_identity": ("bernoulli", 1, None),
    "bern_sal_invbcl": ("bernoulli", 1, lambda: jG.build_chain("SAL_InvBCL", 1)),
    "bern_id": ("bernoulli", 1, lambda: jG.SAL(1, **ID_KW)),
    "cat_identity": ("categorical", 3, None),
    "cat_bcl": ("categorical", 3, lambda: jG.build_chain("BCL_AL", 1)),
    "cat_id": ("categorical", 3, lambda: jG.SAL(1, **ID_KW)),
}
WARP_ARCH = {"wgp_sal": "SAL", "wgp_log_exp": "log_exp",
             "wgp_steptanhl": "StepTanhL"}


def model(name, N=15, M=5, Dx=2, seed=0):
    """(JAX spec, port spec, JAX params, port params, (X, Y)): the JAX init
    moved by `weights.perturb_params`; Y are labels for classification."""
    kind, Dy, fl = MODELS[name]
    rs = np.random.RandomState(seed)
    X = rs.randn(N, Dx)
    fspec, finits = ((), None)
    if fl is not None:
        np.random.seed(0)
        fspec, finits = j_spec(fl())
    warp = {}
    if kind == "warped":
        js, _, fp = warp_flow(WARP_ARCH[name])
        warp = dict(warp_flow=js)
        Y = rs.randn(N, Dy)
    elif kind == "bernoulli":
        Y = (rs.rand(N, 1) > 0.5).astype(np.float64)
    else:
        Y = rs.randint(0, Dy, (N, 1)).astype(np.float64)
    lik = JLik(kind, Dy, quad_points=12, num_classes=Dy if kind == "categorical"
               else 0, **warp)
    spec_j = JM.TGPSpec(Dy=Dy, Dx=Dx, M=M, N=float(N),
                        kernel=jK.from_name("scale_rbf"), likelihood=lik,
                        **(dict(flow=fspec) if fl else {}))
    pj = JM.init_tgp_params(spec_j, X, X[:M], flow_inits=finits,
                            kernel_init={"length_scale": 1.5,
                                         "kernel_scale": 1.2})
    if kind == "warped":
        pj["likelihood"]["warp"] = to_jax_tree(fp)
    spec_p = weights.spec_from_dict(jser.spec_to_dict(spec_j))
    pp = weights.perturb_params(to_port(pj), seed=seed + 1)
    pp["q_L"] = pp["q_L"] * 0.3             # keep var of the order of 1
    return spec_j, spec_p, to_jax(pp), pp, (X, Y)


def draws_of(name):
    return MODELS[name][0] == "categorical" or name.endswith("_id")


@pytest.mark.parametrize("name", sorted(MODELS))
def test_elbo_value_and_gradient(monkeypatch, name):
    rep = replay(monkeypatch)
    spec_j, spec_p, pj, pp, (X, Y) = model(name)
    key = jax.random.PRNGKey(1)

    def fj(p):
        return JM.elbo(spec_j, p, jnp.asarray(X), jnp.asarray(Y), key)[0]

    vj, gj = jax.jit(jax.value_and_grad(fj))(pj)
    rep.seal()
    gen = torch.Generator().manual_seed(1)
    vp, gp = grads_p(lambda p: PM.elbo(spec_p, p, T(X), T(Y), gen)[0], pp)
    close(vp, vj)
    gj = jax.tree_util.tree_leaves_with_path(gj)
    assert len(gj) == len(gp)
    for (path, a), b in zip(gj, gp):
        close(b, a, err_msg=jax.tree_util.keystr(path), **F64)


# fully-Bayesian prediction for the models with a stochastic flow
BAYES_CASES = [(n, False) for n in sorted(MODELS)] + \
    [(n, True) for n in sorted(MODELS) if n.endswith("_id")]


@pytest.mark.parametrize("name, bayes", BAYES_CASES)
def test_predictive_distribution(monkeypatch, name, bayes):
    rep = replay(monkeypatch)
    spec_j, spec_p, pj, pp, (X, _) = model(name)
    kw = dict(S_MC=4, fully_bayesian=bayes)
    out_j = jax.jit(lambda p: JM.predictive_distribution(
        spec_j, p, jnp.asarray(X), rng=jax.random.PRNGKey(2), **kw))(pj)
    rep.seal()
    with torch.no_grad():
        out_p = PM.predictive_distribution(
            spec_p, pp, T(X), rng=torch.Generator().manual_seed(2), **kw)
    if MODELS[name][0] == "warped":
        assert out_p[1] is not None
    else:
        assert out_p[1] is None and out_j[1] is None
        assert out_p[0].shape == (X.shape[0], max(2, spec_p.Dy))
        close(out_p[0].sum(-1), np.ones(X.shape[0]))
    for a, b in zip(out_j, out_p):
        if a is not None:
            close(b, a)


@pytest.mark.parametrize("reduce", [True, False])
@pytest.mark.parametrize("name, bayes", BAYES_CASES)
def test_test_log_likelihood(monkeypatch, name, bayes, reduce):
    rep = replay(monkeypatch)
    spec_j, spec_p, pj, pp, (X, Y) = model(name)
    Y_std = np.array([1.7, 0.6][:spec_p.Dy]) if MODELS[name][0] == "warped" \
        else np.ones(1)
    kw = dict(S_MC=4, fully_bayesian=bayes, reduce=reduce)
    lj = jax.jit(lambda p: JM.test_log_likelihood(
        spec_j, p, jnp.asarray(X), jnp.asarray(Y), jnp.asarray(Y_std),
        rng=jax.random.PRNGKey(4), **kw))(pj)
    rep.seal()
    with torch.no_grad():
        lp = PM.test_log_likelihood(spec_p, pp, T(X), T(Y), T(Y_std),
                                    rng=torch.Generator().manual_seed(4), **kw)
    assert lp.shape == tuple(lj.shape)
    close(lp, lj)


@pytest.mark.parametrize("name", ["wgp_log_exp", "bern_sal_invbcl", "bern_id",
                                  "cat_id"])
def test_sample_predictive_at_distribution_level(name):
    """S samples of y against the JAX package's predictive: the warped
    GP's mean against m1; Bernoulli and categorical label frequencies
    against the probabilities (the ID models' point-estimate flow)."""
    spec_j, spec_p, pj, pp, (X, _) = model(name)
    S = 2000
    with torch.no_grad():
        y, fk, f0 = PM.sample_predictive(spec_p, pp, T(X), S,
                                         torch.Generator().manual_seed(5))
    kind, Dy = MODELS[name][:2]
    assert fk.shape == f0.shape == (S, Dy, X.shape[0])
    assert y.shape == ((1 if kind == "categorical" else Dy), S, X.shape[0])
    m1, m2, _, _ = jax.jit(lambda p: JM.predictive_distribution(
        spec_j, p, jnp.asarray(X), rng=jax.random.PRNGKey(0)))(pj)
    m1 = np.asarray(m1)
    y = y.numpy()
    if kind == "warped":
        se = np.sqrt(np.asarray(m2) / S)
        assert np.all(np.abs(y.mean(1) - m1) < 5 * se)
        return
    labels = y[0].astype(int)                      # (S, MB)
    assert set(np.unique(labels)) <= set(range(m1.shape[1]))
    if kind == "categorical":
        # the JAX package's probabilities are an MC estimate too (S=12)
        m1 = np.asarray(PM.predictive_distribution(
            spec_p, pp, T(X), rng=torch.Generator().manual_seed(0))[0])
    freq = np.stack([(labels == c).mean(0) for c in range(m1.shape[1])], -1)
    se = np.sqrt(m1 * (1 - m1) / S) + 1e-3
    assert np.all(np.abs(freq - m1) < 5 * se)


@pytest.mark.parametrize("arch", ["SAL", "log_exp", "StepTanhL"])
def test_confidence_intervals_warped_closed_path(arch):
    name = {"SAL": "wgp_sal", "log_exp": "wgp_log_exp",
            "StepTanhL": "wgp_steptanhl"}[arch]
    spec_j, spec_p, pj, pp, (X, _) = model(name)
    cj = jutils.compute_95_and_median_confidence_intervals(
        spec_j, pj, jnp.asarray(X), 10, jax.random.PRNGKey(0))
    cp = putils.compute_95_and_median_confidence_intervals(
        spec_p, pp, T(X), 10, torch.Generator().manual_seed(0))
    assert len(cp) == len(cj) == 2
    for bands_j, bands_p in zip(cj, cp):
        assert len(bands_p) == 3
        for a, b in zip(bands_j, bands_p):
            close(b, a)
        assert np.all(bands_p[0] <= bands_p[1]) and np.all(bands_p[1] <= bands_p[2])


def test_confidence_intervals_by_samples_and_sample_prior():
    """The sampled path's bands are ordered quantiles of the port's samples
    and `sample_prior`'s draws have the prior's covariance."""
    spec_j, spec_p, pj, pp, (X, _) = model("bern_sal_invbcl")
    cp = putils.confidence_intervals(spec_p, pp, T(X), [0.1, 0.9], 50,
                                     torch.Generator().manual_seed(0),
                                     distribution="posterior")
    assert len(cp) == 1 and all(b.shape == (X.shape[0],) for b in cp[0])
    assert np.all(cp[0][0] <= cp[0][1])
    S = 20000
    f = putils.sample_prior(spec_p, pp, T(X[:4]), S,
                            torch.Generator().manual_seed(1)).numpy()
    assert f.shape == (S, 1, 4)
    from tgp.pytorch_tpu.ops.kernels import gram
    K = np.asarray(gram(spec_j.kernel, pj["kernel"], jnp.asarray(X[:4])[None],
                        jnp.asarray(X[:4])[None], same=True))[0]
    emp = np.cov(f[:, 0, :].T)
    assert np.all(np.abs(emp - K) < 6 * np.sqrt((K ** 2 + np.outer(
        np.diag(K), np.diag(K))) / S) + 1e-6)


@pytest.mark.parametrize("C", [2, 3, 7])
def test_calibration_metrics_match_jax(C):
    rs = np.random.RandomState(C)
    N = 500
    logits = 2.0 * rs.randn(N, C)
    probs = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    probs[:3] = np.eye(C)[0]                    # confidence exactly 1
    labels = rs.randint(0, C, N)
    vj = jmetrics.calibration_accumulators(probs, labels)
    vp = pmetrics.calibration_accumulators(probs, labels)
    np.testing.assert_array_equal(vp, vj)
    half = pmetrics.calibration_accumulators(probs[:200], labels[:200]) + \
        pmetrics.calibration_accumulators(probs[200:], labels[200:])
    np.testing.assert_allclose(half, vj, **F64)
    for got, want in ((pmetrics.calibration_from_accumulators(vp),
                       jmetrics.calibration_from_accumulators(vj)),
                      (pmetrics.calibration_measures(probs, labels),
                       jmetrics.calibration_measures(probs, labels))):
        assert got.keys() == want.keys() == {"ECE", "MCE", "BRIER", "NLL"}
        for k in want:
            np.testing.assert_allclose(got[k], want[k], **F64)
