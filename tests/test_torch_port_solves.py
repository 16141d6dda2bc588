"""The port's `marginal_qf` branches, the ELBO around them, per-output
flows and serving of the new model surface, against the JAX package on
the CPU, fp64.

  * `marginal_qf` whitened and unwhitened, each with the covariance's
    diagonal and in full, with and without `fast_solves`, in value and in
    gradient (into every parameter and X);
  * `solve_precision`: on the CPU every mode is 'highest', bit for bit, as
    the JAX package's modes agree on the CPU;
  * the ELBO (and so `kld_qu`'s unwhitened KL) and its gradient for each
    branch, the means, a spectral mixture and a white-noise sum;
  * `flow_per_output`: the JAX package's `tests/test_hetero_flows.py`
    model (SAL(1) on output 0, ArcSL(1) on output 1);
  * `serve.Predictor`, `models/utils.sample_prior` and the confidence
    intervals on a spectral-mixture, an unwhitened, a mean and a
    per-output-flow model.

Parameters are the JAX package's init moved by `weights.perturb_params`.
Tolerance: rtol 1e-8, atol 1e-10 (the same float64 math, LAPACK on both
sides; only the order of sums differs).
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tgp.pytorch_tpu.flows import generators as jG, spec_from_list as j_spec_from_list
from tgp.pytorch_tpu.likelihoods import LikelihoodSpec as JLik
from tgp.pytorch_tpu.models import serialization as jser, tgp as JM
from tgp.pytorch_tpu.ops import kernels as jK

from tgp.pytorch_tpu_torch import config as pcfg, weights
from tgp.pytorch_tpu_torch.flows import generators as pG, spec_from_list as p_spec_from_list
from tgp.pytorch_tpu_torch.models import tgp as PM, utils as putils
from tgp.pytorch_tpu_torch.serve import Predictor

F64 = dict(rtol=1e-8, atol=1e-10)


@pytest.fixture(autouse=True)
def _port_state():
    prev, dt = pcfg.precision(), torch.get_default_dtype()
    nt = torch.get_num_threads()
    pcfg.set_precision("fp64")
    torch.set_num_threads(1)        # small eager ops; the workers share the cores
    yield
    torch.set_num_threads(nt)
    pcfg.set_precision(prev)
    assert torch.get_default_dtype() == dt


def t64(a):
    return torch.tensor(np.asarray(a, np.float64))


def close(port, ref, **tol):
    np.testing.assert_allclose(port.detach().cpu().numpy(), np.asarray(ref),
                               **(tol or F64))


def to_jax(tree):
    return weights.tree_map(lambda t: jnp.asarray(t.detach().numpy()), tree)


KERNELS = {"scale_rbf": jK.scale(jK.rbf()),
           "spectral_mixture": jK.spectral_mixture(2),
           "white_sum": jK.additive(jK.scale(jK.matern(1.5)), jK.white())}


def build(kernel="scale_rbf", flow=True, Dy=2, Dx=3, M=7, N=20, quad=20,
          seed=0, **spec_kw):
    """(JAX spec, port spec, JAX params, port params, X, Y): the JAX init
    (q(U) variance 0.4) moved by `perturb_params`."""
    rng = np.random.RandomState(seed)
    X, Y = rng.randn(N, Dx), rng.randn(N, Dy)
    np.random.seed(seed)
    fspec, finits = j_spec_from_list(jG.SAL(1)) if flow else ((), None)
    lik = JLik("gaussian_flow" if flow else "gaussian", Dy, quad_points=quad)
    spec_j = JM.TGPSpec(Dy=Dy, Dx=Dx, M=M, N=float(N), kernel=KERNELS[kernel],
                        likelihood=lik, flow=fspec, **spec_kw)
    pj = JM.init_tgp_params(spec_j, X, X[:M], variance_scale=0.4,
                            kernel_init={"length_scale": 1.5,
                                         "kernel_scale": 1.2,
                                         "noisy_variance": 0.05},
                            flow_inits=finits, dtype=jnp.float64)
    spec_p = weights.spec_from_dict(jser.spec_to_dict(spec_j))
    pp = weights.perturb_params(
        weights.params_from_jax(jax.tree_util.tree_map(np.asarray, pj),
                                device="cpu", dtype=torch.float64), seed + 1)
    return spec_j, spec_p, to_jax(pp), pp, X, Y


def grads_match(port_fn, jax_fn, pp, pj, X):
    """port_fn(params, X) and jax_fn(params, X) return a scalar: the values
    and the gradients into every parameter and X agree."""
    vj, (gpj, gXj) = jax.jit(jax.value_and_grad(jax_fn, argnums=(0, 1)))(
        pj, jnp.asarray(X))
    leaves = weights.tree_map(lambda t: t.clone().requires_grad_(True), pp)
    x = t64(X).requires_grad_(True)
    v = port_fn(leaves, x)
    close(v, vj)
    pl = weights.tree_leaves(leaves)
    gp = torch.autograd.grad(v, pl + [x], allow_unused=True,
                             materialize_grads=True)
    jl = jax.tree_util.tree_leaves(gpj)
    assert len(pl) == len(jl) > 0
    for a, b in zip(gp, jl):
        close(a, b)
    close(gp[-1], gXj)


# ---------------------------------------------------------------------------
# marginal_qf: four branches, fast solves, solve precision
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("diagonal", [True, False])
@pytest.mark.parametrize("whiten", [True, False])
def test_marginal_qf_branches_match(whiten, diagonal, fast):
    spec_j, spec_p, pj, pp, X, _ = build(whiten=whiten, fast_solves=fast,
                                         mean="linear")
    Xq = np.random.RandomState(9).randn(11, 3)
    mu_j, cov_j = jax.jit(lambda p, x: JM.marginal_qf(
        spec_j, p, x, diagonal=diagonal))(pj, jnp.asarray(Xq))
    mu_p, cov_p = PM.marginal_qf(spec_p, pp, t64(Xq), diagonal=diagonal)
    assert tuple(cov_p.shape) == cov_j.shape == ((2, 11) if diagonal
                                                 else (2, 11, 11))
    close(mu_p, mu_j)
    close(cov_p, cov_j)
    rng = np.random.RandomState(3)
    wm, wc = rng.randn(*mu_j.shape), rng.randn(*cov_j.shape)

    def port(p, x):
        mu, cov = PM.marginal_qf(spec_p, p, x, diagonal=diagonal)
        return (t64(wm) * mu).sum() + (t64(wc) * cov).sum()

    def ref(p, x):
        mu, cov = JM.marginal_qf(spec_j, p, x, diagonal=diagonal)
        return jnp.sum(wm * mu) + jnp.sum(wc * cov)

    grads_match(port, ref, pp, pj, Xq)


@pytest.mark.parametrize("whiten", [True, False])
def test_solve_precision_is_highest_on_the_cpu(whiten):
    """Like the JAX package's modes on the CPU: every mode computes the
    same thing, here bit for bit, forward and backward."""
    spec_j, spec_p, pj, pp, X, Y = build(whiten=whiten)
    outs = []
    for fast in (False, True):
        for prec in ("highest", "high", "default"):
            sp = dataclasses.replace(spec_p, fast_solves=fast,
                                     solve_precision=prec)
            leaves = weights.tree_map(lambda t: t.clone().requires_grad_(True), pp)
            e = PM.elbo(sp, leaves, t64(X), t64(Y))[0]
            qf = PM.marginal_qf(sp, leaves, t64(X), diagonal=False)
            g = torch.autograd.grad(e, weights.tree_leaves(leaves))
            outs.append((fast, [e, *qf, *g]))
    for fast, o in outs:
        ref = next(r for f, r in outs if f == fast)
        assert all(torch.equal(a, b) for a, b in zip(o, ref))
    with pytest.raises(ValueError, match="solve_precision"):
        dataclasses.replace(spec_p, solve_precision="medium")


# ---------------------------------------------------------------------------
# the ELBO of each branch
# ---------------------------------------------------------------------------

ELBO_CASES = {
    "whitened": dict(),
    "whitened_fast": dict(fast_solves=True, solve_precision="high"),
    "unwhitened": dict(whiten=False),
    "unwhitened_linear_mean": dict(whiten=False, mean="linear"),
    "identity_mean": dict(mean="identity"),
    "unwhitened_shared": dict(whiten=False, mean="linear", Z_is_shared=True,
                              K_is_shared=True, mean_is_shared=True,
                              q_U_is_shared=True),
    "spectral_mixture": dict(kernel="spectral_mixture", flow=False, Dx=1),
    "spectral_mixture_unwhitened": dict(kernel="spectral_mixture", Dx=1,
                                        whiten=False),
    "white_sum_unwhitened": dict(kernel="white_sum", whiten=False),
}


@pytest.mark.parametrize("name", sorted(ELBO_CASES))
def test_elbo_matches_in_value_and_gradient(name):
    spec_j, spec_p, pj, pp, X, Y = build(**ELBO_CASES[name])
    ej = jax.jit(lambda p: JM.elbo(spec_j, p, jnp.asarray(X),
                                   jnp.asarray(Y)))(pj)
    ep = PM.elbo(spec_p, pp, t64(X), t64(Y))
    for a, b in zip(ep, ej):
        close(a, b)
    close(PM.kld_qu(spec_p, pp), jax.jit(lambda p: JM.kld_qu(spec_j, p))(pj))
    grads_match(lambda p, x: PM.elbo(spec_p, p, x, t64(Y))[0],
                lambda p, x: JM.elbo(spec_j, p, x, jnp.asarray(Y))[0],
                pp, pj, X)


def test_unwhitened_kl_takes_the_elbos_kzz():
    """The ELBO hands `marginal_qf`'s K_zz and factor to the KL; the KL
    alone computes K_zz itself: the same value and gradient."""
    _, spec_p, _, pp, X, _ = build(whiten=False, mean="linear")
    leaves = weights.tree_map(lambda t: t.clone().requires_grad_(True), pp)
    prior = PM._marginal_qf(spec_p, leaves, t64(X), True)[2]
    a, b = PM.kld_qu(spec_p, leaves, prior), PM.kld_qu(spec_p, leaves)
    close(a, b.detach(), rtol=1e-13, atol=0)
    ga = torch.autograd.grad(a.sum(), weights.tree_leaves(leaves),
                             allow_unused=True, materialize_grads=True)
    gb = torch.autograd.grad(b.sum(), weights.tree_leaves(leaves),
                             allow_unused=True, materialize_grads=True)
    for x, y in zip(ga, gb):
        close(x, y.detach(), rtol=1e-12, atol=1e-14)


# ---------------------------------------------------------------------------
# per-output flows (the JAX package's tests/test_hetero_flows.py model)
# ---------------------------------------------------------------------------

def hetero():
    np.random.seed(0)
    N, Dx, Dy = 30, 3, 2
    X = np.random.randn(N, Dx)
    Y = np.random.randn(N, Dy)
    s0, i0 = j_spec_from_list(jG.SAL(1))
    s1, i1 = j_spec_from_list(jG.ArcSL(1))
    spec_j = JM.TGPSpec(Dy=Dy, Dx=Dx, M=5, N=float(N),
                        kernel=jK.from_name("scale_rbf"),
                        likelihood=JLik("gaussian_flow", Dy, quad_points=32),
                        flow=s0, flow_per_output=(s0, s1))
    pj = JM.init_tgp_params(spec_j, X, X[:5], flow_inits=[i0, i1])
    spec_p = weights.spec_from_dict(jser.spec_to_dict(spec_j))
    pp = weights.params_from_jax(jax.tree_util.tree_map(np.asarray, pj),
                                 device="cpu", dtype=torch.float64)
    return spec_j, spec_p, pj, pp, X, Y


def test_flow_per_output_matches():
    spec_j, spec_p, pj, pp, X, Y = hetero()
    assert spec_p.has_flow and isinstance(pp["flow"], list)
    # the port's own init is the JAX package's (the generators' numpy draws)
    np.random.seed(0)
    np.random.randn(30, 3), np.random.randn(30, 2)
    s0, i0 = p_spec_from_list(pG.SAL(1))
    s1, i1 = p_spec_from_list(pG.ArcSL(1))
    assert (s0, s1) == spec_p.flow_per_output
    own = PM.init_tgp_params(spec_p, X, X[:5], flow_inits=[i0, i1],
                             device="cpu")
    for a, b in zip(weights.tree_leaves(own), jax.tree_util.tree_leaves(pj)):
        close(a, b, rtol=0, atol=0)

    Xj, Xp = jnp.asarray(X), t64(X)
    for a, b in zip(PM.elbo(spec_p, pp, Xp, t64(Y)),
                    jax.jit(lambda p: JM.elbo(spec_j, p, Xj,
                                              jnp.asarray(Y)))(pj)):
        close(a, b)
    out_p = PM.predictive_distribution(spec_p, pp, Xp)
    out_j = jax.jit(lambda p: JM.predictive_distribution(spec_j, p, Xj))(pj)
    for a, b in zip(out_p, out_j):
        close(a, b)
    # output 0's SAL is the identity at init, output 1's ArcSL is not
    close(out_p[0][0], out_p[2][0], rtol=0, atol=1e-6)
    assert float((out_p[0][1] - out_p[2][1]).abs().max()) > 1e-3
    Y_std = np.array([1.3, 0.7])
    for reduce in (True, False):
        close(PM.test_log_likelihood(spec_p, pp, Xp, t64(Y), t64(Y_std),
                                     reduce=reduce),
              jax.jit(lambda p: JM.test_log_likelihood(
                  spec_j, p, Xj, jnp.asarray(Y), jnp.asarray(Y_std),
                  reduce=reduce))(pj))
    pp = weights.perturb_params(pp, 5)
    grads_match(lambda p, x: PM.elbo(spec_p, p, x, t64(Y))[0],
                lambda p, x: JM.elbo(spec_j, p, x, jnp.asarray(Y))[0],
                pp, to_jax(pp), X)


# ---------------------------------------------------------------------------
# serving the new model surface
# ---------------------------------------------------------------------------

SERVED = {"spectral_mixture": dict(kernel="spectral_mixture", Dx=1),
          "unwhitened": dict(whiten=False),
          "linear_mean": dict(mean="linear", whiten=False, fast_solves=True),
          "flow_per_output": None}


@pytest.mark.parametrize("name", sorted(SERVED))
def test_predictor_and_utils_serve_the_model(name):
    if SERVED[name] is None:
        spec_j, spec_p, pj, pp, X, Y = hetero()
    else:
        spec_j, spec_p, pj, pp, X, Y = build(**SERVED[name])
    Xq = np.random.RandomState(2).randn(13, X.shape[1])
    pred = Predictor(spec_p, pp, buckets=(8, 16), device="cpu")
    out = pred.predict(Xq, samples=50)
    m1, m2, _, _ = jax.jit(lambda p: JM.predictive_distribution(
        spec_j, p, jnp.asarray(Xq)))(pj)
    np.testing.assert_allclose(out["mean"], np.asarray(m1), **F64)
    np.testing.assert_allclose(out["var"], np.asarray(m2), **F64)
    assert out["samples"].shape == (spec_p.Dy, 50, 13)
    assert np.all(out["lower"] <= out["upper"])
    Yq = np.random.RandomState(3).randn(13, spec_p.Dy)
    lj = jax.jit(lambda p: JM.test_log_likelihood(
        spec_j, p, jnp.asarray(Xq), jnp.asarray(Yq), jnp.ones(spec_p.Dy),
        reduce=False))(pj)
    np.testing.assert_allclose(pred.log_prob(Xq, Yq),
                               np.asarray(lj).sum(axis=-1), **F64)
    gen = torch.Generator().manual_seed(0)
    prior = putils.sample_prior(spec_p, pp, t64(Xq), 20, gen)
    assert prior.shape == (20, spec_p.Dy, 13) and torch.isfinite(prior).all()
    bands = putils.compute_95_and_median_confidence_intervals(
        spec_p, pp, t64(Xq), 200, gen)
    assert len(bands) == spec_p.Dy
    for lo, med, hi in bands:
        assert lo.shape == (13,) and np.all(lo <= med) and np.all(med <= hi)
