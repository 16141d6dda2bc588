"""The PyTorch port's TGP model against the JAX package, on the CPU, fp64.

Both sides get the same parameters: the JAX package initialises them, the
port takes them through `weights.params_from_jax`, a seeded numpy
perturbation moves every leaf (so no flow is the identity and no posterior
is trivial), and the perturbed tree goes back to JAX.  Tolerance: rtol 1e-8,
atol 1e-10 — both sides run the same float64 math (LAPACK Cholesky and
triangular solves on both); only the order of sums differs.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tgp.pytorch_tpu.models import tgp as JM, serialization as jser
from tgp.pytorch_tpu.ops import kernels as jK
from tgp.pytorch_tpu.likelihoods import LikelihoodSpec as JLik
from tgp.pytorch_tpu.flows import generators as jG, spec_from_list as j_spec_from_list
from tgp.pytorch_tpu.data.uci import load_uci_split as j_load_uci_split

from tgp.pytorch_tpu_torch import config as pcfg, weights
from tgp.pytorch_tpu_torch.models import tgp as PM
from tgp.pytorch_tpu_torch.flows import generators as pG, spec_from_list as p_spec_from_list
from tgp.pytorch_tpu_torch.data.uci import load_uci_split as p_load_uci_split

from test_torch_port_large import jax_native_parser

F64 = dict(rtol=1e-8, atol=1e-10)


@pytest.fixture(autouse=True)
def _port_state():
    prev, dt = pcfg.precision(), torch.get_default_dtype()
    pcfg.set_precision("fp64")
    yield
    pcfg.set_precision(prev)
    assert torch.get_default_dtype() == dt


def close(port, ref, **tol):
    np.testing.assert_allclose(port.detach().cpu().numpy(), np.asarray(ref),
                               **(tol or F64))


def to_jax(tree):
    return weights.tree_map(lambda t: jnp.asarray(t.numpy()), tree)


CONFIGS = {
    # the flagship's structure at a small size
    "sal2": dict(),
    "sal2_shared_flow": dict(flow_is_shared=True),
    "svgp_gaussian": dict(flow=None, lik="gaussian"),
    "shared_blocks": dict(Z_is_shared=True, q_U_is_shared=True,
                          K_is_shared=True),
    "rbf_shared_noise": dict(kernel="rbf", noise_is_shared=True),
}


def build(name, Dy=2, Dx=3, M=7, N=20, quad=30, seed=0):
    """(JAX spec, port spec, JAX params, port params, X, Y, Y_std)."""
    cfg = dict(CONFIGS[name])
    rng = np.random.RandomState(seed)
    X = rng.randn(N, Dx)
    Y = rng.randn(N, Dy)
    flow = cfg.pop("flow", "sal")
    fspec, finits = j_spec_from_list(jG.SAL(2)) if flow else ((), None)
    lik = JLik(cfg.pop("lik", "gaussian_flow"), Dy, quad_points=quad,
               noise_is_shared=cfg.pop("noise_is_shared", False))
    kernel = jK.from_name(cfg.pop("kernel", "scale_rbf"))
    kw = dict(flow=fspec) if flow else {}
    spec_j = JM.TGPSpec(Dy=Dy, Dx=Dx, M=M, N=float(N), kernel=kernel,
                        likelihood=lik, **kw, **cfg)
    params_j = JM.init_tgp_params(
        spec_j, X, X[:M], kernel_init={"length_scale": 1.5, "kernel_scale": 1.2},
        flow_inits=finits, dtype=jnp.float64)
    spec_p = weights.spec_from_dict(jser.spec_to_dict(spec_j))
    params_p = weights.perturb_params(
        weights.params_from_jax(jax.tree_util.tree_map(np.asarray, params_j),
                                device="cpu", dtype=torch.float64), seed=seed + 1)
    Y_std = np.array([1.7, 0.6][:Dy])
    return spec_j, spec_p, to_jax(params_p), params_p, X, Y, Y_std


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_marginal_qf_and_predictive_distribution_match(name):
    spec_j, spec_p, pj, pp, X, _, _ = build(name)
    Xq = np.random.RandomState(9).randn(11, X.shape[1])
    mu_j, var_j = JM.marginal_qf(spec_j, pj, jnp.asarray(Xq))
    mu_p, var_p = PM.marginal_qf(spec_p, pp, torch.as_tensor(Xq))
    close(mu_p, mu_j)
    close(var_p, var_j)
    out_j = JM.predictive_distribution(spec_j, pj, jnp.asarray(Xq))
    out_p = PM.predictive_distribution(spec_p, pp, torch.as_tensor(Xq))
    for p, j in zip(out_p, out_j):
        close(p, j)


@pytest.mark.parametrize("reduce", [True, False])
@pytest.mark.parametrize("name", ["sal2", "svgp_gaussian"])
def test_test_log_likelihood_matches(name, reduce):
    spec_j, spec_p, pj, pp, X, Y, Y_std = build(name)
    lj = JM.test_log_likelihood(spec_j, pj, jnp.asarray(X), jnp.asarray(Y),
                                jnp.asarray(Y_std), reduce=reduce)
    lp = PM.test_log_likelihood(spec_p, pp, torch.as_tensor(X),
                                torch.as_tensor(Y), torch.as_tensor(Y_std),
                                reduce=reduce)
    assert lp.shape == tuple(lj.shape)
    close(lp, lj)


def test_sample_predictive_matches_moments_at_distribution_level():
    # MC mean and variance of the port's samples against the quadrature
    # moments (5 standard errors for the mean, 6 for the variance)
    spec_j, spec_p, pj, pp, X, _, _ = build("sal2")
    Xq = torch.as_tensor(X[:6])
    S = 20000
    gen = torch.Generator().manual_seed(3)
    y, fk, f0 = PM.sample_predictive(spec_p, pp, Xq, S, gen)
    assert y.shape == (2, S, 6) and fk.shape == f0.shape == (S, 2, 6)
    m1, m2, _, _ = JM.predictive_distribution(spec_j, pj, jnp.asarray(X[:6]))
    m1, m2 = np.asarray(m1), np.asarray(m2)
    y = y.numpy()
    se_mean = np.sqrt(m2 / S)
    assert np.all(np.abs(y.mean(1) - m1) < 5 * se_mean)
    c = y - y.mean(1, keepdims=True)
    se_var = np.sqrt(np.maximum((c ** 4).mean(1) - m2 ** 2, 0) / S)
    assert np.all(np.abs(y.var(1) - m2) < 6 * se_var + 1e-12)


def test_init_and_params_from_jax_and_spec_from_dict():
    spec_j, spec_p, _, _, X, _, _ = build("sal2")
    assert spec_p == PM.TGPSpec(
        Dy=2, Dx=3, M=7, N=20.0, kernel=spec_p.kernel,
        likelihood=spec_p.likelihood,
        flow=p_spec_from_list(pG.SAL(2))[0])
    np.random.seed(0)
    fspec, finits = j_spec_from_list(jG.SAL(2))
    kinit = {"length_scale": 1.5, "kernel_scale": 1.2}
    pj = JM.init_tgp_params(spec_j, X, X[:7], kernel_init=kinit,
                            flow_inits=finits, variance_scale=0.3,
                            mean_scale=0.1, add_noise_inducing=0.2,
                            dtype=jnp.float64)
    pp = PM.init_tgp_params(spec_p, X, X[:7], kernel_init=kinit,
                            flow_inits=p_spec_from_list(pG.SAL(2))[1],
                            variance_scale=0.3, mean_scale=0.1,
                            add_noise_inducing=0.2, device="cpu")
    conv = weights.params_from_jax(jax.tree_util.tree_map(np.asarray, pj),
                                   device="cpu", dtype=torch.float64)
    flat_p = jax.tree_util.tree_leaves(weights.tree_map(lambda t: t.numpy(), pp))
    flat_c = jax.tree_util.tree_leaves(weights.tree_map(lambda t: t.numpy(), conv))
    assert len(flat_p) == len(flat_c) == len(jax.tree_util.tree_leaves(pj))
    for a, b in zip(flat_p, flat_c):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("change, item", [
    (dict(whiten=False), "item 18"),
    (dict(fast_solves=True), "item 18"),
    (dict(solve_precision="high"), "item 18"),
    (dict(mean="linear"), "item 18"),
])
def test_unported_spec_parts_raise(change, item):
    # item 18 is ported: the spec comes through spec_to_dict/spec_from_dict
    # and its q(f) matches JAX's (the solve levers are 'highest' on the CPU)
    spec_j, _, _, _, X, _, _ = build("sal2")
    spec_j = dataclasses.replace(spec_j, **change)
    spec_p = weights.spec_from_dict(jser.spec_to_dict(spec_j))
    fields = ("whiten", "fast_solves", "solve_precision", "mean")
    assert [getattr(spec_p, f) for f in fields] == \
        [getattr(spec_j, f) for f in fields]
    pj = JM.init_tgp_params(spec_j, X, X[:spec_j.M], variance_scale=0.4,
                            dtype=jnp.float64)
    pp = weights.params_from_jax(jax.tree_util.tree_map(np.asarray, pj),
                                 device="cpu", dtype=torch.float64)
    Xq = np.random.RandomState(9).randn(11, X.shape[1])
    for p, j in zip(PM.marginal_qf(spec_p, pp, torch.as_tensor(Xq)),
                    JM.marginal_qf(spec_j, pj, jnp.asarray(Xq))):
        close(p, j)


def test_unported_flows_and_likelihoods_raise():
    # input-dependent flows are ported: their specs are the JAX package's,
    # hypernet specs included, also through spec_to_dict / spec_from_dict
    for fl in (jG.SAL(1, input_dependent=True, input_dim=3),
               jG.StepTanhL(1, 2, input_dependent=True, input_dim=3,
                            inference="mean_field_gaussian")):
        js, _ = j_spec_from_list(fl)
        ps, _ = p_spec_from_list(fl)
        assert [dataclasses.astuple(x) for x in ps] == \
            [dataclasses.astuple(x) for x in js]
        spec_j = JM.TGPSpec(Dy=1, Dx=3, M=4, N=10.0,
                            kernel=jK.from_name("scale_rbf"),
                            likelihood=JLik("gaussian_flow", 1), flow=js)
        spec_p = weights.spec_from_dict(jser.spec_to_dict(spec_j))
        assert spec_p.flow == ps and spec_p.has_input_dependent_flow
    with pytest.raises(ValueError, match="unknown flow kind"):
        p_spec_from_list([("no_such_flow", {})])
    # the classification and warped likelihoods are ported: their specs
    # come through spec_to_dict / spec_from_dict as the JAX package's
    spec_j, *_ = build("sal2")
    warp, _ = j_spec_from_list(jG.SAL(1))
    for lik in (JLik("bernoulli", 1, quad_points=50),
                JLik("categorical", 1, quad_points=32, num_classes=3),
                JLik("warped", 1, warp_flow=warp)):
        d = jser.spec_to_dict(dataclasses.replace(spec_j, likelihood=lik))
        got = weights.spec_from_dict(d).likelihood
        assert dataclasses.astuple(got) == dataclasses.astuple(lik)


def test_loader_is_bit_identical_to_jax_package():
    jax_native_parser()
    dj = j_load_uci_split("power", 1)
    dp = p_load_uci_split("power", 1)
    assert dj.keys() == dp.keys()
    for k in dj:
        if dj[k] is None:
            assert dp[k] is None
        else:
            assert np.asarray(dp[k]).dtype == np.asarray(dj[k]).dtype
            np.testing.assert_array_equal(dp[k], dj[k])
    assert dp["X_tr"].shape == (8611, 4) and dp["X_te"].shape == (957, 4)


def test_flagship_full_width_on_power_test_rows():
    # the served model at full width (M=100, 100 GH nodes) on the 957 power
    # test rows, fp64 on both sides
    d = p_load_uci_split("power", 1)
    spec_p = weights.flagship_spec(d["X_tr"].shape[0])
    pp = weights.flagship_params(spec_p, d["X_tr"], seed=0, device="cpu")
    fspec, _ = j_spec_from_list(jG.SAL(2))
    spec_j = JM.TGPSpec(Dy=1, Dx=4, M=100, N=8611.0,
                        kernel=jK.from_name("scale_rbf"),
                        likelihood=JLik("gaussian_flow", 1, quad_points=100),
                        flow=fspec)
    assert weights.spec_from_dict(jser.spec_to_dict(spec_j)) == spec_p
    pj = to_jax(pp)
    X, Y, Ys = d["X_te"], d["Y_te"], d["Y_std"]
    out_j = jax.jit(lambda p, x: JM.predictive_distribution(spec_j, p, x))(
        pj, jnp.asarray(X))
    out_p = PM.predictive_distribution(spec_p, pp, torch.as_tensor(X))
    for p, j in zip(out_p, out_j):
        assert p.shape == (1, 957) and np.isfinite(p.numpy()).all()
        close(p, j)
    lj = jax.jit(lambda p, x, y, s: JM.test_log_likelihood(
        spec_j, p, x, y, s, reduce=False))(pj, jnp.asarray(X), jnp.asarray(Y),
                                           jnp.asarray(Ys))
    lp = PM.test_log_likelihood(spec_p, pp, torch.as_tensor(X),
                                torch.as_tensor(Y), torch.as_tensor(Ys),
                                reduce=False)
    close(lp, lj)
