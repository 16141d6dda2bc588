"""The port's Gram pair and its gradients against the JAX package, on the CPU.

Inputs come from numpy seeds and go through both packages.  Tolerances:
  * fp64: rtol 1e-8, atol 1e-10 — both sides run the same math in float64
    (LAPACK on both sides for the factorisations); only the order of sums
    differs.
  * fp32 plain pair against the Pallas kernel in interpret mode: rtol = atol
    = 2e-5, the tolerance of tests/test_pallas.py.
The CUDA kernels themselves run only on the card: tests/test_torch_port_cuda.py.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tgp.pytorch_tpu.models import tgp as JM
from tgp.pytorch_tpu.ops import kernels as jK
from tgp.pytorch_tpu.ops.pallas import rbf_gram as jrbf
from tgp.pytorch_tpu.likelihoods import LikelihoodSpec as JLik
from tgp.pytorch_tpu.flows import generators as jG, spec_from_list as j_spec_from_list

from tgp.pytorch_tpu_torch import config as pcfg, weights
from tgp.pytorch_tpu_torch.data.uci import load_uci_split
from tgp.pytorch_tpu_torch.models import tgp as PM
from tgp.pytorch_tpu_torch.ops import kernels as pK, rbf_gram as prbf

F64 = dict(rtol=1e-8, atol=1e-10)
F32_GRAM = dict(rtol=2e-5, atol=2e-5)


@pytest.fixture(autouse=True)
def _port_state():
    """Port precision fp64 for the test; torch's default dtype untouched."""
    prev, dt = pcfg.precision(), torch.get_default_dtype()
    pcfg.set_precision("fp64")
    yield
    pcfg.set_precision(prev)
    assert torch.get_default_dtype() == dt


@pytest.fixture
def interpret():
    jrbf.INTERPRET = jax.default_backend() != "tpu"
    yield
    jrbf.INTERPRET = False


def t64(a):
    return torch.as_tensor(np.asarray(a, np.float64))


def close(port, ref, **tol):
    np.testing.assert_allclose(port.detach().cpu().numpy(), np.asarray(ref),
                               **(tol or F64))


def named_leaves(tree, prefix=""):
    """(dotted name, leaf) of a params tree, dict keys sorted, for either
    package's tree."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from named_leaves(tree[k], f"{prefix}{k}.")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from named_leaves(v, f"{prefix}{i}.")
    else:
        yield prefix[:-1], tree


def _kernel_params(name, Dy, Dx, seed=5):
    """The same kernel params for both packages, ARD lengthscales perturbed
    so that each dimension differs."""
    init = {"length_scale": 1.3, "kernel_scale": 0.7}
    pp = pK.init_params(pK.from_name(name), Dy, Dx, init, device="cpu")
    delta = t64(0.3 * np.random.RandomState(seed).randn(Dy, Dx))
    if name == "scale_rbf":
        pp["child"]["raw_lengthscale"] = pp["child"]["raw_lengthscale"] + delta
    else:
        pp["raw_lengthscale"] = pp["raw_lengthscale"] + delta
    return pp, weights.tree_map(lambda t: jnp.asarray(t.numpy()), pp)


# ---------------------------------------------------------------------------
# the pair
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["rbf", "scale_rbf"])
def test_gram_pair_matches_two_jax_grams(name):
    rng = np.random.RandomState(4)
    X, Z = rng.randn(2, 9, 3), rng.randn(2, 6, 3)
    pp, jp = _kernel_params(name, 2, 3)
    Kxz, Kzz = pK.gram_pair(pK.from_name(name), pp, t64(X), t64(Z))
    spec_j = jK.from_name(name)
    close(Kxz, jK.gram(spec_j, jp, jnp.asarray(X), jnp.asarray(Z)))
    close(Kzz, jK.gram(spec_j, jp, jnp.asarray(Z), jnp.asarray(Z)))


@pytest.mark.parametrize("shape", [(2, 96, 40, 5), (1, 131, 77, 3),
                                   (1, 256, 100, 4)])
def test_plain_pair_matches_pallas_interpret(interpret, shape):
    Dy, N, M, Dx = shape
    rng = np.random.RandomState(0)
    X = rng.randn(Dy, N, Dx).astype(np.float32)
    Z = rng.randn(Dy, M, Dx).astype(np.float32)
    ks = (rng.rand(Dy) + 0.5).astype(np.float32)
    Kxz, Kzz = prbf.rbf_gram_pair(*map(torch.as_tensor, (X, Z, ks)))
    assert Kxz.dtype == Kzz.dtype == torch.float32
    assert Kxz.shape == (Dy, N, M) and Kzz.shape == (Dy, M, M)
    Xj, Zj, ksj = map(jnp.asarray, (X, Z, ks))
    close(Kxz, jrbf.rbf_gram_pallas(Xj, Zj, ksj), **F32_GRAM)
    close(Kzz, jrbf.rbf_gram_pallas(Zj, Zj, ksj), **F32_GRAM)


def _pair_vjp_case(seed=6):
    rng = np.random.RandomState(seed)
    Xs, Zs = rng.randn(2, 13, 4), rng.randn(2, 7, 4)
    ks = rng.rand(2) + 0.5
    g_xz, g_zz = rng.randn(2, 13, 7), rng.randn(2, 7, 7)
    return Xs, Zs, ks, g_xz, g_zz


def _jax_pair(Xs, Zs, ks):
    def gram(A, B):
        return ks[:, None, None] * jnp.exp(-0.5 * jK._sq_dist(A, B))
    return gram(Xs, Zs), gram(Zs, Zs)


def test_pair_bwd_matches_jax_vjp():
    # the backward kernel's plain version: dZ sums K_xz's column gradient
    # and K_zz's row and column gradients
    Xs, Zs, ks, g_xz, g_zz = _pair_vjp_case()
    _, vjp = jax.vjp(_jax_pair, *map(jnp.asarray, (Xs, Zs, ks)))
    ref = vjp((jnp.asarray(g_xz), jnp.asarray(g_zz)))
    Ks = prbf.rbf_gram_pair_reference(t64(Xs), t64(Zs), t64(ks))
    port = prbf.rbf_gram_pair_bwd(t64(Xs), t64(Zs), t64(ks), *Ks, t64(g_xz),
                                  t64(g_zz))
    for p, r in zip(port, ref):
        close(p, r)


@pytest.mark.parametrize("name", ["rbf", "scale_rbf"])
def test_gram_pair_gradients_match_jax(name):
    # autograd through gram_pair (the lengthscale and output scale included)
    # against jax.vjp of the two JAX Grams
    rng = np.random.RandomState(7)
    X, Z = rng.randn(2, 11, 3), rng.randn(2, 5, 3)
    g_xz, g_zz = rng.randn(2, 11, 5), rng.randn(2, 5, 5)
    pp, jp = _kernel_params(name, 2, 3)
    spec_p, spec_j = pK.from_name(name), jK.from_name(name)

    def jax_pair(X, Z, p):
        return (jK.gram(spec_j, p, X, Z), jK.gram(spec_j, p, Z, Z))

    _, vjp = jax.vjp(jax_pair, jnp.asarray(X), jnp.asarray(Z), jp)
    dX_j, dZ_j, dp_j = vjp((jnp.asarray(g_xz), jnp.asarray(g_zz)))

    Xt, Zt = t64(X).requires_grad_(True), t64(Z).requires_grad_(True)
    pp = weights.tree_map(lambda t: t.clone().requires_grad_(True), pp)
    Kxz, Kzz = pK.gram_pair(spec_p, pp, Xt, Zt)
    ((Kxz * t64(g_xz)).sum() + (Kzz * t64(g_zz)).sum()).backward()
    close(Xt.grad, dX_j)
    close(Zt.grad, dZ_j)
    for (n, leaf), (m, ref) in zip(named_leaves(pp), named_leaves(dp_j)):
        assert n == m
        close(leaf.grad, ref)


# ---------------------------------------------------------------------------
# the slice: the gradient of the flagship's test log-likelihood
# ---------------------------------------------------------------------------

def test_flagship_gradient_matches_jax_grad():
    # full width (M=100, 100 GH nodes, the SAL 2 flow) on 300 power training
    # rows; the gradient into every parameter, fp64 on both sides.  The
    # objective is the mean log-likelihood per row, so that its gradient is
    # O(1) and atol 1e-10 means what it means for the values; the summed
    # objective's gradient reaches 2e3, where entries whose terms cancel to
    # 1e-3 carry fp64 rounding of the larger terms (8e-10, 3e-12 of the
    # largest entry).
    d = load_uci_split("power", 1)
    n = 300
    X, Y, Ys = d["X_tr"][:n], d["Y_tr"][:n], d["Y_std"]
    spec_p = weights.flagship_spec(d["X_tr"].shape[0])
    pp = weights.flagship_params(spec_p, d["X_tr"], seed=0, device="cpu")
    fspec, _ = j_spec_from_list(jG.SAL(2))
    spec_j = JM.TGPSpec(Dy=1, Dx=4, M=100, N=8611.0,
                        kernel=jK.from_name("scale_rbf"),
                        likelihood=JLik("gaussian_flow", 1, quad_points=100),
                        flow=fspec)
    pj = weights.tree_map(lambda t: jnp.asarray(t.numpy()), pp)
    Xj, Yj, Ysj = map(jnp.asarray, (X, Y, Ys))
    lj, gj = jax.jit(jax.value_and_grad(
        lambda p: jnp.sum(JM.test_log_likelihood(spec_j, p, Xj, Yj, Ysj)) / n))(pj)

    pp = weights.tree_map(lambda t: t.clone().requires_grad_(True), pp)
    lp = PM.test_log_likelihood(spec_p, pp, t64(X), t64(Y), t64(Ys)).sum() / n
    lp.backward()
    close(lp, lj)
    names = []
    for (n, leaf), (m, ref) in zip(named_leaves(pp), named_leaves(gj)):
        assert n == m and leaf.grad is not None, n
        assert np.abs(np.asarray(ref)).max() > 0, n      # every leaf is live
        close(leaf.grad, ref)
        names.append(n)
    assert {"Z", "q_mu", "q_L", "kernel.raw_outputscale",
            "kernel.child.raw_lengthscale", "likelihood.log_var_noise"} \
        <= set(names)
