"""The port's kernels, means and Gaussian KL against the JAX package, on
the CPU, fp64.

Every kernel kind of `ops/kernels.py` (and products, sums and spectral
mixtures of them): `gram` at same=False and same=True, `gram_diag`, and the
port's recursive `gram_pair` against two JAX `gram` calls, in value and in
gradient (into every kernel parameter and both inputs).  Then the white
kernel's gating, the spectral-mixture init, both means (with the Trainer's
frozen labels), `kl_gaussian` and `batched_log_gaussian`.

Tolerance: rtol 1e-8, atol 1e-10 (the same float64 math on both sides, only
the order of sums differs).  matern12 is held on K(X, Z) only: exp(-r) with
r = sqrt(d2) carries the rounding of d2 ~ 1e-16 on a Gram's diagonal into
1e-8 of its value and 1e-7 of its gradient, in either package.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tgp.pytorch_tpu.likelihoods import LikelihoodSpec as JLik
from tgp.pytorch_tpu.models import means as jmeans, serialization as jser, tgp as JM
from tgp.pytorch_tpu.ops import kernels as jK, linalg as jla
from tgp.pytorch_tpu.train.trainer import frozen_param_labels as j_frozen

from tgp.pytorch_tpu_torch import config as pcfg, weights
from tgp.pytorch_tpu_torch.models import means as pmeans
from tgp.pytorch_tpu_torch.ops import kernels as pK, linalg as pla
from tgp.pytorch_tpu_torch.train.trainer import frozen_param_labels

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


def port_spec(k):
    return pK.KernelSpec(k.kind, tuple(port_spec(c) for c in k.children), k.ard)


KERNELS = {
    "rbf": jK.rbf(),
    "scale_rbf": jK.scale(jK.rbf()),
    "matern12": jK.matern(0.5),
    "matern32": jK.matern(1.5),
    "matern52": jK.matern(2.5),
    "scale_matern32": jK.scale(jK.matern(1.5)),
    "periodic": jK.periodic(),
    "cosine": jK.cosine(),
    "white": jK.white(),
    "product": jK.product(jK.scale(jK.matern(2.5)), jK.periodic()),
    "additive": jK.additive(jK.rbf(), jK.white(), jK.cosine()),
    "spectral_mixture": jK.spectral_mixture(2),
    "sm": jK.spectral_mixture(2, base="cosine"),
    "nested": jK.additive(jK.product(jK.periodic(), jK.scale(jK.rbf())),
                          jK.scale(jK.additive(jK.matern(1.5), jK.rbf()))),
}
INIT = {"length_scale": 1.3, "kernel_scale": 0.7, "period": 1.9,
        "noisy_variance": 0.2}


def case(name, Dy=2, N=9, M=6, Dx=3, seed=4):
    """(JAX spec, port spec, JAX params, port params, X1, X2): the JAX
    package's init moved by 0.3 randn on every leaf."""
    rng = np.random.RandomState(seed)
    spec_j = KERNELS[name]
    pj = jK.init_params(spec_j, Dy, Dx, INIT, dtype=jnp.float64)
    pp = weights.params_from_jax(jax.tree_util.tree_map(np.asarray, pj),
                                 device="cpu", dtype=torch.float64)
    pp = weights.tree_map(lambda t: t + t64(0.3 * rng.randn(*t.shape)), pp)
    pj = weights.tree_map(lambda t: jnp.asarray(t.numpy()), pp)
    return (spec_j, port_spec(spec_j), pj, pp, rng.randn(Dy, N, Dx),
            rng.randn(Dy, M, Dx))


@pytest.mark.parametrize("name", sorted(KERNELS))
def test_spec_and_params_match(name):
    spec_j, spec_p, *_ = case(name)
    assert port_spec(spec_j) == spec_p
    pj = jK.init_params(spec_j, 2, 3, INIT, dtype=jnp.float64)
    pp = pK.init_params(spec_p, 2, 3, INIT, device="cpu")
    jl, pl = jax.tree_util.tree_leaves(pj), weights.tree_leaves(pp)
    assert len(jl) == len(pl) > 0
    for a, b in zip(pl, jl):
        close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("name", sorted(KERNELS))
def test_gram_diag_and_pair_match_in_value(name):
    spec_j, spec_p, pj, pp, X1, X2 = case(name)
    Kxz, diag, diag0, Kxx, Kzz = jax.jit(lambda p, A, B: (
        jK.gram(spec_j, p, A, B), jK.gram_diag(spec_j, p, A),
        jK.gram_diag(spec_j, p, A, same=False),
        jK.gram(spec_j, p, A, A, same=True), jK.gram(spec_j, p, B, B)))(
        pj, jnp.asarray(X1), jnp.asarray(X2))
    A, B = t64(X1), t64(X2)
    pairs = [(pK.gram(spec_p, pp, A, B), Kxz), (pK.gram_diag(spec_p, pp, A), diag),
             (pK.gram_diag(spec_p, pp, A, same=False), diag0)]
    if name != "matern12":
        pairs += [(pK.gram(spec_p, pp, A, A, same=True), Kxx),
                  *zip(pK.gram_pair(spec_p, pp, A, B), (Kxz, Kzz))]
    for got, want in pairs:
        close(got, want)


@pytest.mark.parametrize("name", sorted(KERNELS))
def test_gram_pair_matches_in_gradient(name):
    """The weighted sum of K(X, Z) and K(Z, Z) (K(X, Z) alone for
    matern12) and of K(X, X) at same=True, differentiated into every
    kernel parameter, X and Z."""
    spec_j, spec_p, pj, pp, X1, X2 = case(name)
    rng = np.random.RandomState(7)
    w1, w2, w3 = rng.randn(2, 9, 6), rng.randn(2, 6, 6), rng.randn(2, 9, 9)
    zz = 0.0 if name == "matern12" else 1.0

    def ref(p, A, B):
        return (jnp.sum(w1 * jK.gram(spec_j, p, A, B))
                + zz * jnp.sum(w2 * jK.gram(spec_j, p, B, B))
                + zz * jnp.sum(w3 * jK.gram(spec_j, p, A, A, same=True)))

    gj = jax.jit(jax.grad(ref, argnums=(0, 1, 2)))(pj, jnp.asarray(X1),
                                                    jnp.asarray(X2))
    leaves = weights.tree_map(lambda t: t.clone().requires_grad_(True), pp)
    A, B = t64(X1).requires_grad_(True), t64(X2).requires_grad_(True)
    Kxz, Kzz = pK.gram_pair(spec_p, leaves, A, B)
    loss = (t64(w1) * Kxz).sum() + zz * (t64(w2) * Kzz).sum() \
        + zz * (t64(w3) * pK.gram(spec_p, leaves, A, A, same=True)).sum()
    pl = weights.tree_leaves(leaves)
    *gp, gA, gB = torch.autograd.grad(loss, pl + [A, B], allow_unused=True,
                                      materialize_grads=True)
    jl = jax.tree_util.tree_leaves(gj[0])
    assert len(pl) == len(jl) > 0
    for a, b in zip(gp, jl):
        close(a, b)
    close(gA, gj[1])
    close(gB, gj[2])


def test_white_kernel_adds_noise_only_to_kxx():
    spec = pK.white()
    pp = pK.init_params(spec, 2, 3, {"noisy_variance": 0.3}, device="cpu")
    X = t64(np.random.RandomState(0).randn(2, 5, 3))
    Kxx = pK.gram(spec, pp, X, X, same=True)
    close(Kxx, 0.3 * np.eye(5)[None].repeat(2, 0))
    for K in (pK.gram(spec, pp, X, X), pK.gram(spec, pp, X, X[:, :4], same=True),
              *pK.gram_pair(spec, pp, X, X[:, :4])):
        assert not K.any()
    close(pK.gram_diag(spec, pp, X), np.full((2, 5), 0.3))
    assert not pK.gram_diag(spec, pp, X, same=False).any()
    # in a sum, K_zz of the pair carries no noise and K_xx does
    spec = pK.additive(pK.rbf(), pK.white())
    pp = pK.init_params(spec, 2, 3, {"noisy_variance": 0.3}, device="cpu")
    Kxz, Kzz = pK.gram_pair(spec, pp, X, X)
    close(Kzz, pK.gram(pK.rbf(), pp["children"][0], X, X))
    close(pK.gram(spec, pp, X, X, same=True) - Kzz, 0.3 * np.eye(5)[None].repeat(2, 0))


def test_from_name_table_and_spectral_mixture_init():
    for name in ("rbf", "scale_rbf", "matern32", "scale_matern32", "matern52",
                 "scale_matern52", "whitenoise", "periodic", "cosine"):
        assert pK.from_name(name) == port_spec(jK.from_name(name))
    with pytest.raises(NotImplementedError, match="unknown kernel"):
        pK.from_name("spectral")
    for base in ("periodic", "cosine"):
        spec_j = jK.spectral_mixture(3, base=base)
        spec_p = pK.spectral_mixture(3, base=base)
        assert spec_p == port_spec(spec_j)
        args = ([0.3, 1.2, 2.5], [1.2, 4.8, 10.0], [0.5, 0.3, 0.05])
        pj = jK.init_spectral_mixture_params(spec_j, 2, 1, *args,
                                             dtype=jnp.float64)
        pp = pK.init_spectral_mixture_params(spec_p, 2, 1, *args, device="cpu")
        jl, pl = jax.tree_util.tree_leaves(pj), weights.tree_leaves(pp)
        assert len(jl) == len(pl) == 3 * (4 if base == "periodic" else 3)
        for a, b in zip(pl, jl):
            close(a, b, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# means
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("Dy, Dx", [(3, 3), (4, 2), (2, 5)])
def test_projection_and_means_match(Dy, Dx):
    rng = np.random.RandomState(1)
    X = rng.randn(20, Dx)
    np.testing.assert_array_equal(pmeans.projection_matrix(Dx, Dy, X),
                                  jmeans.projection_matrix(Dx, Dy, X))
    X3 = rng.randn(Dy, 7, Dx)
    for kind in ("zero", "identity", "linear"):
        pj = jmeans.mean_init(kind, Dy, Dx, X=X, dtype=jnp.float64, seed=3)
        pp = pmeans.mean_init(kind, Dy, Dx, X=X, device="cpu", seed=3)
        assert sorted(pp) == sorted(pj)
        for k in pj:
            close(pp[k], pj[k], rtol=0, atol=0)
        # value and gradient of the mean into its parameters and X
        w = rng.randn(Dy, 7)
        gj = jax.grad(lambda p, x: jnp.sum(w * jmeans.mean_apply(kind, p, x)),
                      argnums=(0, 1))(pj, jnp.asarray(X3))
        leaves = {k: v.clone().requires_grad_(True) for k, v in pp.items()}
        x = t64(X3).requires_grad_(True)
        out = pmeans.mean_apply(kind, leaves, x)
        close(out, jmeans.mean_apply(kind, pj, jnp.asarray(X3)))
        gx, *gp = torch.autograd.grad(
            (t64(w) * out).sum() + 0.0 * x.sum(), [x] + list(leaves.values()))
        close(gx, gj[1])
        for k, g in zip(leaves, gp):
            close(g, gj[0][k])
    # the linear mean's slopes are numpy's draw from the config seed
    np.testing.assert_array_equal(
        pmeans.mean_init("linear", Dy, Dx, device="cpu")["a"].numpy(),
        np.random.RandomState(pcfg.config_seed).randn(Dy, Dx))


def test_identity_mean_projection_is_frozen_as_in_jax():
    rng = np.random.RandomState(2)
    X = rng.randn(30, 3)
    spec_j = JM.TGPSpec(Dy=2, Dx=3, M=4, N=30.0, kernel=jK.scale(jK.rbf()),
                        likelihood=JLik("gaussian", 2), mean="identity")
    pj = JM.init_tgp_params(spec_j, X, X[:4], dtype=jnp.float64)
    spec_p = weights.spec_from_dict(jser.spec_to_dict(spec_j))
    pp = weights.params_from_jax(jax.tree_util.tree_map(np.asarray, pj),
                                 device="cpu", dtype=torch.float64)
    fj = jax.tree_util.tree_leaves(j_frozen(spec_j, pj))
    fp = weights.tree_leaves(frozen_param_labels(spec_p, pp))
    assert fp == fj and sum(fp) == 1
    frozen = [leaf for leaf, f in zip(weights.tree_leaves(pp), fp) if f]
    assert frozen[0] is pp["mean"]["W"]


# ---------------------------------------------------------------------------
# the unwhitened KL and the diagonal Gaussian density
# ---------------------------------------------------------------------------

def test_kl_gaussian_matches_in_value_and_gradient():
    rng = np.random.RandomState(3)
    Dy, M = 2, 6
    m_q, m_p = rng.randn(Dy, M), rng.randn(Dy, M)
    Lq = np.tril(0.3 * rng.randn(Dy, M, M)) + np.eye(M)
    A = rng.randn(Dy, M, M)
    K = A @ A.transpose(0, 2, 1) / M + 0.1 * np.eye(M)
    w = rng.randn(Dy)
    ins = (m_q, Lq, m_p, K)
    gj = jax.jit(jax.grad(lambda *a: jnp.sum(w * jla.kl_gaussian(*a)),
                          argnums=(0, 1, 2, 3)))(*map(jnp.asarray, ins))
    leaves = [t64(a).requires_grad_(True) for a in ins]
    kl = pla.kl_gaussian(*leaves)
    close(kl, jax.jit(jla.kl_gaussian)(*map(jnp.asarray, ins)))
    (kl * t64(w)).sum().backward()
    for leaf, g in zip(leaves, gj):
        close(leaf.grad, g)
    # with the factor handed in, the same value
    L = pla.safe_cholesky(t64(K))[0]
    close(pla.kl_gaussian(*map(t64, ins), L_p=L), kl.detach())


@pytest.mark.parametrize("inverse", [False, True])
def test_batched_log_gaussian_matches(inverse):
    rng = np.random.RandomState(4)
    obs, mean = rng.randn(3, 8), rng.randn(3, 8)
    cov = rng.rand(3, 8) + 0.2
    w = rng.randn(3)
    gj = jax.jit(jax.grad(lambda *a: jnp.sum(w * jla.batched_log_gaussian(
        *a, cov_is_inverse=inverse)), argnums=(0, 1, 2)))(
        *map(jnp.asarray, (obs, mean, cov)))
    leaves = [t64(a).requires_grad_(True) for a in (obs, mean, cov)]
    out = pla.batched_log_gaussian(*leaves, cov_is_inverse=inverse)
    close(out, jla.batched_log_gaussian(*map(jnp.asarray, (obs, mean, cov)),
                                        cov_is_inverse=inverse))
    (out * t64(w)).sum().backward()
    for leaf, g in zip(leaves, gj):
        close(leaf.grad, g)
