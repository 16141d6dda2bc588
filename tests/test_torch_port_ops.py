"""The PyTorch port's ops against the JAX package, on the CPU.

Inputs come from numpy seeds and go through both the JAX function and its
port.  Tolerances:
  * fp64: rtol 1e-8, atol 1e-10 — both sides run the same math in float64
    (LAPACK on both sides for the factorisations); only the order of sums
    differs.
  * fp32 plain Gram against the Pallas kernel in interpret mode: rtol = atol
    = 2e-5, the tolerance of tests/test_pallas.py.
  * fp32 VJP of the Pallas kernel: rtol = atol = 1e-4, the tolerance of
    tests/test_pallas.py's custom-VJP test.
The CUDA kernel itself runs only on the card: tests/test_torch_port_cuda.py.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tgp.pytorch_tpu.ops import transforms as jtr, quadrature as jquad
from tgp.pytorch_tpu.ops import linalg as jla, kernels as jK
from tgp.pytorch_tpu.ops.pallas import rbf_gram as jrbf

from tgp.pytorch_tpu_torch import config as pcfg
from tgp.pytorch_tpu_torch.ops import transforms as ptr, quadrature as pquad
from tgp.pytorch_tpu_torch.ops import linalg as pla, kernels as pK
from tgp.pytorch_tpu_torch.ops import rbf_gram as prbf

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


# ---------------------------------------------------------------------------
# transforms and quadrature
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_transforms_match(dtype):
    rng = np.random.RandomState(0)
    x = np.concatenate([rng.randn(50) * 10, [-400.0, -35.0, 25.0, 35.0, 400.0]])
    x = x.astype(dtype)
    xt = torch.as_tensor(x)
    tol = F64 if dtype == "float64" else dict(rtol=1e-6, atol=1e-6)
    close(ptr.softplus(xt), jtr.softplus(jnp.asarray(x)), **tol)
    close(ptr.safe_sinh(xt), jtr.safe_sinh(jnp.asarray(x)), **tol)
    close(ptr.safe_exp(xt), jtr.safe_exp(jnp.asarray(x)), **tol)
    close(ptr.safe_tanh(xt), jtr.safe_tanh(jnp.asarray(x)), **tol)
    pos = np.abs(x[:50]) + 0.1
    post = torch.as_tensor(pos)
    close(ptr.inv_softplus(post), jtr.inv_softplus(jnp.asarray(pos)), **tol)
    for kind in ("exp", "softplus"):
        close(ptr.positive(xt[:50], kind), jtr.positive(jnp.asarray(x[:50]), kind),
              **tol)
        close(ptr.inverse_positive(post, kind),
              jtr.inverse_positive(jnp.asarray(pos), kind), **tol)
        close(ptr.positive(ptr.inverse_positive(post, kind), kind), pos, **tol)
    np.testing.assert_array_equal(ptr.np_inv_softplus(pos),
                                  jtr.np_inv_softplus(pos))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_safe_sinh_derivative_matches_custom_jvp(dtype):
    # inside the clip: sqrt(1 + sinh^2); outside: exactly 0
    x = np.array([-400.0, -31.0, -5.0, -0.3, 0.0, 0.7, 12.0, 29.0, 31.0, 400.0],
                 dtype)
    xt = torch.as_tensor(x).requires_grad_(True)
    ptr.safe_sinh(xt).sum().backward()
    gj = jax.grad(lambda v: jnp.sum(jtr.safe_sinh(v)))(jnp.asarray(x))
    tol = F64 if dtype == "float64" else dict(rtol=1e-6, atol=1e-6)
    close(xt.grad, gj, **tol)
    assert np.isfinite(xt.grad.numpy()).all()


@pytest.mark.parametrize("n", [5, 100])
def test_gauss_hermite_matches(n):
    rng = np.random.RandomState(1)
    mu, var = rng.randn(2, 7), rng.rand(2, 7) + 0.1
    gj, gp = jquad.GaussHermite(n), pquad.GaussHermite(n)
    fj = gj.shifted_locations(jnp.asarray(mu), jnp.asarray(var))
    fp = gp.shifted_locations(t64(mu), t64(var))
    close(fp, fj)
    close(gp.reduce(torch.sin(fp)), gj.reduce(jnp.sin(fj)))


# ---------------------------------------------------------------------------
# linear algebra
# ---------------------------------------------------------------------------

def _spd_with_min_eig(M, min_eigs, seed=0):
    """Batch of symmetric matrices with prescribed smallest eigenvalues."""
    rng = np.random.RandomState(seed)
    out = []
    for lam_min in min_eigs:
        Q, _ = np.linalg.qr(rng.randn(M, M))
        lam = np.concatenate([[lam_min], np.linspace(0.5, 3.0, M - 1)])
        A = (Q * lam) @ Q.T
        out.append(0.5 * (A + A.T))
    return np.stack(out)


def test_add_jitter_matches():
    A = _spd_with_min_eig(6, [0.1, 0.2])
    close(pla.add_jitter(t64(A)), jla.add_jitter(jnp.asarray(A)))
    close(pla.add_jitter(t64(A), 1e-3), jla.add_jitter(jnp.asarray(A), 1e-3))
    A32 = A.astype(np.float32)
    close(pla.add_jitter(torch.as_tensor(A32)), jla.add_jitter(jnp.asarray(A32)),
          rtol=1e-6, atol=1e-7)


def test_safe_cholesky_ladder_rungs():
    # fp64 base jitter 1e-8: element 0 factorises at x1, element 1 needs the
    # 10x rung (min eig -5e-8), element 2 the 100x rung (min eig -5e-7)
    A = _spd_with_min_eig(8, [0.05, -5e-8, -5e-7])
    Lp, Ajp = pla.safe_cholesky(t64(A))
    Lj, Ajj = jla.safe_cholesky(jnp.asarray(A))
    close(Ajp, Ajj)
    close(Lp, Lj)
    jit = np.diagonal(Ajp.numpy() - A, axis1=-2, axis2=-1)[:, 0]
    np.testing.assert_allclose(jit, [1e-8, 1e-7, 1e-6], rtol=1e-6)
    assert np.isfinite(Lp.numpy()).all()


def test_safe_cholesky_explicit_jitter_and_gradient():
    A = _spd_with_min_eig(5, [0.3])
    close(pla.safe_cholesky(t64(A), 1e-4)[0],
          jla.safe_cholesky(jnp.asarray(A), 1e-4)[0])
    At = t64(A).requires_grad_(True)
    pla.safe_cholesky(At)[0].sum().backward()
    gj = jax.grad(lambda a: jnp.sum(jla.safe_cholesky(a)[0]))(jnp.asarray(A))
    close(At.grad, gj)


def test_triangular_solves_match():
    rng = np.random.RandomState(3)
    A = _spd_with_min_eig(6, [0.4, 0.2])
    L = np.linalg.cholesky(A)
    B = rng.randn(2, 6, 3)
    close(pla.tril_solve(t64(L), t64(B)), jla.tril_solve(jnp.asarray(L), jnp.asarray(B)))
    U = np.swapaxes(L, -1, -2)
    close(pla.triu_solve(t64(U), t64(B)), jla.triu_solve(jnp.asarray(U), jnp.asarray(B)))
    close(pla.cholesky_solve(t64(L), t64(B)),
          jla.cholesky_solve(jnp.asarray(L), jnp.asarray(B)))
    close(pla.tril_mask(t64(A)), jla.tril_mask(jnp.asarray(A)))


# ---------------------------------------------------------------------------
# Gram matrices
# ---------------------------------------------------------------------------

def _gram_case(Dy=2, N=9, M=6, Dx=3, seed=4):
    rng = np.random.RandomState(seed)
    return rng.randn(Dy, N, Dx), rng.randn(Dy, M, Dx)


@pytest.mark.parametrize("name", ["rbf", "scale_rbf"])
def test_gram_and_diag_match(name):
    X1, X2 = _gram_case()
    init = {"length_scale": 1.3, "kernel_scale": 0.7}
    jp = jK.init_params(jK.from_name(name), 2, 3, init, dtype=jnp.float64)
    pp = pK.init_params(pK.from_name(name), 2, 3, init, device="cpu")
    # perturb the ARD lengthscales so each dimension differs
    rng = np.random.RandomState(5)
    ls_key = ("child",) if name == "scale_rbf" else ()
    delta = 0.3 * rng.randn(2, 3)

    def bump(tree, conv):
        tree = dict(tree)
        if ls_key:
            tree["child"] = {"raw_lengthscale":
                             tree["child"]["raw_lengthscale"] + conv(delta)}
        else:
            tree["raw_lengthscale"] = tree["raw_lengthscale"] + conv(delta)
        return tree

    jp, pp = bump(jp, jnp.asarray), bump(pp, t64)
    spec_j, spec_p = jK.from_name(name), pK.from_name(name)
    close(pK.gram(spec_p, pp, t64(X1), t64(X2)),
          jK.gram(spec_j, jp, jnp.asarray(X1), jnp.asarray(X2)))
    close(pK.gram(spec_p, pp, t64(X1), t64(X1), same=True),
          jK.gram(spec_j, jp, jnp.asarray(X1), jnp.asarray(X1), same=True))
    close(pK.gram_diag(spec_p, pp, t64(X1)),
          jK.gram_diag(spec_j, jp, jnp.asarray(X1)))


@pytest.mark.parametrize("name", ["matern32", "periodic", "whitenoise"])
def test_unported_kernels_raise(name):
    # item 17 is ported: the named kernel is the JAX package's, and its
    # Grams (the white kernel's noise only at same=True) match JAX's
    assert pK.from_name(name) == pK.KernelSpec(jK.from_name(name).kind)
    X1, X2 = _gram_case()
    init = {"length_scale": 1.3, "period": 1.7, "noisy_variance": 0.2}
    jp = jK.init_params(jK.from_name(name), 2, 3, init, dtype=jnp.float64)
    pp = pK.init_params(pK.from_name(name), 2, 3, init, device="cpu")
    spec_j, spec_p = jK.from_name(name), pK.from_name(name)
    for A, B, same in ((X1, X2, False), (X1, X1, True), (X1, X1, False)):
        close(pK.gram(spec_p, pp, t64(A), t64(B), same=same),
              jK.gram(spec_j, jp, jnp.asarray(A), jnp.asarray(B), same=same))
    close(pK.gram_diag(spec_p, pp, t64(X1)),
          jK.gram_diag(spec_j, jp, jnp.asarray(X1)))


@pytest.mark.parametrize("shape", [(2, 96, 40, 5), (1, 131, 77, 3),
                                   (1, 100, 100, 4)])
def test_plain_gram_matches_pallas_interpret(interpret, shape):
    Dy, N, M, Dx = shape
    rng = np.random.RandomState(0)
    X1 = rng.randn(Dy, N, Dx).astype(np.float32)
    X2 = rng.randn(Dy, M, Dx).astype(np.float32)
    ks = (rng.rand(Dy) + 0.5).astype(np.float32)
    ref = jrbf.rbf_gram_pallas(jnp.asarray(X1), jnp.asarray(X2), jnp.asarray(ks))
    out = prbf.rbf_gram_reference(torch.as_tensor(X1), torch.as_tensor(X2),
                                  torch.as_tensor(ks))
    assert out.dtype == torch.float32 and out.shape == (Dy, N, M)
    close(out, ref, **F32_GRAM)


def _bwd_case(dtype, seed=6):
    rng = np.random.RandomState(seed)
    X1 = rng.randn(2, 13, 4).astype(dtype)
    X2 = rng.randn(2, 7, 4).astype(dtype)
    ks = (rng.rand(2) + 0.5).astype(dtype)
    g = rng.randn(2, 13, 7).astype(dtype)
    return X1, X2, ks, g


def test_bwd_transcription_matches_jax_bwd_fp64():
    X1, X2, ks, g = _bwd_case(np.float64)
    K = prbf.rbf_gram_reference(t64(X1), t64(X2), t64(ks))
    port = prbf.rbf_gram_bwd(t64(X1), t64(X2), t64(ks), K, t64(g))
    ref = jrbf._bwd((jnp.asarray(X1), jnp.asarray(X2), jnp.asarray(ks),
                     jnp.asarray(K.numpy())), jnp.asarray(g))
    for p, r in zip(port, ref):
        close(p, r)


def test_bwd_transcription_matches_pallas_vjp_fp32(interpret):
    X1, X2, ks, g = _bwd_case(np.float32)
    _, vjp = jax.vjp(jrbf.rbf_gram_pallas, jnp.asarray(X1), jnp.asarray(X2),
                     jnp.asarray(ks))
    ref = vjp(jnp.asarray(g))
    tX1, tX2, tks = map(torch.as_tensor, (X1, X2, ks))
    K = prbf.rbf_gram_reference(tX1, tX2, tks)
    port = prbf.rbf_gram_bwd(tX1, tX2, tks, K, torch.as_tensor(g))
    for p, r in zip(port, ref):
        close(p, r, rtol=1e-4, atol=1e-4)


def test_bwd_transcription_is_the_autograd_vjp():
    X1, X2, ks, g = _bwd_case(np.float64)
    leaves = [t64(a).requires_grad_(True) for a in (X1, X2, ks)]
    K = prbf.rbf_gram_reference(*leaves)
    K.backward(t64(g))
    port = prbf.rbf_gram_bwd(*[t.detach() for t in leaves], K.detach(), t64(g))
    for p, leaf in zip(port, leaves):
        close(p, leaf.grad.numpy())


def test_cpu_tensors_take_the_plain_version_and_never_launch():
    X1, X2 = _gram_case()
    ks = np.array([0.9, 1.4])
    before = prbf.LAUNCHES
    out = prbf.rbf_gram(t64(X1), t64(X2), t64(ks))
    close(out, prbf.rbf_gram_reference(t64(X1), t64(X2), t64(ks)).numpy())
    assert prbf.LAUNCHES == before
    with pytest.raises(ValueError, match="CUDA"):
        prbf._launch(t64(X1), t64(X2), t64(ks))


def test_triangular_solves_in_column_blocks_equal_one_solve(monkeypatch):
    """A right-hand side wider than `TRSM_COLUMNS` (over the batch) is
    solved in column blocks: the values and gradients of one solve, to
    rounding (the CPU's trsm blocks its work by the width it is given)."""
    from tgp.pytorch_tpu_torch.ops import linalg as la

    g = torch.Generator().manual_seed(0)
    A = torch.randn(3, 6, 6, generator=g, dtype=torch.float64)
    L = torch.linalg.cholesky(A @ A.transpose(-1, -2) + 6 * torch.eye(6,
                                                                      dtype=torch.float64))
    B = torch.randn(3, 6, 1000, generator=g, dtype=torch.float64,
                    requires_grad=True)
    whole = [la.tril_solve(L, B), la.triu_solve(L.transpose(-1, -2), B)]
    monkeypatch.setattr(la, "TRSM_COLUMNS", 700)       # blocks of 233 columns
    blocks = [la.tril_solve(L, B), la.triu_solve(L.transpose(-1, -2), B)]
    for a, b in zip(whole, blocks):
        np.testing.assert_allclose(b.detach().numpy(), a.detach().numpy(),
                                   rtol=1e-13, atol=1e-15)
        ga, gb = (torch.autograd.grad(torch.sin(x).sum(), B)[0] for x in (a, b))
        np.testing.assert_allclose(gb.numpy(), ga.numpy(), rtol=1e-13,
                                   atol=1e-15)
