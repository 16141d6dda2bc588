"""The port's flows, initializers, k-means, loaders and weights against the
JAX package (and scikit-learn), on the CPU in fp64.

Inputs come from numpy seeds and go through both packages.  Tolerances:
  * every step kind's value and gradient, the model's warp, the inverses
    (analytic and Newton): rtol 1e-8, atol 1e-10 (the same float64 math);
  * generator lists and arch tables: equal;
  * `fit_flow_to_identity` after 50 epochs and `gaussianize` after 20:
    rtol 1e-8, atol 1e-10 (measured: 1e-15 relative);
  * `kmeans_centers` against scikit-learn's centers, both sorted by rows:
    atol 1e-10 (measured: 4e-15 on boston and power split 1 at M=5 and
    M=100, every case matched);
  * the loaders: equal arrays.
"""

import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tgp.pytorch_tpu.data import return_dataset as j_return_dataset
from tgp.pytorch_tpu.flows import core as jcore, generators as jG
from tgp.pytorch_tpu.flows import initializers as jinit
from tgp.pytorch_tpu.likelihoods import LikelihoodSpec as JLik
from tgp.pytorch_tpu.models import serialization as jser, tgp as JM
from tgp.pytorch_tpu.ops import kernels as jK

from tgp.pytorch_tpu_torch import config as pcfg, weights
from tgp.pytorch_tpu_torch.data import kmeans_centers, return_dataset
from tgp.pytorch_tpu_torch.experiments import exp_config as PEC
from tgp.pytorch_tpu_torch.experiments import flow_arch as PFA
from tgp.pytorch_tpu_torch.flows import core as pcore, generators as pG
from tgp.pytorch_tpu_torch.flows import initializers as pinit
from tgp.pytorch_tpu_torch.likelihoods import LikelihoodSpec as PLik
from tgp.pytorch_tpu_torch.models import tgp as PM
from tgp.pytorch_tpu_torch.ops import kernels as pK

from test_torch_port_large import jax_native_parser

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "experiments"))
import exp_config as JEC          # noqa: E402
import flow_arch as JFA           # noqa: E402

F64 = dict(rtol=1e-8, atol=1e-10)
UCI9 = ["boston", "concrete", "energy", "kin8nm", "naval", "power", "protein",
        "wine_red", "wine_white"]


@pytest.fixture(autouse=True)
def _port_state():
    """Port precision fp64 for the test; torch's default dtype, its thread
    count and numpy's global RNG state as they were."""
    prev, dt, nt = pcfg.precision(), torch.get_default_dtype(), torch.get_num_threads()
    np_state = np.random.get_state()
    pcfg.set_precision("fp64")
    yield
    pcfg.set_precision(prev)
    torch.set_num_threads(nt)
    np.random.set_state(np_state)
    assert torch.get_default_dtype() == dt


def close(port, ref, **tol):
    port = port.detach().cpu().numpy() if torch.is_tensor(port) else port
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref), **(tol or F64))


def to_port_step(js):
    """The port's FlowStep with the JAX step's fields."""
    return pcore.FlowStep(js.kind, js.set_restrictions, js.add_init_f0,
                          js.input_dependent, js.hypernet, js.constraint,
                          js.learnable, js.n_terms,
                          tuple(to_port_step(s) for s in js.sub))


def perturbed_params(jstep, seed, scale=0.3):
    """JAX default params of `jstep` moved by scale * randn: (jax tree,
    numpy tree)."""
    rs = np.random.RandomState(seed)
    p = jcore.init_flow_params((jstep,), None, jax.random.PRNGKey(0),
                               jnp.float64)[0]
    np_tree = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + scale * rs.randn(*np.shape(a)), p)
    return jax.tree_util.tree_map(jnp.asarray, np_tree), np_tree


# ---------------------------------------------------------------------------
# every step kind, value and gradient
# ---------------------------------------------------------------------------

def _S(kind, **kw):
    return jcore.FlowStep(kind, **kw)


_GATED_SUB = (_S("boxcox", constraint="sigmoid_ref"), _S("tanh", set_restrictions=True),
              _S("sinh_arcsinh", set_restrictions=True), _S("inverseboxcox",
                                                             constraint="sigmoid2"))
STEP_CASES = {
    "identity": _S("identity"),
    "affine": _S("affine"),
    "affine/res": _S("affine", set_restrictions=True),
    "translation": _S("translation"),
    "sinh_arcsinh": _S("sinh_arcsinh"),
    "sinh_arcsinh/res": _S("sinh_arcsinh", set_restrictions=True),
    "sinh_arcsinh/f0": _S("sinh_arcsinh", set_restrictions=True, add_init_f0=True),
    "inverse_sinh_arcsinh/res": _S("inverse_sinh_arcsinh", set_restrictions=True),
    "inverse_sinh_arcsinh/f0": _S("inverse_sinh_arcsinh", set_restrictions=True,
                                  add_init_f0=True),
    "arcsinh/res": _S("arcsinh", set_restrictions=True),
    "arcsinh/f0": _S("arcsinh", set_restrictions=True, add_init_f0=True),
    "inverse_arcsinh/res": _S("inverse_arcsinh", set_restrictions=True),
    "sinh/res": _S("sinh", set_restrictions=True),
    "sinh/f0": _S("sinh", set_restrictions=True, add_init_f0=True),
    "tanh": _S("tanh"),
    "tanh/res": _S("tanh", set_restrictions=True),
    "tanh/f0": _S("tanh", set_restrictions=True, add_init_f0=True),
    "boxcox/none": _S("boxcox"),
    "boxcox/sigmoid2": _S("boxcox", constraint="sigmoid2"),
    "boxcox/sigmoid_ref/f0": _S("boxcox", constraint="sigmoid_ref",
                                add_init_f0=True, set_restrictions=True),
    "inverseboxcox/none": _S("inverseboxcox"),
    "inverseboxcox/sigmoid2": _S("inverseboxcox", constraint="sigmoid2"),
    "inverseboxcox/sigmoid_ref/f0": _S("inverseboxcox", constraint="sigmoid_ref",
                                       add_init_f0=True, set_restrictions=True),
    "tukey_left": _S("tukey_left"),
    "tukey_right": _S("tukey_right"),
    "tukey_right/f0": _S("tukey_right", add_init_f0=True, set_restrictions=True),
    "normalCDF": _S("normalCDF"),
    "normalCDF/res/f0": _S("normalCDF", set_restrictions=True, add_init_f0=True),
    "normalCDF/fixed": _S("normalCDF", learnable=False),
    "log_exp/3": _S("log_exp", n_terms=3),
    "log_exp/3/f0": _S("log_exp", n_terms=3, add_init_f0=True),
    "exp": _S("exp"),
    "log": _S("log"),
    "softplus": _S("softplus"),
    "softminus": _S("softminus"),
    "step_flow/gates": _S("step_flow", sub=_GATED_SUB),
    "step_flow/gates/f0": _S("step_flow", add_init_f0=True, sub=_GATED_SUB),
    "step_flow/tanh": _S("step_flow", add_init_f0=True,
                         sub=(_S("tanh", set_restrictions=True),) * 3),
}


def _inputs(kind, seed):
    rs = np.random.RandomState(seed)
    f = 2.0 * rs.randn(7, 11)
    if kind in ("log", "softminus"):
        f = np.abs(f) + 0.1
    else:
        f[0, :3] = (0.0, 1e-3, -1e-3)
    return f, rs.randn(*f.shape)


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_step_forward_and_gradient_match_jax(case):
    js = STEP_CASES[case]
    ps = to_port_step(js)
    jp, np_p = perturbed_params(js, seed=len(case))
    f, w = _inputs(js.kind, seed=len(case) + 1)

    def jloss(p, x):
        return jnp.sum(jnp.asarray(w) * jcore.step_forward(js, p, x))

    jval = jcore.step_forward(js, jp, jnp.asarray(f))
    jgp, jgf = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(f))

    pp = weights.params_from_jax(np_p, device="cpu", dtype=torch.float64)
    leaves = weights.tree_leaves(pp)
    for t in leaves:
        t.requires_grad_(True)
    ft = torch.tensor(f, requires_grad=True)
    val = pcore.step_forward(ps, pp, ft)
    close(val, jval)
    grads = torch.autograd.grad((torch.tensor(w) * val).sum(), leaves + [ft],
                                allow_unused=True, materialize_grads=True)
    jl = jax.tree_util.tree_leaves(jgp)
    assert len(jl) == len(leaves)
    for g, jg in zip(grads[:-1], jl):
        close(g, jg)
    close(grads[-1], jgf)


def test_step_flow_gates_and_log_exp_init():
    js = STEP_CASES["step_flow/gates"]
    jp = jcore.init_flow_params((js,), None, jax.random.PRNGKey(0), jnp.float64)
    pp = pcore.init_flow_params((to_port_step(js),), None, device="cpu")
    gates = pp[0]["gates"]
    # the boxcox, inverseboxcox and sinh_arcsinh members are gated, tanh not
    assert [sorted(g) for g in gates] == [["a", "b"], [], ["a", "b"], ["a", "b"]]
    close(gates[0]["a"], np.log(np.expm1(1.0 / 4)), rtol=0, atol=0)
    spec, inits = pcore.spec_from_list([("log_exp", {
        "init_a": [0.1, 0.2, 0.3], "init_b": [1.0, 2.0, 3.0],
        "init_c": [-1.0, 0.0, 1.0], "add_init_f0": True})])
    assert spec[0].n_terms == 3
    lp = pcore.init_flow_params(spec, inits, device="cpu")
    close(lp[0]["c"], [-1.0, 0.0, 1.0], rtol=0, atol=0)
    for a, b in zip(jax.tree_util.tree_leaves(jp),
                    weights.tree_leaves(pp)):
        close(b, a, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# the model's warp over stacked per-output trees (step_flow, log_exp)
# ---------------------------------------------------------------------------

def test_model_with_nested_and_vector_flow_leaves_matches_jax():
    Dy, Dx, M, N = 2, 3, 6, 40
    rs = np.random.RandomState(3)
    X, Y = rs.randn(N, Dx), rs.randn(N, Dy)
    np.random.seed(0)
    fl = jG.StepAllL(1, add_f0=True) + [("log_exp", {
        "init_a": [0.1, -0.2, 0.3], "init_b": [0.5, 1.0, 0.0],
        "init_c": [-1.0, 0.0, 1.0], "add_init_f0": True})]
    jspec_f, jinits = jcore.spec_from_list(fl)
    mk = dict(Dy=Dy, Dx=Dx, M=M, N=float(N), mean="zero", whiten=True)
    jspec = JM.TGPSpec(kernel=jK.from_name("scale_rbf"),
                       likelihood=JLik("gaussian_flow", Dy, quad_points=20),
                       flow=jspec_f, **mk)
    pspec = PM.TGPSpec(kernel=pK.from_name("scale_rbf"),
                       likelihood=PLik("gaussian_flow", Dy, quad_points=20),
                       flow=pcore.spec_from_list(fl)[0], **mk)
    jp = JM.init_tgp_params(jspec, X, X[:M], flow_inits=jinits,
                            variance_scale=0.1, dtype=jnp.float64)
    # per-output flows that differ, and a posterior that is not trivial
    np_p = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.1 * rs.randn(*np.shape(a)), jp)
    assert np_p["flow"][2]["a"].shape == (Dy, 3)
    jp = jax.tree_util.tree_map(jnp.asarray, np_p)
    pp = weights.params_from_jax(np_p, device="cpu", dtype=torch.float64)
    Ys = np.array([1.5, 0.7])
    close(PM.test_log_likelihood(pspec, pp, torch.tensor(X), torch.tensor(Y),
                                 torch.tensor(Ys)),
          jax.jit(lambda p: JM.test_log_likelihood(
              jspec, p, jnp.asarray(X), jnp.asarray(Y), jnp.asarray(Ys)))(jp))
    leaves = weights.tree_leaves(pp)
    for t in leaves:
        t.requires_grad_(True)
    e = PM.elbo(pspec, pp, torch.tensor(X), torch.tensor(Y))[0]
    je, jg = jax.jit(jax.value_and_grad(
        lambda p: JM.elbo(jspec, p, jnp.asarray(X), jnp.asarray(Y))[0]))(jp)
    close(e, je)
    grads = torch.autograd.grad(e, leaves, allow_unused=True,
                                materialize_grads=True)
    for g, a in zip(grads, jax.tree_util.tree_leaves(jg)):
        close(g, a)


# ---------------------------------------------------------------------------
# inverses
# ---------------------------------------------------------------------------

INVERSE_CASES = {
    "SAL": lambda: jG.SAL(2, init_random=True),
    "ArcSL": lambda: jG.ArcSL(1, init_random=True),
    "InverseBoxCoxL": lambda: jG.InverseBoxCoxL(1),
    "SAL/f0 (Newton)": lambda: jG.SAL(1, init_random=True, add_f0=True),
    "StepTanhL/f0 (Newton)": lambda: jG.StepTanhL(2, 2, add_f0=True),
    "log_exp/f0 (Newton)": lambda: [("log_exp", {
        "init_a": [0.2, 0.5, -0.3], "init_b": [0.0, 0.5, 1.0],
        "init_c": [-1.0, 0.0, 1.0], "add_init_f0": True})],
    "tukey_right (Newton)": lambda: [("tukey_right", {"init_g": -1.0,
                                                      "init_h": -2.0})],
}


@pytest.mark.parametrize("case", list(INVERSE_CASES))
def test_flow_inverse_matches_jax(case):
    np.random.seed(5)
    fl = INVERSE_CASES[case]()
    jspec, jinits = jcore.spec_from_list(fl)
    pspec, pinits = pcore.spec_from_list(fl)
    jp = jcore.init_flow_params(jspec, jinits, jax.random.PRNGKey(0), jnp.float64)
    pp = pcore.init_flow_params(pspec, pinits, device="cpu")
    y = np.linspace(-2.0, 2.0, 41)
    if case.startswith("InverseBoxCoxL"):
        y = np.linspace(0.2, 3.0, 41)
    want = jcore.flow_inverse(jspec, jp, jnp.asarray(y))
    got = pcore.flow_inverse(pspec, pp, torch.tensor(y))
    close(got, want)
    if not case.startswith("StepTanhL"):
        # the inverse inverts: T(T^-1(y)) = y.  (Not for the random
        # StepTanhL: an affine with a < 0 makes it decreasing, where the
        # derivative's clamp at 1e-4 stops Newton, in both packages.)
        close(pcore.flow_forward(pspec, pp, got), y, rtol=1e-8, atol=1e-8)


def test_newton_inverse_matches_jax_and_differentiates():
    def jf(x):
        return x + 0.5 * jnp.tanh(2.0 * x) + 0.1 * x ** 3

    def pf(x):
        return x + 0.5 * torch.tanh(2.0 * x) + 0.1 * x ** 3

    y = np.linspace(-3.0, 3.0, 25)
    want = jcore.newton_inverse(jf, jnp.asarray(y), iters=30)
    yt = torch.tensor(y, requires_grad=True)
    got = pcore.newton_inverse(pf, yt, iters=30)
    close(got, want)
    # d x / d y = 1 / T'(x), through the iterations
    g, = torch.autograd.grad(got.sum(), yt)
    jg = jax.grad(lambda t: jnp.sum(jcore.newton_inverse(jf, t, iters=30)))(
        jnp.asarray(y))
    close(g, jg, rtol=1e-8, atol=1e-9)
    with torch.no_grad():
        close(pcore.newton_inverse(pf, torch.tensor(y), iters=30), want)


def test_flow_kld_is_zero_for_point_flows():
    spec, _ = pcore.spec_from_list(pG.StepAllL(1))
    pp = pcore.init_flow_params(spec, device="cpu")
    assert float(pcore.flow_kld(spec, pp)) == 0.0


# ---------------------------------------------------------------------------
# generators and the experiment tables
# ---------------------------------------------------------------------------

ARCHS = sorted(set(JEC.TGP_REGRESSION_SWEEP.values())
               | set(JEC.TGP_CLASSIFICATION_SWEEP.values()),
               key=lambda a: (a[0], a[1], a[2] or 0))


def _build(FA, arch, nb, ns):
    if FA.is_step_arch(arch):
        return FA.make_step_gen(arch, nb, ns)()
    G = jG if FA is JFA else pG
    if arch in ("SAL", "ArcSL", "BoxCoxL", "InverseBoxCoxL", "Affine"):
        return getattr(G, arch)(nb)
    return G.build_chain(arch, nb)


@pytest.mark.parametrize("arch", ARCHS, ids=lambda a: f"{a[0]}-{a[1]}-{a[2]}")
def test_table_arch_lists_equal_jax(arch):
    np.random.seed(0)
    want = _build(JFA, *arch)
    after_jax = np.random.rand()
    np.random.seed(0)
    got = _build(PFA, *arch)
    assert got == want
    assert np.random.rand() == after_jax        # the same number of draws
    jspec, jinits = jcore.spec_from_list(want)
    pspec, pinits = pcore.spec_from_list(got)
    assert [dataclasses.astuple(s) for s in pspec] == \
        [dataclasses.astuple(s) for s in jspec]
    if not PFA.is_step_arch(arch[0]):
        np.random.seed(0)
        assert PFA.build_point_flow(arch[0], arch[1])[1] == pinits


GENERATOR_CALLS = {
    "SAL random": lambda G: G.SAL(3, init_random=True, set_res=True, add_f0=True),
    "BoxCoxL random": lambda G: G.BoxCoxL(2, init_random=True),
    "BoxCoxL none": lambda G: G.BoxCoxL(2, constraint=None),
    "InverseBoxCoxL random": lambda G: G.InverseBoxCoxL(2, init_random=True),
    "ArcSL random": lambda G: G.ArcSL(2, init_random=True, add_f0=True),
    "Affine random": lambda G: G.Affine(3, init_random=True),
    "StepTanhL random": lambda G: G.StepTanhL(2, 3, init_random=True),
    "StepSAL": lambda G: G.StepSAL(2, 3, add_f0=True),
    "StepArcSL": lambda G: G.StepArcSL(2, 2),
    "StepBoxCoxL": lambda G: G.StepBoxCoxL(2, 2, constraint="sigmoid_ref"),
    "StepInverseBoxCoxL random": lambda G: G.StepInverseBoxCoxL(
        2, 2, init_random=True),
    "StepAllL (first block only)": lambda G: G.StepAllL(3, add_f0=True),
    "build_chain": lambda G: G.build_chain("InvBCL_AL", 2, constraint="sigmoid2"),
    "identity": lambda G: G.identity(),
    "random_flow": lambda G: G.random_flow(
        ["affine", "arcsinh", "inverse_arcsinh", ["sinh_arcsinh",
         "inverse_sinh_arcsinhflow"], "exp", "softplus", "inverse_boxcox",
         "tukey_right", "step_flow"], output_range=(-2.0, 5.0)),
    "step_flow_ladder": lambda G: (jinit if G is jG else pinit).step_flow_ladder(
        4, (-1.0, 3.0), smoothness_scale=0.2, remove_tails=True),
}


@pytest.mark.parametrize("case", list(GENERATOR_CALLS))
def test_generator_lists_equal_jax(case):
    np.random.seed(7)
    want = GENERATOR_CALLS[case](jG)
    after_jax = np.random.rand()
    np.random.seed(7)
    got = GENERATOR_CALLS[case](pG)
    assert got == want
    assert np.random.rand() == after_jax        # the same number of draws
    jspec, jinits = jcore.spec_from_list(want)
    pspec, pinits = pcore.spec_from_list(got)
    assert [dataclasses.astuple(s) for s in pspec] == \
        [dataclasses.astuple(s) for s in jspec]


def test_input_dependent_generators_refuse():
    """The input-dependent generators and the ID arch of every table row
    now build the JAX package's lists and specs (they refused before the
    hypernets were ported); only an input-dependent flow without input_dim
    is refused."""
    for call in (lambda G: G.SAL(2, input_dependent=True, input_dim=3,
                                 dropout=0.5, hidden_activation="tanh"),
                 lambda G: G.StepTanhL(1, 2, input_dependent=True, input_dim=3,
                                       inference="mean_field_gaussian")):
        np.random.seed(3)
        want = call(jG)
        np.random.seed(3)
        assert call(pG) == want
    for table, is_class in ((JEC.ID_TGP_REGRESSION_SWEEP, False),
                            (JEC.ID_TGP_CLASSIFICATION_SWEEP, True)):
        for ds in table:
            for inf in ("MC_dropout", "mean_field_gaussian"):
                js, _ = JFA.build_id_flow(ds, 7, is_class, inf)
                ps, _ = PFA.build_id_flow(ds, 7, is_class, inf)
                assert [dataclasses.astuple(s) for s in ps] == \
                    [dataclasses.astuple(s) for s in js]
    with pytest.raises(ValueError, match="input_dim"):
        pG.SAL(1, input_dependent=True)


def test_experiment_tables_equal_jax():
    for name in ("HYPERPARAMS", "SVGP_DEFAULT", "TGP_REGRESSION_SWEEP",
                 "ID_TGP_REGRESSION_SWEEP", "TGP_CLASSIFICATION_SWEEP",
                 "ID_TGP_CLASSIFICATION_SWEEP", "HOLD_K_PARAMS_EPOCHS",
                 "SWEEP_SEEDS", "SWEEP_NUM_INDUCING", "NUM_VALID_POINTS"):
        assert getattr(PEC, name) == getattr(JEC, name), name
    for model in ("SVGP", "TGP", "ID_TGP"):
        for ds in UCI9:
            assert PEC.return_hyperparams(model, ds) == \
                JEC.return_hyperparams(model, ds)
    assert PFA.resolve_tgp_arch("boston") == JFA.resolve_tgp_arch("boston")
    assert PFA.parse_arch_flag("StepTanhL:3:4") == JFA.parse_arch_flag("StepTanhL:3:4")
    with pytest.raises(ValueError, match="NUM_STEPS"):
        PFA.resolve_tgp_arch("boston", arch_override=("StepSAL", 2, None))


# ---------------------------------------------------------------------------
# initializers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch, restarts", [
    (("StepTanhL", 2, 2), 1), (("StepInverseBoxCoxL", 2, 2), 2),
    (("StepAllL", 1, None), 1)])
def test_fit_flow_to_identity_matches_jax(arch, restarts):
    gen = (lambda G: (lambda: G.StepAllL(1, add_f0=True))) if arch[2] is None \
        else (lambda G: (lambda: getattr(G, arch[0])(arch[1], arch[2], add_f0=True)))
    kw = dict(num_restarts=restarts, num_epochs=50, n_points=500, seed=3)
    jspec, jp, jmse = jinit.fit_flow_to_identity(gen(jG), -2.5, 4.0, **kw)
    pspec, pp, pmse = pinit.fit_flow_to_identity(gen(pG), -2.5, 4.0,
                                                 device="cpu", **kw)
    assert [dataclasses.astuple(s) for s in pspec] == \
        [dataclasses.astuple(s) for s in jspec]
    close(pmse, jmse)
    jl = jax.tree_util.tree_leaves(jp)
    pl = weights.tree_leaves(pp)
    assert len(jl) == len(pl)
    for a, b in zip(jl, pl):
        close(b, a)
        assert not b.requires_grad


def test_gaussianize_matches_jax():
    np.random.seed(2)
    fl = jG.SAL(1, init_random=True, set_res=True)
    jspec, jinits = jcore.spec_from_list(fl)
    pspec, pinits = pcore.spec_from_list(fl)
    y = np.random.RandomState(4).gamma(2.0, 1.0, size=300)
    jp = jcore.init_flow_params(jspec, jinits, jax.random.PRNGKey(0), jnp.float64)
    pp = pcore.init_flow_params(pspec, pinits, device="cpu")
    jout, jloss = jinit.gaussianize(jspec, jp, y, num_epochs=20, lr=0.01)
    pout, ploss = pinit.gaussianize(pspec, pp, y, num_epochs=20, lr=0.01)
    close(ploss, jloss)
    for a, b in zip(jax.tree_util.tree_leaves(jout), weights.tree_leaves(pout)):
        close(b, a)


# ---------------------------------------------------------------------------
# k-means, loaders, weights
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dataset, M", [("boston", 5), ("boston", 100),
                                        ("power", 5), ("power", 100)])
def test_kmeans_centers_match_sklearn(dataset, M):
    from sklearn.cluster import KMeans

    torch.set_num_threads(1)
    _, d = return_dataset(dataset, 10000, seed=1)
    X = d["X_tr"]
    got = kmeans_centers(X, M, n_init=10, seed=0)
    km = KMeans(n_clusters=M, init="k-means++", n_init=10,
                random_state=0).fit(np.asarray(X, np.float64))
    assert got.shape == (M, X.shape[1])
    rows = lambda C: np.array(sorted(map(tuple, C)))   # noqa: E731
    np.testing.assert_allclose(rows(got), rows(km.cluster_centers_),
                               rtol=0, atol=1e-10)


@pytest.mark.parametrize("dataset", UCI9)
def test_loader_matches_jax_return_dataset(dataset):
    jax_native_parser()
    jl, jd = j_return_dataset(dataset, 10000, None, seed=2)
    pl, pd = return_dataset(dataset, 10000, None, seed=2)
    for k in ("N_tr", "Dx", "Dy", "task"):
        assert pd[k] == jd[k]
    for k in ("X_tr", "Y_tr", "Y_std", "Y_mean"):
        np.testing.assert_array_equal(pd[k], jd[k])
    assert len(pl) == len(jl)
    np.testing.assert_array_equal(pl[-1].dataset.X, jl[-1].dataset.X)
    np.testing.assert_array_equal(pl[-1].dataset.Y, jl[-1].dataset.Y)
    assert len(pl[0]) == len(jl[0])


def test_weights_round_trip_a_step_arch():
    np.random.seed(0)
    fl = jG.StepTanhL(2, 2, add_f0=True) + jG.StepInverseBoxCoxL(1, 2) + [
        ("log_exp", {"init_a": [0.1, 0.2], "init_b": [1.0, 0.5],
                     "init_c": [0.0, 1.0]})]
    jspec_f, jinits = jcore.spec_from_list(fl)
    jspec = JM.TGPSpec(Dy=2, Dx=3, M=4, N=10.0, kernel=jK.from_name("scale_rbf"),
                       likelihood=JLik("gaussian_flow", 2, quad_points=10),
                       flow=jspec_f)
    X = np.random.RandomState(1).randn(10, 3)
    jp = JM.init_tgp_params(jspec, X, X[:4], flow_inits=jinits,
                            dtype=jnp.float64)
    pspec = weights.spec_from_dict(jser.spec_to_dict(jspec))
    assert [dataclasses.astuple(s) for s in pspec.flow] == \
        [dataclasses.astuple(s) for s in jspec.flow]
    pp = weights.params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                                 device="cpu", dtype=torch.float64)
    back = weights.params_to_numpy(pp)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(
        jax.tree_util.tree_map(np.asarray, jp))
    for a, b in zip(jax.tree_util.tree_leaves(jp), jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(b, np.asarray(a))
    # the port's own init of the same spec is the same tree
    ours = PM.init_tgp_params(pspec, X, X[:4], flow_inits=pcore.spec_from_list(fl)[1],
                              device="cpu")
    for a, b in zip(jax.tree_util.tree_leaves(jp), weights.tree_leaves(ours)):
        close(b, a, rtol=0, atol=0)
    from tgp.pytorch_tpu_torch.train.optimizers import param_paths
    paths = weights.tree_leaves(param_paths(pp))
    assert "flow/0/sub/1/c" in paths and "flow/4/gates/0/a" in paths
    assert "flow/6/a" in paths and "flow/0/gates/0/a" not in paths
