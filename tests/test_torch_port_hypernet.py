"""The port's input-dependent flows (hypernets, the anchor fit, the ID_TGP
ELBO, fully-Bayesian prediction) against the JAX package, on the CPU in
fp64.

JAX draws its dropout masks and VI noise from threefry keys, which torch
cannot reproduce, so the two are held together in three ways:
  * replayed draws: `Replay` hands both packages the same masks and noise,
    on the port's side through `flows.hypernet._draw` and on the JAX side
    through the `jax.random.bernoulli` / `normal` that the JAX package's
    `flows/hypernet.py` sees (a `pure_callback` batched over the vmapped
    outputs and draws, so one call gives every output's mask at once, in
    the order the port draws them);
  * dropout 0, where nothing is drawn;
  * distribution-level checks with independent draws (S_MC=2000), within 4
    Monte Carlo standard errors.
Tolerance rtol 1e-8, atol 1e-10 (the same float64 math on both sides).
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tgp.pytorch_tpu.flows import core as jcore, generators as jG
from tgp.pytorch_tpu.flows import hypernet as jhyper, initializers as jinit
from tgp.pytorch_tpu.likelihoods import LikelihoodSpec as JLik
from tgp.pytorch_tpu.models import serialization as jser, tgp as JM
from tgp.pytorch_tpu.ops import kernels as jK

from tgp.pytorch_tpu_torch import config as pcfg, weights
from tgp.pytorch_tpu_torch.flows import core as pcore, generators as pG
from tgp.pytorch_tpu_torch.flows import hypernet as phyper
from tgp.pytorch_tpu_torch.flows import initializers as pinit
from tgp.pytorch_tpu_torch.models import tgp as PM

F64 = dict(rtol=1e-8, atol=1e-10)


@pytest.fixture(autouse=True)
def _port_state():
    """Port precision fp64 for the test; torch's default dtype and numpy's
    global RNG state as they were."""
    prev, dt = pcfg.precision(), torch.get_default_dtype()
    np_state = np.random.get_state()
    pcfg.set_precision("fp64")
    yield
    pcfg.set_precision(prev)
    np.random.set_state(np_state)
    assert torch.get_default_dtype() == dt


def close(port, ref, **tol):
    port = port.detach().cpu().numpy() if torch.is_tensor(port) else port
    np.testing.assert_allclose(np.asarray(port, np.float64),
                               np.asarray(ref, np.float64), **(tol or F64))


def to_port(tree):
    return weights.params_from_jax(jax.tree_util.tree_map(np.asarray, tree),
                                   device="cpu", dtype=torch.float64)


def to_jax(tree):
    return weights.tree_map(lambda t: jnp.asarray(t.detach().numpy()), tree)


# ---------------------------------------------------------------------------
# replayed draws
# ---------------------------------------------------------------------------

class Replay:
    """Masks and noise from a numpy seed, one draw per label: a label seen
    again gets its earlier values, a new label the stream's next values (a
    keep-mask is uniform < p, noise standard normal, in C order of the
    shape without its singleton axes)."""

    def __init__(self, seed):
        self.rs = np.random.RandomState(seed)
        self.seen = {}
        self.shapes = []

    def take(self, label, kind, shape, p=None):
        shape = tuple(n for n in shape if n != 1) or (1,)
        self.shapes.append((kind, shape))
        if label not in self.seen:
            self.seen[label] = (self.rs.uniform(size=shape) < p if kind == "keep"
                                else self.rs.standard_normal(shape))
        return self.seen[label]


def replay_draws(monkeypatch, seed=0):
    """Both packages draw from two `Replay`s of the same seed.  Returns
    (port's, JAX's) Replay.

    A draw's label is what decides its values in each package: the JAX key
    (its data, batched over the vmapped outputs and draws) and the state of
    the port's generator (the replay moves it on by one number per draw).
    Equal keys in JAX give equal draws, and so do equal states here.  The
    port's draw shape is draws + (Dy, rows, width) with its singleton
    quadrature axis; the JAX package's the vmapped batch (draws, Dy) + (rows,
    width): the same elements in the same order.  The replay matches the
    two while both run in program order, as eager JAX does (a jitted JAX
    program may run independent draws in another order: `JaxOrderReplay`
    replays those)."""
    port, ref = Replay(seed), Replay(seed)

    def port_draw(kind, shape, p, generator, dtype, device):
        label = bytes(generator.get_state().numpy())
        torch.rand(1, generator=generator)
        vals = port.take(label, kind, shape, p)
        return torch.as_tensor(vals).reshape(shape).to(
            device, torch.bool if kind == "keep" else dtype)

    def jax_draw(kind, dtype):
        def draw(key, *args):
            p, shape = args if kind == "keep" else (None, args[0])

            def cb(k):
                full = tuple(k.shape[:-1]) + tuple(shape)
                label = np.asarray(k).tobytes()
                vals = ref.take(label, kind, full, p)
                return np.asarray(vals).reshape(full).astype(dtype)

            return jax.pure_callback(cb, jax.ShapeDtypeStruct(tuple(shape), dtype),
                                     key, vmap_method="expand_dims")
        return draw

    class Random:
        bernoulli = staticmethod(jax_draw("keep", np.bool_))
        normal = staticmethod(lambda key, shape, dtype=jnp.float64:
                              jax_draw("normal", dtype)(key, shape))

        def __getattr__(self, name):
            return getattr(jax.random, name)

    class Jax:
        random = Random()

        def __getattr__(self, name):
            return getattr(jax, name)

    monkeypatch.setattr(phyper, "_draw", port_draw)
    monkeypatch.setattr(jhyper, "jax", Jax())
    return port, ref


class JaxOrderReplay:
    """The JAX package's own draws under `jax.jit`, replayed to the port in
    program order.

    A jitted JAX program may run independent draws in any order, so here
    each JAX draw is a function of its key (a numpy stream seeded from the
    key's bytes: equal keys give equal draws, whatever the order), each
    draw site is numbered as it is traced, and each run of it recorded.
    `seal` puts the records taken since the last seal in program order:
    sites in runs of equal execution counts form one program, executed in
    turn, each execution visiting its sites in trace order.  The port's
    draws then take them in turn, as the port draws in program order.
    Eager (un-jitted) JAX draws pass to `jax.random` itself."""

    def __init__(self):
        self.sites, self.records, self.queue = 0, [], []

    def jax_draw(self, kind, key, shape, p, dtype):
        site = self.sites
        self.sites += 1

        def cb(k):
            full = tuple(k.shape[:-1]) + tuple(shape)
            rs = np.random.RandomState(np.frombuffer(np.asarray(k).tobytes(),
                                                     np.uint32))
            vals = (rs.uniform(size=full) < p if kind == "keep"
                    else rs.standard_normal(full))
            self.records.append((site, kind, full, vals))
            return vals.astype(dtype)

        return jax.pure_callback(cb, jax.ShapeDtypeStruct(tuple(shape), dtype),
                                 key, vmap_method="expand_dims")

    def seal(self):
        count = {}
        for site, *_ in self.records:
            count[site] = count.get(site, 0) + 1
        program, last = {}, None
        for site in sorted(count):
            program[site] = program.get(site - 1, -1) + (count[site] != last)
            last = count[site]
        seen, order = {}, []
        for site, kind, full, vals in self.records:
            n = seen[site] = seen.get(site, -1) + 1
            order.append(((program[site], n, site), kind, full, vals))
        self.queue += [r[1:] for r in sorted(order, key=lambda r: r[0])]
        self.records = []

    def port_draw(self, kind, shape, p, generator, dtype, device):
        k, full, vals = self.queue.pop(0)
        assert k == kind
        assert [n for n in full if n != 1] == [n for n in shape if n != 1]
        return torch.as_tensor(vals).reshape(shape).to(
            device, torch.bool if kind == "keep" else dtype)

    def patch(self, monkeypatch):
        """The port's draws and the JAX package's hypernet module's."""
        replay = self

        class Random:
            @staticmethod
            def bernoulli(key, p, shape):
                if not isinstance(key, jax.core.Tracer):
                    return jax.random.bernoulli(key, p, shape)
                return replay.jax_draw("keep", key, shape, p, np.bool_)

            @staticmethod
            def normal(key, shape, dtype=jnp.float64):
                if not isinstance(key, jax.core.Tracer):
                    return jax.random.normal(key, shape, dtype)
                return replay.jax_draw("normal", key, shape, None, dtype)

            def __getattr__(self, name):
                return getattr(jax.random, name)

        class Jax:
            random = Random()

            def __getattr__(self, name):
                return getattr(jax, name)

        monkeypatch.setattr(phyper, "_draw", self.port_draw)
        monkeypatch.setattr(jhyper, "jax", Jax())
        return self


# ---------------------------------------------------------------------------
# apply_hypernet, hypernet_kld, finalize_bn_stats
# ---------------------------------------------------------------------------

ACTS = ("relu", "tanh", "gelu", "sigmoid", "linear")
MODES = {
    "dropout": dict(dropout=0.3),
    "bn_train": dict(dropout=0.3, batch_norm=True, num_hidden=2),
    "bn_eval": dict(dropout=0.3, batch_norm=True, num_hidden=2),
    "vi": dict(inference="mean_field_gaussian"),
    "vi_mean_only": dict(inference="mean_field_gaussian"),
}


def perturbed_net(spec_j, seed, logvar=-2.0):
    """A JAX init of the net moved by seeded noise (BN variances kept
    positive, VI logvars around `logvar`): (jax tree, port tree)."""
    rs = np.random.RandomState(seed)
    p = jhyper.init_hypernet(spec_j, jax.random.PRNGKey(seed), jnp.float64)

    def move(path, a):
        name = jax.tree_util.keystr(path)
        a = np.asarray(a)
        if "logvar" in name:
            return logvar + rs.randn(*a.shape)
        if name.endswith("['var']"):
            return a + np.abs(rs.randn(*a.shape))
        return a + 0.3 * rs.randn(*a.shape)

    p = jax.tree_util.tree_map_with_path(move, p)
    return jax.tree_util.tree_map(jnp.asarray, p), to_port(p)


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("act", ACTS)
def test_apply_hypernet_matches_jax(monkeypatch, act, mode):
    kw = dict(MODES[mode])
    nh = kw.pop("num_hidden", 1)
    spec_j = jhyper.HyperNetSpec(in_dim=3, hidden_dim=6, num_hidden=nh,
                                 activation=act, **kw)
    spec_p = phyper.HyperNetSpec(**dataclasses.asdict(spec_j))
    pj, pp = perturbed_net(spec_j, 1)
    X = np.random.RandomState(2).randn(11, 3)
    w = np.random.RandomState(3).randn(11)
    flags = dict(train=mode == "bn_train", mean_only=mode == "vi_mean_only")
    port, ref = replay_draws(monkeypatch, seed=4)

    def fj(p):
        out = jhyper.apply_hypernet(spec_j, p, jnp.asarray(X),
                                    rng=jax.random.PRNGKey(5), **flags)
        return jnp.sum(out * w), out

    (_, out_j), g_j = jax.value_and_grad(fj, has_aux=True)(pj)
    leaves = weights.tree_leaves(pp)
    for t in leaves:
        t.requires_grad_(True)
    out_p = phyper.apply_hypernet(spec_p, pp, torch.as_tensor(X),
                                  rng=torch.Generator(), **flags)
    g_p = torch.autograd.grad(torch.sum(out_p * torch.as_tensor(w)), leaves,
                              allow_unused=True, materialize_grads=True)
    assert port.shapes == ref.shapes
    assert len(port.shapes) == {"dropout": 1, "bn_train": 2, "bn_eval": 2,
                                "vi": 3, "vi_mean_only": 0}[mode]
    close(out_p, out_j)
    for a, b in zip(jax.tree_util.tree_leaves(g_j), g_p):
        close(b, a)


def test_hypernet_kld_and_finalize_bn_match_jax():
    for prior_var, logvar in ((1.0, -2.0), (0.5 / 1e-5, 29.5)):
        spec_j = jhyper.HyperNetSpec(in_dim=3, hidden_dim=5, activation="tanh",
                                     inference="mean_field_gaussian",
                                     prior_var=prior_var)
        spec_p = phyper.HyperNetSpec(**dataclasses.asdict(spec_j))
        pj, pp = perturbed_net(spec_j, 6, logvar=logvar)  # straddles the cap
        kj, gj = jax.jit(jax.value_and_grad(
            lambda p: jhyper.hypernet_kld(spec_j, p)))(pj)
        leaves = weights.tree_leaves(pp)
        for t in leaves:
            t.requires_grad_(True)
        kp = phyper.hypernet_kld(spec_p, pp)
        close(kp, kj)
        for a, b in zip(jax.tree_util.tree_leaves(gj),
                        torch.autograd.grad(kp, leaves)):
            close(b, a)
    spec_j = jhyper.HyperNetSpec(in_dim=3, hidden_dim=5, num_hidden=2,
                                 activation="relu", dropout=0.5, batch_norm=True)
    spec_p = phyper.HyperNetSpec(**dataclasses.asdict(spec_j))
    pj, pp = perturbed_net(spec_j, 7)
    X = np.random.RandomState(8).randn(40, 3)
    fj = jhyper.finalize_bn_stats(spec_j, pj, jnp.asarray(X))
    fp = phyper.finalize_bn_stats(spec_p, pp, torch.as_tensor(X))
    for a, b in zip(jax.tree_util.tree_leaves(fj), weights.tree_leaves(fp)):
        close(b, a)
    assert float(phyper.hypernet_kld(spec_p, pp)) == 0.0


# ---------------------------------------------------------------------------
# flows: spec, init, forward, kld, the anchor fit
# ---------------------------------------------------------------------------

ID_FLOWS = {
    "sal_mc": lambda G: G.SAL(2, input_dependent=True, input_dim=3,
                              hidden_dim=5, dropout=0.4,
                              hidden_activation="tanh"),
    "sal_vi": lambda G: G.SAL(1, input_dependent=True, input_dim=3,
                              hidden_dim=4, hidden_activation="relu",
                              inference="mean_field_gaussian"),
    "steptanh_vi": lambda G: G.StepTanhL(1, 2, input_dependent=True,
                                         input_dim=3, hidden_dim=4,
                                         inference="mean_field_gaussian"),
    "sal_bn": lambda G: G.SAL(1, input_dependent=True, input_dim=3,
                              hidden_dim=5, dropout=0.2, batch_norm=1,
                              num_hidden_layers=2),
}


def id_flow(name, seed=0):
    """(JAX spec, port spec, JAX params, port params) of one flow, its
    JAX init moved by seeded noise."""
    np.random.seed(11)
    want = ID_FLOWS[name](jG)
    np.random.seed(11)
    got = ID_FLOWS[name](pG)
    assert got == want
    sj, ij = jcore.spec_from_list(want)
    sp, _ = pcore.spec_from_list(got)
    assert [dataclasses.astuple(s) for s in sp] == \
        [dataclasses.astuple(s) for s in sj]
    pj = jcore.init_flow_params(sj, ij, jax.random.PRNGKey(seed), jnp.float64)
    rs = np.random.RandomState(seed)
    pj = jax.tree_util.tree_map_with_path(
        lambda path, a: (np.asarray(a) + np.abs(rs.randn(*np.shape(a)))
                         if jax.tree_util.keystr(path).endswith("['var']")
                         else np.asarray(a) + 0.2 * rs.randn(*np.shape(a))), pj)
    return sj, sp, jax.tree_util.tree_map(jnp.asarray, pj), to_port(pj)


def test_id_spec_init_and_kld_match_jax():
    for name in ID_FLOWS:
        sj, sp, pj, pp = id_flow(name)
        # the port's own init has the JAX tree's structure and shapes
        own = pcore.init_flow_params(sp, None, torch.float64, "cpu")
        assert [tuple(t.shape) for t in weights.tree_leaves(own)] == \
            [np.shape(a) for a in jax.tree_util.tree_leaves(pj)]
        kj = jcore.flow_kld(sj, pj)
        kp = pcore.flow_kld(sp, pp)
        close(kp, kj)
        assert (float(kp) != 0.0) == name.endswith("_vi")
    tanh = next(s for s in id_flow("steptanh_vi")[1][0].sub)
    assert tanh.hypernet.prior_var == 0.5 / 1e-5


@pytest.mark.parametrize("name", list(ID_FLOWS))
@pytest.mark.parametrize("ctx", ["train", "point", "mean_only"])
def test_id_flow_forward_matches_jax(monkeypatch, name, ctx):
    sj, sp, pj, pp = id_flow(name)
    rs = np.random.RandomState(12)
    X, f = rs.randn(9, 3), rs.randn(5, 9)
    flags = dict(train=dict(stochastic=True, train=True),
                 point=dict(stochastic=False),
                 mean_only=dict(stochastic=True, mean_only=True))[ctx]
    port, ref = replay_draws(monkeypatch, seed=13)
    out_j = jcore.flow_forward(sj, pj, jnp.asarray(f), jnp.asarray(X),
                               jcore.FlowCtx(rng=jax.random.PRNGKey(0), **flags))
    out_p = pcore.flow_forward(sp, pp, torch.as_tensor(f), torch.as_tensor(X),
                               pcore.FlowCtx(rng=torch.Generator(), **flags))
    close(out_p, out_j)
    assert port.shapes == ref.shapes


@pytest.mark.parametrize("name, order", [("sal_mc", "eager"),
                                         ("sal_vi", "jit"), ("sal_bn", "jit")])
def test_anchor_fit_matches_jax(monkeypatch, name, order):
    """The initializer's loss, then the fit.  sal_mc (two input-dependent
    steps, which JAX hands the same key) runs JAX eagerly for 2 epochs with
    draws labelled by key and by generator state, so the port's rewound
    generator is held to JAX's shared key; the others run JAX's jitted fit
    for 20 epochs with its draws replayed in program order."""
    sj, sp, pj, pp = id_flow(name)
    rs = np.random.RandomState(14)
    batches = [rs.randn(20, 3), rs.randn(20, 3)]
    if order == "eager":
        port, ref = replay_draws(monkeypatch, seed=15)
        lj = jcore.flow_forward_initializer(
            sj, pj, jnp.asarray(batches[0]),
            jcore.FlowCtx(rng=jax.random.PRNGKey(1)))
        lp = pcore.flow_forward_initializer(sp, pp, torch.as_tensor(batches[0]),
                                            pcore.FlowCtx(rng=torch.Generator()))
        close(lp, lj)
        with jax.disable_jit():         # the draws in program order
            fj, loss_j = jinit.fit_hypernet_to_anchors(sj, pj, batches,
                                                       num_epochs=2)
        fp, loss_p = pinit.fit_hypernet_to_anchors(sp, pp, batches,
                                                   num_epochs=2)
        assert port.shapes == ref.shapes and len(port.shapes) == 4 + 16
        # each step's nets drew what the first step's did: 2 draws of each
        # 4 that a pass makes are new
        assert len(port.seen) == len(ref.seen) == 2 + 8
    else:
        replay = JaxOrderReplay().patch(monkeypatch)
        fj, loss_j = jinit.fit_hypernet_to_anchors(sj, pj, batches,
                                                   num_epochs=20)
        replay.seal()
        n = len(replay.queue)
        fp, loss_p = pinit.fit_hypernet_to_anchors(sp, pp, batches,
                                                   num_epochs=20)
        assert replay.queue == [] and n == 40 * (6 if name == "sal_vi" else 4)
    close(loss_p, loss_j)
    for a, b in zip(jax.tree_util.tree_leaves(fj), weights.tree_leaves(fp)):
        close(b, a)
    # the anchors do not move; the caller's params are not changed
    close(fp[0]["a"], pj[0]["a"])
    for a, b in zip(jax.tree_util.tree_leaves(pj), weights.tree_leaves(pp)):
        close(b, a)


def test_anchor_fit_at_dropout_zero_matches_jax():
    # no draws at all: the fit is deterministic on both sides
    want = jG.SAL(1, input_dependent=True, input_dim=3, hidden_dim=5,
                  hidden_activation="tanh", dropout=0.0)
    sj, ij = jcore.spec_from_list(want)
    sp, _ = pcore.spec_from_list(pG.SAL(1, input_dependent=True, input_dim=3,
                                        hidden_dim=5, hidden_activation="tanh",
                                        dropout=0.0))
    pj = jcore.init_flow_params(sj, ij, jax.random.PRNGKey(3), jnp.float64)
    batches = [np.random.RandomState(16).randn(30, 3)]
    fj, loss_j = jinit.fit_hypernet_to_anchors(sj, pj, batches, num_epochs=60)
    fp, loss_p = pinit.fit_hypernet_to_anchors(sp, to_port(pj), batches,
                                               num_epochs=60)
    close(loss_p, loss_j)
    for a, b in zip(jax.tree_util.tree_leaves(fj), weights.tree_leaves(fp)):
        close(b, a)


# ---------------------------------------------------------------------------
# the model: ELBO, fully-Bayesian prediction, params_from_jax
# ---------------------------------------------------------------------------

def id_model(name="sal_mc", Dy=2, N=13, M=4, quad=12, seed=0):
    """(JAX spec, port spec, JAX params, port params, X, Y, Y_std) of an
    ID TGP at a small size, the JAX init moved by seeded noise."""
    np.random.seed(11)
    fspec, finits = jcore.spec_from_list(ID_FLOWS[name](jG))
    rs = np.random.RandomState(seed)
    X, Y = rs.randn(N, 3), rs.randn(N, Dy)
    spec_j = JM.TGPSpec(Dy=Dy, Dx=3, M=M, N=float(N),
                        kernel=jK.from_name("scale_rbf"),
                        likelihood=JLik("gaussian_flow", Dy, quad_points=quad),
                        flow=fspec)
    pj = JM.init_tgp_params(spec_j, X, X[:M], flow_inits=finits,
                            kernel_init={"length_scale": 1.5, "kernel_scale": 1.2},
                            dtype=jnp.float64)
    spec_p = weights.spec_from_dict(jser.spec_to_dict(spec_j))
    pp = weights.perturb_params(to_port(pj), seed)

    def logvars(tree):          # VI weight variances as the anchor fit leaves them
        if isinstance(tree, dict):
            return {k: (torch.as_tensor(-4.0 + 0.5 * rs.randn(*v.shape))
                        if k.endswith("logvar") else logvars(v))
                    for k, v in tree.items()}
        if isinstance(tree, list):
            return [logvars(v) for v in tree]
        return tree

    pp["flow"] = logvars(pp["flow"])
    return (spec_j, spec_p, to_jax(pp), pp, X, Y,
            np.abs(rs.randn(Dy)) + 0.5)


def test_params_from_jax_on_an_id_tgp_tree():
    spec_j, spec_p, _, _, X, _, _ = id_model("sal_bn")
    pj = JM.init_tgp_params(spec_j, X, X[:4], dtype=jnp.float64)
    pp = to_port(pj)
    assert spec_p.has_input_dependent_flow and spec_p.has_bn_flow
    assert spec_p.has_stochastic_flow == spec_j.has_stochastic_flow
    net = pp["flow"][0]["net_a"]["layers"][0]
    assert set(net) == {"W", "b", "bn"} and net["W"].shape == (2, 3, 5)
    jl = jax.tree_util.tree_leaves_with_path(pj)
    pl = weights.tree_leaves(pp)
    assert len(jl) == len(pl)
    for (path, a), b in zip(jl, pl):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a),
                                      err_msg=jax.tree_util.keystr(path))
    back = weights.params_to_numpy(pp)
    for a, b in zip(jax.tree_util.tree_leaves(pj), weights.tree_leaves(back)):
        np.testing.assert_array_equal(b, np.asarray(a))
    # the port's own init: the same tree, every output a draw of its own
    own = PM.init_tgp_params(spec_p, X, X[:4], device="cpu")
    assert [tuple(t.shape) for t in weights.tree_leaves(own)] == \
        [tuple(t.shape) for t in pl]
    W = own["flow"][0]["net_a"]["layers"][0]["W"]
    assert not torch.equal(W[0], W[1])
    # a stochastic flow needs a generator
    with pytest.raises(ValueError, match="rng"):
        PM.elbo(spec_p, own, torch.as_tensor(X), torch.zeros(13, 2))


@pytest.mark.parametrize("name", ["sal_mc", "sal_vi", "steptanh_vi", "sal_bn"])
def test_id_elbo_and_gradient_match_jax(monkeypatch, name):
    spec_j, spec_p, pj, pp, X, Y, _ = id_model(name)
    replay = JaxOrderReplay().patch(monkeypatch)
    (e_j, (ell_j, kl_j)), g_j = jax.jit(jax.value_and_grad(
        lambda p: (lambda r: (r[0], r[1:]))(
            JM.elbo(spec_j, p, jnp.asarray(X), jnp.asarray(Y),
                    jax.random.PRNGKey(2))), has_aux=True))(pj)
    replay.seal()
    leaves = weights.tree_leaves(pp)
    for t in leaves:
        t.requires_grad_(True)
    e_p, ell_p, kl_p = PM.elbo(spec_p, pp, torch.as_tensor(X),
                               torch.as_tensor(Y), torch.Generator())
    g_p = torch.autograd.grad(e_p, leaves, allow_unused=True,
                              materialize_grads=True)
    assert replay.queue == [] and replay.sites > 0
    close(e_p, e_j)
    close(ell_p, ell_j)
    close(kl_p, kl_j)
    jl = jax.tree_util.tree_leaves_with_path(g_j)
    assert len(jl) == len(g_p)
    for (path, a), b in zip(jl, g_p):
        close(b, a, err_msg=jax.tree_util.keystr(path), **F64)


def _jax_normal_from(monkeypatch, arrays):
    """The JAX model's own `jax.random.normal` (the posterior samples'
    noise) returns `arrays` in turn."""
    queue = list(arrays)

    class Random:
        @staticmethod
        def normal(key, shape, dtype=jnp.float64):
            a = queue.pop(0)
            assert a.shape == tuple(shape)
            return jnp.asarray(a, dtype)

        def __getattr__(self, name):
            return getattr(jax.random, name)

    class Jax:
        random = Random()

        def __getattr__(self, name):
            return getattr(jax, name)

    monkeypatch.setattr(JM, "jax", Jax())


@pytest.mark.parametrize("name", ["sal_mc", "sal_vi"])
def test_fully_bayesian_prediction_with_replayed_draws(monkeypatch, name):
    S_MC, S = 4, 3
    spec_j, spec_p, pj, pp, X, Y, Ys = id_model(name)
    Xj, Yj, Ysj = jnp.asarray(X), jnp.asarray(Y), jnp.asarray(Ys)
    Xp, Yp, Ysp = torch.as_tensor(X), torch.as_tensor(Y), torch.as_tensor(Ys)
    replay = JaxOrderReplay().patch(monkeypatch)

    def jax_then_port(fj, fp):
        """fj jitted, its draws sealed, then fp drawing them."""
        out_j = jax.jit(fj)()
        replay.seal()
        with torch.no_grad():
            out_p = fp()
        assert replay.queue == []
        return out_j, out_p

    mj, mp = jax_then_port(
        lambda: JM.predictive_distribution(spec_j, pj, Xj, S_MC=S_MC,
                                           fully_bayesian=True,
                                           rng=jax.random.PRNGKey(0)),
        lambda: PM.predictive_distribution(spec_p, pp, Xp, S_MC=S_MC,
                                           fully_bayesian=True,
                                           rng=torch.Generator()))
    for a, b in zip(mj, mp):
        close(b, a)
    for i, reduce in enumerate((True, False)):
        lj, lp = jax_then_port(
            lambda: JM.test_log_likelihood(spec_j, pj, Xj, Yj, Ysj, S_MC=S_MC,
                                           fully_bayesian=True, reduce=reduce,
                                           rng=jax.random.PRNGKey(1 + i)),
            lambda: PM.test_log_likelihood(spec_p, pp, Xp, Yp, Ysp, S_MC=S_MC,
                                           fully_bayesian=True, reduce=reduce,
                                           rng=torch.Generator()))
        close(lp, lj)
    # samples, one flow draw each: JAX gets the port's posterior noise (the
    # generator's first and second draws: the replay takes none of its)
    g2 = torch.Generator().manual_seed(7)
    eps, noise = (torch.randn((S, 2, 13), generator=g2, dtype=torch.float64)
                  for _ in range(2))
    _jax_normal_from(monkeypatch, [eps.numpy(), noise.numpy()])
    n0 = replay.sites
    (yj, fkj, f0j), (yp, fkp, f0p) = jax_then_port(
        lambda: JM.sample_predictive(spec_j, pj, Xj, S, jax.random.PRNGKey(2),
                                     True),
        lambda: PM.sample_predictive(spec_p, pp, Xp, S,
                                     torch.Generator().manual_seed(7), True))
    for a, b in ((yj, yp), (fkj, fkp), (f0j, f0p)):
        close(b, a)
    # a site for each step, net and layer: SAL(2)'s 2 steps x 2 nets x 1
    # layer, SAL(1)'s 2 nets x 3 VI layers
    assert replay.sites - n0 == (4 if name == "sal_mc" else 6)


def test_fully_bayesian_distribution_with_independent_draws():
    """S_MC=2000 independent draws on each side: the mixture moments, the
    predictive density and the samples' mean and variance agree within 4
    Monte Carlo standard errors."""
    S_MC = 2000
    spec_j, spec_p, pj, pp, X, Y, Ys = id_model("sal_mc", N=7, quad=10)
    Xj, Xp = jnp.asarray(X), torch.as_tensor(X)
    with torch.no_grad():
        mj = jax.jit(lambda: JM.predictive_distribution(
            spec_j, pj, Xj, S_MC=S_MC, fully_bayesian=True,
            rng=jax.random.PRNGKey(0)))()
        mp = PM.predictive_distribution(spec_p, pp, Xp, S_MC=S_MC,
                                        fully_bayesian=True,
                                        rng=torch.Generator().manual_seed(1))
        # per-draw moments of the port, for the standard errors
        from tgp.pytorch_tpu_torch.likelihoods.gaussian import gaussian_flow_moments
        X3 = PM._ensure_3d(spec_p, Xp)
        mu, var = PM.marginal_qf(spec_p, pp, X3)
        m_s, C_s = gaussian_flow_moments(
            spec_p.likelihood, pp["likelihood"], mu, var,
            PM._bayes_warp(spec_p, pp, X3, torch.Generator().manual_seed(2), S_MC))
        se1 = np.sqrt(2.0) * m_s.std(0).numpy() / math.sqrt(S_MC)
        raw = (C_s + m_s ** 2)
        se2 = np.sqrt(2.0) * raw.std(0).numpy() / math.sqrt(S_MC)
        assert np.all(np.abs(mp[0].numpy() - np.asarray(mj[0])) <= 4 * se1)
        e2p = mp[1].numpy() + mp[0].numpy() ** 2
        e2j = np.asarray(mj[1]) + np.asarray(mj[0]) ** 2
        assert np.all(np.abs(e2p - e2j) <= 4 * se2)
        # the predictive density: exp(logL) is a mean over the draws
        lj = np.asarray(jax.jit(lambda: JM.test_log_likelihood(
            spec_j, pj, Xj, jnp.asarray(Y), jnp.asarray(Ys), S_MC=S_MC,
            fully_bayesian=True, reduce=False, rng=jax.random.PRNGKey(3)))())
        lp = PM.test_log_likelihood(spec_p, pp, Xp, torch.as_tensor(Y),
                                    torch.as_tensor(Ys), S_MC=S_MC,
                                    fully_bayesian=True, reduce=False,
                                    rng=torch.Generator().manual_seed(4)).numpy()
        # each draw's density, p_s = the quadrature over the draw's flow
        from tgp.pytorch_tpu_torch.ops.quadrature import GaussHermite
        gh = GaussHermite(spec_p.likelihood.quad_points)
        C = Ys[:, None] ** 2 * np.exp(pp["likelihood"]["log_var_noise"].numpy())
        fk = PM._bayes_warp(spec_p, pp, X3, torch.Generator().manual_seed(6),
                            S_MC)(gh.shifted_locations(mu, var)).numpy()
        dens = np.exp(-0.5 * (Ys[:, None] * (Y.T - fk)) ** 2 / C) \
            / np.sqrt(2 * math.pi * C)
        w = gh.weights(torch.float64, "cpu").numpy()
        p_s = np.tensordot(w, dens, axes=1) / math.sqrt(math.pi)   # (S_MC, Dy, MB)
        se = np.sqrt(2.0) * p_s.std(0) / math.sqrt(S_MC)
        assert np.all(np.abs(np.exp(lp) - np.exp(lj)) <= 4 * se)
        # samples, one flow draw each
        S = 4000
        yp = PM.sample_predictive(spec_p, pp, Xp, S,
                                  torch.Generator().manual_seed(5), True)[0]
        yj = np.asarray(jax.jit(lambda: JM.sample_predictive(
            spec_j, pj, Xj, S, jax.random.PRNGKey(5), True)[0])())
        yp = yp.numpy()
        sd = np.sqrt(yp.var(1) + yj.var(1))
        assert np.all(np.abs(yp.mean(1) - yj.mean(1)) <= 4 * sd / math.sqrt(S))
        # and the samples' mean is the mixture's mean
        assert np.all(np.abs(yp.mean(1) - mp[0].numpy())
                      <= 4 * np.sqrt(yp.var(1) / S + se1 ** 2 / 2))
        # the point-estimate path draws nothing: two calls agree exactly
        a = PM.predictive_distribution(spec_p, pp, Xp)[0]
        b = PM.predictive_distribution(spec_p, pp, Xp, S_MC=3,
                                       fully_bayesian=False,
                                       rng=torch.Generator())[0]
        assert torch.equal(a, b)
        close(a, JM.predictive_distribution(spec_j, pj, Xj)[0])
