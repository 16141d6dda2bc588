"""The port's multi-seed battery (`train/multiseed.py`, the per-replica
natgrad step, `replica_outliers`) against the JAX package's
`train/multiseed.py` and against the port's own `Trainer`, on the CPU in
fp64.

  * full batch (TGP and SVGP, clip, grouped specs, natgrad and its warmup)
    and minibatch batteries on the same stacked inputs as the JAX
    battery's, and each replica against `Trainer(seed=seed + r)` on its
    own split;
  * a carried split call bitwise the single call (full batch and
    minibatch), the kind and clip refusals, the full-batch fallback;
    `spec.remat` bitwise the plain battery (full batch, minibatch, an
    ID_TGP battery's generators, evaluation) and against the JAX battery
    with remat;
  * `eval_multiseed` against JAX (logL, rmse; logL, acc) and against the
    Trainer's evaluation of each replica (coverage too, whose draws differ
    between the packages);
  * the per-replica clip against a per-model clip, batch norm finalised per
    replica, natgrad conjugate exact per replica and halving per replica,
    the classification hold-kernel protocol, `replica_outliers`;
  * the stochastic models (ID_TGP's MC-dropout and VI nets, the deep TGP,
    the categorical likelihood) against independent Trainers: replica r
    draws what `Trainer(seed=seed + r)` draws;
  * with the kernels' launches emulated on the CPU, a mapped step launches
    each Gram kernel once forward and once backward, whatever R is (a
    remat step twice forward).
Values at rtol 1e-8, atol 1e-10 (the same float64 math on both sides).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from tgp.pytorch_tpu import config as jcfg
from tgp.pytorch_tpu.flows import generators as jG, spec_from_list as j_spec
from tgp.pytorch_tpu.likelihoods import LikelihoodSpec as JLik
from tgp.pytorch_tpu.models import serialization as jser, tgp as JM
from tgp.pytorch_tpu.ops import kernels as jK
from tgp.pytorch_tpu.train import (metrics as jmetrics, multiseed as jms,
                                  natgrad as jng)

from tgp.pytorch_tpu_torch import config as pcfg, weights
from tgp.pytorch_tpu_torch.data import ArrayDataset, DataLoader
from tgp.pytorch_tpu_torch.flows import generators as pG
from tgp.pytorch_tpu_torch.flows.core import spec_from_list as p_spec
from tgp.pytorch_tpu_torch.likelihoods import LikelihoodSpec
from tgp.pytorch_tpu_torch.models import tgp as PM
from tgp.pytorch_tpu_torch.models.deep import (DeepTGPSpec, init_deep_params,
                                               layer_spec)
from tgp.pytorch_tpu_torch.ops import kernels as pK, rbf_gram as RG
from tgp.pytorch_tpu_torch.train import (Trainer, metrics as pmetrics,
                                         multiseed as ms, natgrad as png)
from tgp.pytorch_tpu_torch.train.optimizers import param_paths
from tgp.pytorch_tpu_torch.weights import tree_leaves

F64 = dict(rtol=1e-8, atol=1e-10)
R, N, M = 3, 40, 6


@pytest.fixture(autouse=True)
def _port_state():
    prev, jprev = pcfg.precision(), jcfg.precision()
    pcfg.set_precision("fp64")
    yield
    pcfg.set_precision(prev)
    if jcfg.precision() != jprev:
        jcfg.set_precision(jprev)


def close(port, ref, **tol):
    port = port.detach().cpu().numpy() if torch.is_tensor(port) else port
    np.testing.assert_allclose(np.asarray(port, np.float64),
                               np.asarray(ref, np.float64), **(tol or F64))


def close_trees(port, ref):
    for a, b in zip(tree_leaves(port), jax.tree_util.tree_leaves(ref)):
        close(a, b)


def to_port(tree):
    return weights.params_from_jax(jax.tree_util.tree_map(np.asarray, tree),
                                   device="cpu", dtype=torch.float64)


def replicas(n=N, seed0=100, labels=False):
    """(X (R, n, 2), Y (R, n, 1)): one split a replica; regression targets
    or linearly separable binary labels."""
    Xs, Ys = [], []
    for r in range(R):
        rs = np.random.RandomState(seed0 + r)
        X = rs.randn(n, 2)
        Y = ((X[:, :1] + 0.3 * X[:, 1:] > 0).astype(np.float64) if labels
             else np.sinh(X @ rs.randn(2, 1)) + 0.1 * rs.randn(n, 1))
        Xs.append(X)
        Ys.append(Y)
    return np.stack(Xs), np.stack(Ys)


def model(kind="tgp", n=N):
    """(spec_j, spec_p, [JAX params per replica], X, Y): SAL(1) through the
    quadrature ('tgp'), the Gaussian SVGP ('svgp'), or the Bernoulli TGP on
    labels ('bernoulli')."""
    X, Y = replicas(n, labels=kind == "bernoulli")
    lik = {"tgp": JLik("gaussian_flow", 1, quad_points=10),
           "svgp": JLik("gaussian", 1),
           "bernoulli": JLik("bernoulli", 1, quad_points=10)}[kind]
    kw, finits = {}, None
    if kind != "svgp":
        np.random.seed(0)
        kw["flow"], finits = j_spec(jG.SAL(1))
    spec_j = JM.TGPSpec(Dy=1, Dx=2, M=M, N=float(n),
                        kernel=jK.from_name("scale_rbf"), likelihood=lik, **kw)
    ps = [JM.init_tgp_params(spec_j, X[r], X[r][:M].copy(),
                             variance_scale=1e-5,
                             kernel_init={"length_scale": 2.0,
                                          "kernel_scale": 2.0},
                             noise_init=0.05, flow_inits=finits)
          for r in range(R)]
    return spec_j, weights.spec_from_dict(jser.spec_to_dict(spec_j)), ps, X, Y


def stacks(ps):
    return jms.stack_trees(ps), ms.stack_trees([to_port(p) for p in ps])


def perturbed(ps, scale=0.1):
    """Each replica's JAX params moved by seeded noise, off the symmetric
    init (where the class probabilities tie at 0.5)."""
    rs = np.random.RandomState(3)
    return [jax.tree_util.tree_map(
        lambda a: np.asarray(a) + scale * rs.randn(*np.shape(a)), p)
        for p in ps]


def trainer_of(spec, params, X, Y, seed, batch=None, loader_seed=0,
               S_test=20):
    loader = DataLoader(ArrayDataset(X, Y), batch or 10 ** 9,
                        shuffle=batch is not None, seed=loader_seed)
    return Trainer(spec, params, [loader, loader], np.ones(1), S_test=S_test,
                   seed=seed, device="cpu")


def trainers_match(spec_p, ps_p, X, Y, out, curves, epochs, seed, batch=None,
                   **train_kw):
    """Each replica of a port battery against `Trainer(seed=seed + r)` on
    its split (the minibatch loader seeded as the battery's shuffles)."""
    for r in range(R):
        tr = trainer_of(spec_p, ps_p[r], X[r], Y[r], seed + r, batch,
                        loader_seed=seed + 7919 * (r + 1))
        tr.train(epochs, 0.01, verbose_each=0, **train_kw)
        for a, b in zip(tree_leaves(ms.unstack_tree(out, r)),
                        tree_leaves(tr.params)):
            close(a, b.detach())
        close(curves["elbo"][:, r], np.asarray(tr.loss_curve))


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

FULL_CASES = {
    "tgp": ("tgp", dict()),
    "svgp": ("svgp", dict()),
    "clip": ("tgp", dict(clip_norm=5.0)),
    "adam_W_groups": ("tgp", dict(opt="adam_W",
                                  specs=[[0.02, 1e-3, "flow"],
                                         [0.0, "likelihood"]])),
    "natgrad": ("svgp", dict(natgrad_gamma=0.5)),
    "natgrad_warmup": ("tgp", dict(natgrad_gamma=0.5, natgrad_warmup=4)),
}


@pytest.mark.parametrize("case", list(FULL_CASES))
def test_full_batch_battery_matches_jax_and_trainers(case):
    kind, kw = FULL_CASES[case]
    kw = dict(kw)
    spec_j, spec_p, ps, X, Y = model(kind)
    sj, sp = stacks(ps)
    epochs = 12
    out_j, cv_j = jms.train_multiseed(spec_j, sj, X, Y, epochs, 0.01, seed=5,
                                      **kw)
    out_p, cv_p = ms.train_multiseed(spec_p, sp, X, Y, epochs, 0.01, seed=5,
                                     device="cpu", **kw)
    assert cv_p["elbo"].shape == (epochs, R)
    close_trees(out_p, out_j)
    for k in ("elbo", "ell", "kld"):
        close(cv_p[k], cv_j[k])
    if "clip_norm" in kw:
        return          # the Trainer's clip is the Trainer's own formula
    opt = kw.pop("opt", "adam")
    specs = kw.pop("specs", None)
    ps_p = [to_port(p) for p in ps]
    trainers_match(spec_p, ps_p, X, Y, out_p, cv_p, epochs, 5, opt=opt,
                   optimisation_schedule=([1.0], [specs]), **kw)


@pytest.mark.parametrize("case", ["vs_jax_and_trainers", "full_batch_fallback",
                                  "natgrad"])
def test_minibatch_battery(case):
    """N=40 in batches of 15: two full batches and a remainder of 10."""
    spec_j, spec_p, ps, X, Y = model("svgp" if case == "natgrad" else "tgp")
    sj, sp = stacks(ps)
    kw = dict(natgrad_gamma=1.0) if case == "natgrad" else {}
    if case == "full_batch_fallback":
        out_a, cv_a = ms.train_multiseed_minibatch(
            spec_p, sp, X, Y, 5, 0.01, batch_size=10 ** 6, seed=3,
            device="cpu")
        out_b, cv_b = ms.train_multiseed(spec_p, sp, X, Y, 5, 0.01, seed=3,
                                         device="cpu")
        for a, b in zip(tree_leaves(out_a), tree_leaves(out_b)):
            assert torch.equal(a, b)
        np.testing.assert_array_equal(cv_a["elbo"], cv_b["elbo"])
        return
    epochs = 6
    out_j, cv_j = jms.train_multiseed_minibatch(
        spec_j, sj, X, Y, epochs, 0.01, batch_size=15, seed=11, **kw)
    out_p, cv_p = ms.train_multiseed_minibatch(
        spec_p, sp, X, Y, epochs, 0.01, batch_size=15, seed=11, device="cpu",
        **kw)
    assert cv_p["elbo"].shape == (epochs, R)
    close_trees(out_p, out_j)
    close(cv_p["elbo"], cv_j["elbo"])
    trainers_match(spec_p, [to_port(p) for p in ps], X, Y, out_p, cv_p,
                   epochs, 11, batch=15, **kw)


@pytest.mark.parametrize("batch", [None, 15])
def test_split_call_with_carry_is_bitwise_the_single_call(batch):
    """train(8) == train(4) -> carry -> train(4): moments, generators, the
    shuffles and the natgrad ramp go on across the boundary."""
    spec_j, spec_p, ps, X, Y = model("tgp")
    sp = stacks(ps)[1]
    kw = (dict(batch_size=batch) if batch else
          dict(batch_size=10 ** 6, natgrad_gamma=0.5, natgrad_warmup=6))
    train = ms.train_multiseed_minibatch
    p_once, c_once, _ = train(spec_p, sp, X, Y, 8, 0.05, seed=2,
                              return_state=True, device="cpu", **kw)
    p1, c1, st = train(spec_p, sp, X, Y, 4, 0.05, seed=2, return_state=True,
                       device="cpu", **kw)
    p2, c2, st2 = train(spec_p, p1, X, Y, 4, 0.05, seed=2, carry=st,
                        return_state=True, device="cpu", **kw)
    for a, b in zip(tree_leaves(p_once), tree_leaves(p2)):
        assert torch.equal(a, b)
    np.testing.assert_array_equal(
        c_once["elbo"], np.concatenate([c1["elbo"], c2["elbo"]], axis=0))
    # the Adam family shares one state layout: another kind or clip raises
    with pytest.raises(ValueError, match="opt_kind"):
        train(spec_p, p2, X, Y, 1, 0.05, opt="adam_W", carry=st2,
              device="cpu", **kw)
    with pytest.raises(ValueError, match="clip_norm"):
        train(spec_p, p2, X, Y, 1, 0.05, clip_norm=1.0, carry=st2,
              device="cpu", **kw)


def test_classification_battery_two_phase_hold_kernel():
    """The hold-kernel protocol on the JAX test's synthetic replicas: phase
    1 holds the kernel ([0.0, 'kernel'], no moments, no steps), phase 2
    releases it with the other groups' moments carried; both phases and the
    classification metrics against JAX."""
    spec_j, spec_p, ps, X, Y = model("bernoulli", n=60)
    Yl = Y[..., 0]                                    # (R, N) labels
    sj, sp = stacks(ps)
    kern0 = [t.clone() for t in tree_leaves(sp["kernel"])]
    hold = dict(specs=[[0.0, "kernel"]], seed=9, return_state=True)
    s1_j, c1_j, st_j = jms.train_multiseed(spec_j, sj, X, Yl.astype(np.int32),
                                           15, 0.01, **hold)
    s1, c1, st = ms.train_multiseed(spec_p, sp, X, Yl, 15, 0.01,
                                    device="cpu", **hold)
    for a, b in zip(tree_leaves(s1["kernel"]), kern0):
        assert torch.equal(a, b)                      # held exactly
    counts = dict(zip(tree_leaves(param_paths(s1)), st["opt_state"].count))
    assert counts["q_mu"] == 15
    assert all(c == 0 for p, c in counts.items() if p.startswith("kernel"))
    close_trees(s1, s1_j)
    close(c1["elbo"], c1_j["elbo"])
    s2_j, c2_j = jms.train_multiseed(spec_j, s1_j, X, Yl.astype(np.int32),
                                     15, 0.01, carry=st_j)
    s2_p, c2_p = ms.train_multiseed(spec_p, s1, X, Yl, 15, 0.01, carry=st,
                                    device="cpu")
    assert not torch.equal(tree_leaves(s2_p["kernel"])[0], kern0[0])
    close_trees(s2_p, s2_j)
    close(c2_p["elbo"], c2_j["elbo"])
    m_j = jms.eval_multiseed(spec_j, s2_j, X, Yl.astype(np.int32),
                             np.ones((R, 1)), S_test=20)
    m_p = ms.eval_multiseed(spec_p, s2_p, X, Yl, np.ones((R, 1)), S_test=20,
                            device="cpu")
    assert m_p["logL"].shape == (R,) and m_p["acc"].shape == (R,)
    close(m_p["logL"], m_j["logL"])
    close(m_p["acc"], m_j["acc"])


# ---------------------------------------------------------------------------
# evaluation, clip, batch norm, natgrad, outliers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["regression", "bernoulli"])
def test_eval_multiseed_matches_jax_and_the_trainer(case):
    """logL and rmse (logL and acc) against JAX; every metric, coverage
    included, against the Trainer's evaluation of each replica with its
    generator seeded seed + r (the JAX package draws coverage's samples
    from its own keys)."""
    spec_j, spec_p, ps, X, Y = model("tgp" if case == "regression"
                                     else "bernoulli")
    ps = perturbed(ps)
    Yin = Y if case == "regression" else Y[..., 0]
    sj, sp = stacks(ps)
    Ystd = np.array([[1.0], [2.0], [0.5]])
    m_j = jms.eval_multiseed(spec_j, sj, X, Yin if case == "regression"
                             else Yin.astype(np.int32), Ystd, S_test=30)
    m_p = ms.eval_multiseed(spec_p, sp, X, Yin, Ystd, S_test=30, seed=77,
                            device="cpu")
    assert set(m_p) == set(m_j)
    for k in m_j:
        assert m_p[k].shape == np.shape(m_j[k])
        if k != "coverage":
            close(m_p[k], m_j[k])
    for r in range(R):
        tr = trainer_of(spec_p, to_port(ps[r]), X[r], Y[r], 77 + r,
                        S_test=30)
        tr.Y_std = Ystd[r]
        tr._Y_std_dev = tr._put(Ystd[r])
        got = tr._metrics_for_loader(tr.test_loader)
        for k in m_p:
            close(m_p[k][r], got[k])


@pytest.mark.parametrize("entry", ["full_batch", "minibatch", "eval",
                                   "id_tgp", "categorical", "bernoulli",
                                   "svgp_unwhitened"])
def test_battery_remat(entry):
    """spec.remat in a battery checkpoints `marginal_qf` and the warp, each
    over all replicas: its training (full batch, minibatch) gives the plain
    battery's parameters, curves and optimizer state bitwise and matches
    the JAX battery with remat; an ID_TGP battery's generators (its masks)
    and a categorical one's (its MC normals) end bitwise where the plain
    battery's do, as do a Bernoulli TGP's and an unwhitened SVGP's (K_zz
    carried out of the checkpoint) batteries; its evaluation, which takes
    no gradient, gives the plain spec's metrics bitwise."""
    if entry in ("id_tgp", "categorical"):
        spec_p, ps, X, Y = _port_model(
            "id_mc" if entry == "id_tgp" else "categorical")
        sp = ms.stack_trees(ps)
    elif entry in ("bernoulli", "svgp_unwhitened"):
        spec_j, spec_p, ps, X, Y = model(entry.split("_")[0])
        sj, sp = stacks(ps)
        if entry == "svgp_unwhitened":
            spec_p = dataclasses.replace(spec_p, whiten=False)
    else:
        spec_j, spec_p, ps, X, Y = model("tgp")
        sj, sp = stacks(ps)
    rspec = dataclasses.replace(spec_p, remat=True)
    if entry == "eval":
        Ystd = np.ones((R, 1))
        got = ms.eval_multiseed(rspec, sp, X, Y, Ystd, S_test=10,
                                device="cpu")
        want = ms.eval_multiseed(spec_p, sp, X, Y, Ystd, S_test=10,
                                 device="cpu")
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
        return
    train, jtrain, kw = ((ms.train_multiseed, jms.train_multiseed, {})
                         if entry != "minibatch" else
                         (ms.train_multiseed_minibatch,
                          jms.train_multiseed_minibatch,
                          dict(batch_size=15)))
    runs = [train(s, sp, X, Y, 6, 0.01, seed=5, device="cpu",
                  return_state=True, **kw) for s in (rspec, spec_p)]
    (out, cv, st), (out_p, cv_p, st_p) = runs
    for a, b in zip(tree_leaves(out), tree_leaves(out_p)):
        assert torch.equal(a, b)
    for k in cv_p:
        np.testing.assert_array_equal(cv[k], cv_p[k])
    for a, b in zip(tree_leaves(st["opt_state"].mu + st["opt_state"].nu),
                    tree_leaves(st_p["opt_state"].mu + st_p["opt_state"].nu)):
        assert torch.equal(a, b)
    for a, b in zip(st["rngs"], st_p["rngs"]):
        assert torch.equal(a, b)
    if entry in ("id_tgp", "categorical"):
        # the generators moved: the battery drew its masks or normals
        fresh = [pcfg.make_rng(5 + r, "cpu").get_state() for r in range(R)]
        assert not any(torch.equal(a, b) for a, b in zip(st["rngs"], fresh))
    if entry not in ("full_batch", "minibatch"):
        return
    out_j, cv_j = jtrain(dataclasses.replace(spec_j, remat=True), sj, X, Y,
                         6, 0.01, seed=5, **kw)
    close_trees(out, out_j)
    for k in ("elbo", "ell", "kld"):
        close(cv[k], cv_j[k])


def test_per_replica_clip_matches_a_per_model_clip():
    """Each replica's slice clipped by its own global norm, as the JAX
    battery's clip and as optax's clip_by_global_norm on each model alone:
    the large replica is scaled, the small one is untouched."""
    import optax
    g = [np.array([[3.0, 4.0], [0.1, 0.0]]), np.array([[0.0], [0.2]])]
    got = ms.clip_by_global_norm_per_replica(0.5)([torch.tensor(a) for a in g])
    ref, _ = jms.clip_by_global_norm_per_replica(0.5).update(
        {"a": g[0], "b": g[1]}, ())
    close(got[0], ref["a"])
    close(got[1], ref["b"])
    one, _ = optax.clip_by_global_norm(0.5).update(
        {"a": g[0][0], "b": g[1][0]}, optax.EmptyState())
    close(got[0][0], one["a"])
    close(got[0][1], g[0][1])
    close(got[1][1], g[1][1])


def test_bn_battery_finalizes_stats_per_replica():
    """MC-dropout nets at dropout 0 with batch norm, each replica's inputs
    shifted: the statistics finalised per replica from its own inputs move
    the scores, and equal JAX's, as do the scores before and after.  (The
    params are a seeded move off the init, not trained: a bias before
    batch norm has an exactly zero gradient, so Adam steps on rounding
    noise there and the two packages' trained biases part at 1e-6.)"""
    rs = np.random.RandomState(7)
    X = np.stack([rs.randn(40, 3) + 3.0 * r for r in range(R)])
    Y = np.stack([rs.randn(40, 1) for _ in range(R)])
    flow = dict(input_dependent=True, input_dim=3, batch_norm=1, dropout=0.0,
                hidden_dim=8, hidden_activation="relu", num_hidden_layers=1,
                inference="MC_dropout")
    fspec, finits = j_spec(jG.SAL(1, **flow))
    spec_j = JM.TGPSpec(Dy=1, Dx=3, M=5, N=40.0,
                        kernel=jK.from_name("scale_rbf"),
                        likelihood=JLik("gaussian_flow", 1, quad_points=8),
                        flow=fspec)
    spec_p = weights.spec_from_dict(jser.spec_to_dict(spec_j))
    assert spec_p.has_bn_flow
    ps = perturbed([JM.init_tgp_params(spec_j, X[r], X[r][:5].copy(),
                                       flow_inits=finits) for r in range(R)])
    sj, sp = stacks(ps)
    fin_j = jms.stack_trees([JM.finalize_batch_norm(
        spec_j, jms.unstack_tree(sj, r), X[r]) for r in range(R)])
    fin_p = ms.stack_trees([PM.finalize_batch_norm(
        spec_p, ms.unstack_tree(sp, r), X[r]) for r in range(R)])
    close_trees(fin_p, fin_j)
    ones = np.ones((R, 1))
    raw = ms.eval_multiseed(spec_p, sp, X, Y, ones, S_test=8, device="cpu")
    fin = ms.eval_multiseed(spec_p, fin_p, X, Y, ones, S_test=8, device="cpu")
    assert not np.allclose(raw["logL"], fin["logL"])
    for got, tree in ((raw, sj), (fin, fin_j)):
        close(got["logL"], jms.eval_multiseed(spec_j, tree, X, Y, ones,
                                              S_test=8)["logL"])


def test_natgrad_battery_conjugate_exact_per_replica():
    """gamma=1 natgrad on conjugate SVGP replicas (hyperparameters all but
    fixed by lr 1e-12): epoch 1 jumps, later epochs sit at each replica's
    optimum, as in the JAX package's test; and the curves are JAX's."""
    spec_j, spec_p, ps, X, Y = model("svgp")
    sj, sp = stacks(ps)
    _, c_j = jms.train_multiseed(spec_j, sj, X, Y, 3, 1e-12,
                                 natgrad_gamma=1.0)
    _, c_p = ms.train_multiseed(spec_p, sp, X, Y, 3, 1e-12,
                                natgrad_gamma=1.0, device="cpu")
    e = c_p["elbo"]
    assert np.isfinite(e).all()
    assert (e[2] - e[1] < 1e-3).all() and (np.abs(e[2] - e[1]) < 1e-2).all()
    assert (e[1] > e[0] - 1e-6).all()
    close(e, c_j["elbo"])


def test_natgrad_halves_gamma_per_replica():
    """Three replicas stacked at gamma 40 (the cases of
    tests/test_torch_port_natgrad.py): one whose step needs no halving, one
    that halves gamma until the new precision is positive definite, one
    that never gets there (left as it was); the result is JAX's vmapped
    `natgrad_apply`, and each replica's is `natgrad_apply` on it alone."""
    rs = np.random.RandomState(7)
    nq, Mq = 2, 5
    reps = []
    for case in ("plain", "halving", "no_op"):
        A = rs.randn(nq, Mq, Mq)
        sym = A @ np.swapaxes(A, -1, -2) / Mq
        reps.append({
            "q_mu": rs.randn(nq, Mq),
            "q_L": np.tril(0.3 * rs.randn(nq, Mq, Mq)) + np.eye(Mq),
            "dm": rs.randn(nq, Mq),
            "dS": {"plain": -sym, "halving": -sym + 0.4 * np.eye(Mq),
                   "no_op": sym + 10.0 * np.eye(Mq)}[case]})
    spec = PM.TGPSpec(Dy=nq, Dx=1, M=Mq, N=1.0,
                      kernel=pK.from_name("scale_rbf"),
                      likelihood=LikelihoodSpec("gaussian", nq))
    stack = {k: np.stack([r[k] for r in reps]) for k in reps[0]}
    t = {k: torch.tensor(v) for k, v in stack.items()}
    out = png.natgrad_apply_replicas(spec, {"q_mu": t["q_mu"], "q_L": t["q_L"]},
                                     t["dm"], t["dS"], 40.0)
    want = jax.vmap(lambda m, L, dm, dS: jng.natgrad_apply(
        spec, {"q_mu": m, "q_L": L}, dm, dS, 40.0))(
        stack["q_mu"], stack["q_L"], stack["dm"], stack["dS"])
    close(out["q_mu"], want["q_mu"])
    close(out["q_L"], want["q_L"])
    moved = []
    for i, r in enumerate(reps):
        one = png.natgrad_apply(
            spec, {"q_mu": t["q_mu"][i], "q_L": t["q_L"][i]},
            t["dm"][i], t["dS"][i], 40.0)
        assert torch.equal(out["q_mu"][i], one["q_mu"])
        assert torch.equal(out["q_L"][i], one["q_L"])
        moved.append(not torch.equal(one["q_mu"], t["q_mu"][i]))
    assert moved == [True, True, False]


@pytest.mark.parametrize("values", [
    [1.0, 1.1, 0.9, 1.05, 0.95, 1.02, 9.0, 1.0, 0.98, 1.01],
    [2.0] * 6,
    [1.0, 5.0, 9.0],
    [3.1, 3.3, -4.0, 3.2, 3.25, 3.0, 3.15],
])
def test_replica_outliers_matches_jax(values):
    got, ref = pmetrics.replica_outliers(values), \
        jmetrics.replica_outliers(values)
    np.testing.assert_array_equal(got["flags"], ref["flags"])
    np.testing.assert_array_equal(got["z"], ref["z"])
    assert (got["median"], got["mad"]) == (ref["median"], ref["mad"])


def test_params_from_jax_takes_a_stacked_tree():
    """A JAX `stack_trees` result carries across as one stack, and back."""
    _, _, ps, _, _ = model("tgp")
    sj, sp = stacks(ps)
    whole = to_port(sj)
    for a, b in zip(tree_leaves(whole), tree_leaves(sp)):
        assert torch.equal(a, b)
    back = weights.params_to_numpy(whole)
    for a, b in zip(tree_leaves(back), jax.tree_util.tree_leaves(sj)):
        np.testing.assert_array_equal(a, np.asarray(b))


# ---------------------------------------------------------------------------
# the stochastic models against independent Trainers
# ---------------------------------------------------------------------------

def _port_model(kind):
    """(spec, [params per replica], X, Y) of a model that draws."""
    X, Y = replicas()
    kernel = pK.from_name("scale_rbf")
    kinit = {"length_scale": 2.0, "kernel_scale": 2.0}
    if kind == "dgp":
        inner = (layer_spec(2, 2, 5, float(N), kernel, whiten=True),)
        last = PM.TGPSpec(Dy=1, Dx=2, M=5, N=float(N), kernel=kernel,
                          likelihood=LikelihoodSpec("gaussian", 1))
        spec = DeepTGPSpec(layers=inner + (last,), S_train=2, S_test=10)
        ps = [init_deep_params(spec, X[r], X[r][:5].copy(),
                               variance_scale=1e-5,
                               kernel_init=dict(kinit, noisy_variance=1e-6),
                               noise_init=0.05, device="cpu")
              for r in range(R)]
        return spec, ps, X, Y
    if kind == "categorical":
        Y = np.stack([np.digitize(x[:, :1], [-0.5, 0.5]).astype(np.float64)
                      for x in X])
        spec = PM.TGPSpec(Dy=3, Dx=2, M=5, N=float(N), kernel=kernel,
                          likelihood=LikelihoodSpec("categorical", 3,
                                                    quad_points=10,
                                                    num_classes=3))
        flow_inits = None
    else:
        np.random.seed(0)
        fspec, flow_inits = p_spec(pG.SAL(
            1, input_dependent=True, input_dim=2, hidden_dim=4,
            num_hidden_layers=1,
            dropout=0.25 if kind == "id_mc" else 0.0,
            inference="MC_dropout" if kind == "id_mc"
            else "mean_field_gaussian"))
        spec = PM.TGPSpec(Dy=1, Dx=2, M=5, N=float(N), kernel=kernel,
                          likelihood=LikelihoodSpec("gaussian_flow", 1,
                                                    quad_points=10),
                          flow=fspec)
    ps = [PM.init_tgp_params(spec, X[r], X[r][:5].copy(),
                             variance_scale=1e-5, kernel_init=kinit,
                             noise_init=0.05, flow_inits=flow_inits,
                             device="cpu")
          for r in range(R)]
    return spec, ps, X, Y


@pytest.mark.parametrize("kind", ["id_mc", "id_vi", "dgp", "categorical"])
def test_stochastic_battery_equals_independent_trainers(kind):
    """Replica r draws from its own generator seeded seed + r: training
    and evaluation (fully Bayesian for the nets) equal Trainer(seed=seed +
    r)'s on its split."""
    spec, ps, X, Y = _port_model(kind)
    assert spec.has_stochastic_flow or kind in ("dgp", "categorical")
    out, cv = ms.train_multiseed(spec, ms.stack_trees(ps), X, Y, 8, 0.01,
                                 seed=5, device="cpu")
    trainers_match(spec, ps, X, Y, out, cv, 8, 5)
    fb = kind.startswith("id")
    m = ms.eval_multiseed(spec, out, X, Y, np.ones((R, 1)), S_test=10,
                          seed=40, fully_bayesian=fb, device="cpu")
    for r in range(R):
        tr = trainer_of(spec, ms.unstack_tree(out, r), X[r], Y[r], 40 + r,
                        S_test=10)
        tr.fully_bayesian = fb
        got = tr._metrics_for_loader(tr.test_loader)
        for k in m:
            close(m[k][r], got[k])


# ---------------------------------------------------------------------------
# launches: the mapped Gram folds the replicas into one launch
# ---------------------------------------------------------------------------

@pytest.fixture
def emulated_kernels(monkeypatch):
    """The kernels' wrappers take the autograd Functions on CPU tensors,
    whose launches run the plain versions and count as launches do: the
    fold of the replica axis (`RBFGramPair.vmap`) is what runs."""
    def launch_pair(Xs, Zs, ks, pair):
        RG.LAUNCHES += 1
        return (RG.rbf_gram_reference(Xs, Zs, ks),
                RG.rbf_gram_reference(Zs, Zs, ks) if pair else None)

    def launch_bwd(Xs, Zs, ks, g_xz, g_zz=None):
        RG.BWD_LAUNCHES += 1
        if g_zz is None:
            return RG.rbf_gram_bwd(Xs, Zs, ks, RG.rbf_gram_reference(
                Xs, Zs, ks), g_xz)
        Kxz, Kzz = RG.rbf_gram_pair_reference(Xs, Zs, ks)
        return RG.rbf_gram_pair_bwd(Xs, Zs, ks, Kxz, Kzz, g_xz, g_zz)

    monkeypatch.setattr(RG, "_on_cpu", lambda *ts: False)
    monkeypatch.setattr(RG, "_launch_pair", launch_pair)
    monkeypatch.setattr(RG, "_launch_bwd", launch_bwd)
    monkeypatch.setattr(RG, "LAUNCHES", 0)
    monkeypatch.setattr(RG, "BWD_LAUNCHES", 0)


@pytest.mark.parametrize("case", ["full_batch", "natgrad", "dgp", "remat"])
def test_mapped_step_launches_each_kernel_once(emulated_kernels, case):
    """A battery step, whatever R, launches the pair once forward and once
    backward a rbf leaf (a DGP-2 step: 2 and 2, a layer each; a remat step
    2 and 1, its recompute the second forward); an evaluation call 2
    forward and no backward (a DGP-2's: 2, its one propagation); and the
    results equal the plain path's (the same run without the
    Functions)."""
    fwd = 1
    if case == "dgp":
        spec, ps, X, Y = _port_model("dgp")
        stack, leaves = ms.stack_trees(ps), 2
    else:
        _, spec, ps, X, Y = model("svgp" if case == "natgrad" else "tgp")
        stack, leaves = stacks(ps)[1], 1
    if case == "remat":
        spec, fwd = dataclasses.replace(spec, remat=True), 2
    kw = dict(natgrad_gamma=1.0) if case == "natgrad" else {}
    counts = []
    for Rn in (1, R):
        sub = ms.unstack_tree(stack, slice(0, Rn))
        RG.LAUNCHES = RG.BWD_LAUNCHES = 0
        out, cv = ms.train_multiseed(spec, sub, X[:Rn], Y[:Rn], 4, 0.01,
                                     seed=5, device="cpu", **kw)
        counts.append((RG.LAUNCHES, RG.BWD_LAUNCHES))
    assert counts == [(4 * fwd * leaves, 4 * leaves)] * 2
    RG.LAUNCHES = RG.BWD_LAUNCHES = 0
    m = ms.eval_multiseed(spec, out, X, Y, np.ones((R, 1)), S_test=10,
                          device="cpu")
    assert (RG.LAUNCHES, RG.BWD_LAUNCHES) == (2, 0)
    # the same runs through the plain versions
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(RG, "_on_cpu", lambda *ts: True)
        out_p, cv_p = ms.train_multiseed(spec, stack, X, Y, 4, 0.01, seed=5,
                                         device="cpu", **kw)
        m_p = ms.eval_multiseed(spec, out_p, X, Y, np.ones((R, 1)),
                                S_test=10, device="cpu")
    for a, b in zip(tree_leaves(out), tree_leaves(out_p)):
        close(a, b)
    close(cv["elbo"], cv_p["elbo"])
    for k in m:
        close(m[k], m_p[k])
