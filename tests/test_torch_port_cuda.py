"""The port's CUDA Gram kernels, and the paths through them, on the card
(marker `cuda`; skips without one).

This file imports no JAX, so it runs on a machine with a card and PyTorch
alone (the repo's conftest imports JAX, hence `--noconftest`):

    python -m pytest --noconftest -q tests/test_torch_port_cuda.py

Tolerances: fp32 rtol = atol = 2e-5 (tests/test_pallas.py's), fp64 1e-12
(same expansion, only the order of a 4-term sum differs); gradients fp32
1e-4 and fp64 1e-10, relative to their largest entry (tests/test_pallas.py's
VJP tolerance; the kernel sums gK (z - x) where the plain version sums
gK z - (sum gK) x).
"""

import numpy as np
import pytest
import torch

from tgp.pytorch_tpu_torch import bench, config as pcfg, weights
from tgp.pytorch_tpu_torch.ops import rbf_gram as R
from tgp.pytorch_tpu_torch.serve import Predictor
from tgp.pytorch_tpu_torch.train.optimizers import param_paths

pytestmark = pytest.mark.cuda

SHAPES = [(1, 100, 100, 4), (1, 256, 100, 4), (1, 4096, 100, 4),
          (2, 131, 77, 3), (3, 1, 1, 9)]
TRAIN = (1, 8611, 100, 4)       # the flagship's full-batch training Gram
# the experiment CLI's: boston TGP M=100 (455 training and 51 test rows,
# Dx=13); M=20 at naval's (Dx=17) and protein's (Dx=9) minibatches of 10000
# and last batches, and kin8nm's full batch (Dx=8)
CLI_SHAPES = [(1, 455, 100, 13), (1, 51, 100, 13), (1, 10000, 20, 17),
              (1, 740, 20, 17), (1, 10000, 20, 9), (1, 1157, 20, 9),
              (1, 7372, 20, 8)]
# the classification protocol's: 1080 training and 120 test rows, M=50,
# Dx=4; the 3-class model batches one Gram a class (Dy=3)
CLASS_SHAPES = [(1, 1080, 50, 4), (1, 120, 50, 4), (3, 1080, 50, 4),
                (3, 120, 50, 4)]
# the warped GP's on boston (Dx=13): serving at buckets 256 and 4096
# (M=100), and the StepTanhL run's 455 training and 51 test rows at M=20
WGP_SHAPES = [(1, 256, 100, 13), (1, 4096, 100, 13), (1, 455, 20, 13),
              (1, 51, 20, 13)]
# the deep TGP's: DGP-2 on boston, the inner layer 13 outputs wide (Dx=13,
# M=100) at the 455 training rows and at S_test=100 paths of the 51 test
# rows; --dgp_flow on kin8nm (Dx=8): the 7373 training rows, and x 100
# paths in an evaluation batch
DGP_SHAPES = [(13, 455, 100, 13), (13, 5100, 100, 13), (8, 7373, 100, 8),
              (8, 737300, 100, 8)]
# the large corpora's: airline's batch of 10000 against M=500 (Dx=8), and
# YearMSD's width (Dx=90) at M=100
LARGE_SHAPES = [(1, 10000, 500, 8), (1, 10000, 100, 90)]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; the CUDA kernel has no CPU mode")
    prev = pcfg.precision()
    pcfg.set_precision("fp32")
    yield torch.device("cuda", 0)
    pcfg.set_precision(prev)


def _inputs(dev, shape, dtype, seed=0):
    """X1, X2 and ks; inputs scaled so that d2 is of order 4 at any Dx, as
    lengthscale-scaled inputs are, and K is not all but its diagonal."""
    Dy, N, M, Dx = shape
    g = torch.Generator(device=dev).manual_seed(seed)
    sc = min(1.0, 2.0 / Dx ** 0.5)
    X1 = sc * torch.randn(Dy, N, Dx, generator=g, device=dev, dtype=dtype)
    X2 = sc * torch.randn(Dy, M, Dx, generator=g, device=dev, dtype=dtype)
    ks = torch.rand(Dy, generator=g, device=dev, dtype=dtype) + 0.5
    return X1, X2, ks


def _close(got, want, tol):
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=tol, atol=tol)


def _close_scaled(got, want, tol):
    s = float(want.abs().max()) if want.numel() else 1.0
    _close(got / (s or 1.0), want / (s or 1.0), tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", SHAPES)
def test_kernel_matches_plain_version(dev, shape, dtype):
    X1, X2, ks = _inputs(dev, shape, dtype)
    before = R.LAUNCHES
    out = R.rbf_gram(X1, X2, ks)
    torch.cuda.synchronize()
    assert R.LAUNCHES == before + 1
    assert out.shape == shape[:3] and out.dtype == dtype
    tol = 2e-5 if dtype == torch.float32 else 1e-12
    _close(out, R.rbf_gram_reference(X1, X2, ks), tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
# (2, 37, 300, 50): Z too wide for the shared-memory budget, staged in chunks
@pytest.mark.parametrize("shape", SHAPES + [TRAIN, (2, 37, 300, 50)] + CLI_SHAPES
                         + CLASS_SHAPES + WGP_SHAPES + DGP_SHAPES
                         + LARGE_SHAPES)
def test_pair_kernel_matches_plain_version(dev, shape, dtype):
    Xs, Zs, ks = _inputs(dev, shape, dtype)
    before = R.LAUNCHES
    Kxz, Kzz = R.rbf_gram_pair(Xs, Zs, ks)
    torch.cuda.synchronize()
    assert R.LAUNCHES == before + 1
    Dy, N, M, _ = shape
    assert Kxz.shape == (Dy, N, M) and Kzz.shape == (Dy, M, M)
    tol = 2e-5 if dtype == torch.float32 else 1e-12
    for got, want in zip((Kxz, Kzz), R.rbf_gram_pair_reference(Xs, Zs, ks)):
        _close(got, want, tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_gradients_match_autograd_of_plain_version(dev, dtype):
    X1, X2, ks = _inputs(dev, (2, 131, 77, 3), dtype, seed=1)
    w = torch.randn(2, 131, 77, device=dev, dtype=dtype)
    grads = []
    for f in (R.RBFGram.apply, R.rbf_gram_reference):
        leaves = [t.clone().requires_grad_(True) for t in (X1, X2, ks)]
        (torch.sin(f(*leaves)) * w).sum().backward()
        grads.append([t.grad for t in leaves])
    tol = 1e-4 if dtype == torch.float32 else 1e-10
    for a, b in zip(*grads):
        _close_scaled(a, b, tol)


# the backward's two designs: the block pass and the tile pass
DESIGNS = ["block", "tile"]


def _takes(design, shape, dtype):
    """Whether `design` takes the shape; the tile pass refuses what its
    shared memory does not hold, and the test then holds the refusal."""
    return design == "block" or R.tile_kind(dtype, shape[2],
                                            shape[3]) != R.REFUSED


@pytest.mark.parametrize("design", DESIGNS)
@pytest.mark.parametrize("pair", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", [(2, 131, 77, 3), (1, 4096, 100, 4), TRAIN,
                                   (3, 1, 1, 9), (2, 37, 300, 50)] + CLI_SHAPES
                         + CLASS_SHAPES + WGP_SHAPES + DGP_SHAPES
                         + LARGE_SHAPES)
def test_backward_kernel_matches_plain_version(dev, shape, dtype, pair, design):
    Xs, Zs, ks = _inputs(dev, shape, dtype, seed=2)
    Dy, N, M, _ = shape
    gen = torch.Generator(device=dev).manual_seed(3)
    g_xz = torch.randn(Dy, N, M, generator=gen, device=dev, dtype=dtype)
    g_zz = torch.randn(Dy, M, M, generator=gen, device=dev, dtype=dtype)
    gs = (g_xz, g_zz) if pair else (g_xz,)
    if not _takes(design, shape, dtype):
        with pytest.raises(ValueError, match="tile pass does not take"):
            R._launch_bwd(Xs, Zs, ks, *gs, design=design)
        return
    before, tiles = R.BWD_LAUNCHES, R.BWD_TILE_LAUNCHES
    got = R._launch_bwd(Xs, Zs, ks, *gs, design=design)
    if pair:
        want = R.rbf_gram_pair_bwd(Xs, Zs, ks, *R.rbf_gram_pair_reference(
            Xs, Zs, ks), g_xz, g_zz)
    else:
        want = R.rbf_gram_bwd(Xs, Zs, ks, R.rbf_gram_reference(Xs, Zs, ks), g_xz)
    torch.cuda.synchronize()
    assert R.BWD_LAUNCHES == before + 1
    assert R.BWD_TILE_LAUNCHES == tiles + (design == "tile")
    tol = 1e-4 if dtype == torch.float32 else 1e-10
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == dtype
        _close_scaled(a, b, tol)


def _cotangents(dev, shape, dtype, seed):
    Dy, N, M, _ = shape
    gen = torch.Generator(device=dev).manual_seed(seed)
    return (torch.randn(Dy, N, M, generator=gen, device=dev, dtype=dtype),
            torch.randn(Dy, M, M, generator=gen, device=dev, dtype=dtype))


@pytest.mark.parametrize("design", DESIGNS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
# the flagship's training pair, YearMSD's width (Dx=90) and a DGP-2 inner
# layer (Dy=13)
@pytest.mark.parametrize("shape", [TRAIN, (1, 10000, 100, 90),
                                   (13, 455, 100, 13)])
def test_backward_kernel_is_bitwise_repeatable(dev, shape, dtype, design):
    # no floating-point atomics: the partial sums are reduced in a fixed order
    Xs, Zs, ks = _inputs(dev, shape, dtype, seed=4)
    g_xz, g_zz = _cotangents(dev, shape, dtype, seed=5)
    first = R._launch_bwd(Xs, Zs, ks, g_xz, g_zz, design=design)
    for _ in range(3):
        again = R._launch_bwd(Xs, Zs, ks, g_xz, g_zz, design=design)
        for a, b in zip(first, again):
            assert torch.equal(a, b)


def test_backward_kernel_small_n_gives_the_same_bits(dev):
    # boston's test batch against M=100 (Dx=13, fp64): few rows, each
    # entry's partials summed in one order
    shape = (1, 51, 100, 13)
    Xs, Zs, ks = _inputs(dev, shape, torch.float64, seed=6)
    g_xz, g_zz = _cotangents(dev, shape, torch.float64, seed=7)
    want = R.rbf_gram_pair_bwd(Xs, Zs, ks, *R.rbf_gram_pair_reference(
        Xs, Zs, ks), g_xz, g_zz)
    first = R._launch_bwd(Xs, Zs, ks, g_xz, g_zz)
    for a, b in zip(first, want):
        _close_scaled(a, b, 1e-10)
    for _ in range(5):
        for a, b in zip(first, R._launch_bwd(Xs, Zs, ks, g_xz, g_zz)):
            assert torch.equal(a, b)


@pytest.mark.parametrize("design", DESIGNS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_backward_kernel_under_cuda_graph_replay_is_bitwise_eager(dev, dtype,
                                                                   design):
    # the pass and its reduction, with their scratch, captured and replayed
    shape = (2, 455, 100, 13)
    Xs, Zs, ks = _inputs(dev, shape, dtype, seed=8)
    g_xz, g_zz = _cotangents(dev, shape, dtype, seed=9)
    eager = R._launch_bwd(Xs, Zs, ks, g_xz, g_zz, design=design)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        R._launch_bwd(Xs, Zs, ks, g_xz, g_zz, design=design)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = R.BWD_LAUNCHES
    with torch.cuda.graph(graph):
        out = R._launch_bwd(Xs, Zs, ks, g_xz, g_zz, design=design)
    assert R.BWD_LAUNCHES == before + 1
    for _ in range(3):
        for t in out:
            t.fill_(float("nan"))
        graph.replay()
        torch.cuda.synchronize()
        for a, b in zip(out, eager):
            assert torch.equal(a, b)


@pytest.mark.parametrize("design", DESIGNS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_backward_calls_on_two_streams_share_no_state(dev, dtype, design):
    # two calls in flight at once, each against its own eager result
    shapes = [TRAIN, (1, 455, 100, 13)]
    args = []
    for n, shape in enumerate(shapes):
        Xs, Zs, ks = _inputs(dev, shape, dtype, seed=10 + n)
        args.append((Xs, Zs, ks, *_cotangents(dev, shape, dtype, seed=20 + n)))
    eager = [R._launch_bwd(*a, design=design) for a in args]
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream() for _ in args]
    for _ in range(3):
        outs = []
        for st, a in zip(streams, args):
            st.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(st):
                outs.append(R._launch_bwd(*a, design=design))
        for st in streams:
            torch.cuda.current_stream().wait_stream(st)
        torch.cuda.synchronize()
        for got, want in zip(outs, eager):
            for a, b in zip(got, want):
                assert torch.equal(a, b)


@pytest.mark.parametrize("shape", [TRAIN, (1, 4096, 100, 4), (1, 455, 100, 13),
                                   (13, 455, 100, 13), (10, 8611, 100, 4),
                                   (1, 10000, 500, 8), (1, 10000, 100, 90),
                                   (8, 7373, 100, 8), (3, 1080, 50, 4)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_dispatched_backward_is_its_designs_bits(dev, shape, dtype):
    # `bwd_design` picks the pass by shape; the call gives that pass's bits
    # (the block pass's are the earlier kernel's), and only a tile-pass
    # call counts in BWD_TILE_LAUNCHES
    Dy, N, M, Dx = shape
    Xs, Zs, ks = _inputs(dev, shape, dtype, seed=12)
    g_xz, g_zz = _cotangents(dev, shape, dtype, seed=13)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    design = R.bwd_design(dtype, Dy, N, M, Dx, sms,
                          R.tile_kind(dtype, M, Dx), True)
    tiles = R.BWD_TILE_LAUNCHES
    got = R._launch_bwd(Xs, Zs, ks, g_xz, g_zz)
    assert R.BWD_TILE_LAUNCHES == tiles + (design == "tile")
    want = R._launch_bwd(Xs, Zs, ks, g_xz, g_zz, design=design)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_tile_kind_is_what_the_tile_pass_plans(dev):
    # `tile_kind` refuses exactly the shapes whose scratch the tile pass
    # refuses, and names the quad kernel only in fp32 at Dx <= 16
    _, bwd = R._load()
    sms = R._sms(bwd, dev)
    for dtype, fn in ((torch.float32, bwd.rbf_gram_bwd_tile_scratch_f32),
                      (torch.float64, bwd.rbf_gram_bwd_tile_scratch_f64)):
        for M in (1, 7, 20, 50, 100, 256, 300, 420, 500, 640, 1000):
            for Dx in (1, 4, 8, 9, 13, 16, 17, 50, 90, 128):
                kind = R.tile_kind(dtype, M, Dx)
                assert (fn(1, 100, M, Dx, 1, sms) >= 0) == (
                    kind != R.REFUSED), (dtype, M, Dx)
                assert kind != R.QUAD or (dtype == torch.float32
                                          and Dx <= 16), (dtype, M, Dx)


def test_gram_beyond_the_old_grid_cap(dev):
    # more rows than 65535 tiles of 32 (2,097,120): the flat grid takes it
    X1, X2, ks = _inputs(dev, (1, 2_200_000, 8, 1), torch.float32, seed=5)
    out = R.rbf_gram(X1, X2, ks)
    torch.cuda.synchronize()
    _close(out, R.rbf_gram_reference(X1, X2, ks), 2e-5)


def test_wrapper_refuses_what_the_kernel_does_not_take(dev):
    X1, X2, ks = _inputs(dev, (1, 64, 32, 4), torch.float32)
    with pytest.raises(ValueError, match="contiguous"):
        R.rbf_gram(X1.transpose(1, 2).contiguous().transpose(1, 2), X2, ks)
    with pytest.raises(TypeError):
        R.rbf_gram(X1.half(), X2.half(), ks.half())
    with pytest.raises(ValueError, match="shape"):
        R.rbf_gram(X1, X2[..., :3].contiguous(), ks)
    with pytest.raises(ValueError, match="CUDA"):
        R.rbf_gram(X1, X2.cpu(), ks)
    with pytest.raises(ValueError, match="cotangent shape"):
        R._launch_bwd(X1, X2, ks, torch.zeros(1, 64, 31, device=dev))
    # more Dy slices than a grid dimension's 65535: the flat grid takes them
    before = R.LAUNCHES
    X1, X2, ks = _inputs(dev, (70000, 1, 1, 1), torch.float32)
    out = R.rbf_gram(X1, X2, ks)
    torch.cuda.synchronize()
    assert R.LAUNCHES == before + 1
    _close(out, R.rbf_gram_reference(X1, X2, ks), 2e-5)


def test_predictor_goes_through_the_kernel_once_per_request(dev):
    rng = np.random.RandomState(0)
    X = rng.randn(50, 4)
    spec = weights.flagship_spec(50, M=10, quad=20)
    params = weights.flagship_params(spec, X, seed=0, device=dev,
                                     dtype=torch.float32)
    pred = Predictor(spec, params, buckets=(16, 64))
    before, bwd_before = R.LAUNCHES, R.BWD_LAUNCHES
    out = pred.predict(X[:20], samples=30)
    lp = pred.log_prob(X[:20], rng.randn(20, 1))
    assert R.LAUNCHES == before + 2
    assert R.BWD_LAUNCHES == bwd_before
    assert np.isfinite(out["mean"]).all() and np.isfinite(lp).all()
    assert (out["lower"] <= out["upper"]).all()


def _train(device, steps, precision="fp32"):
    """`bench.flagship_trainer` trained for `steps` full-batch Adam steps at
    `bench.LR` in `precision`; returns the Trainer."""
    pcfg.set_precision(precision)
    try:
        tr = bench.flagship_trainer(device)
        tr.train(steps, bench.LR, "adam", verbose_each=0)
    finally:
        pcfg.set_precision("fp32")
    return tr


def test_trainer_step_goes_through_both_kernels_once(dev):
    before, bwd_before = R.LAUNCHES, R.BWD_LAUNCHES
    tr = _train(dev, 5)
    assert R.LAUNCHES == before + 5
    assert R.BWD_LAUNCHES == bwd_before + 5
    assert len(tr.loss_curve) == 5 and np.isfinite(tr.loss_curve).all()
    assert tr.params["Z"].device == dev


def test_trainer_fp64_trajectory_equals_the_cpu_one(dev):
    # the limits that chip_smoke.py holds the card's fp64 training to
    gpu, cpu = _train(dev, 20, "fp64"), _train("cpu", 20, "fp64")
    a, b = np.asarray(gpu.loss_curve), np.asarray(cpu.loss_curve)
    assert abs(a[0] - b[0]) <= bench.TRAIN_F64_STEP0_LIMIT * np.abs(b).max()
    names = ["curve", "kld"] + weights.tree_leaves(param_paths(gpu.params))
    pairs = [(a, b), (np.asarray(gpu.kld_curve), np.asarray(cpu.kld_curve))] + [
        (p.detach().cpu().numpy(), q.detach().numpy())
        for p, q in zip(weights.tree_leaves(gpu.params),
                        weights.tree_leaves(cpu.params))]
    for n, (a, b) in zip(names, pairs):
        lim = bench.TRAIN_F64_LIMITS[n]
        assert np.abs(a - b).max() <= lim * np.abs(b).max(), n


def test_trainer_on_the_card_is_bitwise_repeatable(dev):
    # the backward kernel sums in a fixed order and Adam is elementwise
    a, b = _train(dev, 20), _train(dev, 20)
    assert np.array_equal(np.asarray(a.loss_curve), np.asarray(b.loss_curve))
    for p, q in zip(weights.tree_leaves(a.params), weights.tree_leaves(b.params)):
        assert torch.equal(p, q)


# The experiment CLI on the card against the port on the CPU, fp64, boston
# split 1, M=5, 20 epochs (StepTanhL(10, 2) identity-fitted for 2000 epochs
# first): limits relative to the largest entry of the CPU's value ("flow"
# and "fit": the largest over the trained flow's and the identity fit's
# leaves), 10x the gaps measured on an NVIDIA H100 80GB HBM3 at 700 W
# (the metrics agreed to the bit; their limit is 1e-14, a few ulps).
CLI_F64_LIMITS = {"fit": 5.2e-13, "curve": 3.4e-15, "params": 4.8e-15,
                  "flow": 5.8e-12, "metrics": 1e-14}


def _cli(platform):
    from tgp.pytorch_tpu_torch.experiments import main as X
    try:
        return X.run(X.parse_args([
            "--model", "TGP", "--dataset", "boston", "--train_test_seed_split",
            "1", "--num_inducing", "5", "--epochs", "20", "--platform",
            platform, "--verbose_each", "0"]))
    finally:
        pcfg.set_precision("fp32")


def _rel(a, b):
    a, b = (np.asarray(x.detach().cpu() if torch.is_tensor(x) else x,
                       np.float64) for x in (a, b))
    return float(np.abs(a - b).max() / (np.abs(b).max() or 1.0))


def test_cli_on_the_card_matches_the_cpu_and_counts_its_launches(dev):
    before = (R.LAUNCHES, R.BWD_LAUNCHES)
    gpu = _cli("gpu")
    calls = (R.LAUNCHES - before[0], R.BWD_LAUNCHES - before[1])
    cpu = _cli("cpu")
    # 1 forward launch and 1 backward call per full-batch step; evaluation
    # launches twice per batch (test_log_likelihood and marginal_qf) on the
    # training and the test split
    assert gpu.kernel_calls == {"train": (20, 20), "eval": (4, 0)}
    assert calls == (24, 20)
    assert gpu.trainer.params["Z"].device == dev
    assert np.array_equal(gpu.Z0, cpu.Z0)
    fit = max(_rel(a, b) for a, b in zip(weights.tree_leaves(gpu.identity_fit[1]),
                                          weights.tree_leaves(cpu.identity_fit[1])))
    assert fit <= CLI_F64_LIMITS["fit"]
    assert _rel(gpu.trainer.loss_curve, cpu.trainer.loss_curve) <= CLI_F64_LIMITS["curve"]
    paths = weights.tree_leaves(param_paths(gpu.trainer.params))
    for n, a, b in zip(paths, weights.tree_leaves(gpu.trainer.params),
                       weights.tree_leaves(cpu.trainer.params)):
        lim = CLI_F64_LIMITS["flow" if n.startswith("flow/") else "params"]
        assert _rel(a, b) <= lim, n
    for split in ("train", "test"):
        for k in ("logL", "rmse"):
            assert _rel(gpu.metrics[split][k], cpu.metrics[split][k]) \
                <= CLI_F64_LIMITS["metrics"], (split, k)


# ---------------------------------------------------------------------------
# input-dependent flows: the hypernets and the fully-Bayesian moments, the
# card against the CPU on the same draws (every draw from one seeded CPU
# generator, moved to the device)
# ---------------------------------------------------------------------------

# relative to the largest entry: fp64 1e-12 (the same float64 math, only
# the order of the matmuls' sums differs); fp32 1e-5 for the nets (a few
# float32 ulps through two layers) and the serving limit on the variance
# (2.4e-3) for the moments, which go through K_zz's Cholesky
ID_TOL = {torch.float64: (1e-12, 1e-12), torch.float32: (1e-5, 2.4e-3)}


def _cpu_draws(monkeypatch, seed):
    from tgp.pytorch_tpu_torch.flows import hypernet as H
    gen = torch.Generator().manual_seed(seed)

    def draw(kind, shape, p, generator, dtype, device):
        if kind == "keep":
            v = torch.rand(shape, generator=gen, dtype=torch.float64) < p
        else:
            v = torch.randn(shape, generator=gen, dtype=torch.float64).to(dtype)
        return v.to(device)

    monkeypatch.setattr(H, "_draw", draw)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kind", ["MC_dropout", "batch_norm",
                                  "mean_field_gaussian"])
def test_hypernet_on_the_card_matches_the_cpu(dev, monkeypatch, dtype, kind):
    from tgp.pytorch_tpu_torch.flows import hypernet as H
    spec = H.HyperNetSpec(
        in_dim=13, hidden_dim=25, num_hidden=2 if kind == "batch_norm" else 1,
        activation="tanh", dropout=0.0 if kind == "mean_field_gaussian" else 0.5,
        batch_norm=kind == "batch_norm",
        inference="MC_dropout" if kind != "mean_field_gaussian" else kind)
    g = torch.Generator().manual_seed(1)
    nets = [H.init_hypernet(spec, g, torch.float64, "cpu") for _ in range(2)]
    stacked = {"layers": [{k: (torch.stack([n["layers"][i][k] for n in nets])
                               if k != "bn" else
                               {s: torch.stack([n["layers"][i]["bn"][s]
                                                for n in nets])
                                for s in layer["bn"]})
                           for k in layer}
                          for i, layer in enumerate(nets[0]["layers"])]}
    X = torch.randn(2, 455, 13, generator=g, dtype=torch.float64)
    outs = []
    for device in (dev, "cpu"):
        _cpu_draws(monkeypatch, 2)
        p = weights.tree_map(lambda t: t.to(device, dtype), stacked)
        outs.append(H.apply_hypernet(spec, p, X.to(device, dtype),
                                     rng=torch.Generator(device=device),
                                     train=kind == "batch_norm",
                                     draws=(4, 1)))
    assert outs[0].shape == (4, 1, 2, 455)
    tol = ID_TOL[dtype][0]
    assert _rel(outs[0], outs[1]) <= tol


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_bayesian_moments_on_the_card_match_the_cpu(dev, monkeypatch, dtype):
    from tgp.pytorch_tpu_torch.experiments import flow_arch
    from tgp.pytorch_tpu_torch.likelihoods.gaussian import LikelihoodSpec
    from tgp.pytorch_tpu_torch.models import tgp as M
    from tgp.pytorch_tpu_torch.ops import kernels

    rng = np.random.RandomState(0)
    X, Y = rng.randn(455, 13), rng.randn(455, 1)
    fspec, finits = flow_arch.build_id_flow("boston", 13)
    spec = M.TGPSpec(Dy=1, Dx=13, M=100, N=455.0,
                     kernel=kernels.from_name("scale_rbf"),
                     likelihood=LikelihoodSpec("gaussian_flow", 1), flow=fspec)
    params = weights.perturb_params(M.init_tgp_params(
        spec, X, X[:100], variance_scale=1e-2, flow_inits=finits,
        kernel_init={"length_scale": 2.0, "kernel_scale": 2.0},
        dtype=torch.float64, device="cpu"), seed=3)
    outs = []
    for device in (dev, "cpu"):
        _cpu_draws(monkeypatch, 4)
        p = weights.tree_map(lambda t: t.to(device, dtype), params)
        Xd, Yd = (torch.as_tensor(a, dtype=dtype, device=device) for a in (X, Y))
        gen = torch.Generator(device=device)
        before = R.LAUNCHES
        with torch.no_grad():
            m1, m2, _, _ = M.predictive_distribution(
                spec, p, Xd, S_MC=16, fully_bayesian=True, rng=gen)
            lp = M.test_log_likelihood(spec, p, Xd, Yd, torch.ones(1, dtype=dtype,
                                                                  device=device),
                                       S_MC=16, fully_bayesian=True, rng=gen,
                                       reduce=False)
        if device == dev:
            assert R.LAUNCHES == before + 2     # one marginal_qf each
        outs.append((m1, m2, lp))
    tol = ID_TOL[dtype][1]
    for a, b in zip(*outs):
        assert a.shape == b.shape and torch.isfinite(a).all()
        assert _rel(a, b) <= tol


def _one_step(dev, spec, params, X, Y, precision="fp64"):
    """One full-batch Trainer step on the card; returns (forward launches,
    backward calls, the step's ELBO)."""
    from tgp.pytorch_tpu_torch.data import ArrayDataset, DataLoader
    from tgp.pytorch_tpu_torch.train import Trainer

    pcfg.set_precision(precision)
    try:
        tr = Trainer(spec, params, [DataLoader(ArrayDataset(X, Y), 10000)],
                     np.ones(1), device=dev)
        before = (R.LAUNCHES, R.BWD_LAUNCHES)
        tr.train(1, 0.01, "adam", verbose_each=0)
        calls = (R.LAUNCHES - before[0], R.BWD_LAUNCHES - before[1])
    finally:
        pcfg.set_precision("fp32")
    return calls, tr.loss_curve[0]


def test_wgp_step_goes_through_both_kernels_once(dev):
    """A warped-GP (log_exp warp, T^{-1} by Newton) training step: its
    gradient goes through dT/dy, and the Gram once each way."""
    from tgp.pytorch_tpu_torch.flows.core import spec_from_list
    from tgp.pytorch_tpu_torch.likelihoods import LikelihoodSpec
    from tgp.pytorch_tpu_torch.models import tgp as M
    from tgp.pytorch_tpu_torch.ops import kernels

    rng = np.random.RandomState(0)
    X, Y = rng.randn(455, 13), rng.randn(455, 1)
    wspec, winits = spec_from_list([("log_exp", {
        "add_init_f0": True, "init_a": [-1.0] * 3, "init_b": [0.5] * 3,
        "init_c": [-1.0, 0.0, 1.0]})])
    spec = M.TGPSpec(Dy=1, Dx=13, M=100, N=455.0,
                     kernel=kernels.from_name("scale_rbf"),
                     likelihood=LikelihoodSpec("warped", 1, warp_flow=wspec))
    params = M.init_tgp_params(spec, X, X[:100], warp_inits=winits,
                               dtype=torch.float64, device="cpu")
    calls, elbo = _one_step(dev, spec, params, X, Y)
    assert calls == (1, 1) and np.isfinite(elbo)


def test_categorical_step_goes_through_both_kernels_once(dev, monkeypatch):
    """A 3-class categorical step (per-class BCL_AL, 32 MC draws, the Gram
    at Dy=3): 1 forward launch and 1 backward call, and the ELBO the CPU
    gives on the same draws."""
    from tgp.pytorch_tpu_torch.data.uci_classification import synthetic_corpus
    from tgp.pytorch_tpu_torch.flows import generators as G
    from tgp.pytorch_tpu_torch.flows.core import spec_from_list
    from tgp.pytorch_tpu_torch.likelihoods import LikelihoodSpec
    from tgp.pytorch_tpu_torch.models import tgp as M
    from tgp.pytorch_tpu_torch.ops import kernels

    X, y = synthetic_corpus("multiclass")
    X, y = X[:1080], y[:1080].reshape(-1, 1)
    np.random.seed(0)
    fspec, finits = spec_from_list(G.build_chain("BCL_AL", 1))
    spec = M.TGPSpec(Dy=3, Dx=4, M=50, N=1080.0,
                     kernel=kernels.from_name("scale_rbf"),
                     likelihood=LikelihoodSpec("categorical", 3, quad_points=32,
                                               num_classes=3), flow=fspec)
    params = M.init_tgp_params(spec, X, X[:50], variance_scale=1e-5,
                               flow_inits=finits, dtype=torch.float64,
                               device="cpu")
    out = []
    for device in (dev, "cpu"):
        _cpu_draws(monkeypatch, 5)
        out.append(_one_step(device, spec, params, X, y))
    assert out[0][0] == (1, 1) and out[1][0] == (0, 0)
    assert abs(out[0][1] - out[1][1]) <= 1e-10 * abs(out[1][1])


# ---------------------------------------------------------------------------
# the model surface: composite kernels, the marginal_qf branches, the solve
# levers
# ---------------------------------------------------------------------------

def test_recursive_pair_launches_once_per_rbf_leaf(dev):
    """A 2-component spectral mixture's `gram_pair`: 2 forward launches and,
    through autograd, 2 backward calls; a tree without an rbf leaf none.
    The values and gradients are the CPU's (fp64, 1e-12 and 1e-10 of the
    largest entry)."""
    from tgp.pytorch_tpu_torch.ops import kernels as K

    rng = np.random.RandomState(0)
    X, Z = rng.randn(1, 300, 1), rng.randn(1, 50, 1)
    for spec, leaves in ((K.spectral_mixture(2), 2),
                         (K.spectral_mixture(2, base="cosine"), 2),
                         (K.product(K.periodic(), K.matern(1.5)), 0)):
        p64 = K.init_params(spec, 1, 1, {"period": 0.7, "length_scale": 1.4},
                            dtype=torch.float64, device="cpu")
        out = []
        for device in (dev, "cpu"):
            p = weights.tree_map(lambda t: t.to(device).requires_grad_(True), p64)
            x, z = (torch.tensor(a, device=device, requires_grad=True)
                    for a in (X, Z))
            before = (R.LAUNCHES, R.BWD_LAUNCHES)
            Kxz, Kzz = K.gram_pair(spec, p, x, z)
            fwd = R.LAUNCHES - before[0]
            loss = (torch.sin(Kxz)).sum() + (Kzz ** 2).sum()
            grads = torch.autograd.grad(loss, weights.tree_leaves(p) + [x, z])
            out.append((fwd, R.BWD_LAUNCHES - before[1], Kxz, Kzz, grads))
        assert out[0][:2] == (leaves, leaves) and out[1][:2] == (0, 0)
        for a, b in zip(out[0][2:4], out[1][2:4]):
            _close(a.detach(), b.detach(), 1e-12)
        for a, b in zip(out[0][4], out[1][4]):
            _close_scaled(a, b, 1e-10)


def _power_model(dev, M=100):
    """The flagship's spec at M and its perturbed init in fp32 on the card,
    over the 8611 power training rows."""
    from tgp.pytorch_tpu_torch.data.uci import load_uci_split

    d = load_uci_split("power", 1)
    spec = weights.flagship_spec(d["X_tr"].shape[0], M=M)
    params = weights.flagship_params(spec, d["X_tr"], seed=0, device=dev,
                                     dtype=torch.float32)
    X, Y = (torch.as_tensor(d[k], dtype=torch.float32, device=dev)
            for k in ("X_tr", "Y_tr"))
    return spec, params, X, Y


def _matmul_flags():
    return (torch.backends.cuda.matmul.allow_tf32,
            torch.get_float32_matmul_precision())


def test_solve_precision_acts_in_both_passes_and_leaves_no_tf32(dev):
    """`einsum_at` at 'high' (three TF32 passes) and 'default' (one pass
    over bf16 operands) moves the product and both of its gradients off
    'highest' on the card, a matrix-vector product too; each is the sum of
    its rounded operands' products; the flags are those `set_precision`
    set after every forward and backward."""
    from tgp.pytorch_tpu_torch.ops.linalg import einsum_at

    assert _matmul_flags() == (False, "highest")
    g = torch.Generator(device=dev).manual_seed(0)
    a = torch.randn(2, 100, 64, generator=g, device=dev)
    b = torch.randn(2, 100, 300, generator=g, device=dev)
    w = torch.randn(2, 64, 300, generator=g, device=dev)
    out = {}
    for mode in ("highest", "high", "default"):
        x, y = a.clone().requires_grad_(True), b.clone().requires_grad_(True)
        r = einsum_at("dmk,dmn->dkn", x, y, mode)
        assert _matmul_flags() == (False, "highest")
        gx, gy = torch.autograd.grad((r * w).sum(), (x, y))
        assert _matmul_flags() == (False, "highest")
        out[mode] = (r.detach(), gx, gy)
    for mode in ("high", "default"):
        for got, want in zip(out[mode], out["highest"]):
            gap = float((got - want).abs().max() / want.abs().max())
            assert 0.0 < gap < (1e-5 if mode == "high" else 5e-2), (mode, gap)
    bf = [t.bfloat16().double() for t in (a, b)]
    want = torch.einsum("dmk,dmn->dkn", *bf)
    _close_scaled(out["default"][0].double(), want, 1e-6)
    def tf32(t):
        return ((t.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)

    (ah, al), (bh, bl) = ((tf32(t), tf32(t - tf32(t))) for t in (a, b))
    want = sum(torch.einsum("dmk,dmn->dkn", x.double(), y.double())
               for x, y in ((ah, bh), (ah, bl), (al, bh)))
    _close_scaled(out["high"][0].double(), want, 1e-6)
    # a matrix-vector product (marginal_qf's mean) takes the lever too
    v = b[..., :1].contiguous()
    mv = {m: einsum_at("dnm,dmo->dn", a.transpose(-1, -2).contiguous(), v, m)
          for m in ("highest", "high")}
    assert float((mv["high"] - mv["highest"]).abs().max()) > 0.0


def test_solve_precision_keeps_the_factor_and_splits_in_both_passes(dev,
                                                                   monkeypatch):
    """fast_solves at each solve precision on the flagship at M=100 in
    fp32: K_zz's factor and jittered matrix (so its rung) are bitwise those
    of 'highest'; the moments and the ELBO's gradient move by a nonzero
    amount; each step is 1 forward launch and 1 backward call; the flags
    are restored."""
    import dataclasses

    from tgp.pytorch_tpu_torch.models import tgp as M

    spec, params, X, Y = _power_model(dev)
    seen = {}
    chol = M.safe_cholesky

    def spy(A, *a, **k):
        out = chol(A, *a, **k)
        seen.setdefault(mode, []).append(out)
        return out

    monkeypatch.setattr(M, "safe_cholesky", spy)
    res = {}
    for mode in ("highest", "high", "default"):
        sp = dataclasses.replace(spec, fast_solves=True, solve_precision=mode)
        p = weights.tree_map(lambda t: t.detach().clone().requires_grad_(True),
                             params)
        before = (R.LAUNCHES, R.BWD_LAUNCHES)
        mu, var = M.marginal_qf(sp, p, X)
        e = M.elbo(sp, p, X, Y)[0]
        grads = torch.autograd.grad(e, weights.tree_leaves(p))
        assert (R.LAUNCHES - before[0], R.BWD_LAUNCHES - before[1]) == (2, 1)
        assert _matmul_flags() == (False, "highest")
        res[mode] = (mu.detach(), var.detach(), grads)
    for mode in ("high", "default"):
        for (L, Aj), (L0, Aj0) in zip(seen[mode], seen["highest"]):
            assert torch.equal(L, L0) and torch.equal(Aj, Aj0)
        mu, var, grads = res[mode]
        mu0, var0, grads0 = res["highest"]
        assert float((mu - mu0).abs().max()) > 0.0
        assert float((var - var0).abs().max()) > 0.0
        assert max(float((g - g0).abs().max()) for g, g0 in zip(grads, grads0)) > 0.0


@pytest.mark.parametrize("change, calls", [
    (dict(whiten=False), (1, 1)), (dict(fast_solves=True), (1, 1)),
    (dict(fast_solves=True, solve_precision="default"), (1, 1)),
    (dict(whiten=False, mean="linear"), (1, 1))])
def test_model_branches_step_through_both_kernels_once(dev, change, calls):
    """A training step of the unwhitened model (its KL reuses marginal_qf's
    K_zz), of fast solves and of a linear mean: 1 forward launch and 1
    backward call, and the ELBO the CPU gives (fp64)."""
    import dataclasses

    from tgp.pytorch_tpu_torch.models import tgp as M

    rng = np.random.RandomState(0)
    X, Y = rng.randn(455, 13), rng.randn(455, 1)
    spec = dataclasses.replace(weights.flagship_spec(455, Dx=13, M=50, quad=20),
                               **change)
    params = M.init_tgp_params(spec, X, X[:50], variance_scale=0.1,
                               dtype=torch.float64, device="cpu")
    gpu, cpu = _one_step(dev, spec, params, X, Y), _one_step("cpu", spec,
                                                             params, X, Y)
    assert gpu[0] == calls and cpu[0] == (0, 0)
    assert abs(gpu[1] - cpu[1]) <= 1e-10 * abs(cpu[1])


def test_full_covariance_adds_one_gram_launch(dev):
    """marginal_qf with diagonal=False: the pair and K_xx, 2 forward
    launches, and the CPU's covariance (fp64)."""
    from tgp.pytorch_tpu_torch.models import tgp as M

    rng = np.random.RandomState(1)
    X = rng.randn(200, 4)
    pcfg.set_precision("fp64")
    try:
        spec = weights.flagship_spec(200, M=30, quad=20)
        params = weights.flagship_params(spec, X, seed=0, device="cpu",
                                         dtype=torch.float64)
        out = []
        for device in (dev, "cpu"):
            p = weights.tree_map(lambda t: t.to(device), params)
            before = R.LAUNCHES
            mu, cov = M.marginal_qf(spec, p, torch.tensor(X, device=device),
                                    diagonal=False)
            out.append((R.LAUNCHES - before, mu, cov))
    finally:
        pcfg.set_precision("fp32")
    assert out[0][0] == 2 and out[1][0] == 0
    _close_scaled(out[0][1], out[1][1], 1e-10)
    _close_scaled(out[0][2], out[1][2], 1e-10)


# ---------------------------------------------------------------------------
# the deep TGP and natural gradients
# ---------------------------------------------------------------------------

def _dgp(device, L=2, N=60, Dx=3, M=10):
    """A DGP-L (inner layers Dx wide, a SAL(1) output flow, 10 GH nodes,
    S_train 2, S_test 5) on seeded rows, its Trainer on `device` (fp64)."""
    from tgp.pytorch_tpu_torch.data import ArrayDataset, DataLoader
    from tgp.pytorch_tpu_torch.flows import generators as G, spec_from_list
    from tgp.pytorch_tpu_torch.likelihoods import LikelihoodSpec
    from tgp.pytorch_tpu_torch.models import deep as D, tgp as M_
    from tgp.pytorch_tpu_torch.ops import kernels as K
    from tgp.pytorch_tpu_torch.train import Trainer

    rng = np.random.RandomState(2)
    X, Y = rng.randn(N, Dx), rng.randn(N, 1)
    np.random.seed(0)
    fspec, inits = spec_from_list(G.SAL(1))
    k = K.from_name("scale_rbf")
    last = M_.TGPSpec(Dy=1, Dx=Dx, M=M, N=float(N), kernel=k, flow=fspec,
                      likelihood=LikelihoodSpec("gaussian_flow", 1,
                                                quad_points=10))
    spec = D.DeepTGPSpec(layers=tuple(D.layer_spec(Dx, Dx, M, float(N), k)
                                      for _ in range(L - 1)) + (last,),
                         S_train=2, S_test=5)
    params = D.init_deep_params(spec, X, X[:M], flow_inits=inits,
                                device="cpu", dtype=torch.float64)
    loaders = [DataLoader(ArrayDataset(X, Y), N, seed=0),
               DataLoader(ArrayDataset(X[:20], Y[:20]), 100, shuffle=False)]
    return Trainer(spec, params, loaders, np.ones(1), S_test=5, seed=0,
                   device=device), X, Y


@pytest.mark.parametrize("L", [2, 3])
def test_dgp_goes_through_both_kernels_once_a_layer(dev, L):
    """L forward launches and L backward calls a training step, L forward
    launches an evaluation batch and a served request, none backward."""
    pcfg.set_precision("fp64")
    try:
        tr, X, Y = _dgp(dev, L)
        before = (R.LAUNCHES, R.BWD_LAUNCHES)
        tr.train(3, 0.01, verbose_each=0)
        assert (R.LAUNCHES - before[0], R.BWD_LAUNCHES - before[1]) == (3 * L,
                                                                        3 * L)
        before = R.LAUNCHES
        m = tr.compute_metrics()
        assert R.LAUNCHES == before + 2 * L          # 2 evaluation batches
        assert np.isfinite(m["test"]["logL"]).all()
        pred = Predictor(tr.spec, tr.params, buckets=(16, 64))
        before, bwd = R.LAUNCHES, R.BWD_LAUNCHES
        out = pred.predict(X[:20], samples=30)
        lp = pred.log_prob(X[:20], Y[:20])
        assert R.LAUNCHES == before + 2 * L and R.BWD_LAUNCHES == bwd
    finally:
        pcfg.set_precision("fp32")
    assert np.isfinite(out["mean"]).all() and np.isfinite(lp).all()
    assert (out["lower"] <= out["upper"]).all()


def test_dgp_on_the_card_matches_the_cpu(dev, monkeypatch):
    """5 training steps of DGP-2 on the same draws: the curves and every
    parameter, fp64, relative to the largest entry (1e-10)."""
    pcfg.set_precision("fp64")
    try:
        runs = []
        for device in (dev, "cpu"):
            _cpu_draws(monkeypatch, 5)
            tr, _, _ = _dgp(device)
            tr.train(5, 0.01, verbose_each=0)
            runs.append(tr)
    finally:
        pcfg.set_precision("fp32")
    gpu, cpu = runs
    assert _rel(gpu.loss_curve, cpu.loss_curve) <= 1e-10
    for a, b in zip(weights.tree_leaves(gpu.params),
                    weights.tree_leaves(cpu.params)):
        assert _rel(a, b) <= 1e-10


def test_natgrad_step_launches_once_and_lands_on_the_conjugate_optimum(dev):
    """One gamma=1 natural-gradient step of a conjugate SVGP (fp64, fixed
    hyperparameters, full batch) is 1 forward launch and no backward call
    (K does not depend on q(U)) and lands on the optimal q(U)
    (`tests/test_natgrad.py`'s tolerance)."""
    from tgp.pytorch_tpu_torch.likelihoods import LikelihoodSpec
    from tgp.pytorch_tpu_torch.models import tgp as M_
    from tgp.pytorch_tpu_torch.ops import kernels as K
    from tgp.pytorch_tpu_torch.train import natgrad as NG

    rng = np.random.RandomState(0)
    Xn, Yn = rng.randn(80, 2), rng.randn(80, 1)
    pcfg.set_precision("fp64")
    try:
        spec = M_.TGPSpec(Dy=1, Dx=2, M=12, N=80.0,
                          kernel=K.from_name("scale_rbf"),
                          likelihood=LikelihoodSpec("gaussian", 1))
        p0 = M_.init_tgp_params(spec, Xn, Xn[:12], variance_scale=1e-5,
                                kernel_init={"length_scale": 2.0,
                                             "kernel_scale": 2.0}, device=dev)
        X, Y = (torch.tensor(a, device=dev) for a in (Xn, Yn))
        before = (R.LAUNCHES, R.BWD_LAUNCHES)
        p1 = NG.natgrad_update(spec, p0, X, Y, None, 1.0)
        assert (R.LAUNCHES - before[0], R.BWD_LAUNCHES - before[1]) == (1, 0)
        e0, e1 = (float(M_.elbo(spec, p, X, Y)[0]) for p in (p0, p1))
        e2 = float(M_.elbo(spec, NG.natgrad_update(spec, p1, X, Y, None, 1.0),
                           X, Y)[0])
    finally:
        pcfg.set_precision("fp32")
    assert e1 > e0 + 10.0 and abs(e2 - e1) < 1e-4


def _ng_trainer(device, batch, move=0.0, N=60, M=6):
    """A TGP (Dy=1, Dx=3, a SAL(1) flow, M inducing points, 10 GH nodes) on
    N seeded rows from a perturbed init, every initial parameter scaled by
    (1 + move); its Trainer on `device` (fp64), training rows in batches of
    `batch` (the permutation is drawn on the host)."""
    from tgp.pytorch_tpu_torch.data import ArrayDataset, DataLoader
    from tgp.pytorch_tpu_torch.flows import generators as G, spec_from_list
    from tgp.pytorch_tpu_torch.likelihoods import LikelihoodSpec
    from tgp.pytorch_tpu_torch.models import tgp as M_
    from tgp.pytorch_tpu_torch.ops import kernels as K
    from tgp.pytorch_tpu_torch.train import Trainer

    rng = np.random.RandomState(3)
    X, Y = rng.randn(N, 3), rng.randn(N, 1)
    np.random.seed(0)
    fspec, inits = spec_from_list(G.SAL(1))
    spec = M_.TGPSpec(Dy=1, Dx=3, M=M, N=float(N),
                      kernel=K.from_name("scale_rbf"), flow=fspec,
                      likelihood=LikelihoodSpec("gaussian_flow", 1,
                                                quad_points=10))
    params = M_.init_tgp_params(spec, X, X[:M].copy(), flow_inits=inits,
                                dtype=torch.float64, device="cpu")
    params = weights.tree_map(lambda t: t * (1 + move),
                              weights.perturb_params(params, seed=1))
    loaders = [DataLoader(ArrayDataset(X, Y), batch, seed=2),
               DataLoader(ArrayDataset(X[:20], Y[:20]), 100, shuffle=False)]
    return Trainer(spec, params, loaders, np.ones(1), S_test=5, seed=0,
                   device=device)


# these runs are not chaotic: the CPU's own run from a start scaled by
# 1 + 1e-15 stays within 9.4e-15 (full batch) and 3.7e-15 (minibatch) of a
# leaf's largest entry over the same steps
@pytest.mark.parametrize("batch, ng", [
    pytest.param(60, dict(natgrad_gamma=1.0), id="full_batch"),
    pytest.param(16, dict(natgrad_gamma=0.5, natgrad_warmup=9),
                 id="minibatch-warmup"),
])
def test_natgrad_trainer_on_the_card_matches_the_cpu(dev, batch, ng):
    """The Trainer's fused natural-gradient step (Adam on the
    hyperparameters, natural gradients on q(U)): 20 full-batch steps at
    gamma 1, or 5 epochs of 4 minibatches under a ramp, on the card and on
    the CPU: the curves and every parameter, fp64, relative to the largest
    entry (1e-10); 1 forward launch and 1 backward call a step."""
    pcfg.set_precision("fp64")
    try:
        runs = []
        for device in (dev, "cpu"):
            tr = _ng_trainer(device, batch)
            before = (R.LAUNCHES, R.BWD_LAUNCHES)
            tr.train(20 if batch == 60 else 5, 0.01, "adam", verbose_each=0,
                     **ng)
            runs.append((tr, (R.LAUNCHES - before[0],
                              R.BWD_LAUNCHES - before[1])))
    finally:
        pcfg.set_precision("fp32")
    (gpu, calls), (cpu, _) = runs
    assert calls == (20, 20)
    for attr in ("loss_curve", "ell_curve", "kld_curve"):
        assert _rel(getattr(gpu, attr), getattr(cpu, attr)) <= 1e-10
    for a, b in zip(weights.tree_leaves(gpu.params),
                    weights.tree_leaves(cpu.params)):
        assert _rel(a, b) <= 1e-10


def test_natgrad_warmup_split_is_bitwise_on_the_card(dev):
    """A ramp of K=10 over one train() call and over 4 + 6: the same bits,
    each step 1 forward launch and 1 backward call (fp32; the full batch
    unshuffled, so that each call sums its rows in one order)."""
    def run(chunks):
        tr = bench.flagship_trainer(dev)
        tr.train_loader.shuffle = False
        before = (R.LAUNCHES, R.BWD_LAUNCHES)
        for n in chunks:
            tr.train(n, bench.LR, "adam", verbose_each=0, natgrad_gamma=1.0,
                     natgrad_warmup=10)
        assert (R.LAUNCHES - before[0], R.BWD_LAUNCHES - before[1]) == (10, 10)
        return tr

    a, b = run([10]), run([4, 6])
    assert a._ng_t == b._ng_t == 10
    assert np.array_equal(np.asarray(a.loss_curve), np.asarray(b.loss_curve))
    for p, q in zip(weights.tree_leaves(a.params), weights.tree_leaves(b.params)):
        assert torch.equal(p, q)


# ---------------------------------------------------------------------------
# the multi-seed battery: the replica axis folded into the kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", [(1, 455, 100, 13), TRAIN, (2, 131, 77, 3)])
def test_mapped_pair_is_one_launch_and_the_replicas_own(dev, shape, dtype):
    """`torch.func.vmap` of `rbf_gram_pair` over R=4 replicas: one forward
    launch and one backward call, each replica's Grams and gradients those
    of its own kernel calls (and of the plain version) at the kernel
    tolerances, and two backward runs bitwise equal."""
    Rn = 4
    parts = [_inputs(dev, shape, dtype, seed=r) for r in range(Rn)]
    X, Z, ks = (torch.stack(ts) for ts in zip(*parts))
    g = torch.Generator(device=dev).manual_seed(9)
    Dy, N, M, _ = shape
    gs = [torch.randn(Rn, Dy, n, M, generator=g, device=dev, dtype=dtype)
          for n in (N, M)]

    def mapped():
        leaves = [t.clone().requires_grad_(True) for t in (X, Z, ks)]
        Ks = torch.func.vmap(R.rbf_gram_pair)(*leaves)
        return Ks, torch.autograd.grad(Ks, leaves, gs)

    before = (R.LAUNCHES, R.BWD_LAUNCHES)
    Ks, grads = mapped()
    assert (R.LAUNCHES - before[0], R.BWD_LAUNCHES - before[1]) == (1, 1)
    again = mapped()[1]
    for a, b in zip(grads, again):
        assert torch.equal(a, b)
    tol = 2e-5 if dtype == torch.float32 else 1e-12
    gtol = 1e-4 if dtype == torch.float32 else 1e-10
    for r in range(Rn):
        leaves = [t[r].clone().requires_grad_(True) for t in (X, Z, ks)]
        own = R.rbf_gram_pair(*leaves)
        own_grads = torch.autograd.grad(own, leaves, [g_[r] for g_ in gs])
        plain = R.rbf_gram_pair_reference(X[r], Z[r], ks[r])
        for k, o, p in zip(Ks, own, plain):
            _close(k[r].detach(), o.detach(), tol)
            _close(k[r].detach(), p, tol)
        for a, b in zip(grads, own_grads):
            _close_scaled(a[r], b, gtol)


def test_battery_on_the_card_matches_the_cpu(dev):
    """A 3-replica `train_multiseed` (TGP, SAL(1), 60 rows, M=6) for 15
    steps and `eval_multiseed`, fp64, on the card and on the CPU: the curves,
    every parameter and the metrics (coverage's draws come from each
    device's own generators, so it is left out), relative to the largest
    entry (1e-10); 1 forward launch and 1 backward call a step, 2 forward
    launches an evaluation."""
    from tgp.pytorch_tpu_torch.flows import generators as G
    from tgp.pytorch_tpu_torch.flows.core import spec_from_list
    from tgp.pytorch_tpu_torch.likelihoods import LikelihoodSpec
    from tgp.pytorch_tpu_torch.models import tgp as M_
    from tgp.pytorch_tpu_torch.ops import kernels as K
    from tgp.pytorch_tpu_torch.train import multiseed as ms

    pcfg.set_precision("fp64")
    try:
        rs = np.random.RandomState(4)
        X = rs.randn(3, 60, 2)
        Y = np.sinh(X @ rs.randn(3, 2, 1)) + 0.1 * rs.randn(3, 60, 1)
        np.random.seed(0)
        fspec, inits = spec_from_list(G.SAL(1))
        spec = M_.TGPSpec(Dy=1, Dx=2, M=6, N=60.0,
                          kernel=K.from_name("scale_rbf"), flow=fspec,
                          likelihood=LikelihoodSpec("gaussian_flow", 1,
                                                    quad_points=10))
        stack = ms.stack_trees([weights.perturb_params(M_.init_tgp_params(
            spec, X[r], X[r][:6].copy(), flow_inits=inits, device="cpu"),
            seed=r) for r in range(3)])
        runs = []
        for device in (dev, "cpu"):
            before = (R.LAUNCHES, R.BWD_LAUNCHES)
            out, curves = ms.train_multiseed(spec, stack, X, Y, 15, 0.01,
                                             device=device)
            train_calls = (R.LAUNCHES - before[0], R.BWD_LAUNCHES - before[1])
            m = ms.eval_multiseed(spec, out, X, Y, np.ones((3, 1)), S_test=20,
                                  device=device)
            runs.append((out, curves, m, train_calls,
                         (R.LAUNCHES - before[0] - train_calls[0],
                          R.BWD_LAUNCHES - before[1] - train_calls[1])))
    finally:
        pcfg.set_precision("fp32")
    (out_g, cv_g, m_g, calls, ev_calls), (out_c, cv_c, m_c, _, _) = runs
    assert calls == (15, 15) and ev_calls == (2, 0)
    for k in cv_c:
        assert _rel(cv_g[k], cv_c[k]) <= 1e-10
    for a, b in zip(weights.tree_leaves(out_g), weights.tree_leaves(out_c)):
        assert _rel(a, b) <= 1e-10
    for k in ("logL", "rmse"):
        assert _rel(m_g[k], m_c[k]) <= 1e-10


# ---------------------------------------------------------------------------
# L-BFGS and a run's runtime
# ---------------------------------------------------------------------------

def test_lbfgs_trainer_on_the_card_matches_the_cpu(dev):
    """10 L-BFGS iterations on the SAL(1) TGP above (full batch, fp64), on
    the card and on the CPU: the curves and every parameter within 1e-10 of
    the largest entry; each evaluation (an iteration's start and each
    line-search trial, one host read each) 1 forward launch and 1 backward
    call."""
    from tgp.pytorch_tpu_torch.train import lbfgs as LB

    pcfg.set_precision("fp64")
    try:
        runs = []
        for device in (dev, "cpu"):
            tr = _ng_trainer(device, 60)
            before = (R.LAUNCHES, R.BWD_LAUNCHES, LB.HOST_READS)
            tr.train(10, 0.0, "lbfgs", verbose_each=0)
            runs.append((tr, (R.LAUNCHES - before[0], R.BWD_LAUNCHES - before[1],
                              LB.HOST_READS - before[2])))
    finally:
        pcfg.set_precision("fp32")
    (gpu, (fwd, bwd, reads)), (cpu, (_, _, cpu_reads)) = runs
    assert fwd == bwd == reads == cpu_reads and reads > 10
    assert len(gpu.loss_curve) == 10
    for attr in ("loss_curve", "ell_curve", "kld_curve"):
        assert _rel(getattr(gpu, attr), getattr(cpu, attr)) <= 1e-10
    for a, b in zip(weights.tree_leaves(gpu.params),
                    weights.tree_leaves(cpu.params)):
        assert _rel(a, b) <= 1e-10


def test_resume_on_the_card_is_bitwise_and_eval_device_cpu_agrees(dev,
                                                                   tmp_path):
    """Adam 5 + 5 steps on one card Trainer against 5, save, restore into a
    fresh card Trainer, 5 more: the same bits; then the restored Trainer's
    metrics with `eval_device="cpu"` (no launch) against the card's (fp64,
    within 1e-10)."""
    pcfg.set_precision("fp64")
    try:
        a = _ng_trainer(dev, 60)
        for _ in range(2):
            a.train(5, 0.01, "adam", verbose_each=0)
        b = _ng_trainer(dev, 60)
        b.train(5, 0.01, "adam", verbose_each=0)
        b.save(str(tmp_path))
        c = _ng_trainer(dev, 60)
        c.restore(str(tmp_path))
        c.train(5, 0.01, "adam", verbose_each=0)
        for p, q in zip(weights.tree_leaves(a.params),
                        weights.tree_leaves(c.params)):
            assert p.is_cuda and torch.equal(p, q)
        c.save(str(tmp_path), step=100)
        d = _ng_trainer(dev, 60)
        d.restore(str(tmp_path), step=100)
        d.eval_device = "cpu"
        want = c.compute_metrics()
        before = R.LAUNCHES
        got = d.compute_metrics()
        assert R.LAUNCHES == before
    finally:
        pcfg.set_precision("fp32")
    for split in ("train", "test"):
        for k in ("logL", "rmse"):
            assert _rel(got[split][k], want[split][k]) <= 1e-10


def test_remat_step_launches_the_forward_twice_and_gives_the_plain_bits(dev):
    """`spec.remat` recomputes marginal_qf in the backward: 2 forward
    launches and 1 backward call a step, and the loss and every gradient
    bitwise the plain step's (the flagship, 8611 rows, fp32)."""
    import dataclasses
    from tgp.pytorch_tpu_torch.models import tgp as M_

    spec, params, X, Y = _power_model(dev)
    outs, calls = [], []
    for remat in (False, True):
        leaves = [t.detach().clone().requires_grad_(True)
                  for t in weights.tree_leaves(params)]
        before = (R.LAUNCHES, R.BWD_LAUNCHES)
        e = M_.elbo(dataclasses.replace(spec, remat=remat),
                    weights.tree_unflatten(params, leaves), X, Y)[0]
        g = torch.autograd.grad(-e, leaves, allow_unused=True,
                                materialize_grads=True)
        torch.cuda.synchronize()
        calls.append((R.LAUNCHES - before[0], R.BWD_LAUNCHES - before[1]))
        outs.append((e.detach(), g))
    assert calls == [(1, 1), (2, 1)]
    assert torch.equal(outs[0][0], outs[1][0])
    for a, b in zip(outs[0][1], outs[1][1]):
        assert torch.equal(a, b)


def test_host_loop_is_bitwise_the_device_resident_path(dev):
    """The Trainer's host loop (DEVICE_RESIDENT_BYTES = 0, and a track_fn)
    against the device-resident minibatch path: the same rows in the same
    order through the same kernels, 1 and 1 launches a step, the same
    bits (fp64, 60 rows in batches of 16: 4 steps an epoch)."""
    pcfg.set_precision("fp64")
    try:
        trs, counts, calls = [], [], []
        for mode in ("resident", "host_bytes", "track_fn"):
            tr = _ng_trainer(dev, 16)
            if mode == "host_bytes":
                tr.DEVICE_RESIDENT_BYTES = 0
            if mode == "track_fn":
                tr.track_fn = lambda t: calls.append(1)
            before = (R.LAUNCHES, R.BWD_LAUNCHES)
            tr.train(3, 0.01, "adam", verbose_each=0)
            counts.append((R.LAUNCHES - before[0], R.BWD_LAUNCHES - before[1]))
            trs.append(tr)
    finally:
        pcfg.set_precision("fp32")
    assert counts == [(12, 12)] * 3 and len(calls) == 12
    for tr in trs[1:]:
        assert len(tr.loss_curve) == 12
        np.testing.assert_array_equal(tr.loss_curve[2::4], trs[0].loss_curve)
        for p, q in zip(weights.tree_leaves(trs[0].params),
                        weights.tree_leaves(tr.params)):
            assert p.is_cuda and torch.equal(p, q)


def _kin8nm_trainer(device):
    """The flagship's model on kin8nm split 1 (7372 rows, Dx=8, M=100,
    Z = the first 100 rows): its bf16 K_zz is positive definite."""
    import dataclasses

    from tgp.pytorch_tpu_torch.data import return_dataset
    from tgp.pytorch_tpu_torch.train import Trainer

    loaders, d = return_dataset("kin8nm", 10000, seed=1)
    X = d["X_tr"]
    spec = dataclasses.replace(weights.flagship_spec(X.shape[0], Dx=8),
                               min_var=1e-8)
    params = weights.flagship_init(spec, X, variance_scale=1e-5,
                                   device=device)
    return Trainer(spec, params, loaders, d["Y_std"], device=device)


# 10x the gap first measured (1.19e-3, on an NVIDIA H100 80GB HBM3 at 700 W):
# bf16 runs part as far as bf16 rounding carries them
BF16_CURVE_LIMIT = 1.2e-2


def test_bf16_routes_on_a_step_and_two_serving_buckets(dev):
    """bf16: a flagship step is 1 forward launch (K_xz, 861,100 entries),
    1 backward call and 1 bf16-route Gram (K_zz); a request at bucket 256
    launches nothing (2 bf16 Grams), at 4096 once (1 bf16 Gram)."""
    from tgp.pytorch_tpu_torch.ops import kernels as K

    pcfg.set_precision("bf16")
    try:
        tr = bench.flagship_trainer(dev)
        tr.nan_guard = False            # its bf16 K_zz is not PD (NaN)
        R.LAUNCHES = R.BWD_LAUNCHES = K.BF16_GRAMS = 0
        tr.train(3, bench.LR, "adam", verbose_each=0)
        assert (R.LAUNCHES, R.BWD_LAUNCHES, K.BF16_GRAMS) == (3, 3, 3)
        kin = _kin8nm_trainer(dev)
        pred = Predictor(kin.spec, weights.tree_map(lambda t: t.detach(),
                                                    kin.params),
                         buckets=(256, 4096), device=dev)
        X = kin.train_loader.dataset.X
        for n, want in ((200, (0, 0, 2)), (3000, (1, 0, 1))):
            R.LAUNCHES = R.BWD_LAUNCHES = K.BF16_GRAMS = 0
            out = pred.predict(X[:n])
            assert (R.LAUNCHES, R.BWD_LAUNCHES, K.BF16_GRAMS) == want
            assert np.isfinite(out["mean"]).all()
    finally:
        pcfg.set_precision("fp32")


def test_bf16_trainer_on_the_card_matches_the_cpu(dev):
    """kin8nm's model, 10 bf16 epochs on the card and the CPU: the ELBO
    curves within BF16_CURVE_LIMIT of the CPU's largest entry."""
    pcfg.set_precision("bf16")
    try:
        curves = []
        for d in (dev, "cpu"):
            tr = _kin8nm_trainer(d)
            tr.train(10, bench.LR, "adam", verbose_each=0)
            curves.append(np.asarray(tr.loss_curve, np.float64))
    finally:
        pcfg.set_precision("fp32")
    assert np.isfinite(curves[0]).all()
    gap = np.abs(curves[0] - curves[1]).max() / np.abs(curves[1]).max()
    print(f"bf16 kin8nm 10 epochs, card against CPU: {gap:.3e}")
    assert gap <= BF16_CURVE_LIMIT, gap


def test_one_by_one_nccl_mesh_is_bitwise_the_run_without(dev, tmp_path):
    """A 1x1 mesh under NCCL (one process): 10 fp64 flagship epochs with
    the same bits and the same launches as the Trainer without a mesh."""
    from tgp.pytorch_tpu_torch.parallel import make_mesh, multihost
    from tgp.pytorch_tpu_torch.train import Trainer

    pcfg.set_precision("fp64")
    multihost.initialize(f"file://{tmp_path}/store", 1, 0, platform="gpu")
    try:
        assert torch.distributed.get_backend() == "nccl"
        mesh = make_mesh(1, 1)
        runs = []
        for m in (None, mesh):
            tr = bench.flagship_trainer(dev)
            if m is not None:
                tr = Trainer(tr.spec, tr.params,
                             [tr.train_loader, tr.test_loader], tr.Y_std,
                             mesh=m)
            R.LAUNCHES = R.BWD_LAUNCHES = 0
            tr.train(10, bench.LR, "adam", verbose_each=0)
            runs.append((tr, (R.LAUNCHES, R.BWD_LAUNCHES)))
    finally:
        multihost.shutdown()
        pcfg.set_precision("fp32")
    assert runs[0][1] == runs[1][1] == (10, 10)
    for a, b in zip(weights.tree_leaves(runs[0][0].params),
                    weights.tree_leaves(runs[1][0].params)):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the library surface and remat under the battery's replica map
# ---------------------------------------------------------------------------

def _battery_model(kind, R_=3, N=60, M=6):
    """(spec, stacked params, X, Y) on the CPU: a SAL(1) TGP, or an ID_TGP
    whose SAL(1) nets draw dropout masks ('id_tgp'), R_ replicas."""
    from tgp.pytorch_tpu_torch.flows import generators as G
    from tgp.pytorch_tpu_torch.flows.core import spec_from_list
    from tgp.pytorch_tpu_torch.likelihoods import LikelihoodSpec
    from tgp.pytorch_tpu_torch.models import tgp as M_
    from tgp.pytorch_tpu_torch.ops import kernels as K
    from tgp.pytorch_tpu_torch.train import multiseed as ms

    rs = np.random.RandomState(4)
    X = rs.randn(R_, N, 2)
    Y = np.sinh(X @ rs.randn(R_, 2, 1)) + 0.1 * rs.randn(R_, N, 1)
    np.random.seed(0)
    arch = (G.SAL(1, input_dependent=True, input_dim=2, hidden_dim=4,
                  num_hidden_layers=1, dropout=0.25, inference="MC_dropout")
            if kind == "id_tgp" else G.SAL(1))
    fspec, inits = spec_from_list(arch)
    spec = M_.TGPSpec(Dy=1, Dx=2, M=M, N=float(N),
                      kernel=K.from_name("scale_rbf"), flow=fspec,
                      likelihood=LikelihoodSpec("gaussian_flow", 1,
                                                quad_points=10))
    stack = ms.stack_trees([weights.perturb_params(M_.init_tgp_params(
        spec, X[r], X[r][:M].copy(), flow_inits=inits, device="cpu"),
        seed=r) for r in range(R_)])
    return spec, stack, X, Y


@pytest.mark.parametrize("kind, R_", [("tgp", 1), ("tgp", 3),
                                      ("minibatch", 3), ("id_tgp", 3)])
def test_battery_remat_on_the_card_is_bitwise_the_plain_battery(dev, kind,
                                                                R_):
    """`spec.remat` under the battery's map, fp32 on the card, 6 steps: 2
    forward launches and 1 backward call a step whatever R; parameters,
    curves, Adam moments and the replicas' generators bitwise the plain
    battery's (an ID_TGP's dropout masks replayed in the recompute)."""
    import dataclasses
    from tgp.pytorch_tpu_torch.train import multiseed as ms

    spec, stack, X, Y = _battery_model(kind, R_)
    kw = dict(batch_size=20) if kind == "minibatch" else {}
    steps = 6 * (3 if kind == "minibatch" else 1)
    runs = []
    for remat in (False, True):
        before = (R.LAUNCHES, R.BWD_LAUNCHES)
        out, cv, st = ms.train_multiseed_minibatch(
            dataclasses.replace(spec, remat=remat), stack, X, Y, 6, 0.01,
            batch_size=kw.get("batch_size", 10 ** 9), seed=5, device=dev,
            return_state=True)
        torch.cuda.synchronize()
        runs.append((out, cv, st, (R.LAUNCHES - before[0],
                                   R.BWD_LAUNCHES - before[1])))
    (out, cv, st, calls), (out_r, cv_r, st_r, calls_r) = runs
    assert calls == (steps, steps) and calls_r == (2 * steps, steps)
    for a, b in zip(weights.tree_leaves(out), weights.tree_leaves(out_r)):
        assert torch.equal(a, b)
    for k in cv:
        np.testing.assert_array_equal(cv[k], cv_r[k])
    for a, b in zip(st["opt_state"].mu + st["opt_state"].nu,
                    st_r["opt_state"].mu + st_r["opt_state"].nu):
        assert torch.equal(a, b)
    for a, b in zip(st["rngs"], st_r["rngs"]):
        assert torch.equal(a, b)


def test_top_level_names_and_the_tgp_wrapper_on_the_card(dev):
    """The JAX quickstart's names from the port's top level build a model
    on the card; `TGP`'s five methods give the functional calls' bits, each
    through one forward launch and no backward but the ELBO's gradient."""
    from tgp.pytorch_tpu_torch import (TGP, TGPSpec, LikelihoodSpec,
                                       init_tgp_params, kmeans_centers)
    from tgp.pytorch_tpu_torch.flows import generators as G, spec_from_list
    from tgp.pytorch_tpu_torch.models import tgp as M_
    from tgp.pytorch_tpu_torch.ops import kernels as K

    rs = np.random.RandomState(2)
    X = rs.randn(200, 4)
    Y = np.sinh(X @ rs.randn(4, 1)) + 0.1 * rs.randn(200, 1)
    np.random.seed(0)
    flow, inits = spec_from_list(G.SAL(2))
    spec = TGPSpec(Dy=1, Dx=4, M=20, N=200.0, kernel=K.from_name("scale_rbf"),
                   likelihood=LikelihoodSpec("gaussian_flow", 1,
                                             quad_points=100), flow=flow)
    params = init_tgp_params(spec, X, kmeans_centers(X, 20, n_init=10),
                             variance_scale=1e-5, flow_inits=inits,
                             device=dev)
    model = TGP(spec, params)
    Xd, Yd, Ys = (torch.as_tensor(a, dtype=torch.float32, device=dev)
                  for a in (X, Y, np.array([1.3])))
    calls = {"elbo": ((Xd, Yd), {}), "marginal_qf": ((Xd,), {}),
             "predictive_distribution": ((Xd,), {}),
             "test_log_likelihood": ((Xd, Yd, Ys), {}),
             "sample_predictive": ((Xd, 10), {})}
    for name, (args, kw) in calls.items():
        outs = []
        for fn in (getattr(model, name),
                   lambda *a, **k: getattr(M_, name)(spec, params, *a, **k)):
            extra = ((torch.Generator(device=dev).manual_seed(3),)
                     if name == "sample_predictive" else ())
            before = R.LAUNCHES
            out = fn(*args, *extra, **kw)
            torch.cuda.synchronize()
            assert R.LAUNCHES - before == 1, name
            outs.append(out if isinstance(out, tuple) else (out,))
        for a, b in zip(*outs):
            assert torch.equal(a, b), name


def test_quickstart_on_the_card_reads_its_checkpoint_back(dev, tmp_path):
    """`examples.quickstart.run` for 5 epochs on the card (fp32, M=50): 1
    forward launch and 1 backward call a step, 2 forward an evaluation
    batch (train and test), 1 for the served request; the checkpoint's
    params and JSON spec read back bitwise."""
    from tgp.pytorch_tpu_torch.examples import quickstart
    from tgp.pytorch_tpu_torch.models.serialization import spec_from_json
    from tgp.pytorch_tpu_torch.train.checkpoint import load_checkpoint

    before = (R.LAUNCHES, R.BWD_LAUNCHES)
    res = quickstart.run(5, dev, checkpoint_dir=str(tmp_path), verbose_each=0)
    torch.cuda.synchronize()
    assert (R.LAUNCHES - before[0], R.BWD_LAUNCHES - before[1]) == (10, 5)
    params, _, step, extra = load_checkpoint(str(tmp_path))
    assert step == 5
    for a, b in zip(weights.tree_leaves(params),
                    weights.tree_leaves(res["trainer"].params)):
        assert torch.equal(a, b.detach().cpu())
    assert spec_from_json(extra["spec"]) == res["spec"]
    assert np.all(np.isfinite(res["prediction"]["mean"]))
