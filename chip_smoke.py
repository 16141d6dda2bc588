#!/usr/bin/env python3
"""Drive the PyTorch port (`tgp.pytorch_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --bwd-compare DIR   # the backward's two designs
                                              # against DIR's backward,
                                              # information only

Phases, each of which fails the run (non-zero exit) on any error:
  1. device: the card's name and power limit; build the CUDA Gram kernels
     (forward and backward, one nvcc each, at once) from
     `tgp/pytorch_tpu_torch/csrc/` into `build/kernels/`;
  2. kernel: both kernels against their plain torch versions on the card at
     the serving shapes (K_zz 100x100, K_xz 256x100 and 4096x100, a ragged
     batched case, fp64), the training shape 8611x100 (fp32 and fp64) and
     the pair (K_xz and K_zz in one launch) at 256, 4096 and 8611 rows and
     at the experiment CLI's shapes (boston 455+100 and 51+100 at Dx=13 in
     fp64 and fp32; M=20 at naval's, protein's and kin8nm's batches, Dx 17,
     9 and 8), the WGP's (boston at Dx=13: serving's 256+100 and 4096+100
     in fp32, StepTanhL's 455+20 and 51+20 in fp64) and the classification
     protocol's (1080+50 and 120+50, Dy=1 and Dy=3, fp32 and fp64): the
     forward, the backward kernel's block pass and tile pass (each twice,
     bitwise equal; the tile pass where it takes the shape) and the
     dispatched call (`bwd_design`'s pass, to the bit), and the autograd
     gradients, with device times from CUDA-graph replays
     beside the bound; the deep TGP's (Dy=13 Dx=13 455+100 in fp64 and
     fp32, 5100+100 and 45500+100 in fp64; Dy=8 Dx=8 7373+100 and
     737300+100 in fp32); and one Gram of 2,200,000 rows;
  3. serving: `serve.Predictor` on the flagship TGP (UCI power split 1, SAL 2
     flow, scale-RBF ARD kernel, whitened q(U) with M=100, 100 Gauss-Hermite
     nodes, fp32, buckets 256/4096) answering moments, band, sample,
     log_prob and map requests; the forward kernel's launch count must rise
     by exactly 1 per request and the backward's not at all; results are
     checked against the same Predictor on the CPU in fp32 and in fp64, and
     K_zz's jitter rung must be the CPU's;
  4. gradient: the flagship's `test_log_likelihood` over the 8611 training
     rows in fp32 and its gradient into every parameter, through exactly 1
     forward launch and 1 backward kernel call, checked against the same
     gradient on the CPU in fp32 and in fp64;
  5. training: `bench.flagship_trainer` (`train.Trainer` on the 8611 power
     training rows with `bench.py`'s model and init, full batch, Adam at lr
     0.01): 20 steps in fp64 on the card against the CPU, 50 steps in fp32
     on the card against the CPU in fp32 and in fp64 (q(U) through its KL
     curve there), exactly 1 forward launch and 1 backward kernel call per
     step, `compute_metrics` against the CPU's on the same trained
     parameters; then the step time (median of 5 x 10 steps) and a profile
     of 10 steps (steps/s is `python -m tgp.pytorch_tpu_torch.bench`'s);
  6. experiment: the experiment CLI (`experiments.main.run`) on boston TGP
     at M=100 (StepTanhL(10, 2), identity-fitted, then 100 epochs) on the
     card against the CPU in fp64 and fp32, SVGP boston against the CPU,
     all nine bundled regression datasets with their table archs for 5
     epochs, exactly 1 forward launch and 1 backward call per training
     step; the boston TGP step's time and profile;
  7. ID_TGP (`--model ID_TGP`, the paper's BA-TGP): boston M=100 (the
     2000-epoch hypernet anchor fit, then 100 epochs) on the card against
     the CPU in fp64 and fp32 with the same replayed dropout masks, the
     same with the card's own draws (the step's time and profile, the
     anchor fit's epoch), the VI nets (`--nnet_inference
     mean_field_gaussian`), power's deeper nets for 3 epochs with the
     fully-Bayesian evaluation over the 8611 training rows (peak device
     memory); 1 forward launch and 1 backward call a step, none in the
     anchor fit, 2 forward launches an evaluation batch.  Phase 3 also
     serves power's ID_TGP fully Bayesian (`Predictor(fully_bayesian=True)`,
     S_MC=100): moments and bands at both buckets, 1 launch a request.
  8. WGP (`--model WGP`, the warped GP): boston M=100 for 100 epochs with
     the SAL and log_exp observation warps on the card against the CPU in
     fp64 and fp32 (SAL in fp64 held after 30 epochs, its 100-epoch gaps
     logged beside the CPU's run from a start moved by 1e-15), StepTanhL
     (identity-fitted) at M=20 for 5 epochs, the log_exp step's time and
     profile, and warped serving (T^{-1} by Newton's method) at both
     buckets, 1 launch a request;
  9. classification (`experiments.classification_protocol.run`): binary
     (Bernoulli) and 3-class (categorical, the Gram at Dy=3), TGP and
     ID_TGP, 200 epochs, on the card against the CPU in fp64 and fp32 on
     the same draws (`CpuDraws`; binary TGP in fp64 held after 30 epochs,
     as SAL above), accuracy within 2 rows; the four trained fp32 models
     served (`{"probs"}`, 1 launch a request) against the CPU's
     `Predictor`.  Phases 6-9 check 1 forward launch and 1 backward call a
     training step, 2 forward launches an evaluation batch.
 10. model surface: the spectral-mixture forecast's SVGP
     (`experiments.sm_timeseries.run`, two Periodic x ScaleRBF components:
     2 forward launches and 2 backward calls a step, one per rbf leaf), an
     unwhitened TGP on boston at M=100 (its KL reuses marginal_qf's K_zz:
     1 and 1 a step) and per-output flows at Dy=2, 100 epochs in fp64 on
     the card against the CPU; the unwhitened model's full covariance
     (diagonal=False: the pair and K_xx, 2 launches); fast solves at
     solve precision 'high' (TF32) and 'default' (bf16 operands) against
     'highest' in fp32 at power M=100 and M=256 (K_zz's factor bitwise
     equal, the moments and the ELBO's gradient moved, 1 and 1 a step);
     the step times of trsm/highest, fast/highest, fast/high and
     fast/default at both M.
 11. deep and natgrad: the deep TGP (`--model DGP --layers 2`) on boston
     (M=100, the inner layer 13 outputs wide) for 200 epochs on the card
     against the CPU in fp64 and fp32 on the same draws (`CpuDraws`; fp64
     also after 30 epochs, and beside the CPU's run from a moved start), its
     S_test=100 evaluation, step and serving at buckets 256/4096 (2 launches
     a request, the propagation of 819,200 rows in a band request); DGP-2
     --dgp_flow on kin8nm (fp32): its step and one evaluation batch of
     737,300 rows a layer; natural gradients: the conjugate step on power
     (fp64: one gamma=1 step lands on the optimum), the flagship with
     natgrad_gamma 1.0 for 100 epochs on the card against the CPU in fp64
     and fp32 (held after 30 epochs, logged beside moved starts), its step,
     and a warmup ramp of 10 split over two train() calls bitwise equal to
     one call.  2 forward launches and 2 backward calls a DGP-2 step, 2
     forward launches an evaluation batch and a request; 1 and 1 a natgrad
     step.
 12. battery (`experiments.battery`, `train.multiseed`): the Gram pair
     under `torch.func.vmap` over 10 replicas (one launch each way, the
     kernel rows at R·Dy=10 in phase 2); the flagship over power seeds
     1-10 for 30 epochs on the card against the CPU (fp64 leaf by leaf,
     fp32 by the 4x rule) and each replica against `Trainer(seed=r)`;
     `eval_multiseed`; the battery CLI for 100 epochs (boston SVGP, TGP
     SAL_BCL:1, ID_TGP and DGP-2 on replica-wise `CpuDraws`, natgrad power
     SVGP, a minibatch run), and ID_TGP and DGP-2 in fp64 for 30 epochs,
     held against the same runs on the CPU; `--ckpt` resume bitwise;
     `spec.remat` under the replica map (the flagship over power seeds 1-3,
     and boston ID_TGP on replayed replica-wise draws) bitwise the plain
     battery, with both batteries' peak memory; the step at
     R=1 and R=10 (flagship, boston ID_TGP and DGP-2).  1 forward launch
     and 1 backward call a battery step whatever R (2 and 2 for DGP-2, 2
     and 1 with remat), 2 and 0 an `eval_multiseed` call.
 13. L-BFGS and a run's runtime: `Trainer(opt="lbfgs")` on the flagship
     for 20 iterations, fp64 on the card against the CPU (held leaf by
     leaf, beside the CPU's run from a start moved by 1e-15), fp32 on both
     (finite, the gaps to fp64 logged), 1 forward launch and 1 backward
     call an evaluation (an iteration's start and each line-search trial,
     counted by the line search's host reads), the time an iteration, a
     profile and a Chrome trace (`utils.profiling.trace`); a flagship
     Trainer resumed from a checkpoint bitwise the uninterrupted one (fp32
     and fp64), the save and the restore timed; `eval_device="cpu"`
     against the card's metrics (fp64, 1e-10); the CLI with
     `--checkpoint_dir` and one sweep cell (`experiments.sweep`), boston
     SVGP at M=100.
 14. large corpora: a synthetic airline.csv (2,058,097 rows of
     `benchmarks/airline_scale.py`'s synthetic data) parsed by the native
     parser (`data/native.py`, built with g++) and by `np.loadtxt` (the
     same bits), `data.large.load_airline` (1,955,192 training rows);
     airline_scale's model (SAL(2), M=500 from k-means, batch 10000, fp32)
     on the device-resident minibatch path (196 steps an epoch, 1 forward
     launch and 1 backward call each), its steps/s, a profile, the test
     rows' metrics; 20 steps in fp64 on the card against the CPU; the
     Trainer's host loop (a `track_fn`, and DEVICE_RESIDENT_BYTES = 0)
     against the device-resident epoch; `spec.remat` (2 forward launches
     and 1 backward call a step, bitwise the plain step, on airline and on
     a boston ID_TGP whose masks are replayed); a YearMSD-shaped file
     (60,000 x 91) through `load_year`, 20 steps at Dx=90 in fp64 against
     the CPU and in fp32.  The kernel phase holds the pair at airline's
     10000+500 and 5192+500 and YearMSD's 10000+100 at Dx=90.
 15. bf16, rbg and meshes (see `last_modules_phase`).
 16. library surface: the JAX quickstart through the port's top-level
     names (`examples.quickstart`: boston, SAL(2), M=50 from k-means, 100
     Gauss-Hermite nodes, fp32, its full 2000 epochs; E + 5 forward
     launches and E backward calls, 1 and 0 a request), its checkpoint read
     back bitwise, `TGP`'s five methods bitwise the functional calls, its
     test NLL beside the JAX quickstart's, 30 fp64 epochs against the CPU;
     the deep example (`examples.deep_tgp`, 300 of its 1500 epochs; L and
     L a deep step), its shallow SVGP alone for 30 fp64 epochs against the
     CPU.
Beside the kernel phase, two freshly spawned CPU workers each make one
forward-only CPU reference as their first call (WGP log_exp fp32 on boston
at the CLI's init, no epochs: its test and train metrics) and must agree to
the bit, or the run fails with "CPU reference not reproducible".
Phases 9, 11, 12 and 16 run in a second process beside the others.  Every
counted run reads the tile pass's backward calls (`BWD_TILE_LAUNCHES`)
beside the others, set to 0 and read at the same places: none in the
flagship's gradient and training, some in the experiment, deep, battery
and large-corpora phases, whose fp64 Dx = 13 Grams, R Dy = 10 battery and
YearMSD the rule gives the tile pass.
The line before the last holds the kernels' JSON record, the last line
`{"ok": true, "device": {...}}`.  Details go to chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))

# H100 SXM published peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
# fp32 outside the tensor cores; fp64 on the tensor cores (FP64 Tensor Core),
# the larger of the two fp64 rates, so the bound is the least time
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 67e12}

F32_TOL = dict(rtol=2e-5, atol=2e-5)      # tests/test_pallas.py's tolerance
F64_TOL = dict(rtol=1e-12, atol=1e-12)
F32_GRAD_TOL = dict(rtol=1e-4, atol=1e-4)  # tests/test_pallas.py's VJP tolerance
F64_GRAD_TOL = dict(rtol=1e-10, atol=1e-10)


def log(*a):
    print(*a, flush=True)


def check(cond, msg):
    """A failed check ends the run with a non-zero exit (not an assert,
    which `python -O` would drop)."""
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def nvidia_smi() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def host_cpu() -> dict:
    """The host CPU and the math library behind the CPU references: the
    model name, cores, torch's threads, the vector capability it dispatches
    to, and the BLAS/LAPACK it was built with (the CPU references' rounding
    depends on them)."""
    import os
    import re

    model = ""
    try:
        with open("/proc/cpuinfo") as f:
            model = next((ln.split(":", 1)[1].strip() for ln in f
                          if ln.startswith("model name")), "")
    except OSError:
        pass
    show = torch.__config__.show()
    libs = dict(re.findall(r"(BLAS_INFO|LAPACK_INFO)=(\w+)", show))
    mkl = next((ln.strip() for ln in
                torch.__config__.parallel_info().splitlines()
                if "Math Kernel Library" in ln), "")
    return dict(model=model, cores=os.cpu_count(),
                torch_threads=torch.get_num_threads(),
                capability=torch.backends.cpu.get_cpu_capability(),
                blas=libs.get("BLAS_INFO", ""),
                lapack=libs.get("LAPACK_INFO", ""), mkl=mkl)


def graph_ms(fn, calls=100, replays=5) -> float:
    """Device time of one fn() call: a CUDA graph of `calls` calls, replayed
    `replays` times between CUDA events (host launch cost excluded)."""
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(s)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(calls):
            fn()
    g.replay()
    torch.cuda.synchronize()
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0.record()
    for _ in range(replays):
        g.replay()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / (calls * replays)


def gram_bound(Dy, N, M, Dx, dtype, pair=False):
    """Least time for one forward launch: bytes (inputs read once, outputs
    written once) over HBM rate vs operations over the peak rate of the
    dtype; the pair reads Z once and writes K_xz and K_zz.  Returns
    (ms, 'bytes'|'operations', bytes, flops)."""
    item = torch.finfo(dtype).bits // 8
    rows = N + M if pair else N         # output rows, each against Z
    nbytes = item * (Dy * N * Dx + Dy * M * Dx + Dy + Dy * rows * M)
    # cross term 2*Dx, norms 2*Dx per row of X and Z, and per output: add,
    # add, scale, clamp, -0.5*, exp, *ks (an exp counted as one operation)
    flops = Dy * (2 * rows * M * Dx + 2 * (N + M) * Dx + 7 * rows * M)
    return _bound(nbytes, flops, dtype)


def bwd_bound(Dy, N, M, Dx, dtype, pair=False):
    """Least time for the backward: read g (and g_zz for the pair), X, Z and
    ks, write dX, dZ and dks; K is recomputed, not read.  Operations per
    output: the forward's 2*Dx + 7, g*K 1, dks 2, the two gK-weighted sums
    2*Dx each and the row and column sums 2 (6*Dx + 12); per row and column
    their norms and the -sum(gK)*x terms (4*Dx)."""
    item = torch.finfo(dtype).bits // 8
    rows = N + M if pair else N
    nbytes = item * (Dy * rows * M + 2 * (Dy * N * Dx + Dy * M * Dx + Dy))
    flops = Dy * (rows * M * (6 * Dx + 12) + 4 * (rows + M) * Dx)
    return _bound(nbytes, flops, dtype)


def _bound(nbytes, flops, dtype):
    t_b, t_f = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return 1e3 * max(t_b, t_f), ("bytes" if t_b >= t_f else "operations"), \
        nbytes, flops


def _jsonable(x):
    """numpy arrays and scalars in the details file."""
    return x.tolist() if isinstance(x, (np.ndarray, np.generic)) else str(x)


def max_err(a, b) -> float:
    return float((a.double() - b.double()).abs().max())


def assert_close(name, got, want, tol):
    np.testing.assert_allclose(got.double().cpu().numpy(),
                               want.double().cpu().numpy(), **tol,
                               err_msg=name)


def assert_close_scaled(name, got, want, tol):
    """Close relative to the largest entry of `want` (the VJP tolerance)."""
    scale = float(want.abs().max()) or 1.0
    assert_close(name, got / scale, want / scale, tol)


# ---------------------------------------------------------------------------
# phase 2: the kernels against their plain versions
# ---------------------------------------------------------------------------

F32, F64 = torch.float32, torch.float64
KERNEL_SHAPES = [  # (label, Dy, N, M, Dx, dtype, pair)
    ("K_zz 100x100 fp32", 1, 100, 100, 4, F32, False),
    ("K_xz 256x100 fp32", 1, 256, 100, 4, F32, False),
    ("K_xz 4096x100 fp32", 1, 4096, 100, 4, F32, False),
    ("ragged 2x131x77x3 fp32", 2, 131, 77, 3, F32, False),
    ("K_xz 4096x100 fp64", 1, 4096, 100, 4, F64, False),
    ("ragged 2x131x77x3 fp64", 2, 131, 77, 3, F64, False),
    ("K_xz 8611x100 fp32", 1, 8611, 100, 4, F32, False),
    ("K_xz 8611x100 fp64", 1, 8611, 100, 4, F64, False),
    ("pair 256+100 fp32", 1, 256, 100, 4, F32, True),
    ("pair 4096+100 fp32", 1, 4096, 100, 4, F32, True),
    ("pair 8611+100 fp32", 1, 8611, 100, 4, F32, True),
    ("pair 8611+100 fp64", 1, 8611, 100, 4, F64, True),
    # the experiment CLI's shapes: boston TGP M=100 (455 training rows and
    # 51 test rows, Dx=13) in fp64 and fp32; the nine-dataset pass at M=20:
    # naval (the widest Dx, 17) and protein (Dx=9) in minibatches of 10000
    # and their last batches, kin8nm's full batch (Dx=8)
    ("pair 455+100 Dx=13 fp64", 1, 455, 100, 13, F64, True),
    ("pair 51+100 Dx=13 fp64", 1, 51, 100, 13, F64, True),
    ("pair 455+100 Dx=13 fp32", 1, 455, 100, 13, F32, True),
    ("pair 51+100 Dx=13 fp32", 1, 51, 100, 13, F32, True),
    ("pair 10000+20 Dx=17 fp32", 1, 10000, 20, 17, F32, True),
    ("pair 740+20 Dx=17 fp32", 1, 740, 20, 17, F32, True),
    ("pair 10000+20 Dx=9 fp32", 1, 10000, 20, 9, F32, True),
    ("pair 1157+20 Dx=9 fp32", 1, 1157, 20, 9, F32, True),
    ("pair 7372+20 Dx=8 fp32", 1, 7372, 20, 8, F32, True),
    # ID_TGP power (fp64, the CLI's default): its 957 test rows
    ("pair 957+100 fp64", 1, 957, 100, 4, F64, True),
    # the classification protocol (M=50, Dx=4): 1080 training and 120 test
    # rows, binary (Dy=1) and 3-class (Dy=3, one Gram a class)
    ("pair 1080+50 Dy=1 fp32", 1, 1080, 50, 4, F32, True),
    ("pair 120+50 Dy=1 fp32", 1, 120, 50, 4, F32, True),
    ("pair 1080+50 Dy=3 fp32", 3, 1080, 50, 4, F32, True),
    ("pair 120+50 Dy=3 fp32", 3, 120, 50, 4, F32, True),
    ("pair 1080+50 Dy=1 fp64", 1, 1080, 50, 4, F64, True),
    ("pair 120+50 Dy=1 fp64", 1, 120, 50, 4, F64, True),
    ("pair 1080+50 Dy=3 fp64", 3, 1080, 50, 4, F64, True),
    ("pair 120+50 Dy=3 fp64", 3, 120, 50, 4, F64, True),
    # the warped GP on boston (Dx=13): serving in fp32 at buckets 256 and
    # 4096 (M=100), and the StepTanhL run at M=20 in fp64
    ("pair 256+100 Dx=13 fp32", 1, 256, 100, 13, F32, True),
    ("pair 4096+100 Dx=13 fp32", 1, 4096, 100, 13, F32, True),
    ("pair 455+20 Dx=13 fp64", 1, 455, 20, 13, F64, True),
    ("pair 51+20 Dx=13 fp64", 1, 51, 20, 13, F64, True),
    # the model surface (phase 10): each rbf leaf of the spectral-mixture
    # forecast (Dx=1, M=50; 1008 training and 336 forecast hours), the
    # per-output flows' Gram at Dy=2 (boston, M=50), the unwhitened model's
    # full covariance K_xx (boston's 51 test rows; fp64), and the solve arms
    # at power M=256 (fp32)
    ("pair 1008+50 Dx=1 fp64", 1, 1008, 50, 1, F64, True),
    ("pair 336+50 Dx=1 fp64", 1, 336, 50, 1, F64, True),
    ("pair 455+50 Dy=2 Dx=13 fp64", 2, 455, 50, 13, F64, True),
    ("pair 51+50 Dy=2 Dx=13 fp64", 2, 51, 50, 13, F64, True),
    ("K_xx 51x51 Dx=13 fp64", 1, 51, 51, 13, F64, False),
    ("pair 8611+256 fp32", 1, 8611, 256, 4, F32, True),
    # the deep TGP (phase 11): DGP-2 on boston, its inner layer 13 outputs
    # wide (Dx=13, M=100) at the 455 training rows, at S_test=100 paths of
    # the 51 test rows and of the 455 training rows (fp64, the CLI's), and
    # in fp32; --dgp_flow on kin8nm (Dx=8, fp32): the 7373 training rows,
    # and x 100 paths in an evaluation batch
    ("pair 455+100 Dy=13 Dx=13 fp64", 13, 455, 100, 13, F64, True),
    ("pair 455+100 Dy=13 Dx=13 fp32", 13, 455, 100, 13, F32, True),
    ("pair 5100+100 Dy=13 Dx=13 fp64", 13, 5100, 100, 13, F64, True),
    ("pair 45500+100 Dy=13 Dx=13 fp64", 13, 45500, 100, 13, F64, True),
    ("pair 7373+100 Dy=8 Dx=8 fp32", 8, 7373, 100, 8, F32, True),
    ("pair 737300+100 Dy=8 Dx=8 fp32", 8, 737300, 100, 8, F32, True),
    # the battery (phase 12): ten replicas folded into the output axis, the
    # flagship's power split (8611 rows, fp32) and boston's (455 rows,
    # Dx=13, fp64)
    ("pair 8611+100 Dy=10 fp32", 10, 8611, 100, 4, F32, True),
    ("pair 455+100 Dy=10 Dx=13 fp64", 10, 455, 100, 13, F64, True),
    # the large corpora (phase 14): airline's batch of 10000 and its
    # training remainder of 5192 against M=500 (Dx=8, fp32); YearMSD's
    # width, Dx=90, at M=100 in fp32 and fp64 (the first shape whose bound
    # is set by operations)
    ("pair 10000+500 Dx=8 fp32", 1, 10000, 500, 8, F32, True),
    ("pair 5192+500 Dx=8 fp32", 1, 5192, 500, 8, F32, True),
    ("pair 10000+100 Dx=90 fp32", 1, 10000, 100, 90, F32, True),
    ("pair 10000+100 Dx=90 fp64", 1, 10000, 100, 90, F64, True),
]
# more rows than the earlier kernel's grid took (65535 tiles of 32)
BIG_GRAM = ("K_xz 2200000x8 Dx=1 fp32", 1, 2_200_000, 8, 1, F32)


def kernel_phase(dev):
    from tgp.pytorch_tpu_torch.ops import rbf_gram as R

    gen = torch.Generator(device=dev).manual_seed(0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rows = []
    for label, Dy, N, M, Dx, dtype, pair in KERNEL_SHAPES:
        # scaled so that d2 is of order 4 at any Dx, as lengthscale-scaled
        # inputs are: at Dx=17 unscaled rows would leave every K below the
        # fp32 tolerance
        sc = min(1.0, 2.0 / Dx ** 0.5)
        X1 = sc * torch.randn(Dy, N, Dx, generator=gen, device=dev, dtype=dtype)
        X2 = sc * torch.randn(Dy, M, Dx, generator=gen, device=dev, dtype=dtype)
        ks = torch.rand(Dy, generator=gen, device=dev, dtype=dtype) + 0.5
        fused, plain = ((R.rbf_gram_pair, R.rbf_gram_pair_reference) if pair
                        else (lambda *a: (R.rbf_gram(*a),),
                              lambda *a: (R.rbf_gram_reference(*a),)))
        outs, refs = fused(X1, X2, ks), plain(X1, X2, ks)
        torch.cuda.synchronize()
        tol = F32_TOL if dtype == F32 else F64_TOL
        gtol = F32_GRAD_TOL if dtype == F32 else F64_GRAD_TOL
        for out, ref in zip(outs, refs):
            assert_close(label, out, ref, tol)
            check(out.shape == ref.shape and out.dtype == dtype, label)

        # the backward kernel against its plain version, twice (same bits):
        # each design (the tile pass where it takes the shape), and the
        # call `bwd_design` dispatches, which must give its design's bits
        gs = [torch.randn(r.shape, generator=gen, device=dev, dtype=dtype)
              for r in refs]
        bwd = lambda: R._launch_bwd(X1, X2, ks, *gs)       # noqa: E731
        plain_bwd = ((lambda: R.rbf_gram_pair_bwd(X1, X2, ks, *refs, *gs))
                     if pair else
                     (lambda: R.rbf_gram_bwd(X1, X2, ks, refs[0], gs[0])))
        kind = R.tile_kind(dtype, M, Dx)
        rule = R.bwd_design(dtype, Dy, N, M, Dx, sms, kind, pair)
        want = plain_bwd()
        by_design = {}
        for w in ["block"] + (["tile"] if kind != R.REFUSED else []):
            got = R._launch_bwd(X1, X2, ks, *gs, design=w)
            again = R._launch_bwd(X1, X2, ks, *gs, design=w)
            torch.cuda.synchronize()
            for a, b, v, nm in zip(got, again, want, ("dX1", "dX2", "dks")):
                assert_close_scaled(f"{label} {w} {nm}", a, v, gtol)
                check(torch.equal(a, b), f"{label} {w} {nm}: two backward runs differ")
            by_design[w] = got
        got = bwd()
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(got, by_design[rule])),
              f"{label}: the dispatched backward is not the {rule} pass's bits")

        # the Function's gradients against autograd of the plain version
        ws = [torch.randn(r.shape, generator=gen, device=dev, dtype=dtype)
              for r in refs]
        grads = []
        for f in ((R.RBFGramPair.apply, R.rbf_gram_pair_reference) if pair
                  else (R.RBFGram.apply, R.rbf_gram_reference)):
            leaves = [t.clone().requires_grad_(True) for t in (X1, X2, ks)]
            Ks = f(*leaves)
            Ks = Ks if pair else (Ks,)
            sum((torch.sin(K) * w).sum() for K, w in zip(Ks, ws)).backward()
            grads.append([t.grad for t in leaves])
        for gk, gr, nm in zip(*grads, ("dX1", "dX2", "dks")):
            assert_close_scaled(f"{label} autograd {nm}", gk, gr, gtol)

        calls = 10 if Dy * N * M > 10 ** 8 else 100     # graph memory
        ms = graph_ms(lambda: R._launch_pair(X1, X2, ks, pair), calls)
        plain_ms = graph_ms(lambda: plain(X1, X2, ks), calls)
        bwd_ms = graph_ms(bwd, calls)
        tile_ms = (graph_ms(lambda: R._launch_bwd(X1, X2, ks, *gs, design="tile"),
                            calls) if "tile" in by_design else None)
        bwd_plain_ms = graph_ms(plain_bwd, calls)
        bound_ms, bound_by, nbytes, flops = gram_bound(Dy, N, M, Dx, dtype, pair)
        b_ms, b_by, b_bytes, b_flops = bwd_bound(Dy, N, M, Dx, dtype, pair)
        row = dict(shape=label, pair=pair,
                   max_abs_err=max(max_err(o, r) for o, r in zip(outs, refs)),
                   ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                   bound_by=bound_by, bytes=nbytes, flops=flops,
                   bwd_max_abs_err=max(max_err(a, w) for a, w in zip(got, want)),
                   bwd_design=rule, tile_ms=tile_ms,
                   tile_max_abs_err=(max(max_err(a, w) for a, w in
                                         zip(by_design["tile"], want))
                                     if "tile" in by_design else None),
                   bwd_ms=bwd_ms, bwd_plain_ms=bwd_plain_ms, bwd_bound_ms=b_ms,
                   bwd_bound_by=b_by, bwd_bytes=b_bytes, bwd_flops=b_flops,
                   grad_max_abs_err=max(max_err(a, b) for a, b in zip(*grads)))
        rows.append(row)
        log(f"kernel {label:24s} fwd {ms * 1e3:7.2f} us (plain {plain_ms * 1e3:7.2f},"
            f" bound {bound_ms * 1e3:6.3f} {bound_by}) err {row['max_abs_err']:.2e}"
            f" | bwd {bwd_ms * 1e3:7.2f} us ({rule}; tile "
            + (f"{tile_ms * 1e3:7.2f}" if tile_ms is not None else "      -")
            + f", plain {bwd_plain_ms * 1e3:7.2f}, bound {b_ms * 1e3:6.3f} {b_by})"
            f" err {row['bwd_max_abs_err']:.2e}")

    label, Dy, N, M, Dx, dtype = BIG_GRAM
    X1 = torch.randn(Dy, N, Dx, generator=gen, device=dev, dtype=dtype)
    X2 = torch.randn(Dy, M, Dx, generator=gen, device=dev, dtype=dtype)
    ks = torch.rand(Dy, generator=gen, device=dev, dtype=dtype) + 0.5
    out, ref = R.rbf_gram(X1, X2, ks), R.rbf_gram_reference(X1, X2, ks)
    torch.cuda.synchronize()
    assert_close(label, out, ref, F32_TOL)
    big = dict(shape=label, max_abs_err=max_err(out, ref),
               ms=graph_ms(lambda: R._launch(X1, X2, ks), calls=10),
               bound_ms=gram_bound(Dy, N, M, Dx, dtype)[0])
    log(f"kernel {label:24s} fwd {big['ms'] * 1e3:7.2f} us (bound "
        f"{big['bound_ms'] * 1e3:6.3f}) err {big['max_abs_err']:.2e}")
    return rows, big


def host_us(fn, calls=200):
    """Host time of one fn() call, from its call to its return (the launch's
    enqueue, not the device's work): the median over `calls` warm calls,
    the device drained every 20."""
    fn()
    torch.cuda.synchronize()
    times = []
    for n in range(calls):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
        if n % 20 == 19:
            torch.cuda.synchronize()
    torch.cuda.synchronize()
    return 1e6 * float(np.median(times))


# the shapes at which `bwd_compare` times each design's host side too
HOST_SHAPES = ("pair 8611+100 fp32", "pair 455+100 Dy=13 Dx=13 fp64",
               "pair 10000+100 Dx=90 fp64")


def bwd_compare(dev, other_dir):
    """The backward kernel's two designs against another checkout's kernel
    (a `git archive` of an earlier commit unpacked in `other_dir`; its
    `ops/rbf_gram.py` builds its own kernels under `other_dir/build/`),
    information only: at every `KERNEL_SHAPES` shape, the block pass, the
    tile pass (where it takes the shape) and the other checkout's kernel on
    the same inputs, timed in turns (block, tile, other, other, tile,
    block), each against the plain version, whether the dispatched call
    (`bwd_design`) gives the other's bits, and the spread (the larger gap
    between a design's two turns); at `HOST_SHAPES` each one's host time a
    call, in the same turns.  Then the device time of a flagship, a DGP-2 boston and an
    airline step with the dispatched backward and with the other's in
    `RBFGram`'s backward, in turns."""
    import importlib.util

    from tgp.pytorch_tpu_torch.ops import rbf_gram as R

    src = Path(other_dir) / "tgp" / "pytorch_tpu_torch" / "ops" / "rbf_gram.py"
    spec = importlib.util.spec_from_file_location("other_rbf_gram", src)
    other = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(other)
    other.build()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []
    for label, Dy, N, M, Dx, dtype, pair in KERNEL_SHAPES:
        sc = min(1.0, 2.0 / Dx ** 0.5)
        X1 = sc * torch.randn(Dy, N, Dx, generator=gen, device=dev, dtype=dtype)
        X2 = sc * torch.randn(Dy, M, Dx, generator=gen, device=dev, dtype=dtype)
        ks = torch.rand(Dy, generator=gen, device=dev, dtype=dtype) + 0.5
        gs = [torch.randn(shape, generator=gen, device=dev, dtype=dtype)
              for shape in ((Dy, N, M), (Dy, M, M))[:2 if pair else 1]]
        kind = R.tile_kind(dtype, M, Dx)
        designs = ["block"] + (["tile"] if kind != R.REFUSED else [])
        fns = {w: (lambda w=w: R._launch_bwd(X1, X2, ks, *gs, design=w))
               for w in designs}
        fns["other"] = lambda: other._launch_bwd(X1, X2, ks, *gs)
        outs = {w: f() for w, f in fns.items()}
        rule = R.bwd_design(dtype, Dy, N, M, Dx, sms, kind, pair)
        dispatched = R._launch_bwd(X1, X2, ks, *gs)
        if pair:
            want = R.rbf_gram_pair_bwd(X1, X2, ks, *R.rbf_gram_pair_reference(
                X1, X2, ks), *gs)
        else:
            want = R.rbf_gram_bwd(X1, X2, ks, R.rbf_gram_reference(X1, X2, ks),
                                  gs[0])
        torch.cuda.synchronize()
        plain_diff = {w: max(max_err(a, b) / (float(b.abs().max()) or 1.0)
                             for a, b in zip(o, want)) for w, o in outs.items()}
        same = all(torch.equal(a, b) for a, b in zip(dispatched, outs["other"]))
        block_same = all(torch.equal(a, b) for a, b in zip(outs["block"],
                                                            outs["other"]))
        calls = 10 if Dy * N * M > 10 ** 8 else 100
        order = designs + ["other", "other"] + designs[::-1]
        turns = [(w, graph_ms(fns[w], calls)) for w in order]
        ms = {w: float(np.mean([t for v, t in turns if v == w])) for w in fns}
        spread = max(abs(a - b) for w in fns
                     for a, b in [[t for v, t in turns if v == w]])
        row = dict(shape=label, rule=rule, ms=ms, turns_ms=turns,
                   spread_ms=spread,
                   bound_ms=bwd_bound(Dy, N, M, Dx, dtype, pair)[0],
                   rel_diff_plain=plain_diff, dispatched_same_bits=same,
                   block_same_bits=block_same)
        if label in HOST_SHAPES:
            ht = [(w, host_us(fns[w])) for w in order]
            row["host_turns_us"] = ht
            row["host_us"] = {w: float(np.mean([t for v, t in ht if v == w]))
                              for w in fns}
        rows.append(row)
        log(f"bwd compare {label:30s} block {ms['block'] * 1e3:8.2f} us, tile "
            + (f"{ms['tile'] * 1e3:8.2f}" if "tile" in ms else "       -")
            + f", other {ms['other'] * 1e3:8.2f} (spread {spread * 1e3:.2f};"
            f" rule {rule}), bound {row['bound_ms'] * 1e3:.3f} us; rel diff to"
            " plain " + ", ".join(f"{w} {d:.1e}" for w, d in plain_diff.items())
            + ("; dispatched = other's bits" if same else "")
            + ("; block = other's bits" if block_same else "")
            + ("; host " + ", ".join(f"{w} {t:.1f}" for w, t in
                                     row["host_us"].items()) + " us a call"
               if "host_us" in row else ""))

    def flagship():
        from tgp.pytorch_tpu_torch import bench

        return bench.flagship_trainer(device=dev), "fp32"

    def dgp2():
        return dgp_run("boston", 100, 2, "fp64", "gpu")[0].trainer, "fp64"

    def airline():
        rng = np.random.default_rng(0)
        X = rng.standard_normal((4 * AIR_BATCH, 8))
        Y = rng.standard_normal((4 * AIR_BATCH, 1))
        spec, params = large_model("airline", X, X[:500], "cpu")
        return large_trainer(spec, params, X, Y, np.ones(1), dev), "fp32"

    own = R._launch_bwd
    steps = {}
    for tag, make in (("flagship", flagship), ("DGP-2 boston", dgp2),
                      ("airline", airline)):
        tr, precision = make()
        turns = []
        for w in ("this", "that", "that", "this"):
            R._launch_bwd = own if w == "this" else other._launch_bwd
            try:
                t = step_timing(tr, precision, f"{tag} step, {w} backward")
            finally:
                R._launch_bwd = own
            turns.append((w, t["profile_per_step"]["device_busy_ms"],
                          t["profile_per_step"]["gram_bwd_ms"], t["step_ms"]))
        steps[tag] = {w: dict(device_busy_ms=float(np.mean(
            [b for v, b, _, _ in turns if v == w])), gram_bwd_ms=float(np.mean(
            [g for v, _, g, _ in turns if v == w])), step_ms=float(np.mean(
            [m for v, _, _, m in turns if v == w]))) for w in ("this", "that")}
        log(f"bwd compare {tag} step: device busy {steps[tag]['this']['device_busy_ms']:.4f}"
            f" ms a step with this backward, {steps[tag]['that']['device_busy_ms']:.4f}"
            f" with the other (backward {steps[tag]['this']['gram_bwd_ms'] * 1e3:.2f}"
            f" / {steps[tag]['that']['gram_bwd_ms'] * 1e3:.2f} us a step)")
    return dict(rows=rows, steps=steps)


def compare_main(other_dir) -> int:
    """`python3 chip_smoke.py --bwd-compare DIR`: `bwd_compare` alone, its
    record in chiprun_out/bwd_compare.json and on the last line."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    from tgp.pytorch_tpu_torch import config as cfg
    from tgp.pytorch_tpu_torch.ops import rbf_gram as R

    cfg.set_precision("fp32")
    smi = nvidia_smi()
    log(f"device: {torch.cuda.get_device_name(0)}; {smi}")
    R.build()
    out = bwd_compare(torch.device("cuda", 0), other_dir)
    out["nvidia_smi"] = smi
    out_dir = HERE / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "bwd_compare.json").write_text(json.dumps(out, indent=1,
                                                         default=_jsonable))
    log(smi)
    log(json.dumps(out, default=_jsonable))
    return 0


# ---------------------------------------------------------------------------
# phase 3: serving
# ---------------------------------------------------------------------------

def profile_device(fn):
    """Device activity of one warm fn() under torch.profiler: number of
    device operations, their summed device time, the Gram kernels' shares,
    and the top operations by device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name = {}
    for e in ev:
        by_name[e.name[:70]] = by_name.get(e.name[:70], 0.0) + e.device_time
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]

    def ms_of(tag):
        return sum(e.device_time for e in ev if tag in e.name) / 1e3

    return dict(device_ops=len(ev),
                device_busy_ms=sum(e.device_time for e in ev) / 1e3,
                gram_ms=ms_of("rbf_gram_kernel"), gram_bwd_ms=ms_of("rbf_gram_bwd"),
                gram_seen=sum("rbf_gram_kernel" in e.name for e in ev),
                top_ms=[(k, v / 1e3) for k, v in top])


def ladder_rung(spec, params):
    """The jitter rung (1, 10 or 100 times the base) that
    `safe_cholesky` picks for the model's K_zz, per output."""
    from tgp.pytorch_tpu_torch.ops import kernels
    from tgp.pytorch_tpu_torch.ops.linalg import _default_jitter, safe_cholesky

    Kzz = kernels.gram(spec.kernel, params["kernel"], params["Z"], params["Z"])
    _, Aj = safe_cholesky(Kzz)
    jit = torch.diagonal(Aj - Kzz, dim1=-2, dim2=-1).mean(-1)
    ratio = (jit / _default_jitter(Kzz)[..., 0, 0]).double().cpu().tolist()
    return [int(round(10 ** round(np.log10(r)))) for r in ratio]


def serving_phase(dev):
    from tgp.pytorch_tpu_torch import config as cfg, weights
    from tgp.pytorch_tpu_torch.data.uci import load_uci_split
    from tgp.pytorch_tpu_torch.ops import rbf_gram as R
    from tgp.pytorch_tpu_torch.serve import Predictor

    d = load_uci_split("power", 1)
    X_tr, X_te, Y_te = d["X_tr"], d["X_te"], d["Y_te"]
    spec = weights.flagship_spec(X_tr.shape[0])
    params = weights.flagship_params(spec, X_tr, seed=0, device="cpu",
                                     dtype=torch.float64)
    kw = dict(Y_std=d["Y_std"], Y_mean=d["Y_mean"], buckets=(256, 4096), seed=0)
    # round to fp32 once, so the fp64 reference serves the same model
    params = weights.tree_map(lambda t: t.float().double(), params)
    pred = Predictor(spec, params, device=dev, **kw)
    check(pred.params["q_L"].device == torch.device(dev), "params on the card")

    X32 = X_te[:32]
    X4096 = np.resize(X_te, (4096, X_te.shape[1]))      # test rows tiled
    reqs = [X_te[i * 100:(i + 1) * 100 + 17 * i] for i in range(8)]

    # warm-up: CUDA context, cuBLAS/cuSOLVER handles, the kernel's library
    for X in (X32, X4096):
        pred.predict(X, quantiles=None)
        pred.predict(X, samples=200)
    pred.log_prob(X_te, Y_te)

    lat = {}
    counts = []

    def timed(key, fn):
        before = R.LAUNCHES
        t0 = time.perf_counter()
        out = fn()
        lat.setdefault(key, []).append(time.perf_counter() - t0)
        counts.append((key, R.LAUNCHES - before))
        return out

    # --- the main path: counts from 0, 1 launch per request --------------
    R.LAUNCHES = R.BWD_LAUNCHES = R.BWD_TILE_LAUNCHES = 0
    n_requests = 0
    res = {}
    for key, X, reps, call in (
            ("moments_n32", X32, 50, dict(quantiles=None)),
            ("moments_n4096", X4096, 20, dict(quantiles=None)),
            ("bands_n32", X32, 50, dict()),
            ("bands_n4096", X4096, 20, dict()),
            ("samples200_n32", X32, 20, dict(samples=200)),
            ("samples200_n4096", X4096, 10, dict(samples=200))):
        for _ in range(reps):
            res[key] = timed(key, lambda: pred.predict(X, **call))
            n_requests += 1
    for _ in range(10):
        res["log_prob"] = timed("log_prob_n957", lambda: pred.log_prob(X_te, Y_te))
        n_requests += 1
    for _ in range(5):
        res["map"] = timed("map_8", lambda: pred.map(reqs, quantiles=None))
        n_requests += len(reqs)
    launches, bwd_launches, bwd_tile_launches = (
        R.LAUNCHES, R.BWD_LAUNCHES, R.BWD_TILE_LAUNCHES)
    # ----------------------------------------------------------------------

    for key, c in counts:
        per = len(reqs) if key == "map_8" else 1
        check(c == per, f"{key}: {c} kernel launches for {per} request(s)")
    check(launches == n_requests, f"{launches} launches, {n_requests} requests")
    check(bwd_launches == 0, f"{bwd_launches} backward launches while serving")

    # outputs: finite, shaped, ordered bands
    for key, n in (("moments_n32", 32), ("moments_n4096", 4096),
                   ("bands_n32", 32), ("bands_n4096", 4096),
                   ("samples200_n32", 32), ("samples200_n4096", 4096)):
        out = res[key]
        for k, v in out.items():
            want = (1, 200, n) if k == "samples" else (1, n)
            check(v.shape == want, f"{key} {k} shape {v.shape}")
            check(np.isfinite(v).all(), f"{key} {k} finite")
            check((v > 0).all() if k == "var" else v.std() > 0,
                  f"{key} {k} non-degenerate")
        if "lower" in out:
            check((out["lower"] <= out["upper"]).all(), f"{key} lower <= upper")
    check(np.isfinite(res["log_prob"]).all() and res["log_prob"].shape == (1,),
          "log_prob finite")
    seq = [pred.predict(X, quantiles=None) for X in reqs]
    for got, want in zip(res["map"], seq):
        for k in ("mean", "var"):
            # the same kernels on the same inputs; a reduction order inside
            # cuBLAS/cuSOLVER may differ between calls
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=0,
                                       err_msg=f"map vs predict {k}")

    # against the same Predictor on the CPU (fp32), and the fp64 answer
    gpu = pred.predict(X_te, quantiles=None)
    gpu_lp = pred.log_prob(X_te, Y_te)
    cpu32 = Predictor(spec, params, device="cpu", **kw)
    c32, c32_lp = cpu32.predict(X_te, quantiles=None), cpu32.log_prob(X_te, Y_te)
    cfg.set_precision("fp64")
    try:
        cpu64 = Predictor(spec, params, device="cpu", **kw)
        c64, c64_lp = cpu64.predict(X_te, quantiles=None), cpu64.log_prob(X_te, Y_te)
    finally:
        cfg.set_precision("fp32")
    gaps = {}
    for k in ("mean", "var"):
        gaps[k] = dict(
            gpu32_vs_cpu32=float(np.max(np.abs(gpu[k] - c32[k]) / np.abs(c64[k]))),
            gpu32_vs_cpu64=float(np.max(np.abs(gpu[k] - c64[k]) / np.abs(c64[k]))),
            cpu32_vs_cpu64=float(np.max(np.abs(c32[k] - c64[k]) / np.abs(c64[k]))))
    gaps["log_prob"] = dict(
        gpu32_vs_cpu32=float(abs(gpu_lp - c32_lp)[0] / abs(c64_lp)[0]),
        gpu32_vs_cpu64=float(abs(gpu_lp - c64_lp)[0] / abs(c64_lp)[0]),
        cpu32_vs_cpu64=float(abs(c32_lp - c64_lp)[0] / abs(c64_lp)[0]))
    for k, g in gaps.items():
        log(f"serving {k:8s} max rel gap: gpu32 vs cpu32 {g['gpu32_vs_cpu32']:.3e}"
            f"  gpu32 vs cpu64 {g['gpu32_vs_cpu64']:.3e}"
            f"  cpu32 vs cpu64 {g['cpu32_vs_cpu64']:.3e}")
    # Tolerances.  (1) The card against the CPU in fp32, the same model in
    # the same precision: on an NVIDIA H100 80GB HBM3 the gaps are 1.50e-5
    # (mean), 2.44e-4 (var) and 1.16e-5 (log_prob) of the fp64 answer, the
    # order in which cuBLAS/cuSOLVER and LAPACK sum; the limit is 10x that.
    # (2) An fp32 run of this model is only as good as fp32 rounding
    # amplified by the conditioning of K_zz (M=100 inducing points on
    # standardised power data): the CPU's fp32 gap to fp64 is of order 1e-3
    # (1e-2 for small variances), and the JAX package's fp32 run shows the
    # same, so the card's gap to fp64 is held to at most 4x the CPU's.
    for k, lim in (("mean", 1.5e-4), ("var", 2.4e-3), ("log_prob", 1.2e-4)):
        g = gaps[k]
        check(g["gpu32_vs_cpu32"] <= lim, f"{k} card vs CPU fp32 {g}")
        check(g["gpu32_vs_cpu64"] <= max(4 * g["cpu32_vs_cpu64"], 1e-5),
              f"{k} card vs CPU fp64 {g}")
    # the jitter ladder picks the same rung on both: cuSOLVER and LAPACK
    # report a failed factorisation through `info` each in their own way
    rungs = {d: ladder_rung(spec, p.params) for d, p in (("gpu", pred),
                                                          ("cpu", cpu32))}
    log(f"serving K_zz jitter rung: card {rungs['gpu']}, CPU {rungs['cpu']}")
    check(rungs["gpu"] == rungs["cpu"], f"jitter rung {rungs}")

    p50 = {k: 1e3 * float(np.median(v)) for k, v in lat.items()}
    for k, v in p50.items():
        log(f"serving p50 {k:18s} {v:9.3f} ms  ({len(lat[k])} reps)")

    # where a request's time goes: device busy time against the p50 wall
    profiles = {}
    for key, X, call in (("moments_n32", X32, dict(quantiles=None)),
                         ("bands_n4096", X4096, dict())):
        prof = profile_device(lambda: pred.predict(X, **call))
        prof["busy_share_of_p50"] = prof["device_busy_ms"] / p50[key]
        profiles[key] = prof
        log(f"profile {key}: {prof['device_ops']} device ops, busy "
            f"{prof['device_busy_ms']:.3f} ms = {prof['busy_share_of_p50']:.1%}"
            f" of p50; Gram kernel {prof['gram_ms'] * 1e3:.2f} us")
        for name, ms in prof["top_ms"]:
            log(f"    {ms * 1e3:9.2f} us  {name}")
    return dict(launches=launches, bwd_launches=bwd_launches,
                bwd_tile_launches=bwd_tile_launches,
                requests=n_requests, p50_ms=p50, gaps=gaps,
                jitter_rungs=rungs, profiles=profiles,
                log_prob_n957=float(gpu_lp[0]))


# ---------------------------------------------------------------------------
# phase 4: the gradient at the training shape
# ---------------------------------------------------------------------------

# Limits on the card's fp32 loss and gradients against the CPU's fp32 run
# of the same function, relative to the largest entry of the fp64 value of
# each: 10x the gaps measured on an NVIDIA H100 80GB HBM3 (1.24e-5 for the
# loss, 1.37e-3 for Z, 1.72e-4 for the lengthscales, at most 7.2e-5 for every
# other parameter), the order in which cuBLAS/cuSOLVER and LAPACK sum,
# amplified by K_zz's conditioning, which the CPU's own fp32-to-fp64 gaps
# show (3.3e-2 for Z, 2.0e-2 for the lengthscales).
GRAD_GAP_LIMITS = {"loss": 1.3e-4, "Z": 1.4e-2,
                   "kernel/child/raw_lengthscale": 1.8e-3}
GRAD_GAP_LIMIT_OTHER = 7.3e-4


def named_leaves(tree):
    """(path, tensor) for every leaf of a params tree, its path as
    `train.optimizers.param_paths` writes it ('kernel/child/raw_lengthscale')."""
    from tgp.pytorch_tpu_torch.train.optimizers import param_paths
    from tgp.pytorch_tpu_torch.weights import tree_leaves

    return list(zip(tree_leaves(param_paths(tree)), tree_leaves(tree)))


def gradient_phase(dev):
    """The flagship's `test_log_likelihood` over the 8611 power training rows
    (the shape at which the JAX package sends its Gram to the TPU kernel),
    full width in fp32, and its gradient into every parameter: one forward
    and one backward kernel call, checked against the same function's
    gradient on the CPU in fp32 and fp64."""
    from tgp.pytorch_tpu_torch import config as cfg, weights
    from tgp.pytorch_tpu_torch.data.uci import load_uci_split
    from tgp.pytorch_tpu_torch.models import tgp as PM
    from tgp.pytorch_tpu_torch.ops import rbf_gram as R

    d = load_uci_split("power", 1)
    spec = weights.flagship_spec(d["X_tr"].shape[0])
    base = weights.flagship_params(spec, d["X_tr"], seed=0, device="cpu",
                                   dtype=torch.float64)
    # round to fp32 once, so the fp64 reference differentiates the same model
    base = weights.tree_map(lambda t: t.float().double(), base)

    def loss_and_grads(device, dtype):
        params = weights.tree_map(
            lambda t: t.to(device, dtype, copy=True).requires_grad_(True), base)
        X, Y, Ys = (torch.as_tensor(d[k], dtype=dtype, device=device)
                    for k in ("X_tr", "Y_tr", "Y_std"))
        ll = PM.test_log_likelihood(spec, params, X, Y, Ys)
        ll.sum().backward()
        return ll.detach(), {n: t.grad for n, t in named_leaves(params)}

    loss_and_grads(dev, F32)                            # warm-up
    # --- the main path: counts from 0, 1 forward and 1 backward call -----
    R.LAUNCHES = R.BWD_LAUNCHES = R.BWD_TILE_LAUNCHES = 0
    ll_gpu, g_gpu = loss_and_grads(dev, F32)
    torch.cuda.synchronize()
    launches, bwd_launches, bwd_tile_launches = (
        R.LAUNCHES, R.BWD_LAUNCHES, R.BWD_TILE_LAUNCHES)
    # ----------------------------------------------------------------------
    check(launches == 1, f"gradient: {launches} forward launches, expected 1")
    check(bwd_launches == 1, f"gradient: {bwd_launches} backward calls, expected 1")

    ll_c32, g_c32 = loss_and_grads("cpu", F32)
    cfg.set_precision("fp64")
    try:
        ll_c64, g_c64 = loss_and_grads("cpu", F64)
    finally:
        cfg.set_precision("fp32")

    def rel(a, b, ref):
        return float((a.double().cpu() - b.double().cpu()).abs().max()
                     / (ref.double().abs().max() or 1.0))

    gaps = {"loss": dict(gpu32_vs_cpu32=rel(ll_gpu, ll_c32, ll_c64),
                         gpu32_vs_cpu64=rel(ll_gpu, ll_c64, ll_c64),
                         cpu32_vs_cpu64=rel(ll_c32, ll_c64, ll_c64))}
    for n in g_c64:
        check(g_gpu[n] is not None and torch.isfinite(g_gpu[n]).all(),
              f"gradient of {n} on the card is missing or not finite")
        gaps[n] = dict(gpu32_vs_cpu32=rel(g_gpu[n], g_c32[n], g_c64[n]),
                       gpu32_vs_cpu64=rel(g_gpu[n], g_c64[n], g_c64[n]),
                       cpu32_vs_cpu64=rel(g_c32[n], g_c64[n], g_c64[n]))
    for n, g in gaps.items():
        log(f"gradient {n:34s} rel gap: gpu32 vs cpu32 {g['gpu32_vs_cpu32']:.3e}"
            f"  gpu32 vs cpu64 {g['gpu32_vs_cpu64']:.3e}"
            f"  cpu32 vs cpu64 {g['cpu32_vs_cpu64']:.3e}")
    for n, g in gaps.items():
        lim = GRAD_GAP_LIMITS.get(n, GRAD_GAP_LIMIT_OTHER)
        check(g["gpu32_vs_cpu32"] <= lim, f"{n} card vs CPU fp32 {g}")
        check(g["gpu32_vs_cpu64"] <= max(4 * g["cpu32_vs_cpu64"], 1e-5),
              f"{n} card vs CPU fp64 {g}")

    def step():
        loss_and_grads(dev, F32)
        torch.cuda.synchronize()

    times = []
    for _ in range(10):
        t0 = time.perf_counter()
        step()
        times.append(time.perf_counter() - t0)
    prof = profile_device(step)
    p50 = 1e3 * float(np.median(times))
    log(f"gradient step p50 {p50:.3f} ms (10 reps); {prof['device_ops']} device"
        f" ops, busy {prof['device_busy_ms']:.3f} ms = "
        f"{prof['device_busy_ms'] / p50:.1%} of p50; Gram forward "
        f"{prof['gram_ms'] * 1e3:.2f} us, backward {prof['gram_bwd_ms'] * 1e3:.2f} us")
    for name, ms in prof["top_ms"]:
        log(f"    {ms * 1e3:9.2f} us  {name}")
    return dict(launches=launches, bwd_launches=bwd_launches,
                bwd_tile_launches=bwd_tile_launches, gaps=gaps,
                step_p50_ms=p50, profile=prof, loss=float(ll_gpu.sum()))


# ---------------------------------------------------------------------------
# phase 5: training
# ---------------------------------------------------------------------------

# The fp32 training phase's limits on the card against the CPU's fp32 run
# after 50 steps, relative to the largest entry of the ELBO curve, of the
# KL curve and of each parameter: 10x the gaps measured on an NVIDIA H100
# 80GB HBM3 at 700 W.  Adam moves each entry by about lr whatever the size
# of its gradient, so an entry of q(U) whose gradient is at the level of
# fp32 rounding steps with the rounding's sign: after the first 5 steps the
# card's q_L already sits 0.10 from the CPU's fp32 run, after 50 steps q_mu
# and q_L sit 0.07 from it and 1.4-1.9 from fp64, as far as their largest
# entries.  So the fp32 run does not hold q(U) entry by entry (the fp64 run
# does, after 20 steps): it holds the KL curve, a function of q(U) alone
# that the sign of such a step does not change.  The other gaps depend on
# the trajectory (running the 50 steps as 5 + 45, with a second draw of the
# loader's shuffle, moved flow/3/b's from 1.2e-5 to 1.2e-3); each limit
# holds because both sides repeat their bits, and a change to the path
# measures them anew.
TRAIN_F32_STEPS, TRAIN_F32_EARLY = 50, 5
TRAIN_F32_LIMITS = {
    "curve": 6.1e-4, "kld": 6.8e-4, "Z": 9.4e-2,
    "kernel/child/raw_lengthscale": 1.5e-3, "kernel/raw_outputscale": 5.5e-5,
    "likelihood/log_var_noise": 4.3e-5,
    "flow/0/a": 6.1e-3, "flow/0/b": 2.4e-5, "flow/1/a": 5.5e-5,
    "flow/1/b": 2.4e-2, "flow/2/a": 6.2e-3, "flow/2/b": 3.1e-5,
    "flow/3/a": 4.7e-5, "flow/3/b": 1.2e-2}
# logL and rmse of compute_metrics on the card against the CPU's fp32 run,
# on the same trained parameters, relative (measured: at most 4.0e-5)
METRICS_F32_LIMIT = 4e-4


def training_phase(dev):
    """`Trainer.train` on the flagship (`bench.flagship_trainer`: bench.py's
    spec and init over the 8611 power training rows, full batch): the card's
    trajectory against the CPU's in fp64 and fp32, 1 forward launch and 1
    backward call per step, the trained model's metrics, then the bench
    loop and a profile."""
    from tgp.pytorch_tpu_torch import bench, config as cfg
    from tgp.pytorch_tpu_torch.data import return_dataset
    from tgp.pytorch_tpu_torch.ops import rbf_gram as R
    from tgp.pytorch_tpu_torch.train import Trainer

    def values(tr):
        """The ELBO and KL curves so far and the parameters (fp64 on the
        host), by name."""
        out = {n: torch.as_tensor(np.asarray(c, np.float64))
               for n, c in (("curve", tr.loss_curve), ("kld", tr.kld_curve))}
        out.update((n, t.detach().double().cpu())
                   for n, t in named_leaves(tr.params))
        return out

    def train(device, precision, chunks):
        """A fresh `bench.flagship_trainer` (fresh loaders, so the same
        shuffle) trained for sum(chunks) steps, one train() call a chunk;
        returns it, its `values` after each chunk and the kernel counts of
        the run."""
        cfg.set_precision(precision)
        try:
            tr = bench.flagship_trainer(device)
            snaps = []
            # --- the main path: counts from 0, 1 forward + 1 backward a step
            R.LAUNCHES = R.BWD_LAUNCHES = R.BWD_TILE_LAUNCHES = 0
            for n in chunks:
                tr.train(n, bench.LR, "adam", verbose_each=0)
                snaps.append(values(tr))
            counts = (R.LAUNCHES, R.BWD_LAUNCHES, R.BWD_TILE_LAUNCHES)
            # ------------------------------------------------------------------
        finally:
            cfg.set_precision("fp32")
        return tr, snaps, counts

    def gaps(runs, pairs, snap=-1):
        """{name: {pair: gap}} over the curves and every parameter after
        chunk `snap`, relative to the largest entry of the CPU's fp64 run."""
        ref = runs["cpu64"][1][snap]
        return {n: {k: float((runs[a][1][snap][n] - runs[b][1][snap][n])
                             .abs().max() / (ref[n].abs().max() or 1.0))
                    for k, (a, b) in pairs.items()} for n in ref}

    result, checks = {}, []     # every check is made after the phase's log
    # 1. fp64, the card against the CPU: the whole path held tightly
    runs = {"gpu64": train(dev, "fp64", [20]), "cpu64": train("cpu", "fp64", [20])}
    g64 = gaps(runs, {"gpu64_vs_cpu64": ("gpu64", "cpu64")})
    checks.append((runs["gpu64"][2][:2] == (20, 20),
                   f"fp64 training counts {runs['gpu64'][2]}"))
    curves = [runs[k][1][-1]["curve"] for k in ("gpu64", "cpu64")]
    curve_gap = (curves[0] - curves[1]).abs() / curves[1].abs().max()
    log("training fp64 curve gap by step: " + ", ".join(
        f"{i}: {float(curve_gap[i]):.2e}" for i in (0, 1, 2, 5, 10, 19)))
    checks.append((float(curve_gap[0]) <= bench.TRAIN_F64_STEP0_LIMIT,
                   f"fp64 ELBO at the initial parameters {float(curve_gap[0])}"))
    for n, g in g64.items():
        log(f"training fp64 {n:30s} gpu64 vs cpu64 {g['gpu64_vs_cpu64']:.3e}")
        checks.append((g["gpu64_vs_cpu64"] <= bench.TRAIN_F64_LIMITS[n],
                       f"fp64 training {n} {g}"))
    result.update(fp64_gaps=g64, fp64_curve_gap_step0=float(curve_gap[0]))

    # 2. fp32: the card against the CPU in fp32, and each against fp64,
    # logged after TRAIN_F32_EARLY steps and held after TRAIN_F32_STEPS
    steps, early = TRAIN_F32_STEPS, TRAIN_F32_EARLY
    chunks = [early, steps - early]
    runs = {"gpu32": train(dev, "fp32", chunks),
            "cpu32": train("cpu", "fp32", chunks),
            "cpu64": train("cpu", "fp64", chunks)}
    launches, bwd_launches, bwd_tile_launches = runs["gpu32"][2]
    checks.append((launches == steps,
                   f"training: {launches} forward launches in {steps} steps"))
    checks.append((bwd_launches == steps,
                   f"training: {bwd_launches} backward calls in {steps} steps"))
    pairs = {"gpu32_vs_cpu32": ("gpu32", "cpu32"),
             "gpu32_vs_cpu64": ("gpu32", "cpu64"),
             "cpu32_vs_cpu64": ("cpu32", "cpu64")}
    g32_early, g32 = gaps(runs, pairs, snap=0), gaps(runs, pairs)
    for when, gs in ((early, g32_early), (steps, g32)):
        for n, g in gs.items():
            log(f"training fp32 {when:2d} steps {n:30s} gpu32 vs cpu32 "
                f"{g['gpu32_vs_cpu32']:.3e}  gpu32 vs cpu64 "
                f"{g['gpu32_vs_cpu64']:.3e}  cpu32 vs cpu64 "
                f"{g['cpu32_vs_cpu64']:.3e}")
    for n, lim in TRAIN_F32_LIMITS.items():       # every name but q(U)
        g = g32[n]
        checks.append((g["gpu32_vs_cpu32"] <= lim,
                       f"fp32 training {n} card vs CPU {g}"))
        checks.append((g["gpu32_vs_cpu64"] <= max(4 * g["cpu32_vs_cpu64"], 1e-5),
                       f"fp32 training {n} card vs fp64 {g}"))
    result.update(fp32_early_gaps=g32_early, fp32_gaps=g32, launches=launches,
                  bwd_launches=bwd_launches,
                  bwd_tile_launches=bwd_tile_launches, steps=steps,
                  elbo=float(runs["gpu32"][1][-1]["curve"][-1]))

    # 3. the trained model's metrics on the card and on the CPU (fp32, the
    # same trained parameters); coverage draws other samples on each
    tr_gpu = runs["gpu32"][0]
    m_gpu = tr_gpu.compute_metrics()
    tr_cpu = Trainer(tr_gpu.spec, tr_gpu.params,
                     return_dataset("power", 10000, seed=1)[0], tr_gpu.Y_std,
                     device="cpu")
    m_cpu = tr_cpu.compute_metrics()
    result["metrics"] = {"gpu32": m_gpu, "cpu32": m_cpu}
    for split in ("train", "test"):
        n_rows = len(tr_gpu.test_loader.dataset if split == "test"
                     else tr_gpu.train_loader.dataset)
        for k in ("logL", "rmse", "coverage"):
            a, b = float(m_gpu[split][k][0]), float(m_cpu[split][k][0])
            checks.append((np.isfinite(a), f"{split} {k} finite"))
            lim = (3 * np.sqrt(b * (1 - b) / n_rows) if k == "coverage"
                   else METRICS_F32_LIMIT * abs(b))
            log(f"training metrics {split:5s} {k:8s} card {a:.6f} CPU {b:.6f}"
                f" gap {abs(a - b):.3e} (limit {lim:.3e})")
            checks.append((abs(a - b) <= lim, f"{split} {k}: card {a}, CPU {b}"))

    # 4. the step time (steps/s is the standalone bench's), then a profile
    # of 10 steps
    tr = bench.flagship_trainer(dev)

    def ten_steps():
        tr.train(10, bench.LR, "adam", verbose_each=0)

    ten_steps()                                          # warm-up
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        ten_steps()
        times.append((time.perf_counter() - t0) / 10)
    step_ms = 1e3 * float(np.median(times))
    prof = profile_device(ten_steps)
    per_step = {k: prof[k] / 10 for k in ("device_ops", "device_busy_ms",
                                          "gram_ms", "gram_bwd_ms")}
    log(f"training step {step_ms:.3f} ms (median of 5 x 10 steps); "
        f"{per_step['device_ops']:.1f} device ops, busy "
        f"{per_step['device_busy_ms']:.3f} ms = "
        f"{per_step['device_busy_ms'] / step_ms:.1%} of a step; Gram forward "
        f"{per_step['gram_ms'] * 1e3:.2f} us, backward "
        f"{per_step['gram_bwd_ms'] * 1e3:.2f} us a step")
    for name, ms in prof["top_ms"]:
        log(f"    {ms * 1e3 / 10:9.2f} us a step  {name}")
    result.update(step_ms=step_ms, profile_per_step=per_step,
                  profile_top_ms=prof["top_ms"])
    for cond, msg in checks:
        check(cond, msg)
    return result


# ---------------------------------------------------------------------------
# shared by phases 6-9
# ---------------------------------------------------------------------------

def step_timing(tr, precision, tag, **train_kw):
    """A trained Trainer's step on the card: the median of 5 x 10 steps and
    a profile of 10 (in `precision`, back to fp32 after)."""
    from tgp.pytorch_tpu_torch import config as cfg

    cfg.set_precision(precision)
    try:
        def ten_steps():
            tr.train(10, 0.01, "adam", verbose_each=0, **train_kw)

        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            ten_steps()
            times.append((time.perf_counter() - t0) / 10)
        step_ms = 1e3 * float(np.median(times))
        prof = profile_device(ten_steps)
    finally:
        cfg.set_precision("fp32")
    per_step = {k: prof[k] / 10 for k in ("device_ops", "device_busy_ms",
                                          "gram_ms", "gram_bwd_ms")}
    log(f"{tag} step {step_ms:.3f} ms ({1e3 / step_ms:.2f} steps/s, median of "
        f"5 x 10); {per_step['device_ops']:.1f} device ops, busy "
        f"{per_step['device_busy_ms']:.3f} ms = "
        f"{per_step['device_busy_ms'] / step_ms:.1%} of a step; Gram forward "
        f"{per_step['gram_ms'] * 1e3:.2f} us, backward "
        f"{per_step['gram_bwd_ms'] * 1e3:.2f} us a step")
    for name, ms in prof["top_ms"]:
        log(f"    {ms * 1e3 / 10:9.2f} us a step  {name}")
    return dict(step_ms=step_ms, steps_per_s=1e3 / step_ms,
                profile_per_step=per_step, profile_top_ms=prof["top_ms"])


def held_gaps(vals, pairs, group, limits, tag, checks, logged=()):
    """The largest gap of each group of values relative to the group's
    largest entry in the CPU's fp64 run ('cpu64'), checked against
    `limits[pair][group]` (an anchor fit drives its nets' output weights
    towards 0, so a leaf's own largest entry would be a rounding floor).
    A pair named in `logged`, and a group whose limit is None, is logged and
    not held; so is q(U) where the pair's limits leave it out (fp32 holds it
    through the KL curve).  Any other pair or group without a limit fails,
    so that an empty or missing table cannot switch a check off."""
    ref = vals["cpu64"]
    scale = {}
    for n in ref:
        scale[group(n)] = max(scale.get(group(n), 0.0), float(np.abs(ref[n]).max()))
    out = {}
    for pair, (a, b) in pairs.items():
        grouped, where = {}, {}
        for n in ref:
            d = np.abs(vals[a][n] - vals[b][n])
            g = float(d.max() / (scale[group(n)] or 1.0))
            if g >= grouped.get(group(n), 0.0):
                grouped[group(n)] = g
                where[group(n)] = (n, np.unravel_index(int(d.argmax()), d.shape))
        lim = limits.get(pair)
        if lim is None and pair not in logged:
            checks.append((False, f"{tag} {pair}: no limits given"))
        for n, g in grouped.items():
            log(f"{tag} {pair} {n:32s} {g:.3e}")
            held = not (pair in logged or lim is None
                        or (n in lim and lim[n] is None)
                        or (n not in lim and n.startswith(("q_mu", "q_L"))))
            ok = n in lim and g <= lim[n] if held else True
            if n == "curve0" or not ok:
                # each side's value where the gap is largest, to the last
                # digit: across runs, which of the two sides moved
                leaf, i = where[n]
                log(f"{tag} {pair} {n} at {leaf}{[int(k) for k in i]}: {a} "
                    f"{float(vals[a][leaf][i])!r} {b} {float(vals[b][leaf][i])!r}")
            if held:
                checks.append((ok, f"{tag} {pair} {n}: {g} (limit {lim.get(n)})"))
        out[pair] = grouped
    return out


def main_path_checks(sm, checks, counts):
    """A card run's kernel calls: 1 forward launch and 1 backward call per
    training step, 2 forward launches per evaluation batch (point and
    fully-Bayesian), none elsewhere (an anchor fit), each times the
    kernel's rbf leaves (`rbf_leaves`, 1 when absent), and the counts from
    0 equal to the calls the run saw; the counts are summed into `counts`."""
    kc, n_eval = sm["kernel_calls"], sm["eval_batches"]
    k_rbf = sm.get("rbf_leaves", 1)     # a launch per rbf leaf of the kernel
    counts["launches"] += sm["counts"][0]
    counts["bwd_launches"] += sm["counts"][1]
    counts["bwd_tile_launches"] += sm["counts"][2]
    for k, calls in kc.items():
        want = ((k_rbf * sm["steps"], k_rbf * sm["steps"]) if k == "train" else
                (2 * k_rbf * n_eval, 0) if k in ("eval", "eval_bayes")
                else (0, 0))
        checks.append((calls == want, f"{sm['tag']}: {k} {calls} kernel calls, "
                       f"{sm['steps']} training steps, {n_eval} evaluation "
                       f"batches"))
    checks.append((sm["counts"][:2] == tuple(map(sum, zip(*kc.values()))),
                   f"{sm['tag']}: counts {sm['counts']} against {kc}"))
    checks.append((sm["device"] == "cuda", f"{sm['tag']}: on the card"))


def _job(fn, *args, init_rel=0.0, **kw):
    """A run (`exp_run`, `id_run`, `wgp_run`, `cls_run`) in a worker
    process: its summary, the run's own printing kept out of the log, two
    torch threads (the host has 8 cores for the main process and 3
    workers).  With `init_rel`, every initial parameter the run's
    `models.tgp.init_tgp_params` returns is scaled by (1 + init_rel)."""
    import contextlib
    import io

    from tgp.pytorch_tpu_torch.models import tgp as M
    from tgp.pytorch_tpu_torch.weights import tree_map

    torch.set_num_threads(2)
    init = M.init_tgp_params
    if init_rel:
        M.init_tgp_params = lambda *a, **k: tree_map(
            lambda t: t * (1 + init_rel), init(*a, **k))
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            return fn(*args, **kw)[1]
    finally:
        M.init_tgp_params = init


def _first_call_job():
    """A fresh worker's first call, forward only: WGP log_exp fp32 on
    boston at M=100 (`cli_run` with no epochs: the CLI's init, then its
    test and train metrics) at the CPU workers' 2 threads; each metric's
    repr."""
    import contextlib
    import io

    torch.set_num_threads(2)
    with contextlib.redirect_stdout(io.StringIO()):
        run = cli_run("WGP", "boston", 100, 0, "fp32", "cpu",
                      ("--warp_arch", "log_exp"))
    return {f"{part}/{k}": repr(float(v[0]))
            for part, m in run.metrics.items() for k, v in m.items()}


class FirstCalls:
    """`_first_call_job` in two freshly spawned workers, started at once;
    `check()` waits for both and fails unless they agree to the bit (the
    CPU references of every phase are such workers' calls), `stop()` ends
    the workers."""

    def __init__(self):
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor

        ctx = multiprocessing.get_context("spawn")
        self.pools = [ProcessPoolExecutor(max_workers=1, mp_context=ctx)
                      for _ in range(2)]
        self.futures = [p.submit(_first_call_job) for p in self.pools]

    def check(self):
        a, b = (f.result() for f in self.futures)
        log("first calls of two fresh CPU workers (WGP log_exp fp32, "
            f"forward only): {json.dumps(a)} and {json.dumps(b)}")
        check(a == b, "CPU reference not reproducible: the first calls of "
                      f"two fresh CPU workers differ: {a} against {b}")

    def stop(self):
        for p in self.pools:
            p.shutdown(cancel_futures=True)


# A start moved by rounding: the CPU's fp64 run with every initial parameter
# scaled by (1 + ULP_REL), against the same run unmoved, shows how far
# training alone carries a change of the size the card's other order of
# sums makes (where that reaches the card's gaps, the gaps are the
# trajectory's, not the card's).  COURSE_EPOCHS: where the ELBO curves part.
# Depth: the runs of phases 6-12 that took 200 epochs take 100 (EXP_EPOCHS,
# ID_EPOCHS, WGP_EPOCHS, SURF_EPOCHS, NG_EPOCHS, BAT_EPOCHS), to keep the
# script within its time limit on a slow host.  The held tables of the
# runs cut (EXP_*, ID_*, WGP_LIMITS, SURF_LIMITS' unwhitened and per-output
# runs) are 10x the gaps measured after 100 epochs, floored at 10 rounding
# units, or their earlier limits (10x the 200-epoch gaps) where those are
# tighter; the 200-epoch gaps in their comments were read before the cut.
# The natgrad and battery CLI runs are logged, and their held runs are
# early ones (NG_EARLY, BAT_EARLY).  Two runs keep 200, where a gap measured
# after 100 epochs passed the limit set after 200: the classification
# protocol's (CLS_EPOCHS; its binary TGP's fp32 test logL 1.0e-3, limit
# 5.2e-4) and DGP-2's (DGP_EPOCHS; fp64 layers/0/q_L 3.5e-10, limit
# 2.3e-10).
ULP_REL = 1e-15
COURSE_EPOCHS = (1, 2, 10, 30, 66, 100, 150, 200)


def curve_course(vals, runs, tag):
    """For each run of `runs`, the ELBO curve's largest gap to the CPU's
    fp64 curve ('cpu64') over its first e epochs, for each e of
    COURSE_EPOCHS, relative to that curve's largest |value| (logged)."""
    ref = vals["cpu64"]["curve"]
    out = {}
    for r in runs:
        d = np.abs(vals[r]["curve"] - ref) / np.abs(ref).max()
        out[r] = {e: float(d[:e].max()) for e in COURSE_EPOCHS if e <= len(d)}
        log(f"{tag} {r} vs cpu64, the curve over the first epochs: "
            + ", ".join(f"{e}: {g:.1e}" for e, g in out[r].items()))
    return out


# ---------------------------------------------------------------------------
# phase 6: the experiment CLI
# ---------------------------------------------------------------------------

EXP_EPOCHS = 100          # training epochs of the boston runs
EXP_M = 100               # the README's headline model: boston TGP, M=100
# The nine-dataset pass: 5 epochs each at a smaller M (k-means on protein's
# 41157 rows takes half a minute at M=100 on the host); the identity fit of
# the Step* archs keeps its 2000 epochs.
# boston's entry is the fp32 run at M=100 above (its 100 epochs include 5)
EXP_DATASETS = ("concrete", "energy", "kin8nm", "naval", "power", "protein",
                "wine_red", "wine_white")
EXP_ALL_EPOCHS, EXP_ALL_M = 5, 20
# Limits on the card against the CPU after the identity fit and EXP_EPOCHS,
# relative to the largest entry of the CPU's fp64 run ("flow" and "fit":
# the largest gap over the trained flow's and the identity fit's leaves,
# relative to the group's largest entry): 10x the gaps measured on an
# NVIDIA H100 80GB HBM3 at 700 W, floored at 10 rounding units.  The fit
# repeats the CPU's to 5e-14; Adam amplifies the order of sums as in the
# training phase, to 1e-12 in Z and 3e-12 in q_L after 100 epochs (1e-7
# and 5e-7 after 200).
EXP_F64_LIMITS = {
    "fit_mse": 5.0e-13, "fit": 2.7e-14, "curve": 1.4e-13, "kld": 3.3e-15,
    "Z": 1.1e-11, "q_mu": 1.3e-12, "q_L": 2.7e-11,
    "kernel/child/raw_lengthscale": 1.2e-13, "kernel/raw_outputscale": 1.9e-14,
    "likelihood/log_var_noise": 2.3e-15, "flow": 2.3e-13,
    "train/logL": 2.2e-13, "train/rmse": 8.3e-13, "test/logL": 7.4e-13,
    "test/rmse": 4.2e-12}
# fp32, the card against the CPU's fp32 run, 10x the measured gaps (floored
# at 10 rounding units); q(U) is held through the KL curve only (see
# TRAIN_F32_LIMITS)
EXP_F32_LIMITS = {
    "fit_mse": 5.2e-05, "fit": 1.7e-05, "curve": 2.6e-05, "kld": 1.5e-06,
    "Z": 1.6e-03, "kernel/child/raw_lengthscale": 4.5e-05,
    "kernel/raw_outputscale": 6.7e-06, "likelihood/log_var_noise": 1.2e-06,
    "flow": 4.2e-05, "train/logL": 1.2e-06, "train/rmse": 2.8e-05,
    "test/logL": 5.6e-06, "test/rmse": 2.7e-04}
EXP_SVGP_LIMITS = {"curve": 5.9e-05, "train/logL": 1.6e-04, "train/rmse": 1.6e-04,
                   "test/logL": 8.2e-04, "test/rmse": 3.2e-03}


def cli_run(model, dataset, M, epochs, precision, platform, extra=()):
    """`experiments.main.run` as the command line would call it; the
    precision goes back to fp32 after it."""
    from tgp.pytorch_tpu_torch import config as cfg
    from tgp.pytorch_tpu_torch.experiments import main as X

    try:
        return X.run(X.parse_args([
            "--model", model, "--dataset", dataset,
            "--train_test_seed_split", "1", "--num_inducing", str(M),
            "--epochs", str(epochs), "--precision", precision,
            "--platform", platform, "--verbose_each", "0", *extra]))
    finally:
        cfg.set_precision("fp32")


def exp_values(run):
    """Everything a run is compared by, fp64 on the host, by name: the
    identity fit's MSE and leaves ('fit/...'), the ELBO and KL curves, the
    trained parameters and the metrics."""
    out = {"curve": np.asarray(run.trainer.loss_curve, np.float64),
           "kld": np.asarray(run.trainer.kld_curve, np.float64)}
    if run.identity_fit is not None:
        out["fit_mse"] = np.asarray([run.identity_fit[2]])
        out.update(("fit/" + n.split("/", 1)[1], t.double().cpu().numpy())
                   for n, t in named_leaves({"f": run.identity_fit[1]}))
    out.update((n, t.detach().double().cpu().numpy())
               for n, t in named_leaves(run.trainer.params))
    for split in ("train", "test"):
        for k in ("logL", "rmse"):
            out[f"{split}/{k}"] = np.asarray(run.metrics[split][k], np.float64)
    return out


def exp_group(name):
    return name.split("/")[0] if name.startswith(("flow/", "fit/")) else name


def rule_group(name):
    """The groups the 4x rule against fp64 compares: the metrics together,
    the flow's and the fit's leaves together, every other name alone."""
    return "metrics" if name.startswith(("train/", "test/")) else exp_group(name)


def exp_run(model, dataset, M, epochs, precision, platform, extra=()):
    """One CLI run as the main path: the Gram kernel's counts set to 0 just
    before it and read just after.  Returns the `Run` and its summary (what
    the phase compares and checks, host values only)."""
    from tgp.pytorch_tpu_torch.ops import rbf_gram as R

    t0 = time.perf_counter()
    # --- the main path: counts from 0 ------------------------------------
    R.LAUNCHES = R.BWD_LAUNCHES = R.BWD_TILE_LAUNCHES = 0
    run = cli_run(model, dataset, M, epochs, precision, platform, extra)
    counts = (R.LAUNCHES, R.BWD_LAUNCHES, R.BWD_TILE_LAUNCHES)
    # -----------------------------------------------------------------------
    tr = run.trainer
    return run, dict(
        tag=f"{model} {dataset} M={M} {precision} on the "
            f"{'card' if platform == 'gpu' else 'CPU'}",
        platform=platform, values=exp_values(run), line=run.line,
        kernel_calls=run.kernel_calls, counts=counts,
        steps=len(tr.loss_curve) * len(tr.train_loader),
        eval_batches=len(tr.train_loader) + len(tr.test_loader),
        device=tr.params["Z"].device.type, batches=len(tr.train_loader),
        Z0=run.Z0, arch=[s.kind for s in tr.spec.flow][:4],
        seconds=time.perf_counter() - t0)


def experiment_phase(dev):
    """The port's experiment CLI (`experiments.main.run`) as a user runs it:
    boston TGP at M=100 (StepTanhL(10, 2) identity-fitted for 2000 epochs,
    then 200 Adam epochs, full batch) on the card against the CPU in fp64
    and in fp32, SVGP boston against the CPU in fp32, every bundled
    regression dataset's table arch on the card for 5 epochs, and the boston
    TGP step's time and profile.  Each card run trains through exactly 1
    forward launch and 1 backward kernel call per step.  The card's boston
    runs go in this process; the CPU's runs and the other datasets' in 3
    worker processes at the same time (each eager run is host-bound)."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    result, checks = {}, []
    B = ("boston", EXP_M, EXP_EPOCHS)
    jobs = {ds: ("TGP", ds, EXP_ALL_M, EXP_ALL_EPOCHS, "fp32", "gpu")
            for ds in EXP_DATASETS}
    jobs.update(cpu32=("TGP",) + B + ("fp32", "cpu"),
                cpu64=("TGP",) + B + ("fp64", "cpu"),
                svgp_cpu32=("SVGP",) + B + ("fp32", "cpu"))
    # the longest first: energy's StepTanhL(15, 4) fit, boston's on the CPU,
    # protein's and concrete's
    first = ("energy", "cpu32", "protein", "cpu64", "concrete")
    order = sorted(jobs, key=lambda k: first.index(k) if k in first else 9)
    with ProcessPoolExecutor(
            max_workers=3, mp_context=multiprocessing.get_context("spawn")) as pool:
        futures = {k: pool.submit(_job, exp_run, *jobs[k]) for k in order}
        tgp64, s_gpu64 = exp_run("TGP", *B, "fp64", "gpu")
        tgp32, s_gpu32 = exp_run("TGP", *B, "fp32", "gpu")
        s_svgp = exp_run("SVGP", *B, "fp32", "gpu")[1]
        summ = {k: f.result() for k, f in futures.items()}
    summ.update(gpu64=s_gpu64, gpu32=s_gpu32, svgp_gpu32=s_svgp)

    counts = {"launches": 0, "bwd_launches": 0, "bwd_tile_launches": 0}
    for k, sm in summ.items():
        log(f"experiment {sm['tag']}: {sm['line']}; kernel calls "
            f"{sm['kernel_calls']} ({sm['seconds']:.1f} s)")
        if sm["platform"] == "gpu":
            main_path_checks(sm, checks, counts)
    vals = {k: summ[k]["values"] for k in ("gpu64", "cpu64", "gpu32", "cpu32")}

    # 1. boston TGP, fp64 and fp32: the card against the CPU in the same
    # precision, and each fp32 run against fp64 (logged, and the 4x rule)
    check(np.array_equal(summ["gpu64"]["Z0"], summ["cpu64"]["Z0"]), "k-means Z0")
    pairs = {"gpu64_vs_cpu64": ("gpu64", "cpu64"),
             "gpu32_vs_cpu32": ("gpu32", "cpu32"),
             "gpu32_vs_cpu64": ("gpu32", "cpu64"),
             "cpu32_vs_cpu64": ("cpu32", "cpu64")}
    gaps = held_gaps(vals, pairs, exp_group, {"gpu64_vs_cpu64": EXP_F64_LIMITS,
                                              "gpu32_vs_cpu32": EXP_F32_LIMITS},
                     "experiment TGP", checks,
                     logged=("gpu32_vs_cpu64", "cpu32_vs_cpu64"))
    # Against fp64, by groups: after 2200 fp32 Adam steps each run's
    # distance to fp64 is a walk of its own, and one scalar of the CPU's
    # can land near fp64 by chance (train rmse 1.2e-5 where test rmse sat
    # 7.8e-4 in the first measurement), so the rule compares the largest
    # gap of each group
    by_rule = {}
    for n, cpu in gaps["cpu32_vs_cpu64"].items():
        if n in ("q_mu", "q_L"):
            continue
        r = by_rule.setdefault(rule_group(n), [0.0, 0.0])
        r[0] = max(r[0], gaps["gpu32_vs_cpu64"][n])
        r[1] = max(r[1], cpu)
    for n, (gpu, cpu) in by_rule.items():
        checks.append((gpu <= max(4 * cpu, 1e-5),
                       f"fp32 experiment {n} card vs fp64 {gpu}, CPU {cpu}"))
    result.update(tgp_gaps=gaps, tgp_fp64_line=tgp64.line,
                  tgp_fp32_line=tgp32.line, init_mse=tgp64.identity_fit[2])

    # 2. SVGP boston, fp32: the card against the CPU, relative to the CPU
    sv = {k: {n: summ[f"svgp_{k}"]["values"][n] for n in EXP_SVGP_LIMITS}
          for k in ("gpu32", "cpu32")}
    sv["cpu64"] = sv["cpu32"]
    result.update(svgp_gaps=held_gaps(
        sv, {"gpu32_vs_cpu32": ("gpu32", "cpu32")}, exp_group,
        {"gpu32_vs_cpu32": EXP_SVGP_LIMITS}, "experiment SVGP", checks),
        svgp_line=summ["svgp_gpu32"]["line"])

    # 3. every bundled regression dataset with its table arch, fp32
    table = {}
    for ds in ("boston",) + EXP_DATASETS:
        sm = summ["gpu32" if ds == "boston" else ds]
        v = sm["values"]
        epochs = EXP_EPOCHS if ds == "boston" else EXP_ALL_EPOCHS
        ok = (len(v["curve"]) == epochs and np.isfinite(v["curve"]).all()
              and all(np.isfinite(v[f"{s}/{k}"]).all()
                      for s in ("train", "test") for k in ("logL", "rmse")))
        checks.append((ok, f"{ds}: ELBO {v['curve']}, {sm['line']}"))
        table[ds] = dict(line=sm["line"], batches=sm["batches"],
                         kernel_calls=sm["kernel_calls"],
                         elbo=float(v["curve"][-1]), arch=sm["arch"],
                         init_mse=float(v["fit_mse"][0]) if "fit_mse" in v
                         else None, seconds=sm["seconds"])
    result["datasets"] = table
    seconds = {sm["tag"]: sm["seconds"] for sm in summ.values()}

    # 4. the boston TGP step on the card (fp64, the CLI's default, and fp32)
    timing = {prec: step_timing(run.trainer, prec, f"experiment boston TGP {prec}")
              for prec, run in (("fp64", tgp64), ("fp32", tgp32))}
    result.update(timing=timing, seconds=seconds, **counts)
    for cond, msg in checks:
        check(cond, msg)
    return result


# ---------------------------------------------------------------------------
# phase 7: ID_TGP, the input-dependent flows (the paper's BA-TGP)
# ---------------------------------------------------------------------------

ID_EPOCHS = 100           # training epochs of the boston runs (after the fit)
ID_M = 100                # the README's headline row: boston ID_TGP, M=100
ID_POWER_EPOCHS = 3       # power ID_TGP, the deeper nets: a short run
ID_SEED = 11              # the replayed draws' CPU generator
# Limits on the card against the CPU, both drawing the same masks, relative
# to the largest entry of the CPU's fp64 run ("fit": the anchor fit's
# leaves, "flow": the trained flow's, both relative to the largest entry of
# the group): 10x the gaps measured after ID_EPOCHS on an NVIDIA H100
# 80GB HBM3 at 700 W, floored at 10 rounding units.
# fp64 repeats the CPU closely (the fit to 2.8e-16, the curve to 8.5e-8);
# fp32's fit loss moves 1e-2 (a loss of 1e-15 in fp64, rounding in fp32).
ID_F64_LIMITS = {
    "fit_loss": 8.2e-11, "fit": 2.8e-15, "curve": 8.5e-07, "kld": 2.0e-07,
    "Z": 5.6e-06, "q_mu": 1.2e-05, "q_L": 1.6e-05,
    "kernel/child/raw_lengthscale": 1.3e-06, "kernel/raw_outputscale": 1.3e-06,
    "likelihood/log_var_noise": 5.7e-08, "flow": 1.8e-05, "train/logL": 5.5e-08,
    "train/rmse": 3.8e-07, "test/logL": 1.3e-07, "test/rmse": 4.3e-07,
    "bayes/train/logL": 1.3e-08, "bayes/train/rmse": 4.1e-07,
    "bayes/test/logL": 1.1e-07, "bayes/test/rmse": 3.7e-07}
ID_F32_LIMITS = {
    "fit_loss": 9.8e-02, "fit": 1.4e-06, "curve": 3.5e-05, "kld": 4.1e-06,
    "Z": 6.1e-04, "q_mu": 4.9e-04, "q_L": 1.2e-03,
    "kernel/child/raw_lengthscale": 1.9e-05, "kernel/raw_outputscale": 6.1e-06,
    "likelihood/log_var_noise": 1.2e-06, "flow": 4.8e-03, "train/logL": 1.2e-06,
    "train/rmse": 3.9e-06, "test/logL": 1.2e-06, "test/rmse": 1.8e-05,
    "bayes/train/logL": 5.5e-06, "bayes/train/rmse": 2.3e-06,
    "bayes/test/logL": 3.2e-06, "bayes/test/rmse": 2.4e-05}
# The card's own draws against the replayed run (the same model, other
# masks): the result lines' test NLL within 0.3 and RMSE within 25%,
# stated before the first measurement
ID_NATIVE_BAND = dict(nll=0.3, rmse=0.25)


class CpuDraws:
    """The hypernets' draws (`flows.hypernet._draw`) from one seeded CPU
    generator, moved to the run's device: a run on the card and one on the
    CPU that make the same calls see the same masks and noise."""

    def __init__(self, seed):
        self.gen = torch.Generator().manual_seed(seed)

    def __call__(self, kind, shape, p, generator, dtype, device):
        if kind == "keep":
            v = torch.rand(shape, generator=self.gen, dtype=torch.float64) < p
        else:
            v = torch.randn(shape, generator=self.gen,
                            dtype=torch.float64).to(dtype)
        return v.to(device)


def id_values(run):
    """`exp_values` of an ID_TGP run, with the anchor fit's leaves
    ('fit/...') and loss, and the fully-Bayesian metrics ('bayes/...')."""
    out = exp_values(run)
    out["fit_loss"] = np.asarray([run.anchor_fit[1]])
    out.update(("fit/" + n.split("/", 1)[1], t.double().cpu().numpy())
               for n, t in named_leaves({"f": run.anchor_fit[0]}))
    for split in ("train", "test"):
        for k in ("logL", "rmse"):
            out[f"bayes/{split}/{k}"] = np.asarray(
                run.metrics_bayes[split][k], np.float64)
    return out


def id_run(dataset, M, epochs, precision, platform, replay=None,
           inference=None):
    """One ID_TGP CLI run as the main path, its counts from 0; `replay`
    seeds `CpuDraws` for the hypernets' draws (None: the run's own
    generator).  Returns the `Run` and its summary (host values only)."""
    from tgp.pytorch_tpu_torch.flows import hypernet as H
    from tgp.pytorch_tpu_torch.ops import rbf_gram as R

    extra = ("--nnet_inference", inference) if inference else ()
    prev = H._draw
    if replay is not None:
        H._draw = CpuDraws(replay)
    if platform == "gpu":
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        # --- the main path: counts from 0 --------------------------------
        R.LAUNCHES = R.BWD_LAUNCHES = R.BWD_TILE_LAUNCHES = 0
        run = cli_run("ID_TGP", dataset, M, epochs, precision, platform, extra)
        counts = (R.LAUNCHES, R.BWD_LAUNCHES, R.BWD_TILE_LAUNCHES)
        # -------------------------------------------------------------------
    finally:
        H._draw = prev
    tr = run.trainer
    return run, dict(
        tag=f"ID_TGP {dataset} M={M} {precision} on the "
            f"{'card' if platform == 'gpu' else 'CPU'}"
            + (f", replayed draws" if replay is not None else "")
            + (f", {inference}" if inference else ""),
        platform=platform, values=id_values(run), lines=(run.line, run.line_bayes),
        kernel_calls=run.kernel_calls, counts=counts,
        steps=len(tr.loss_curve) * len(tr.train_loader),
        eval_batches=len(tr.train_loader) + len(tr.test_loader),
        anchor_fit_s=run.anchor_fit_s, train_s=run.train_s,
        device=tr.params["Z"].device.type,
        peak_mem_gb=(torch.cuda.max_memory_allocated() / 2 ** 30
                     if platform == "gpu" else None),
        seconds=time.perf_counter() - t0)


def id_phase(dev):
    """ID_TGP through the port's CLI (`experiments.main.run --model
    ID_TGP`), as a user runs it:
      (i) boston M=100 (SAL(1), hypernets 13 -> 25 -> 1, tanh, dropout 0.5):
          the 2000-epoch anchor fit and 200 Adam epochs, on the card and on
          the CPU in fp64 and fp32 with the same replayed draws, held
          together leaf by leaf;
     (ii) the same with the card's own generator: finite, within a stated
          band of (i), the step's time and a 10-step profile, the anchor
          fit's epoch time and profile;
    (iii) --nnet_inference mean_field_gaussian: the flow's KL term is in the
          ELBO and the result is finite;
     (iv) power M=100 (SAL(3), nets 4 -> 50 -> 50 -> 1, relu, dropout 0.25)
          for a few epochs, with the fully-Bayesian evaluation at S_MC=100
          over the 8611 training rows, and the peak device memory.
    Every card run: 1 forward launch and 1 backward call a training step,
    none in the anchor fit, 2 forward launches an evaluation batch (point
    and Bayesian alike).  The CPU's runs go to 2 worker processes."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    from tgp.pytorch_tpu_torch import config as cfg
    from tgp.pytorch_tpu_torch.flows.initializers import fit_hypernet_to_anchors
    from tgp.pytorch_tpu_torch.models import tgp as M
    from tgp.pytorch_tpu_torch.weights import tree_map

    result, checks = {}, []
    B = ("boston", ID_M, ID_EPOCHS)
    with ProcessPoolExecutor(
            max_workers=2, mp_context=multiprocessing.get_context("spawn")) as pool:
        futures = {k: pool.submit(_job, id_run, *B, prec, "cpu", replay=ID_SEED)
                   for k, prec in (("cpu64", "fp64"), ("cpu32", "fp32"))}
        _, s_gpu64 = id_run(*B, "fp64", "gpu", replay=ID_SEED)
        run32, s_gpu32 = id_run(*B, "fp32", "gpu", replay=ID_SEED)
        native, s_native = id_run(*B, "fp64", "gpu")
        vi, s_vi = id_run(*B, "fp64", "gpu", inference="mean_field_gaussian")
        power, s_power = id_run("power", ID_M, ID_POWER_EPOCHS, "fp64", "gpu")
        summ = {k: f.result() for k, f in futures.items()}
    summ.update(gpu64=s_gpu64, gpu32=s_gpu32, native=s_native, vi=s_vi,
                power=s_power)

    counts = {"launches": 0, "bwd_launches": 0, "bwd_tile_launches": 0}
    for k, sm in summ.items():
        log(f"ID_TGP {sm['tag']}: {sm['lines'][0]} | {sm['lines'][1]}; "
            f"kernel calls {sm['kernel_calls']}; anchor fit "
            f"{sm['anchor_fit_s']:.1f} s, training {sm['train_s']:.1f} s "
            f"({sm['seconds']:.1f} s in all)")
        if sm["platform"] != "gpu":
            continue
        main_path_checks(sm, checks, counts)
        v = sm["values"]
        checks.append((all(np.isfinite(v[n]).all() for n in v),
                       f"{sm['tag']}: finite curves, parameters and metrics"))

    # (i) boston, the card against the CPU on the same draws
    vals = {k: summ[k]["values"] for k in ("gpu64", "cpu64", "gpu32", "cpu32")}
    pairs = {"gpu64_vs_cpu64": ("gpu64", "cpu64"),
             "gpu32_vs_cpu32": ("gpu32", "cpu32")}
    result["group_gaps"] = held_gaps(
        vals, pairs, exp_group, {"gpu64_vs_cpu64": ID_F64_LIMITS,
                                "gpu32_vs_cpu32": ID_F32_LIMITS},
        "ID_TGP boston", checks)

    # (ii) the card's own draws: within the band of the replayed run
    def nll_rmse(sm, bayes):
        v = sm["values"]
        pre = "bayes/" if bayes else ""
        return -float(v[pre + "test/logL"][0]), float(v[pre + "test/rmse"][0])

    for bayes in (False, True):
        (a, ra), (b, rb) = nll_rmse(s_native, bayes), nll_rmse(s_gpu64, bayes)
        log(f"ID_TGP boston native vs replayed draws ({'Bayesian' if bayes else 'point'}):"
            f" test NLL {a:.4f} / {b:.4f}, RMSE {ra:.4f} / {rb:.4f}")
        checks.append((abs(a - b) <= ID_NATIVE_BAND["nll"]
                       and abs(ra - rb) <= ID_NATIVE_BAND["rmse"] * rb,
                       f"native draws off the band: NLL {a} vs {b}, RMSE "
                       f"{ra} vs {rb}"))

    # (iii) VI: the flow's KL term is part of the ELBO
    with torch.no_grad():
        kl_flow = float(M.flows_kld(vi.trainer.spec, vi.trainer.params))
    log(f"ID_TGP boston VI: flow KL {kl_flow:.4e}, KL curve "
        f"{s_vi['values']['kld'][0]:.4e} -> {s_vi['values']['kld'][-1]:.4e}")
    checks.append((np.isfinite(kl_flow) and kl_flow > 0, f"VI flow KL {kl_flow}"))

    # (iv) power: the deeper nets and the Bayesian evaluation's memory
    log(f"ID_TGP power: peak device memory {s_power['peak_mem_gb']:.3f} GiB "
        f"(S_MC=100 over the 8611 training rows)")

    # the boston step on the card (fp64 after the run with the card's own
    # draws, fp32 after the replayed one, both drawing on the card now): the
    # median of 5 x 10 steps, a profile of 10; and the anchor fit's epoch
    specs = ([1.0], [[[0.01, 1e-5, "net_"], [0.01, 0.0, "flow"]]])
    timing = {prec: step_timing(tr, prec, f"ID_TGP boston {prec}",
                                optimisation_schedule=specs)
              for prec, tr in (("fp64", native.trainer), ("fp32", run32.trainer))}
    tr = native.trainer
    cfg.set_precision("fp64")
    try:
        fp0 = tree_map(lambda x: x[0].detach(), tr.params["flow"])
        X = [b for b, _ in tr.train_loader]

        def ten_fit_epochs():
            fit_hypernet_to_anchors(tr.spec.flow, fp0, X, num_epochs=10)
            torch.cuda.synchronize()

        ten_fit_epochs()
        t0 = time.perf_counter()
        ten_fit_epochs()
        fit_ms = 1e3 * (time.perf_counter() - t0) / 10
        fit_prof = profile_device(ten_fit_epochs)
    finally:
        cfg.set_precision("fp32")
    fit_epoch = {k: fit_prof[k] / 10 for k in ("device_ops", "device_busy_ms")}
    log(f"ID_TGP boston anchor-fit epoch {fit_ms:.3f} ms; "
        f"{fit_epoch['device_ops']:.1f} device ops, busy "
        f"{fit_epoch['device_busy_ms']:.3f} ms; 2000 epochs took "
        f"{s_native['anchor_fit_s']:.1f} s in the run")
    result.update(
        summaries={k: {kk: vv for kk, vv in sm.items() if kk != "values"}
                   for k, sm in summ.items()},
        step_timing=timing,
        anchor_fit_epoch=dict(ms=fit_ms, profile=fit_epoch,
                              profile_top_ms=fit_prof["top_ms"]),
        vi_flow_kl=kl_flow, power_peak_mem_gb=s_power["peak_mem_gb"], **counts)
    for cond, msg in checks:
        check(cond, msg)
    return result


# Bayesian serving: `Predictor(fully_bayesian=True)` on power's ID_TGP at full
# width (SAL(3), hypernets 4 -> 50 -> 50 -> 1, relu, dropout 0.25, M=100,
# fp32), its weights random from a seed.  Moments and bands at the two
# buckets; 1 forward launch a request.  The card's moments against the
# CPU's with the same replayed draws: 10x the first measurement's gaps on an
# NVIDIA H100 80GB HBM3 at 700 W, relative to the largest |value|.
BAYES_SERVING_LIMITS = {"mean": 6.6e-3, "var": 3.2e-3}


def bayes_serving_phase(dev):
    from tgp.pytorch_tpu_torch import config as cfg, weights
    from tgp.pytorch_tpu_torch.data.uci import load_uci_split
    from tgp.pytorch_tpu_torch.experiments import flow_arch
    from tgp.pytorch_tpu_torch.flows import hypernet as H
    from tgp.pytorch_tpu_torch.likelihoods.gaussian import LikelihoodSpec
    from tgp.pytorch_tpu_torch.models.tgp import TGPSpec, init_tgp_params
    from tgp.pytorch_tpu_torch.ops import kernels, rbf_gram as R
    from tgp.pytorch_tpu_torch.serve import Predictor

    d = load_uci_split("power", 1)
    X_tr, X_te = d["X_tr"], d["X_te"]
    fspec, finits = flow_arch.build_id_flow("power", X_tr.shape[1])
    spec = TGPSpec(Dy=1, Dx=4, M=100, N=float(X_tr.shape[0]),
                   kernel=kernels.from_name("scale_rbf"),
                   likelihood=LikelihoodSpec("gaussian_flow", 1, quad_points=100),
                   flow=fspec)
    params = weights.perturb_params(init_tgp_params(
        spec, X_tr, X_tr[:100], variance_scale=1e-2,
        kernel_init={"length_scale": 2.0, "kernel_scale": 2.0},
        flow_inits=finits, dtype=torch.float64, device="cpu"), seed=1)
    params = weights.tree_map(lambda t: t.float().double(), params)
    kw = dict(Y_std=d["Y_std"], Y_mean=d["Y_mean"], buckets=(256, 4096),
              S_MC=100, fully_bayesian=True, seed=0)
    pred = Predictor(spec, params, device=dev, **kw)
    X32, X4096 = X_te[:32], np.resize(X_te, (4096, X_te.shape[1]))
    for X in (X32, X4096):                       # warm-up
        pred.predict(X)

    lat, res, per = {}, {}, []
    # --- the main path: counts from 0, 1 launch per request --------------
    R.LAUNCHES = R.BWD_LAUNCHES = R.BWD_TILE_LAUNCHES = 0
    n_requests = 0
    for key, X, reps, call in (
            ("bayes_moments_n32", X32, 20, dict(quantiles=None)),
            ("bayes_moments_n4096", X4096, 10, dict(quantiles=None)),
            ("bayes_bands_n32", X32, 20, dict()),
            ("bayes_bands_n4096", X4096, 10, dict())):
        for _ in range(reps):
            before = R.LAUNCHES
            t0 = time.perf_counter()
            res[key] = pred.predict(X, **call)
            lat.setdefault(key, []).append(time.perf_counter() - t0)
            per.append((key, R.LAUNCHES - before))
            n_requests += 1
    launches, bwd_launches, bwd_tile_launches = (
        R.LAUNCHES, R.BWD_LAUNCHES, R.BWD_TILE_LAUNCHES)
    # ----------------------------------------------------------------------
    checks = [(c == 1, f"{k}: {c} launches in one request") for k, c in per]
    checks += [(launches == n_requests, f"{launches} launches, {n_requests} requests"),
               (bwd_launches == 0, f"{bwd_launches} backward launches")]
    for key, out in res.items():
        n = 32 if key.endswith("n32") else 4096
        for k, v in out.items():
            checks.append((v.shape == (1, n) and np.isfinite(v).all(),
                           f"{key} {k}: shape {v.shape}, finite"))
        checks.append(((out["var"] > 0).all(), f"{key}: var > 0"))
        if "lower" in out:
            checks.append(((out["lower"] <= out["upper"]).all(),
                           f"{key}: lower <= upper"))

    # the card against the CPU (fp32), the same hypernet draws replayed
    prev = H._draw
    try:
        H._draw = CpuDraws(ID_SEED)
        gpu = pred.predict(X32, quantiles=None)
        H._draw = CpuDraws(ID_SEED)
        cpu = Predictor(spec, params, device="cpu", **kw).predict(
            X32, quantiles=None)
    finally:
        H._draw = prev
    gaps = {k: float(np.max(np.abs(gpu[k] - cpu[k])) / np.max(np.abs(cpu[k])))
            for k in ("mean", "var")}
    for k, g in gaps.items():
        log(f"serving Bayesian {k:4s} card vs CPU fp32, replayed draws: {g:.3e}")
        checks.append((k in BAYES_SERVING_LIMITS and g <= BAYES_SERVING_LIMITS[k],
                       f"Bayesian serving {k}: {g} (limit "
                       f"{BAYES_SERVING_LIMITS.get(k)})"))
    p50 = {k: 1e3 * float(np.median(v)) for k, v in lat.items()}
    for k, v in p50.items():
        log(f"serving p50 {k:20s} {v:9.3f} ms  ({len(lat[k])} reps)")
    prof = profile_device(lambda: pred.predict(X4096, quantiles=None))
    prof["busy_share_of_p50"] = prof["device_busy_ms"] / p50["bayes_moments_n4096"]
    log(f"profile bayes_moments_n4096: {prof['device_ops']} device ops, busy "
        f"{prof['device_busy_ms']:.3f} ms = {prof['busy_share_of_p50']:.1%} of "
        f"p50; Gram kernel {prof['gram_ms'] * 1e3:.2f} us")
    for name, ms in prof["top_ms"]:
        log(f"    {ms * 1e3:9.2f} us  {name}")
    for cond, msg in checks:
        check(cond, msg)
    return dict(launches=launches, bwd_launches=bwd_launches,
                bwd_tile_launches=bwd_tile_launches,
                requests=n_requests, p50_ms=p50, gaps=gaps, profile=prof)


# ---------------------------------------------------------------------------
# phase 8: the warped GP (--model WGP)
# ---------------------------------------------------------------------------

WGP_EPOCHS = 100          # training epochs of the boston runs
WGP_M = 100               # PARITY.md's WGP row: boston, M=100
WGP_STEP = (20, 5)        # StepTanhL: M and epochs (after its identity fit)
WGP_EARLY = 30            # SAL in fp64: the epochs held leaf by leaf
# Limits on the card against the CPU after WGP_EPOCHS, relative to the
# largest entry of the group in the CPU's fp64 run ("warp": the warp's
# leaves; "curve0": the first ELBO), per warp: 10x the gaps measured on an
# NVIDIA H100 80GB HBM3 at 700 W, floored at 10 fp64 or fp32 rounding
# units.  fp32 holds q(U) through the KL curve only (see
# TRAIN_F32_LIMITS).  The first ELBO repeats to the last bits.  SAL's
# shift then takes a step from its rounding-noise first gradient (the
# targets have mean 0): the CPU's own run with its start scaled by
# (1 + 1e-15) leaves the unscaled one as far as the card does (q_L 1e-2
# after 200 epochs; 3.6e-6 against the card's 7.3e-8 after 100).  So SAL's
# WGP_EPOCHS fp64 gaps are logged beside that witness, and SAL in fp64 is held leaf by leaf after WGP_EARLY epochs
# (the 200-epoch run's first epochs: WGP has no schedule), where the runs
# still agree (WGP_EARLY_LIMITS).
WGP_LIMITS = {
    'SAL': {
        "gpu32_vs_cpu32": {"curve": 2.8e-05, "kld": 4.7e-06, "Z": 9.7e-03,
            "kernel/child/raw_lengthscale": 1.2e-05,
            "kernel/raw_outputscale": 2.3e-06,
            "likelihood/log_var_noise": 1.2e-06, "warp": 2.2e-05,
            "train/logL": 7.8e-05, "train/rmse": 1.2e-04, "test/logL": 4.5e-05,
            "test/rmse": 2.7e-04, "curve0": 1.8e-06},
    },
    'log_exp': {
        "gpu64_vs_cpu64": {"curve": 2.0e-14, "kld": 4.4e-15, "Z": 1.4e-11,
            "kernel/child/raw_lengthscale": 4.7e-15,
            "kernel/raw_outputscale": 1.2e-14,
            "likelihood/log_var_noise": 2.3e-15, "warp": 3.2e-15,
            "q_L": 1.4e-10, "q_mu": 2.9e-13, "train/logL": 4.6e-13,
            "train/rmse": 3.8e-13, "test/logL": 2.4e-12, "test/rmse": 9.6e-12,
            "curve0": 3.5e-15},
        "gpu32_vs_cpu32": {"curve": 7.5e-06, "kld": 1.5e-06, "Z": 8.4e-03,
            "kernel/child/raw_lengthscale": 1.7e-06,
            "kernel/raw_outputscale": 1.2e-06,
            "likelihood/log_var_noise": 1.2e-06, "warp": 1.2e-06,
            "train/logL": 1.3e-04, "train/rmse": 4.5e-04, "test/logL": 2.1e-04,
            "test/rmse": 1.6e-03, "curve0": 1.3e-06},
    },
}
WGP_EARLY_LIMITS = {
    "gpu64_vs_cpu64": {"curve": 5.4e-9, "curve0": 5.0e-15, "kld": 4.3e-10,
        "Z": 5.0e-7, "kernel/child/raw_lengthscale": 3.1e-9,
        "kernel/raw_outputscale": 1.8e-9, "likelihood/log_var_noise": 1.8e-10,
        "warp": 8.4e-8, "q_L": 5.1e-7, "q_mu": 2.2e-6, "train/logL": 4.6e-9,
        "train/rmse": 4.7e-9, "test/logL": 1.2e-9, "test/rmse": 3.6e-8},
}
# the card's fp32 warped serving answers against the CPU's fp32 answers
# (the trained log_exp model), relative to the largest |value|: 10x the
# gaps measured with the limits above
WGP_SERVING_LIMITS = {"mean": 3.3e-4, "var": 1.9e-4}


def wgp_group(name):
    return "warp" if name.startswith("likelihood/warp/") else exp_group(name)


def wgp_run(arch, M, epochs, precision, platform):
    """One `--model WGP --warp_arch arch` CLI run on boston as the main
    path: `exp_run` with the warp's flags; its values add the first ELBO
    alone ('curve0')."""
    run, sm = exp_run("WGP", "boston", M, epochs, precision, platform,
                      ("--warp_arch", arch))
    sm["values"]["curve0"] = sm["values"]["curve"][:1]
    return run, sm


def wgp_serving(dev, run, checks):
    """`Predictor` on the trained log_exp WGP (its fp64 card run's
    parameters, served in fp32): moments and 95% bands of 200 samples at
    n=32 and n=4096 (buckets 256 and 4096), each through T^{-1} by
    Newton's method (100 steps); 1 forward launch a request and none
    backward.  The card's moments against the CPU's (fp32)."""
    from tgp.pytorch_tpu_torch import config as cfg
    from tgp.pytorch_tpu_torch.data.uci import load_uci_split
    from tgp.pytorch_tpu_torch.ops import rbf_gram as R
    from tgp.pytorch_tpu_torch.serve import Predictor
    from tgp.pytorch_tpu_torch.weights import tree_map

    cfg.set_precision("fp32")
    d = load_uci_split("boston", 1)
    tr = run.trainer
    params = tree_map(lambda t: t.detach().float().double().cpu(), tr.params)
    kw = dict(Y_std=d["Y_std"], Y_mean=d["Y_mean"], buckets=(256, 4096), seed=0)
    pred = Predictor(tr.spec, params, device=dev, **kw)
    X32 = d["X_te"][:32]
    X4096 = np.resize(d["X_tr"], (4096, d["X_tr"].shape[1]))
    for X in (X32, X4096):
        pred.predict(X)                                   # warm-up
    lat, res, per = {}, {}, []
    # --- the main path: counts from 0, 1 launch per request --------------
    R.LAUNCHES = R.BWD_LAUNCHES = R.BWD_TILE_LAUNCHES = 0
    for key, X, reps, call in (
            ("wgp_moments_n32", X32, 20, dict(quantiles=None)),
            ("wgp_moments_n4096", X4096, 10, dict(quantiles=None)),
            ("wgp_bands_n32", X32, 10, dict()),
            ("wgp_bands_n4096", X4096, 5, dict())):
        for _ in range(reps):
            before = R.LAUNCHES
            t0 = time.perf_counter()
            res[key] = pred.predict(X, **call)
            lat.setdefault(key, []).append(time.perf_counter() - t0)
            per.append((key, R.LAUNCHES - before))
    launches, bwd_launches, bwd_tile_launches = (
        R.LAUNCHES, R.BWD_LAUNCHES, R.BWD_TILE_LAUNCHES)
    # ----------------------------------------------------------------------
    checks += [(c == 1, f"{k}: {c} launches in one request") for k, c in per]
    checks += [(launches == len(per), f"{launches} launches, {len(per)} requests"),
               (bwd_launches == 0, f"{bwd_launches} backward launches")]
    for key, out in res.items():
        n = 32 if key.endswith("n32") else 4096
        checks += [(v.shape == (1, n) and np.isfinite(v).all(),
                    f"{key} {k}: shape {v.shape}, finite") for k, v in out.items()]
        checks.append(((out["var"] > 0).all(), f"{key}: var > 0"))
        if "lower" in out:
            checks.append(((out["lower"] <= out["upper"]).all(),
                           f"{key}: lower <= upper"))
    cpu = Predictor(tr.spec, params, device="cpu", **kw).predict(X32, quantiles=None)
    gaps = {k: float(np.max(np.abs(res["wgp_moments_n32"][k] - cpu[k]))
                     / np.max(np.abs(cpu[k]))) for k in ("mean", "var")}
    for k, g in gaps.items():
        log(f"serving WGP log_exp {k:4s} card vs CPU fp32: {g:.3e}")
        checks.append((k in WGP_SERVING_LIMITS and g <= WGP_SERVING_LIMITS[k],
                       f"WGP serving {k}: {g} (limit {WGP_SERVING_LIMITS.get(k)})"))
    p50 = {k: 1e3 * float(np.median(v)) for k, v in lat.items()}
    for k, v in p50.items():
        log(f"serving p50 {k:20s} {v:9.3f} ms  ({len(lat[k])} reps)")
    profs = {}
    for key, X, call in (("wgp_moments_n4096", X4096, dict(quantiles=None)),
                         ("wgp_bands_n4096", X4096, dict())):
        prof = profile_device(lambda: pred.predict(X, **call))
        prof["busy_share_of_p50"] = prof["device_busy_ms"] / p50[key]
        log(f"profile {key}: {prof['device_ops']} device ops, busy "
            f"{prof['device_busy_ms']:.3f} ms = {prof['busy_share_of_p50']:.1%} "
            f"of p50; Gram kernel {prof['gram_ms'] * 1e3:.2f} us")
        if prof["gram_seen"] != 1:
            # the request launched it once (counted above): the profiler
            # dropped events, so the ops and the busy time are lower bounds
            log(f"    the profile holds {prof['gram_seen']} of the request's 1 "
                f"Gram launch: events lost")
        for name, ms in prof["top_ms"]:
            log(f"    {ms * 1e3:9.2f} us  {name}")
        profs[key] = prof
    return dict(launches=launches, bwd_launches=bwd_launches,
                bwd_tile_launches=bwd_tile_launches, requests=len(per),
                p50_ms=p50, gaps=gaps, profiles=profs)


def wgp_phase(dev):
    """The warped GP through the port's CLI (`experiments.main.run --model
    WGP`), as a user runs it: boston M=100 for 100 epochs with the SAL and
    the log_exp warps, on the card against the CPU in fp64 and fp32 (no
    draw in training or evaluation), SAL in fp64 held after WGP_EARLY
    epochs and its 100-epoch gaps logged beside the CPU's from a moved
    start (ULP_REL); StepTanhL (identity-fitted for 2000
    epochs) at M=20 for 5 epochs; 1 forward launch and 1 backward call a
    training step, 2 forward launches an evaluation batch; the log_exp
    step's time and profile; and warped serving (`wgp_serving`).  The CPU's
    runs go to 3 worker processes."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    result, checks = {}, []
    runs, summ = {}, {}
    cpu = {(arch, prec, "cpu"): (arch, WGP_M, WGP_EPOCHS, prec, "cpu")
           for arch in ("log_exp", "SAL") for prec in ("fp64", "fp32")}
    cpu["SAL", "fp64", "cpu_ulp"] = cpu["SAL", "fp64", "cpu"]
    cpu["SAL early", "fp64", "cpu"] = ("SAL", WGP_M, WGP_EARLY, "fp64", "cpu")
    with ProcessPoolExecutor(
            max_workers=3, mp_context=multiprocessing.get_context("spawn")) as pool:
        futures = {k: pool.submit(_job, wgp_run, *a,
                                  init_rel=ULP_REL if k[2] == "cpu_ulp" else 0.0)
                   for k, a in cpu.items()}
        for arch in ("SAL", "log_exp"):
            for prec in ("fp64", "fp32"):
                runs[arch, prec], summ[arch, prec, "gpu"] = wgp_run(
                    arch, WGP_M, WGP_EPOCHS, prec, "gpu")
        summ["SAL early", "fp64", "gpu"] = wgp_run(
            "SAL", WGP_M, WGP_EARLY, "fp64", "gpu")[1]
        summ["StepTanhL", "fp64", "gpu"] = wgp_run(
            "StepTanhL", *WGP_STEP, "fp64", "gpu")[1]
        summ.update({k: f.result() for k, f in futures.items()})

    counts = {"launches": 0, "bwd_launches": 0, "bwd_tile_launches": 0}
    for (arch, prec, plat), sm in summ.items():
        moved = ", init x (1 + 1e-15)" if plat == "cpu_ulp" else ""
        log(f"WGP {arch} {sm['tag']}{moved}: {sm['line']}; kernel calls "
            f"{sm['kernel_calls']} ({sm['seconds']:.1f} s)")
        v = sm["values"]
        checks.append((all(np.isfinite(v[n]).all() for n in v),
                       f"WGP {arch} {sm['tag']}: finite curves, parameters, "
                       f"metrics"))
        if plat == "gpu":
            main_path_checks(sm, checks, counts)
    result["lines"] = {" ".join(k): sm["line"] for k, sm in summ.items()}

    pairs = {"gpu64_vs_cpu64": ("gpu64", "cpu64"),
             "gpu32_vs_cpu32": ("gpu32", "cpu32"),
             "cpu64_ulp_vs_cpu64": ("cpu64_ulp", "cpu64")}
    gaps, course = {}, {}
    for arch in ("SAL", "log_exp"):
        vals = {f"{p}{b}": summ[arch, f"fp{b}", p]["values"]
                for p in ("gpu", "cpu") for b in ("64", "32")}
        if arch == "SAL":
            vals["cpu64_ulp"] = summ[arch, "fp64", "cpu_ulp"]["values"]
            course[arch] = curve_course(vals, ("gpu64", "cpu64_ulp"),
                                        f"WGP {arch}")
        # SAL in fp64 is chaotic: its 100-epoch gaps are logged
        logged = ("cpu64_ulp_vs_cpu64",) + (
            ("gpu64_vs_cpu64",) if arch == "SAL" else ())
        gaps[arch] = held_gaps(vals, {k: v for k, v in pairs.items()
                                      if v[0] in vals},
                               wgp_group, WGP_LIMITS[arch], f"WGP {arch}", checks,
                               logged=logged)
    early = {f"{p}64": summ["SAL early", "fp64", p]["values"] for p in ("gpu", "cpu")}
    gaps["SAL early"] = held_gaps(early, {"gpu64_vs_cpu64": ("gpu64", "cpu64")},
                                  wgp_group, WGP_EARLY_LIMITS,
                                  f"WGP SAL {WGP_EARLY} epochs", checks)
    result.update(gaps=gaps, curve_course=course)
    result["step_timing"] = step_timing(runs["log_exp", "fp64"].trainer, "fp64",
                                        "WGP boston log_exp fp64")
    result["serving"] = wgp_serving(dev, runs["log_exp", "fp64"], checks)
    counts["launches"] += result["serving"]["launches"]
    result.update(counts)
    for cond, msg in checks:
        check(cond, msg)
    return result


# ---------------------------------------------------------------------------
# phase 9: classification (the synthetic classification protocol)
# ---------------------------------------------------------------------------

CLS_EPOCHS = 200          # protocol epochs (the kernel held for 66)
CLS_EARLY = 30            # binary TGP in fp64: the epochs held leaf by leaf
CLS_SEED = 13             # the replayed draws' CPU generator
# Limits on the card against the CPU, both on `CpuDraws(CLS_SEED)`'s draws,
# relative to the largest entry of the group in the CPU's fp64 run ("fit",
# "flow": their leaves), per task and model: 10x the gaps measured on an
# NVIDIA H100 80GB HBM3 at 700 W, floored at 10 rounding units.  The
# first ELBO repeats the CPU's to the last bits in every case, and the ID
# nets' runs stay within 1e-12 in fp64.  Binary TGP (SAL_InvBCL) does not:
# the CPU's own run with its start scaled by (1 + 1e-15) leaves the
# unscaled one from epoch ~30 on, by 1e-2 in q_L and Z after 200 epochs, as
# far as the card does.  So its 200-epoch fp64 gaps are logged beside that
# witness, and it is held leaf by leaf in a run of CLS_EARLY epochs
# (the kernel held for 10), where the runs still agree (CLS_EARLY_LIMITS).
CLS_LIMITS = {
    ('binary', 'TGP'): {
        "gpu32_vs_cpu32": {"curve": 1.5e-4, "curve0": 1.9e-6, "kld": 1.8e-3,
            "Z": 7.5e-2, "flow": 7.2e-3,
            "kernel/child/raw_lengthscale": 4.1e-3,
            "kernel/raw_outputscale": 6.1e-3, "pe/train/logL": 1.5e-3,
            "pe/train/BRIER": 3.5e-3, "pe/train/NLL": 1.5e-3,
            "pe/test/logL": 5.2e-4, "pe/test/BRIER": 5.0e-3,
            "pe/test/NLL": 5.2e-4},
    },
    ('categorical', 'TGP'): {
        "gpu64_vs_cpu64": {"curve": 8.3e-6, "curve0": 2.4e-15, "kld": 2.2e-6,
            "Z": 1.9e-4, "flow": 1.5e-5,
            "kernel/child/raw_lengthscale": 1.1e-4,
            "kernel/raw_outputscale": 4.4e-5, "q_L": 1.7e-3, "q_mu": 2.9e-4,
            "pe/train/logL": 1.1e-5, "pe/train/BRIER": 3.8e-5,
            "pe/train/NLL": 7.5e-6, "pe/test/logL": 3.6e-4,
            "pe/test/BRIER": 5.4e-4, "pe/test/NLL": 3.8e-4},
        "gpu32_vs_cpu32": {"curve": 2.0e-5, "curve0": 6.2e-7, "kld": 2.1e-5,
            "Z": 2.5e-3, "flow": 2.5e-4,
            "kernel/child/raw_lengthscale": 6.5e-4,
            "kernel/raw_outputscale": 1.1e-3, "pe/train/logL": 1.7e-6,
            "pe/train/BRIER": 1.6e-4, "pe/train/NLL": 6.5e-6,
            "pe/test/logL": 1.9e-4, "pe/test/BRIER": 4.3e-4,
            "pe/test/NLL": 1.8e-4},
    },
    ('binary', 'ID_TGP'): {
        "gpu64_vs_cpu64": {"curve": 1.7e-13, "curve0": 1.1e-15,
            "kld": 2.3e-14, "Z": 2.2e-12, "flow": 6.6e-12,
            "kernel/child/raw_lengthscale": 6.2e-14,
            "kernel/raw_outputscale": 1.8e-13, "q_L": 3.0e-12,
            "q_mu": 8.2e-13, "fit": 2.8e-15, "pe/train/logL": 1.4e-14,
            "pe/train/BRIER": 1.2e-14, "pe/train/NLL": 1.4e-14,
            "pe/test/logL": 1.4e-14, "pe/test/BRIER": 6.4e-14,
            "pe/test/NLL": 1.5e-14, "ba/train/logL": 2.8e-14,
            "ba/train/BRIER": 1.8e-14, "ba/train/NLL": 2.4e-14,
            "ba/test/logL": 7.4e-15, "ba/test/BRIER": 6.8e-14,
            "ba/test/NLL": 1.8e-14},
        "gpu32_vs_cpu32": {"curve": 6.8e-5, "curve0": 6.0e-7, "kld": 5.3e-6,
            "Z": 3.5e-4, "flow": 6.0e-3,
            "kernel/child/raw_lengthscale": 3.4e-5,
            "kernel/raw_outputscale": 4.7e-5, "fit": 1.2e-6,
            "pe/train/logL": 1.4e-5, "pe/train/BRIER": 1.8e-5,
            "pe/train/NLL": 1.4e-5, "pe/test/logL": 1.4e-4,
            "pe/test/BRIER": 1.6e-4, "pe/test/NLL": 1.4e-4,
            "ba/train/logL": 7.5e-6, "ba/train/BRIER": 1.4e-5,
            "ba/train/NLL": 6.2e-6, "ba/test/logL": 1.4e-4,
            "ba/test/BRIER": 1.6e-4, "ba/test/NLL": 1.4e-4},
    },
    ('categorical', 'ID_TGP'): {
        "gpu64_vs_cpu64": {"curve": 1.4e-14, "curve0": 1.1e-15,
            "kld": 8.2e-15, "Z": 2.5e-12, "flow": 1.4e-12,
            "kernel/child/raw_lengthscale": 2.6e-13,
            "kernel/raw_outputscale": 2.9e-13, "q_L": 3.0e-12,
            "q_mu": 3.9e-12, "fit": 5.0e-15, "pe/train/logL": 1.1e-15,
            "pe/train/BRIER": 1.1e-14, "pe/train/NLL": 1.6e-15,
            "pe/test/logL": 2.3e-14, "pe/test/BRIER": 4.2e-14,
            "pe/test/NLL": 3.2e-14, "ba/train/logL": 1.6e-15,
            "ba/train/BRIER": 1.1e-14, "ba/train/NLL": 1.6e-15,
            "ba/test/logL": 3.1e-14, "ba/test/BRIER": 3.9e-14,
            "ba/test/NLL": 3.0e-14},
        "gpu32_vs_cpu32": {"curve": 5.5e-5, "curve0": 6.0e-7, "kld": 8.1e-6,
            "Z": 1.0e-3, "flow": 5.7e-3,
            "kernel/child/raw_lengthscale": 6.8e-5,
            "kernel/raw_outputscale": 4.5e-4, "fit": 1.8e-6,
            "pe/train/logL": 2.8e-5, "pe/train/BRIER": 6.0e-7,
            "pe/train/NLL": 2.5e-5, "pe/test/logL": 7.3e-5,
            "pe/test/BRIER": 7.6e-5, "pe/test/NLL": 7.8e-5,
            "ba/train/logL": 2.7e-5, "ba/train/BRIER": 2.2e-6,
            "ba/train/NLL": 2.6e-5, "ba/test/logL": 5.6e-5,
            "ba/test/BRIER": 6.2e-5, "ba/test/NLL": 6.5e-5},
    },
}
CLS_EARLY_LIMITS = {
    "gpu64_vs_cpu64": {"curve": 1.3e-14, "curve0": 1.1e-15, "kld": 1.1e-14,
        "Z": 1.3e-12, "flow": 1.2e-14, "kernel/child/raw_lengthscale": 9.3e-14,
        "kernel/raw_outputscale": 1.9e-14, "q_L": 4.2e-11, "q_mu": 4.8e-12,
        "pe/train/logL": 3.6e-14, "pe/train/BRIER": 4.7e-14,
        "pe/train/NLL": 3.8e-14, "pe/test/logL": 5.4e-14,
        "pe/test/BRIER": 6.9e-14, "pe/test/NLL": 5.4e-14},
}
CLS_CASES = [(k, m) for m in ("TGP", "ID_TGP") for k in ("binary", "categorical")]
# Serving the trained fp32 models: buckets at the protocol's 120 test and
# 1080 training rows (the shapes the kernel phase holds at Dy=1 and 3),
# requests of the 120 test rows and of 1000 training rows (padded); ID_TGP
# fully Bayesian at the protocol's S_MC.  The card's probabilities against
# the CPU's on the same draws, max |difference|: 10x the measured gaps.
CLS_SERVING = dict(buckets=(120, 1080), n=(120, 1000), S_MC=50)
CLS_SERVING_LIMITS = {('binary', 'TGP'): 3.8e-4, ('categorical', 'TGP'): 3.3e-4,
                      ('binary', 'ID_TGP'): 2.0e-4,
                      ('categorical', 'ID_TGP'): 8.3e-5}


def cls_values(run):
    """A protocol run's curves (and the first ELBO alone, 'curve0'),
    parameters, anchor fit's leaves, and each evaluation's logL, Brier
    score and NLL
    ('pe/...', 'ba/...'), fp64 on the host; and apart, the accuracies (a
    count of rows) and the ECEs, which a probability crossing a bin edge
    moves by a step (logged, not held)."""
    tr = run.trainer
    out = {"curve": np.asarray(tr.loss_curve, np.float64),
           "curve0": np.asarray(tr.loss_curve[:1], np.float64),
           "kld": np.asarray(tr.kld_curve, np.float64)}
    out.update((n, t.detach().double().cpu().numpy())
               for n, t in named_leaves(tr.params))
    if run.anchor_fit is not None:
        # its leaves; not its loss, which fp64 drives to 1e-32 and fp32
        # leaves at rounding
        out.update(("fit/" + n.split("/", 1)[1], t.double().cpu().numpy())
                   for n, t in named_leaves({"f": run.anchor_fit[0]}))
    acc, ece = {}, {}
    for ev, m in zip(("pe", "ba"), run.metrics):
        for split in ("train", "test"):
            out[f"{ev}/{split}/logL"] = np.asarray(m[split]["logL"], np.float64)
            for k in ("BRIER", "NLL"):
                out[f"{ev}/{split}/{k}"] = np.asarray(
                    [m[split]["calibration"][k]])
            acc[f"{ev}/{split}"] = float(m[split]["acc"])
            ece[f"{ev}/{split}"] = float(m[split]["calibration"]["ECE"])
    return out, acc, ece


def cls_run(kind, model, precision, platform, epochs, replay=CLS_SEED):
    """One protocol run (`experiments.classification_protocol.run`) as the
    main path, its counts from 0, its draws (MC normals, dropout masks)
    from `CpuDraws(replay)`.  Returns the `Run` and its summary."""
    from tgp.pytorch_tpu_torch import config as cfg
    from tgp.pytorch_tpu_torch.experiments import classification_protocol as P
    from tgp.pytorch_tpu_torch.flows import hypernet as H
    from tgp.pytorch_tpu_torch.ops import rbf_gram as R

    prev = H._draw
    H._draw = CpuDraws(replay)
    cfg.set_precision(precision)
    t0 = time.perf_counter()
    try:
        # --- the main path: counts from 0 --------------------------------
        R.LAUNCHES = R.BWD_LAUNCHES = R.BWD_TILE_LAUNCHES = 0
        run = P.run(kind, epochs, model=model,
                    device="cuda" if platform == "gpu" else "cpu")
        counts = (R.LAUNCHES, R.BWD_LAUNCHES, R.BWD_TILE_LAUNCHES)
        # -------------------------------------------------------------------
    finally:
        H._draw = prev
        cfg.set_precision("fp32")
    tr = run.trainer
    values, acc, ece = cls_values(run)
    return run, dict(
        tag=f"{kind} {model} {precision} on the "
            f"{'card' if platform == 'gpu' else 'CPU'}",
        platform=platform, values=values, acc=acc, ece=ece,
        records=run.records,
        kernel_calls=run.kernel_calls, counts=counts,
        steps=len(tr.loss_curve) * len(tr.train_loader),
        eval_batches=len(tr.train_loader) + len(tr.test_loader),
        device=tr.params["Z"].device.type,
        n_rows={"train": len(tr.train_loader.dataset),
                "test": len(tr.test_loader.dataset)},
        seconds=time.perf_counter() - t0)


def cls_serving(dev, runs, checks):
    """`Predictor` on the four trained fp32 protocol models (CLS_SERVING):
    {"probs": (n, C)} through 1 forward launch a request and none backward,
    probabilities that sum to 1, and the card's against the CPU Predictor's
    on the same draws (`CpuDraws`: the categorical MC normals, the ID nets'
    dropout masks)."""
    from tgp.pytorch_tpu_torch import config as cfg
    from tgp.pytorch_tpu_torch.flows import hypernet as H
    from tgp.pytorch_tpu_torch.ops import rbf_gram as R
    from tgp.pytorch_tpu_torch.serve import Predictor
    from tgp.pytorch_tpu_torch.weights import tree_map

    cfg.set_precision("fp32")
    preds, reqs = {}, {}
    for kind, model in CLS_CASES:
        tr = runs[kind, model, "fp32"].trainer
        params = tree_map(lambda t: t.detach().cpu(), tr.params)
        kw = dict(buckets=CLS_SERVING["buckets"], S_MC=CLS_SERVING["S_MC"],
                  fully_bayesian=model == "ID_TGP", seed=0)
        preds[kind, model] = (Predictor(tr.spec, params, device=dev, **kw),
                              Predictor(tr.spec, params, device="cpu", **kw))
        X_te, X_tr = tr.test_loader.dataset.X, tr.train_loader.dataset.X
        reqs[kind, model] = [X_te[:n] if n <= len(X_te) else X_tr[:n]
                             for n in CLS_SERVING["n"]]
        for X in reqs[kind, model]:
            preds[kind, model][0].predict(X)                  # warm-up
    lat, res, per = {}, {}, []
    # --- the main path: counts from 0, 1 launch per request --------------
    R.LAUNCHES = R.BWD_LAUNCHES = R.BWD_TILE_LAUNCHES = 0
    for case, (pred, _) in preds.items():
        for X in reqs[case]:
            key = f"{case[0]} {case[1]} n={len(X)}"
            for _ in range(10):
                before = R.LAUNCHES
                t0 = time.perf_counter()
                res[key] = pred.predict(X)
                lat.setdefault(key, []).append(time.perf_counter() - t0)
                per.append((key, R.LAUNCHES - before))
    launches, bwd_launches, bwd_tile_launches = (
        R.LAUNCHES, R.BWD_LAUNCHES, R.BWD_TILE_LAUNCHES)
    # ----------------------------------------------------------------------
    checks += [(c == 1, f"{k}: {c} launches in one request") for k, c in per]
    checks += [(launches == len(per), f"{launches} launches, {len(per)} requests"),
               (bwd_launches == 0, f"{bwd_launches} backward launches")]
    for key, out in res.items():
        p, n = out["probs"], int(key.split("n=")[1])
        C = 2 if key.startswith("binary") else 3
        checks.append((set(out) == {"probs"} and p.shape == (n, C)
                       and np.isfinite(p).all() and (p >= 0).all()
                       and np.abs(p.sum(-1) - 1).max() <= 1e-5,
                       f"serving {key}: probs {p.shape}, rows sum to 1"))

    # the card against the CPU, the same draws replayed
    gaps, prev = {}, H._draw
    try:
        for case, (pred, cpu) in preds.items():
            got = []
            for p in (pred, cpu):
                H._draw = CpuDraws(CLS_SEED)
                got.append([p.predict(X)["probs"] for X in reqs[case]])
            gaps[case] = max(float(np.abs(a - b).max()) for a, b in zip(*got))
            # where the gap is largest, each side's value to the last digit,
            # each side's jitter rung and the trained parameters' digest:
            # across runs, which side moved and whether training did
            r = max(range(len(got[0])),
                    key=lambda r: float(np.abs(got[0][r] - got[1][r]).max()))
            i = np.unravel_index(int(np.abs(got[0][r] - got[1][r]).argmax()),
                                 got[0][r].shape)
            spec = runs[case + ("fp32",)].trainer.spec
            try:
                rungs = [ladder_rung(spec, p.params) for p in (pred, cpu)]
            except Exception as e:          # a model without one K_zz
                rungs = [type(e).__name__] * 2
            digest = sum(float(t.double().abs().sum()) for _, t in
                         named_leaves(cpu.params))
            log(f"serving classification {case[0]} {case[1]} request {r} at "
                f"{[int(k) for k in i]}: card {float(got[0][r][i])!r} CPU "
                f"{float(got[1][r][i])!r}; jitter rung card {rungs[0]} CPU "
                f"{rungs[1]}; parameters' sum of |x| {digest!r}")
    finally:
        H._draw = prev
    for case, g in gaps.items():
        log(f"serving classification {case[0]} {case[1]} probs card vs CPU "
            f"fp32: {g:.3e}")
        checks.append((g <= CLS_SERVING_LIMITS[case],
                       f"classification serving {case}: {g} (limit "
                       f"{CLS_SERVING_LIMITS[case]})"))
    p50 = {k: 1e3 * float(np.median(v)) for k, v in lat.items()}
    for k, v in p50.items():
        log(f"serving p50 {k:28s} {v:9.3f} ms  ({len(lat[k])} reps)")
    return dict(launches=launches, bwd_launches=bwd_launches,
                bwd_tile_launches=bwd_tile_launches, requests=len(per),
                p50_ms=p50, gaps={" ".join(k): g for k, g in gaps.items()})


def classification_phase(dev):
    """The classification protocol through the port's
    `experiments.classification_protocol.run`, as a user runs it (1080
    training and 120 test rows, Dx=4, M=50, the kernel held for a third,
    clip norm 100): binary (Bernoulli, SAL_InvBCL) and 3-class (categorical,
    per-class BCL_AL; the Gram's batch axis Dy=3), TGP and ID_TGP (the
    2000-epoch anchor fit, PE and BA evaluations), 200 epochs, on the card
    against the CPU in fp64 and fp32 on the same draws (binary TGP in fp64
    held after CLS_EARLY epochs and its 200-epoch gaps logged beside the
    CPU's from a moved start); 1 forward launch and 1 backward call a
    training step, 2 forward launches an evaluation batch; accuracy within
    2 rows of the CPU's; the categorical TGP step's time and profile; the
    trained fp32 models served (`cls_serving`).  The CPU's runs go to 3
    worker processes."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    result, checks = {}, []
    runs, summ = {}, {}
    cpu = {(k, m, p, "cpu"): (k, m, p, "cpu", CLS_EPOCHS)
           for m in ("ID_TGP", "TGP") for k in ("categorical", "binary")
           for p in ("fp64", "fp32")}
    cpu["binary", "TGP", "fp64", "cpu_ulp"] = cpu["binary", "TGP", "fp64", "cpu"]
    early = ("binary", "TGP", "fp64")
    cpu["binary early", "TGP", "fp64", "cpu"] = early + ("cpu", CLS_EARLY)
    with ProcessPoolExecutor(
            max_workers=3, mp_context=multiprocessing.get_context("spawn")) as pool:
        futures = {k: pool.submit(_job, cls_run, *a,
                                  init_rel=ULP_REL if k[3] == "cpu_ulp" else 0.0)
                   for k, a in cpu.items()}
        for kind, model in CLS_CASES:
            for prec in ("fp64", "fp32"):
                runs[kind, model, prec], summ[kind, model, prec, "gpu"] = \
                    cls_run(kind, model, prec, "gpu", CLS_EPOCHS)
        summ["binary early", "TGP", "fp64", "gpu"] = cls_run(
            *early, "gpu", CLS_EARLY)[1]
        summ.update({k: f.result() for k, f in futures.items()})

    counts = {"launches": 0, "bwd_launches": 0, "bwd_tile_launches": 0}
    for key, sm in summ.items():
        moved = ", init x (1 + 1e-15)" if key[3] == "cpu_ulp" else ""
        log(f"classification {sm['tag']}{moved}: {sm['records']}; kernel "
            f"calls {sm['kernel_calls']} ({sm['seconds']:.1f} s)")
        v = sm["values"]
        checks.append((all(np.isfinite(v[n]).all() for n in v),
                       f"{sm['tag']}: finite curves, parameters, metrics"))
        if key[3] == "gpu":
            main_path_checks(sm, checks, counts)
    result["records"] = {" ".join(k): sm["records"] for k, sm in summ.items()}

    pairs = {"gpu64_vs_cpu64": ("gpu64", "cpu64"),
             "gpu32_vs_cpu32": ("gpu32", "cpu32"),
             "cpu64_ulp_vs_cpu64": ("cpu64_ulp", "cpu64")}
    gaps, course = {}, {}
    for kind, model in CLS_CASES:
        s = {f"{p}{b}": summ[kind, model, f"fp{b}", p]
             for p in ("gpu", "cpu") for b in ("64", "32")}
        vals = {k: sm["values"] for k, sm in s.items()}
        tag = f"classification {kind} {model}"
        if (kind, model) == early[:2]:
            vals["cpu64_ulp"] = summ[early + ("cpu_ulp",)]["values"]
            course[tag] = curve_course(vals, ("gpu64", "cpu64_ulp"), tag)
        # binary TGP in fp64 is chaotic: its 200-epoch gaps are logged
        logged = ("cpu64_ulp_vs_cpu64",) + (
            ("gpu64_vs_cpu64",) if (kind, model) == early[:2] else ())
        gaps[kind, model] = held_gaps(vals, {k: v for k, v in pairs.items()
                                             if v[0] in vals},
                                      exp_group, CLS_LIMITS[kind, model], tag,
                                      checks, logged=logged)
        for b in ("64", "32"):
            for name, acc in s["cpu" + b]["acc"].items():
                rows = s["cpu" + b]["n_rows"][name.split("/")[1]]
                diff = abs(s["gpu" + b]["acc"][name] - acc) * rows
                log(f"{tag} fp{b} accuracy {name}: card "
                    f"{s['gpu' + b]['acc'][name]:.4f}, CPU {acc:.4f}; ECE "
                    f"{s['gpu' + b]['ece'][name]:.4f}, "
                    f"{s['cpu' + b]['ece'][name]:.4f}")
                checks.append((diff <= 2.0 + 1e-9,
                               f"{tag} fp{b} {name}: accuracy {diff} rows apart"))
    gaps["binary early", "TGP"] = held_gaps(
        {f"{p}64": summ["binary early", "TGP", "fp64", p]["values"]
         for p in ("gpu", "cpu")}, {"gpu64_vs_cpu64": ("gpu64", "cpu64")},
        exp_group, CLS_EARLY_LIMITS,
        f"classification binary TGP {CLS_EARLY} epochs", checks)
    result["curve_course"] = course
    result["gaps"] = {" ".join(k): g for k, g in gaps.items()}
    result["step_timing"] = step_timing(
        runs["categorical", "TGP", "fp32"].trainer, "fp32",
        "classification categorical TGP fp32", clip_norm=100.0)
    result["serving"] = cls_serving(dev, runs, checks)
    counts["launches"] += result["serving"]["launches"]
    result.update(counts)
    for cond, msg in checks:
        check(cond, msg)
    return result


# ---------------------------------------------------------------------------
# phase 10: the model surface
# ---------------------------------------------------------------------------

SURF_EPOCHS = 100         # training epochs of the three fp64 runs
SURF_EARLY = 30           # the forecast's epochs held leaf by leaf
SURF_M = {"sm": 50, "unwhitened": 100, "per_output": 50}
SURF_KINDS = ("sm", "unwhitened", "per_output")
# The runs on the card against the CPU in fp64, relative to the largest
# entry of the CPU's run ('flow': the largest gap over the flows' leaves):
# 10x the gaps measured after SURF_EPOCHS (SURF_EARLY for the forecast) on
# an NVIDIA H100 80GB HBM3 at 700 W, floored at 10 rounding units.  The
# forecast is chaotic: the CPU's run from a start scaled by 1 + 1e-15
# parts from the unscaled one between epochs 30 and 66 (1.1e-2 in the
# curve), as the card's does (1.8e-2), so its SURF_EPOCHS are logged and
# its first SURF_EARLY held.  The unwhitened model applies K_zz^{-1}
# (condition number ~1e8) where the whitened one applies L^{-1}: card and
# CPU part by 2.7e-9 in the ELBO after one step and 5.4e-8 after 100, q_L
# (its entries whose gradient is rounding noise, stepped by Adam at the
# learning rate) by 5.6e-4, while the moved CPU start stays within 3e-11.
SURF_LIMITS = {
    "sm": None,
    "sm early": {
        "curve": 1.9e-08, "kld": 3.7e-10, "Z": 4.3e-08,
        "kernel/children/0/children/0/raw_lengthscale": 8.2e-09,
        "kernel/children/0/children/0/raw_period": 1.1e-09,
        "kernel/children/0/children/1/child/raw_lengthscale": 8.4e-09,
        "kernel/children/0/children/1/raw_outputscale": 5.6e-09,
        "kernel/children/1/children/0/raw_lengthscale": 2.5e-09,
        "kernel/children/1/children/0/raw_period": 6.9e-08,
        "kernel/children/1/children/1/child/raw_lengthscale": 2.3e-09,
        "kernel/children/1/children/1/raw_outputscale": 5.7e-09,
        "likelihood/log_var_noise": 1.7e-09, "q_L": 1.6e-07, "q_mu": 1.1e-07,
        "test/logL": 6.9e-08, "test/rmse": 5.4e-08},
    "unwhitened": {
        "curve": 5.4e-07, "kld": 2.8e-05, "Z": 1.7e-05, "flow": 1.7e-06,
        "kernel/child/raw_lengthscale": 1.7e-06,
        "kernel/raw_outputscale": 5.5e-07, "likelihood/log_var_noise": 8.0e-09,
        "q_L": 5.7e-03, "q_mu": 9.6e-06, "train/logL": 2.3e-06,
        "train/rmse": 1.4e-05, "test/logL": 9.3e-06, "test/rmse": 5.6e-06},
    "per_output": {
        "curve": 3.3e-08, "kld": 3.7e-08, "Z": 3.4e-07, "flow": 6.9e-07,
        "kernel/child/raw_lengthscale": 6.8e-08,
        "kernel/raw_outputscale": 3.5e-08, "likelihood/log_var_noise": 1.3e-08,
        "q_L": 9.9e-07, "q_mu": 2.5e-07, "train/logL": 6.2e-08,
        "train/rmse": 3.5e-09, "test/logL": 2.6e-07, "test/rmse": 1.3e-07},
}
# marginal_qf's full covariance (diagonal=False) of the trained unwhitened
# model on boston's 51 test rows, the card against the CPU on the same
# parameters, relative to the largest entry (fp64): 10x the measured gap
FULL_COV_LIMIT = 1.7e-12
SOLVE_MS = (100, 256)     # power M=100 (the flagship) and M=256
SOLVE_MODES = ("highest", "high", "default")
SOLVE_ARMS = (("trsm", "highest"), ("fast", "highest"), ("fast", "high"),
              ("fast", "default"))
# fp32, fast_solves: 'high' and 'default' against 'highest' on the same
# parameters, relative to the largest entry of 'highest' (mu, var; the
# ELBO's gradient: the largest over the leaves of each leaf's gap relative
# to its largest entry): 10x the gaps measured on an NVIDIA H100 80GB HBM3
# at 700 W.  'high' (three TF32 passes) is fp32 rounding amplified by
# K_zz's conditioning; 'default' (one bf16 pass) moves the moments by as
# much as their largest entry, as the TPU's one bf16 pass would.
PREC_LIMITS = {
    (100, "high"): dict(mu=1.3e-3, var=4.5e-4, grad=1.3e-2),
    (100, "default"): dict(mu=15.0, var=8.2, grad=63.0),
    (256, "high"): dict(mu=5.2e-3, var=2.7e-3, grad=2.7e-1),
    (256, "default"): dict(mu=53.0, var=8.0, grad=630.0),
}


def surface_model(kind, device):
    """(spec, params, loaders, Y_std) of phase 10's fp64 runs, in the
    configured precision:
      * 'unwhitened': boston split 1 (455 training rows, Dx=13), SAL(2)
        flow, scale-RBF ARD, whiten=False, M=100 k-means centers, q(U)
        variance 1e-5, lengthscale and output scale 2, noise 0.05;
      * 'per_output': boston's inputs with two targets, y and
        y^3/3 + y/2 (z-scored), SAL(1) on output 0 and ArcSL(1) on
        output 1 (`flow_per_output`, the JAX package's
        tests/test_hetero_flows.py flows), M=50, the Gram at Dy=2."""
    from tgp.pytorch_tpu_torch import config as cfg
    from tgp.pytorch_tpu_torch.data import (ArrayDataset, DataLoader,
                                            kmeans_centers, return_dataset)
    from tgp.pytorch_tpu_torch.flows import generators as G, spec_from_list
    from tgp.pytorch_tpu_torch.likelihoods import LikelihoodSpec
    from tgp.pytorch_tpu_torch.models import tgp as PM
    from tgp.pytorch_tpu_torch.ops import kernels as K

    loaders, dc = return_dataset("boston", 10000, seed=1)
    M = SURF_M[kind]
    Z0 = kmeans_centers(dc["X_tr"], M, n_init=10, seed=cfg.config_seed)
    np.random.seed(cfg.config_seed)
    common = dict(Dx=dc["Dx"], M=M, N=float(dc["N_tr"]),
                  kernel=K.from_name("scale_rbf"))
    if kind == "unwhitened":
        fspec, finits = spec_from_list(G.SAL(2))
        spec = PM.TGPSpec(Dy=1, likelihood=LikelihoodSpec(
            "gaussian_flow", 1, quad_points=cfg.quad_points), flow=fspec,
            whiten=False, **common)
        Y_std = dc["Y_std"]
    else:
        s0, i0 = spec_from_list(G.SAL(1))
        s1, i1 = spec_from_list(G.ArcSL(1))
        finits = [i0, i1]
        spec = PM.TGPSpec(Dy=2, likelihood=LikelihoodSpec(
            "gaussian_flow", 2, quad_points=cfg.quad_points), flow=s0,
            flow_per_output=(s0, s1), **common)

        def two(Y):
            y2 = Y ** 3 / 3 + Y / 2
            return np.concatenate([Y, (y2 - mu2) / sd2], axis=1)

        y2 = dc["Y_tr"] ** 3 / 3 + dc["Y_tr"] / 2
        mu2, sd2 = y2.mean(), y2.std()
        loaders = [DataLoader(ArrayDataset(ld.dataset.X, two(ld.dataset.Y)),
                              ld.batch_size, shuffle=ld.shuffle)
                   for ld in loaders]
        Y_std = np.ones(2)
    params = PM.init_tgp_params(
        spec, dc["X_tr"], Z0, variance_scale=1e-5,
        kernel_init={"length_scale": 2.0, "kernel_scale": 2.0},
        noise_init=0.05, flow_inits=finits, device=device)
    return spec, params, loaders, Y_std


def surface_run(kind, precision, platform, epochs=SURF_EPOCHS):
    """One of phase 10's runs as the main path, its counts from 0: 'sm' is
    `experiments.sm_timeseries.run('spectral_mixture')` (the forecast's
    1008 training and 336 forecast hours, M=50, two Periodic x ScaleRBF
    components: 2 launches each way a step); the others train
    `surface_model`'s model with Adam at lr 0.01, full batch, then evaluate.
    Returns the Trainer and its summary (host values only)."""
    from tgp.pytorch_tpu_torch import config as cfg
    from tgp.pytorch_tpu_torch.experiments import sm_timeseries as S
    from tgp.pytorch_tpu_torch.ops import rbf_gram as R
    from tgp.pytorch_tpu_torch.train import Trainer

    device = torch.device("cuda", 0) if platform == "gpu" else torch.device("cpu")
    t0 = time.perf_counter()
    cfg.set_precision(precision)
    try:
        if kind == "sm":
            # --- the main path: counts from 0 --------------------------------
            R.LAUNCHES = R.BWD_LAUNCHES = R.BWD_TILE_LAUNCHES = 0
            run = S.run("spectral_mixture", epochs, device=device)
            counts = (R.LAUNCHES, R.BWD_LAUNCHES, R.BWD_TILE_LAUNCHES)
            # -------------------------------------------------------------------
            tr, metrics, kc = run.trainer, {"test": run.metrics}, run.kernel_calls
        else:
            spec, params, loaders, Y_std = surface_model(kind, device)
            tr = Trainer(spec, params, loaders, Y_std, device=device)
            # --- the main path: counts from 0 --------------------------------
            R.LAUNCHES = R.BWD_LAUNCHES = R.BWD_TILE_LAUNCHES = 0
            tr.train(epochs, 0.01, "adam", verbose_each=0)
            trained = (R.LAUNCHES, R.BWD_LAUNCHES)
            metrics = tr.compute_metrics()
            counts = (R.LAUNCHES, R.BWD_LAUNCHES, R.BWD_TILE_LAUNCHES)
            # -------------------------------------------------------------------
            kc = {"train": trained,
                  "eval": tuple(b - a for a, b in zip(trained, counts))}
    finally:
        cfg.set_precision("fp32")
    values = {"curve": np.asarray(tr.loss_curve, np.float64),
              "kld": np.asarray(tr.kld_curve, np.float64)}
    values.update((n, t.detach().double().cpu().numpy())
                  for n, t in named_leaves(tr.params))
    for split, m in metrics.items():
        for k in ("logL", "rmse"):
            values[f"{split}/{k}"] = np.asarray(m[k], np.float64)
    return tr, dict(
        tag=f"{kind} {precision} on the {'card' if platform == 'gpu' else 'CPU'}",
        platform=platform, values=values, kernel_calls=kc, counts=counts,
        rbf_leaves=2 if kind == "sm" else 1,
        steps=len(tr.loss_curve) * len(tr.train_loader),
        eval_batches=len(tr.train_loader) + len(tr.test_loader),
        device=tr.params["Z"].device.type,
        metrics={s: {k: np.asarray(v[k], np.float64).tolist()
                     for k in ("logL", "rmse")} for s, v in metrics.items()},
        seconds=time.perf_counter() - t0)


def full_cov_check(dev, tr, checks, counts):
    """marginal_qf(diagonal=False) of the trained unwhitened model on its
    test rows: K_xz, K_zz and K_xx, 2 forward launches, against the CPU on
    the same parameters (fp64)."""
    from tgp.pytorch_tpu_torch import config as cfg
    from tgp.pytorch_tpu_torch.models import tgp as PM
    from tgp.pytorch_tpu_torch.ops import rbf_gram as R
    from tgp.pytorch_tpu_torch.weights import tree_map

    X = tr.test_loader.dataset.X
    cfg.set_precision("fp64")
    try:
        out = {}
        for device in (dev, torch.device("cpu")):
            p = tree_map(lambda t: t.detach().to(device), tr.params)
            Xd = torch.as_tensor(X, dtype=torch.float64, device=device)
            # --- the main path: counts from 0 --------------------------------
            R.LAUNCHES = R.BWD_LAUNCHES = R.BWD_TILE_LAUNCHES = 0
            mu, cov = PM.marginal_qf(tr.spec, p, Xd, diagonal=False)
            torch.cuda.synchronize()
            out[device.type] = ((R.LAUNCHES, R.BWD_LAUNCHES), mu.cpu(), cov.cpu())
            # -------------------------------------------------------------------
    finally:
        cfg.set_precision("fp32")
    calls = out["cuda"][0]
    counts["launches"] += calls[0]
    checks.append((calls == (2, 0), f"full covariance: {calls} kernel calls, "
                   "expected (2, 0)"))
    gap = max(float((a - b).abs().max() / b.abs().max())
              for a, b in zip(out["cuda"][1:], out["cpu"][1:]))
    shape = tuple(out["cuda"][2].shape)
    log(f"model surface full covariance {shape}: card vs CPU {gap:.3e}")
    checks.append((shape == (1, X.shape[0], X.shape[0]), f"full cov {shape}"))
    checks.append((gap <= FULL_COV_LIMIT, f"full covariance gap {gap}"))
    return dict(gap=gap, calls=calls, shape=shape)


def solve_precision_check(dev, checks, counts):
    """fp32, fast_solves at 'high' and 'default' against 'highest' on the
    flagship's perturbed init over the 8611 power training rows at M=100
    and M=256: the K_zz factor and jittered matrix (so the rung) that
    marginal_qf computes inside each mode are bitwise 'highest''s; the
    moments and the ELBO's gradient move by a recorded nonzero gap (its
    forward and its backward take the lever); 2 forward launches and 1
    backward call (marginal_qf, then the ELBO and its gradient)."""
    import dataclasses

    from tgp.pytorch_tpu_torch import weights
    from tgp.pytorch_tpu_torch.data.uci import load_uci_split
    from tgp.pytorch_tpu_torch.models import tgp as PM
    from tgp.pytorch_tpu_torch.ops import rbf_gram as R

    d = load_uci_split("power", 1)
    X, Y = (torch.as_tensor(d[k], dtype=F32, device=dev) for k in ("X_tr", "Y_tr"))
    result = {}
    chol = PM.safe_cholesky
    for M in SOLVE_MS:
        spec = weights.flagship_spec(X.shape[0], M=M)
        params = weights.flagship_params(spec, d["X_tr"], seed=0, device=dev,
                                         dtype=F32)
        res, seen = {}, {}
        for mode in SOLVE_MODES:
            sp = dataclasses.replace(spec, fast_solves=True, solve_precision=mode)
            p = weights.tree_map(lambda t: t.detach().clone().requires_grad_(True),
                                 params)
            seen[mode] = []
            PM.safe_cholesky = lambda A, *a, _s=seen[mode], **k: (
                _s.append(chol(A, *a, **k)) or _s[-1])
            try:
                # --- the main path: counts from 0 ----------------------------
                R.LAUNCHES = R.BWD_LAUNCHES = R.BWD_TILE_LAUNCHES = 0
                mu, var = PM.marginal_qf(sp, p, X)
                e = PM.elbo(sp, p, X, Y)[0]
                grads = torch.autograd.grad(e, [t for _, t in named_leaves(p)])
                torch.cuda.synchronize()
                calls = (R.LAUNCHES, R.BWD_LAUNCHES, R.BWD_TILE_LAUNCHES)
                # ---------------------------------------------------------------
            finally:
                PM.safe_cholesky = chol
            counts["launches"] += calls[0]
            counts["bwd_launches"] += calls[1]
            counts["bwd_tile_launches"] += calls[2]
            checks.append((calls[:2] == (2, 1), f"solve precision M={M} {mode}: "
                           f"{calls} kernel calls, expected (2, 1)"))
            checks.append((not torch.backends.cuda.matmul.allow_tf32
                           and torch.get_float32_matmul_precision() == "highest",
                           f"solve precision M={M} {mode}: TF32 left on"))
            res[mode] = (mu.detach(), var.detach(), grads, float(e.detach()))
        names = [n for n, _ in named_leaves(params)]
        out = {}
        for mode in ("high", "default"):
            same = all(torch.equal(L, L0) and torch.equal(A, A0)
                       for (L, A), (L0, A0) in zip(seen[mode], seen["highest"]))
            checks.append((same and len(seen[mode]) == 2,
                           f"M={M} {mode}: K_zz's factor differs from 'highest'"))
            mu, var, grads, e = res[mode]
            mu0, var0, grads0, e0 = res["highest"]
            g = {n: float((a - b).abs().max() / (b.abs().max() or 1.0))
                 for n, a, b in zip(names, grads, grads0)}
            gap = dict(mu=float((mu - mu0).abs().max() / mu0.abs().max()),
                       var=float((var - var0).abs().max() / var0.abs().max()),
                       grad=max(g.values()), elbo=abs(e - e0) / abs(e0))
            log(f"solve precision M={M} fast/{mode} vs fast/highest: mu "
                f"{gap['mu']:.3e}, var {gap['var']:.3e}, ELBO {gap['elbo']:.3e}, "
                f"gradient {gap['grad']:.3e} (largest: "
                f"{max(g, key=g.get)}); K_zz factor bitwise equal: {same}")
            for k in ("mu", "var", "grad"):
                checks.append((gap[k] > 0.0, f"M={M} {mode}: {k} did not move"))
            lim = PREC_LIMITS[M, mode]
            for k in ("mu", "var", "grad"):
                checks.append((gap[k] <= lim[k],
                               f"M={M} {mode} {k}: {gap[k]} (limit {lim[k]})"))
            out[mode] = dict(gap, grad_by_leaf=g, factor_equal=same)
        result[M] = out
    return result


def solve_arm_timing(dev, checks, counts):
    """A training step's time for the four solve arms (trsm/highest,
    fast/highest, fast/high, fast/default) on the 8611 power rows in fp32
    at M=100 and M=256 (`bench.flagship_trainer`'s model at M), one
    Trainer for each M with its spec swapped between arms; the arms run
    in the order 1 2 3 4 4 3 2 1, each 3 x 10 steps, the median of the 6;
    1 forward launch and 1 backward call a step in every arm."""
    import dataclasses

    from tgp.pytorch_tpu_torch import weights
    from tgp.pytorch_tpu_torch.data import return_dataset
    from tgp.pytorch_tpu_torch.ops import rbf_gram as R
    from tgp.pytorch_tpu_torch.train import Trainer

    loaders, d = return_dataset("power", 10000, seed=1)
    out = {}
    for M in SOLVE_MS:
        spec = dataclasses.replace(weights.flagship_spec(d["X_tr"].shape[0], M=M),
                                   min_var=1e-8)
        tr = Trainer(spec, weights.flagship_init(spec, d["X_tr"],
                                                 variance_scale=1e-5, device=dev),
                     loaders, d["Y_std"], device=dev)
        tr.train(20, 0.01, "adam", verbose_each=0)
        times = {arm: [] for arm in SOLVE_ARMS}
        for arm in SOLVE_ARMS + SOLVE_ARMS[::-1]:
            tr.spec = dataclasses.replace(spec, fast_solves=arm[0] == "fast",
                                          solve_precision=arm[1])
            tr.train(3, 0.01, "adam", verbose_each=0)
            # --- the main path: counts from 0 --------------------------------
            R.LAUNCHES = R.BWD_LAUNCHES = R.BWD_TILE_LAUNCHES = 0
            for _ in range(3):
                t0 = time.perf_counter()
                tr.train(10, 0.01, "adam", verbose_each=0)
                times[arm].append((time.perf_counter() - t0) / 10)
            calls = (R.LAUNCHES, R.BWD_LAUNCHES, R.BWD_TILE_LAUNCHES)
            # -------------------------------------------------------------------
            counts["launches"] += calls[0]
            counts["bwd_launches"] += calls[1]
            counts["bwd_tile_launches"] += calls[2]
            checks.append((calls[:2] == (30, 30), f"M={M} {arm}: {calls} kernel "
                           "calls in 30 steps"))
        rows = {}
        for arm in SOLVE_ARMS:
            tr.spec = dataclasses.replace(spec, fast_solves=arm[0] == "fast",
                                          solve_precision=arm[1])
            prof = profile_device(lambda: tr.train(10, 0.01, "adam",
                                                   verbose_each=0))
            step_ms = 1e3 * float(np.median(times[arm]))
            busy = prof["device_busy_ms"] / 10
            rows["/".join(arm)] = dict(step_ms=step_ms, steps_ms=times[arm],
                                       device_ops=prof["device_ops"] / 10,
                                       device_busy_ms=busy,
                                       top_ms=prof["top_ms"][:4])
            log(f"solve arm M={M} {'/'.join(arm):13s} step {step_ms:.3f} ms "
                f"(median of 6 x 10), {prof['device_ops'] / 10:.1f} device ops, "
                f"busy {busy:.3f} ms; top: " + "; ".join(
                    f"{n[:40]} {ms * 100:.1f} us" for n, ms in prof["top_ms"][:3]))
        checks.append((np.isfinite(tr.loss_curve).all(), f"M={M} arms: ELBO"))
        out[M] = rows
    return out


def surface_phase(dev):
    """The rest of the model surface on the card: the spectral-mixture
    forecast's SVGP (two Periodic x ScaleRBF components, the Gram pair at
    Dx=1 once a component: 2 launches each way a step), an unwhitened TGP
    on boston at M=100 (its KL takes marginal_qf's K_zz: 1 and 1 a step),
    and per-output flows at Dy=2, each 100 epochs in fp64 on the card
    against the CPU, beside the CPU's run from a start scaled by 1 + 1e-15
    (the forecast, whose runs part within tens of epochs, also after
    SURF_EARLY); the unwhitened model's full covariance (2 forward launches);
    the solve-precision lever in fp32 at power M=100 and 256; the four
    solve arms' step times, and the forecast's and the unwhitened model's.
    The CPU's runs go to 3 worker processes."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    result, checks = {}, []
    counts = {"launches": 0, "bwd_launches": 0, "bwd_tile_launches": 0}
    runs_of = {k: (k, SURF_EPOCHS) for k in SURF_KINDS}
    runs_of["sm early"] = ("sm", SURF_EARLY)
    with ProcessPoolExecutor(
            max_workers=3, mp_context=multiprocessing.get_context("spawn")) as pool:
        futures = {}
        for label, (k, epochs) in runs_of.items():
            futures[label, "cpu64"] = pool.submit(_job, surface_run, k, "fp64",
                                                  "cpu", epochs)
            futures[label, "cpu64_ulp"] = pool.submit(
                _job, surface_run, k, "fp64", "cpu", epochs, init_rel=ULP_REL)
        runs, summ = {}, {}
        for label, (k, epochs) in runs_of.items():
            runs[label], summ[label, "gpu64"] = surface_run(k, "fp64", "gpu",
                                                            epochs)
        result["full_cov"] = full_cov_check(dev, runs["unwhitened"], checks,
                                            counts)
        result["solve_precision"] = solve_precision_check(dev, checks, counts)
        summ.update({key: f.result() for key, f in futures.items()})
    # timed with the host's cores free of the CPU runs
    result["solve_arms"] = solve_arm_timing(dev, checks, counts)
    result["step_timing"] = {
        "sm": step_timing(runs["sm"], "fp64", "model surface forecast fp64",
                          clip_norm=100.0),
        "unwhitened": step_timing(runs["unwhitened"], "fp64",
                                  "model surface unwhitened boston TGP fp64")}

    gaps, course = {}, {}
    pairs = {"gpu64_vs_cpu64": ("gpu64", "cpu64"),
             "cpu64_ulp_vs_cpu64": ("cpu64_ulp", "cpu64")}
    for label in runs_of:
        sm = summ[label, "gpu64"]
        log(f"model surface {label} {sm['tag']}: test {sm['metrics']['test']}; "
            f"kernel calls {sm['kernel_calls']} ({sm['seconds']:.1f} s); CPU "
            f"{summ[label, 'cpu64']['metrics']['test']}, moved start "
            f"{summ[label, 'cpu64_ulp']['metrics']['test']}")
        main_path_checks(sm, checks, counts)
        vals = {p: summ[label, p]["values"] for p in ("gpu64", "cpu64", "cpu64_ulp")}
        checks.append((all(np.isfinite(v).all() for v in sm["values"].values()),
                       f"{sm['tag']}: finite curves, parameters, metrics"))
        tag = f"model surface {label}"
        course[label] = curve_course(vals, ("gpu64", "cpu64_ulp"), tag)
        lim = SURF_LIMITS[label]
        gaps[label] = held_gaps(
            vals, pairs, exp_group,
            {} if lim is None else {"gpu64_vs_cpu64": lim}, tag, checks,
            logged=("cpu64_ulp_vs_cpu64",) + (
                ("gpu64_vs_cpu64",) if lim is None else ()))
    result.update(gaps=gaps, curve_course=course, metrics={
        f"{k} {p}": summ[k, p]["metrics"] for k in runs_of
        for p in ("gpu64", "cpu64", "cpu64_ulp")}, seconds={
        summ[key]["tag"]: summ[key]["seconds"] for key in summ}, **counts)
    for cond, msg in checks:
        check(cond, msg)
    return result


# ---------------------------------------------------------------------------
# phase 11: the deep TGP and natural gradients
# ---------------------------------------------------------------------------

DGP_EPOCHS = 200          # training epochs of the boston DGP-2 runs
DGP_M = 100               # PARITY.md's DGP rows: M=100
DGP_EARLY = 30            # the fp64 run's epochs held leaf by leaf
DGP_SEED = 17             # the replayed draws' CPU generator
DGP_FLOW_EPOCHS = 5       # kin8nm's DGP-2 --dgp_flow (fp32, the card alone)
NG_EPOCHS = 100           # the flagship's natgrad runs (natgrad_gamma 1.0)
NG_EARLY = 30             # the natgrad runs' epochs held leaf by leaf
NG_WARMUP = 10            # the ramp split over two train() calls
ULP_REL32 = 1e-7          # a moved start in fp32 (about one rounding unit)
# DGP-2 on boston (fp64 and fp32) and the flagship under natural gradients,
# the card against the CPU on the same draws, relative to the largest entry
# of the group in the CPU's fp64 run ('layers/L/flow': a layer's flow
# leaves; 'curve0': the first ELBO): 10x the gaps measured on an NVIDIA
# H100 80GB HBM3 at 700 W, floored at 10 fp64 or fp32 rounding units.  The
# DGP is not chaotic: the CPU's run from a start scaled by 1 + 1e-15 stays
# within 1.4e-15 of the unscaled one on the curve and 7.3e-12 on q_L after
# 200 epochs, as the card does (8.6e-15, 2.3e-11), so its 200 epochs are
# held, and its first DGP_EARLY too.
DGP_LIMITS = {
    "gpu64_vs_cpu64": {
        "curve": 8.6e-14, "kld": 4.3e-15, "layers/0/Z": 5.0e-12,
        "layers/0/kernel/child/raw_lengthscale": 4.0e-13,
        "layers/0/kernel/raw_outputscale": 3.5e-13,
        "layers/0/likelihood/log_var_noise": 2.2e-15,
        "layers/0/mean/W": 2.2e-15, "layers/0/q_L": 2.3e-10,
        "layers/0/q_mu": 1.6e-12, "layers/1/Z": 2.9e-12,
        "layers/1/kernel/child/raw_lengthscale": 4.9e-14,
        "layers/1/kernel/raw_outputscale": 1.0e-14,
        "layers/1/likelihood/log_var_noise": 2.2e-15,
        "layers/1/q_L": 1.0e-12, "layers/1/q_mu": 7.0e-13,
        "train/logL": 3.8e-15, "train/rmse": 8.6e-15, "test/logL": 5.6e-15,
        "test/rmse": 2.2e-15, "curve0": 5.1e-15},
    "gpu32_vs_cpu32": {
        "curve": 3.4e-06, "kld": 1.3e-06, "layers/0/Z": 1.7e-03,
        "layers/0/kernel/child/raw_lengthscale": 4.5e-05,
        "layers/0/kernel/raw_outputscale": 3.0e-05,
        "layers/0/likelihood/log_var_noise": 1.2e-06,
        "layers/0/mean/W": 1.2e-06, "layers/0/q_L": 6.9e-02,
        "layers/0/q_mu": 1.1e-03, "layers/1/Z": 2.8e-04,
        "layers/1/kernel/child/raw_lengthscale": 2.5e-06,
        "layers/1/kernel/raw_outputscale": 2.2e-06,
        "layers/1/likelihood/log_var_noise": 1.9e-06,
        "layers/1/q_L": 4.4e-04, "layers/1/q_mu": 1.4e-04,
        "train/logL": 5.7e-06, "train/rmse": 1.6e-05, "test/logL": 1.3e-06,
        "test/rmse": 1.4e-05, "curve0": 3.4e-06},
}
DGP_EARLY_LIMITS = {
    "gpu64_vs_cpu64": {
        "curve": 5.7e-15, "kld": 2.2e-15, "layers/0/Z": 3.3e-12,
        "layers/0/kernel/child/raw_lengthscale": 4.2e-14,
        "layers/0/kernel/raw_outputscale": 2.8e-15,
        "layers/0/likelihood/log_var_noise": 2.2e-15,
        "layers/0/mean/W": 2.2e-15, "layers/0/q_L": 2.9e-10,
        "layers/0/q_mu": 2.5e-11, "layers/1/Z": 2.2e-12,
        "layers/1/kernel/child/raw_lengthscale": 4.1e-15,
        "layers/1/kernel/raw_outputscale": 2.2e-15,
        "layers/1/likelihood/log_var_noise": 2.2e-15,
        "layers/1/q_L": 4.4e-13, "layers/1/q_mu": 4.1e-13,
        "train/logL": 1.4e-14, "train/rmse": 1.6e-14, "test/logL": 2.2e-15,
        "test/rmse": 6.2e-15, "curve0": 5.1e-15},
}
# Natural gradients from the flagship's init are chaotic from their first
# step: gamma=1 lands q(U) on the conditional optimum of an ill-conditioned
# precision, so a rounding gap grows to 1.6e-7 of the ELBO in fp64 (6.5e-3
# in fp32) at the second epoch, on the card as on the CPU's own run from a
# start scaled by 1 + 1e-15 (1 + 1e-7 in fp32): 1.4e-7 (2.0e-3).  So the
# 200-epoch gaps are logged beside that witness, and fp64 is held after
# NG_EARLY epochs.  In fp32 the first update is rounding: on the CPU it
# lands the ELBO at -4819 where fp64 lands at -390 (a start moved by 1e-7:
# -5679), and q(U) parts from fp64 by 0.5-0.7 of its largest entry within a
# 10-step warmup ramp.  So fp32 is held at its first ELBO ('curve0', before
# any update) and by the 4x rule against fp64 over NG_EARLY epochs (the
# card's curve no further from the CPU's fp64 one than 4x the farther of
# the CPU's fp32 runs from the start and from the moved one), its groups'
# gaps to the CPU's fp32 run logged.
NG_EARLY_LIMITS = {
    "gpu64_vs_cpu64": {
        "curve": 1.6e-06, "kld": 5.7e-07, "curve0": 4.8e-14, "Z": 3.7e-05,
        "flow": 9.1e-06, "kernel/child/raw_lengthscale": 2.4e-06,
        "kernel/raw_outputscale": 7.0e-08, "likelihood/log_var_noise": 1.0e-08,
        "q_L": 7.3e-05, "q_mu": 7.7e-05},
    "gpu32_vs_cpu32": {
        "curve0": 4.8e-06, "curve": None, "kld": None, "Z": None,
        "flow": None, "kernel/child/raw_lengthscale": None,
        "kernel/raw_outputscale": None, "likelihood/log_var_noise": None,
        "q_L": None, "q_mu": None},
}
# the card's fp32 DGP answers (moments, log_prob) against the CPU's on the
# same draws, relative to the largest |value|: 10x the gaps measured
DGP_SERVING_LIMITS = {"mean": 1.5e-5, "var": 4.3e-5, "log_prob": 9.8e-7}


def dgp_group(name):
    """A deep run's value groups: each layer's flow leaves together."""
    parts = name.split("/")
    if parts[0] == "layers" and len(parts) > 3 and parts[2] == "flow":
        return "/".join(parts[:3])
    return name


def dgp_run(dataset, M, epochs, precision, platform, extra=(),
            replay=DGP_SEED):
    """One `--model DGP --layers 2` CLI run as the main path, its counts
    from 0; `replay` seeds `CpuDraws` for the inner layers' and the
    samples' normals (None: the run's own generator).  Returns the `Run`
    and its summary (host values only; 'curve0' the first ELBO)."""
    from tgp.pytorch_tpu_torch.flows import hypernet as H
    from tgp.pytorch_tpu_torch.ops import rbf_gram as R

    prev = H._draw
    if replay is not None:
        H._draw = CpuDraws(replay)
    t0 = time.perf_counter()
    try:
        # --- the main path: counts from 0 --------------------------------
        R.LAUNCHES = R.BWD_LAUNCHES = R.BWD_TILE_LAUNCHES = 0
        run = cli_run("DGP", dataset, M, epochs, precision, platform,
                      ("--layers", "2", *extra))
        counts = (R.LAUNCHES, R.BWD_LAUNCHES, R.BWD_TILE_LAUNCHES)
        # -------------------------------------------------------------------
    finally:
        H._draw = prev
    tr = run.trainer
    values = exp_values(run)
    values["curve0"] = values["curve"][:1]
    return run, dict(
        tag=f"DGP-2{'+flow' if extra else ''} {dataset} M={M} {precision} on "
            f"the {'card' if platform == 'gpu' else 'CPU'}",
        platform=platform, values=values, line=run.line,
        kernel_calls=run.kernel_calls, counts=counts,
        steps=len(tr.loss_curve) * len(tr.train_loader),
        eval_batches=len(tr.train_loader) + len(tr.test_loader),
        layers=len(tr.spec.layers), train_s=run.train_s,
        device=tr.params["layers"][0]["Z"].device.type,
        seconds=time.perf_counter() - t0)


def deep_path_checks(sm, checks, counts):
    """A deep card run's kernel calls: L forward launches and L backward
    calls a training step, L forward launches an evaluation batch, the
    counts from 0 equal to them; summed into `counts`."""
    L, kc = sm["layers"], sm["kernel_calls"]
    counts["launches"] += sm["counts"][0]
    counts["bwd_launches"] += sm["counts"][1]
    counts["bwd_tile_launches"] += sm["counts"][2]
    checks.append((kc["train"] == (L * sm["steps"], L * sm["steps"]),
                   f"{sm['tag']}: train {kc['train']} in {sm['steps']} steps"))
    checks.append((kc["eval"] == (L * sm["eval_batches"], 0),
                   f"{sm['tag']}: eval {kc['eval']} in {sm['eval_batches']} "
                   f"batches"))
    checks.append((sm["counts"][:2] == tuple(map(sum, zip(*kc.values()))),
                   f"{sm['tag']}: counts {sm['counts']} against {kc}"))
    checks.append((sm["device"] == "cuda", f"{sm['tag']}: on the card"))


def dgp_serving(dev, run, checks):
    """`Predictor` on the trained DGP-2 (its fp64 card run's parameters,
    served in fp32): moments and 95% bands of 200 samples at n=32 and
    n=4096 (buckets 256 and 4096; a band request propagates 200 paths, so
    the 4096 bucket is the Gram at 819,200 rows) and log_prob at n=32; 2
    forward launches a request (one a layer) and none backward.  The card's
    answers at n=32 against the CPU's on the same draws (`CpuDraws`)."""
    from tgp.pytorch_tpu_torch import config as cfg
    from tgp.pytorch_tpu_torch.data.uci import load_uci_split
    from tgp.pytorch_tpu_torch.flows import hypernet as H
    from tgp.pytorch_tpu_torch.ops import rbf_gram as R
    from tgp.pytorch_tpu_torch.serve import Predictor
    from tgp.pytorch_tpu_torch.weights import tree_map

    cfg.set_precision("fp32")
    d = load_uci_split("boston", 1)
    tr = run.trainer
    L = len(tr.spec.layers)
    params = tree_map(lambda t: t.detach().float().double().cpu(), tr.params)
    kw = dict(Y_std=d["Y_std"], Y_mean=d["Y_mean"], buckets=(256, 4096), seed=0)
    pred = Predictor(tr.spec, params, device=dev, **kw)
    X32, Y32 = d["X_te"][:32], d["Y_te"][:32]
    X4096 = np.resize(d["X_tr"], (4096, d["X_tr"].shape[1]))
    for X in (X32, X4096):
        pred.predict(X)                                   # warm-up
    lat, res, per = {}, {}, []
    # --- the main path: counts from 0, L launches per request ------------
    R.LAUNCHES = R.BWD_LAUNCHES = R.BWD_TILE_LAUNCHES = 0
    for key, X, reps, call in (
            ("dgp_moments_n32", X32, 20, dict(quantiles=None)),
            ("dgp_moments_n4096", X4096, 10, dict(quantiles=None)),
            ("dgp_bands_n32", X32, 10, dict()),
            ("dgp_bands_n4096", X4096, 3, dict()),
            ("dgp_log_prob_n32", X32, 10, None)):
        for _ in range(reps):
            before = R.LAUNCHES
            t0 = time.perf_counter()
            res[key] = (pred.log_prob(X, Y32) if call is None
                        else pred.predict(X, **call))
            lat.setdefault(key, []).append(time.perf_counter() - t0)
            per.append((key, R.LAUNCHES - before))
    launches, bwd_launches, bwd_tile_launches = (
        R.LAUNCHES, R.BWD_LAUNCHES, R.BWD_TILE_LAUNCHES)
    # ----------------------------------------------------------------------
    checks += [(c == L, f"{k}: {c} launches in one request") for k, c in per]
    checks += [(launches == L * len(per),
                f"{launches} launches, {len(per)} requests"),
               (bwd_launches == 0, f"{bwd_launches} backward launches")]
    for key, out in res.items():
        if key.startswith("dgp_log_prob"):
            checks.append((np.isfinite(out).all(), f"{key} finite"))
            continue
        n = 32 if key.endswith("n32") else 4096
        checks += [(v.shape == (1, n) and np.isfinite(v).all(),
                    f"{key} {k}: shape {v.shape}, finite") for k, v in out.items()]
        checks.append(((out["var"] > 0).all(), f"{key}: var > 0"))
        if "lower" in out:
            checks.append(((out["lower"] <= out["upper"]).all(),
                           f"{key}: lower <= upper"))
    # the card against the CPU on the same draws
    answers = {}
    prev = H._draw
    try:
        for where in (dev, "cpu"):
            H._draw = CpuDraws(DGP_SEED)
            p = Predictor(tr.spec, params, device=where, **kw)
            out = p.predict(X32)
            answers[str(where)] = dict(mean=out["mean"], var=out["var"],
                                       log_prob=p.log_prob(X32, Y32))
    finally:
        H._draw = prev
    card, cpu = answers[str(dev)], answers["cpu"]
    gaps = {k: float(np.max(np.abs(card[k] - cpu[k])) / np.max(np.abs(cpu[k])))
            for k in cpu}
    for k, g in gaps.items():
        log(f"serving DGP-2 {k:8s} card vs CPU fp32: {g:.3e}")
        checks.append((g <= DGP_SERVING_LIMITS[k],
                       f"DGP serving {k}: {g} (limit {DGP_SERVING_LIMITS[k]})"))
    p50 = {k: 1e3 * float(np.median(v)) for k, v in lat.items()}
    for k, v in p50.items():
        log(f"serving p50 {k:20s} {v:9.3f} ms  ({len(lat[k])} reps)")
    profs = {}
    for key, X, call in (("dgp_moments_n4096", X4096, dict(quantiles=None)),
                         ("dgp_bands_n4096", X4096, dict())):
        prof = profile_device(lambda: pred.predict(X, **call))
        prof["busy_share_of_p50"] = prof["device_busy_ms"] / p50[key]
        log(f"profile {key}: {prof['device_ops']} device ops, busy "
            f"{prof['device_busy_ms']:.3f} ms = {prof['busy_share_of_p50']:.1%} "
            f"of p50; Gram kernel {prof['gram_ms'] * 1e3:.2f} us "
            f"({prof['gram_seen']} launches seen of {L})")
        for name, ms in prof["top_ms"]:
            log(f"    {ms * 1e3:9.2f} us  {name}")
        profs[key] = prof
    return dict(launches=launches, bwd_launches=bwd_launches,
                bwd_tile_launches=bwd_tile_launches, requests=len(per),
                p50_ms=p50, gaps=gaps, profiles=profs)


def dgp_eval_batch(dev, run, tag):
    """One evaluation batch of a trained DGP: the training split in one
    batch (S_test paths a row), its time (the median of 3 between CUDA
    events), a profile, its kernel calls (L forward, 0 backward) and the
    peak device memory."""
    from tgp.pytorch_tpu_torch.ops import rbf_gram as R

    tr = run.trainer
    X, Y = next(iter(tr.train_loader))
    Xd, Yd = tr._put(X), tr._put(Y)
    tr._eval_batch(Xd, Yd)                                # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(3):
        t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        before = (R.LAUNCHES, R.BWD_LAUNCHES)
        t0.record()
        out = tr._eval_batch(Xd, Yd)
        t1.record()
        torch.cuda.synchronize()
        calls = (R.LAUNCHES - before[0], R.BWD_LAUNCHES - before[1])
        times.append(t0.elapsed_time(t1))
    prof = profile_device(lambda: tr._eval_batch(Xd, Yd))
    ms = float(np.median(times))
    rows = X.shape[0] * max(tr.spec.S_test, tr.S_test)
    log(f"{tag} evaluation batch: {X.shape[0]} rows x {rows // X.shape[0]} "
        f"paths = {rows} rows a layer, {ms:.3f} ms; {prof['device_ops']} "
        f"device ops, busy {prof['device_busy_ms']:.3f} ms = "
        f"{prof['device_busy_ms'] / ms:.1%}; Gram kernel "
        f"{prof['gram_ms'] * 1e3:.2f} us; kernel calls {calls}; peak "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    for name, t in prof["top_ms"]:
        log(f"    {t * 1e3:9.2f} us  {name}")
    return dict(ms=ms, rows=rows, calls=calls, profile=prof,
                finite=bool(torch.isfinite(out[0]).all()),
                peak_gb=torch.cuda.max_memory_allocated() / 2 ** 30)


def ng_run(device, precision, chunks, gamma=1.0, warmup=None, move=0.0,
           shuffle=True):
    """The flagship (`bench.flagship_trainer`) under natural gradients: Adam
    at `bench.LR` on the hyperparameters, gamma on q(U), one train() call a
    chunk; the main path, its counts from 0.  `move` scales every initial
    parameter by (1 + move); shuffle=False keeps the full
    batch's rows in one order for every call.  Returns the Trainer and its
    summary (host values; 'curve0' the first ELBO)."""
    from tgp.pytorch_tpu_torch import bench, config as cfg
    from tgp.pytorch_tpu_torch.ops import rbf_gram as R
    from tgp.pytorch_tpu_torch.weights import tree_leaves

    cfg.set_precision(precision)
    try:
        tr = bench.flagship_trainer(device)
        tr.train_loader.shuffle = shuffle
        with torch.no_grad():
            for t in tree_leaves(tr.params):
                t.mul_(1 + move)
        # --- the main path: counts from 0, 1 forward + 1 backward a step
        R.LAUNCHES = R.BWD_LAUNCHES = R.BWD_TILE_LAUNCHES = 0
        for n in chunks:
            tr.train(n, bench.LR, "adam", verbose_each=0, natgrad_gamma=gamma,
                     natgrad_warmup=warmup)
        counts = (R.LAUNCHES, R.BWD_LAUNCHES, R.BWD_TILE_LAUNCHES)
        # ------------------------------------------------------------------
    finally:
        cfg.set_precision("fp32")
    values = {"curve": np.asarray(tr.loss_curve, np.float64),
              "kld": np.asarray(tr.kld_curve, np.float64)}
    values["curve0"] = values["curve"][:1]
    values.update((n, t.detach().double().cpu().numpy())
                  for n, t in named_leaves(tr.params))
    return tr, dict(values=values, counts=counts, steps=sum(chunks),
                    device=tr.params["Z"].device.type)


def natgrad_conjugate(dev):
    """The conjugate case on the card in fp64: SVGP on the 8611 power
    training rows (M=100, the first 100 rows, q(U) variance 1e-5,
    lengthscale and output scale 2), fixed hyperparameters, full batch.
    One gamma=1 `natgrad_update` lands on the optimal q(U): a second step
    moves the ELBO by less than 1e-4 and dELBO/dq(U) is below 1e-5 of
    |ELBO| + 1 (`tests/test_natgrad.py::test_conjugate_one_step_exact`).
    A step is 1 forward launch and no backward call: the hyperparameters
    are fixed, and K does not depend on q(U)."""
    from tgp.pytorch_tpu_torch import config as cfg
    from tgp.pytorch_tpu_torch.data.uci import load_uci_split
    from tgp.pytorch_tpu_torch.likelihoods import LikelihoodSpec
    from tgp.pytorch_tpu_torch.models import tgp as M
    from tgp.pytorch_tpu_torch.ops import kernels as K, rbf_gram as R
    from tgp.pytorch_tpu_torch.train import natgrad as NG

    cfg.set_precision("fp64")
    try:
        d = load_uci_split("power", 1)
        X = torch.as_tensor(d["X_tr"], dtype=torch.float64).to(dev)
        Y = torch.as_tensor(d["Y_tr"], dtype=torch.float64).to(dev)
        spec = M.TGPSpec(Dy=1, Dx=4, M=100, N=float(X.shape[0]),
                         kernel=K.from_name("scale_rbf"),
                         likelihood=LikelihoodSpec("gaussian", 1))
        p0 = M.init_tgp_params(spec, d["X_tr"], d["X_tr"][:100],
                               variance_scale=1e-5,
                               kernel_init={"length_scale": 2.0,
                                            "kernel_scale": 2.0}, device=dev)
        e0 = float(M.elbo(spec, p0, X, Y)[0])
        # --- the main path: counts from 0 --------------------------------
        R.LAUNCHES = R.BWD_LAUNCHES = R.BWD_TILE_LAUNCHES = 0
        p1 = NG.natgrad_update(spec, p0, X, Y, None, 1.0)
        counts = (R.LAUNCHES, R.BWD_LAUNCHES)
        # -------------------------------------------------------------------
        e1 = float(M.elbo(spec, p1, X, Y)[0])
        p2 = NG.natgrad_update(spec, p1, X, Y, None, 1.0)
        e2 = float(M.elbo(spec, p2, X, Y)[0])
        q = {k: p2[k].detach().clone().requires_grad_(True)
             for k in ("q_mu", "q_L")}
        e = M.elbo(spec, dict(p2, **q), X, Y)[0]
        g = torch.autograd.grad(e, list(q.values()))
        grad = max(float(t.abs().max()) for t in g)
    finally:
        cfg.set_precision("fp32")
    scale = abs(e1) + 1.0
    log(f"natgrad conjugate (SVGP power M=100 fp64, the card): ELBO {e0:.6f}"
        f" -> {e1:.6f} after one gamma=1 step, {e2:.6f} after two "
        f"(moved {abs(e2 - e1):.3e}); largest dELBO/dq(U) {grad:.3e} "
        f"({grad / scale:.3e} of |ELBO| + 1); kernel calls {counts}")
    return dict(e0=e0, e1=e1, e2=e2, grad=grad, counts=counts,
                ok=(e1 > e0 + 10.0 and abs(e2 - e1) < 1e-4
                    and grad < 1e-5 * scale and counts == (1, 0)))


def deep_natgrad_phase(dev):
    """The deep TGP (`--model DGP`) and natural gradients (`--natgrad`), as a
    user runs them:
      (i) DGP-2 on boston (Dx=13 inner layer, M=100) for 200 epochs, on the
          card and on the CPU in fp64 and fp32 with the same draws
          (`CpuDraws`), the fp64 run also held after DGP_EARLY epochs and
          its 200-epoch gaps logged beside the CPU's run from a moved start;
          S_test=100 evaluation; served (`dgp_serving`); its step's time;
     (ii) DGP-2 --dgp_flow on kin8nm (InverseBoxCoxL(1), Dx=8, M=100, fp32)
          on the card: its step's time and profile, and one evaluation batch
          of the 7373 training rows x 100 paths (the Gram at 737,300 rows);
    (iii) natural gradients: the conjugate step (`natgrad_conjugate`), the
          flagship with natgrad_gamma 1.0 for 100 epochs on the card
          against the CPU in fp64 and fp32 and its step's time, and a
          warmup ramp of NG_WARMUP split over two train() calls against the
          unsplit run, bit for bit, on the card.
    L forward launches and L backward calls a DGP-L training step, L
    forward launches a DGP evaluation batch and request, 1 and 1 a natgrad
    step.  The CPU's runs go to 3 worker processes."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    from tgp.pytorch_tpu_torch.weights import tree_leaves

    result, checks = {}, []
    counts = {"launches": 0, "bwd_launches": 0, "bwd_tile_launches": 0}
    summ, ng = {}, {}
    t0 = time.perf_counter()

    def stage(name):
        log(f"phase 11: {name} done at {time.perf_counter() - t0:.1f} s")

    cpu = {("fp64", "cpu"): ("boston", DGP_M, DGP_EPOCHS, "fp64", "cpu"),
           ("fp32", "cpu"): ("boston", DGP_M, DGP_EPOCHS, "fp32", "cpu"),
           ("early", "cpu"): ("boston", DGP_M, DGP_EARLY, "fp64", "cpu")}
    with ProcessPoolExecutor(
            max_workers=3, mp_context=multiprocessing.get_context("spawn")) as pool:
        futures = {k: pool.submit(_job, dgp_run, *a) for k, a in cpu.items()}
        futures["fp64", "cpu_ulp"] = pool.submit(
            _job, dgp_run, *cpu["fp64", "cpu"], init_rel=ULP_REL)
        ng_futures = {}
        for b, rel in (("64", ULP_REL), ("32", ULP_REL32)):
            ng_futures[f"cpu{b}"] = pool.submit(_job, ng_run, "cpu", f"fp{b}",
                                                [NG_EPOCHS])
            ng_futures[f"cpu{b}_ulp"] = pool.submit(
                _job, ng_run, "cpu", f"fp{b}", [NG_EPOCHS], move=rel)
            ng_futures[f"early cpu{b}"] = pool.submit(
                _job, ng_run, "cpu", f"fp{b}", [NG_EARLY])
        runs = {}
        for prec in ("fp64", "fp32"):
            runs[prec], summ[prec, "gpu"] = dgp_run(
                "boston", DGP_M, DGP_EPOCHS, prec, "gpu")
        summ["early", "gpu"] = dgp_run("boston", DGP_M, DGP_EARLY, "fp64",
                                       "gpu")[1]
        flow_run, summ["flow", "gpu"] = dgp_run(
            "kin8nm", DGP_M, DGP_FLOW_EPOCHS, "fp32", "gpu", ("--dgp_flow",),
            replay=None)
        ng_trainers = {}
        for b in ("64", "32"):
            ng_trainers[b], ng[f"gpu{b}"] = ng_run(dev, f"fp{b}", [NG_EPOCHS])
            ng[f"early gpu{b}"] = ng_run(dev, f"fp{b}", [NG_EARLY])[1]
        stage("the card's runs")
        summ.update({k: f.result() for k, f in futures.items()})
        ng.update({k: f.result() for k, f in ng_futures.items()})
    stage("the CPU's runs")

    # (i) DGP-2 boston
    for key, sm in summ.items():
        moved = ", init x (1 + 1e-15)" if key[1] == "cpu_ulp" else ""
        log(f"{sm['tag']}{moved}: {sm['line']}; kernel calls "
            f"{sm['kernel_calls']} ({sm['seconds']:.1f} s)")
        v = sm["values"]
        checks.append((all(np.isfinite(v[n]).all() for n in v),
                       f"{sm['tag']}: finite curves, parameters, metrics"))
        if key[1] == "gpu":
            deep_path_checks(sm, checks, counts)
    result["lines"] = {" ".join(k): sm["line"] for k, sm in summ.items()}
    vals = {f"{p}{b}": summ[f"fp{b}", p]["values"]
            for p in ("gpu", "cpu") for b in ("64", "32")}
    vals["cpu64_ulp"] = summ["fp64", "cpu_ulp"]["values"]
    pairs = {"gpu64_vs_cpu64": ("gpu64", "cpu64"),
             "gpu32_vs_cpu32": ("gpu32", "cpu32"),
             "cpu64_ulp_vs_cpu64": ("cpu64_ulp", "cpu64")}
    result["curve_course"] = curve_course(vals, ("gpu64", "cpu64_ulp"),
                                          "DGP-2 boston")
    gaps = {"dgp": held_gaps(vals, pairs, dgp_group, DGP_LIMITS,
                             "DGP-2 boston", checks,
                             logged=("cpu64_ulp_vs_cpu64",))}
    early = {f"{p}64": summ["early", p]["values"] for p in ("gpu", "cpu")}
    gaps["dgp early"] = held_gaps(early, {"gpu64_vs_cpu64": ("gpu64", "cpu64")},
                                  dgp_group, DGP_EARLY_LIMITS,
                                  f"DGP-2 boston {DGP_EARLY} epochs", checks)
    result["dgp_step"] = step_timing(runs["fp64"].trainer, "fp64",
                                     "DGP-2 boston fp64")
    result["dgp_eval"] = dgp_eval_batch(dev, runs["fp64"], "DGP-2 boston fp64")
    stage("DGP step and evaluation batch")
    result["serving"] = dgp_serving(dev, runs["fp64"], checks)
    counts["launches"] += result["serving"]["launches"]
    stage("DGP serving")

    # (ii) DGP-2 --dgp_flow on kin8nm
    result["flow_step"] = step_timing(flow_run.trainer, "fp32",
                                      "DGP-2+flow kin8nm fp32")
    result["flow_eval"] = ev = dgp_eval_batch(dev, flow_run,
                                              "DGP-2+flow kin8nm fp32")
    checks.append((ev["calls"] == (2, 0) and ev["finite"],
                   f"kin8nm evaluation batch: calls {ev['calls']}, finite "
                   f"{ev['finite']}"))
    for e in (result["dgp_eval"],):
        checks.append((e["calls"] == (2, 0) and e["finite"],
                       f"boston evaluation batch: calls {e['calls']}"))

    stage("kin8nm")

    # (iii) natural gradients
    conj = result["natgrad_conjugate"] = natgrad_conjugate(dev)
    checks.append((conj["ok"], f"natgrad conjugate step: {conj}"))
    for k, sm in ng.items():
        checks.append((all(np.isfinite(sm["values"][n]).all()
                           for n in sm["values"]), f"natgrad {k}: finite"))
        if sm["device"] == "cuda":
            counts["launches"] += sm["counts"][0]
            counts["bwd_launches"] += sm["counts"][1]
            counts["bwd_tile_launches"] += sm["counts"][2]
            checks.append((sm["counts"][:2] == (sm["steps"], sm["steps"])
                           and sm["device"] == "cuda",
                           f"natgrad {k}: counts {sm['counts']} in "
                           f"{sm['steps']} steps"))
    ng_vals = {k: sm["values"] for k, sm in ng.items()
               if not k.startswith("early")}
    result["natgrad_course"] = {
        b: curve_course({**ng_vals, "cpu64": ng_vals[f"cpu{b}"]},
                        (f"gpu{b}", f"cpu{b}_ulp"), f"natgrad flagship fp{b}")
        for b in ("64", "32")}
    ng_pairs = {"gpu64_vs_cpu64": ("gpu64", "cpu64"),
                "gpu32_vs_cpu32": ("gpu32", "cpu32"),
                "cpu64_ulp_vs_cpu64": ("cpu64_ulp", "cpu64"),
                "cpu32_ulp_vs_cpu32": ("cpu32_ulp", "cpu32")}
    # chaotic from the first step: the 100-epoch gaps are logged beside the
    # moved starts', and the NG_EARLY-epoch runs are held below
    gaps["natgrad"] = held_gaps(ng_vals, ng_pairs, exp_group, {},
                                "natgrad flagship", checks,
                                logged=tuple(ng_pairs))
    gaps["natgrad early"] = held_gaps(
        {k.split()[1]: sm["values"] for k, sm in ng.items()
         if k.startswith("early")},
        {"gpu64_vs_cpu64": ("gpu64", "cpu64"),
         "gpu32_vs_cpu32": ("gpu32", "cpu32")},
        exp_group, NG_EARLY_LIMITS, f"natgrad flagship {NG_EARLY} epochs",
        checks)
    # the 4x rule over the 100-epoch runs' first NG_EARLY epochs: the CPU's
    # fp32 runs from the start and from the moved one bracket where fp32
    # rounding lands the curve
    c64 = ng_vals["cpu64"]["curve"][:NG_EARLY]
    to64 = {r: float(np.abs(ng_vals[r]["curve"][:NG_EARLY] - c64).max()
                     / np.abs(c64).max()) for r in ("gpu32", "cpu32", "cpu32_ulp")}
    cpu32 = max(to64["cpu32"], to64["cpu32_ulp"])
    log(f"natgrad flagship fp32, the curve's gap to the CPU's fp64 over "
        f"{NG_EARLY} epochs: card {to64['gpu32']:.3e}, CPU {to64['cpu32']:.3e}, "
        f"moved start {to64['cpu32_ulp']:.3e}")
    result["natgrad_fp32_to_fp64"] = to64
    checks.append((to64["gpu32"] <= max(4 * cpu32, 1e-5),
                   f"natgrad fp32 {NG_EARLY} epochs: the card's curve "
                   f"{to64['gpu32']} from fp64, the CPU's {to64}"))
    result["natgrad_step"] = step_timing(ng_trainers["32"], "fp32",
                                         "natgrad flagship fp32",
                                         natgrad_gamma=1.0)
    # the full batch's rows in one order in every call (a shuffling loader
    # sums them in another order in each train() call)
    whole = ng_run(dev, "fp32", [NG_WARMUP], warmup=NG_WARMUP, shuffle=False)
    split = ng_run(dev, "fp32", [4, NG_WARMUP - 4], warmup=NG_WARMUP,
                   shuffle=False)
    same = all(torch.equal(a, b) for a, b in zip(
        tree_leaves(whole[0].params), tree_leaves(split[0].params))) and \
        np.array_equal(whole[1]["values"]["curve"], split[1]["values"]["curve"])
    log(f"natgrad warmup K={NG_WARMUP}, one train() call against 4 + "
        f"{NG_WARMUP - 4}: bitwise equal {same}; ramp position "
        f"{split[0]._ng_t}")
    checks.append((same and split[0]._ng_t == NG_WARMUP,
                   "natgrad warmup split over two calls differs"))
    for sm in (whole[1], split[1]):
        counts["launches"] += sm["counts"][0]
        counts["bwd_launches"] += sm["counts"][1]
        counts["bwd_tile_launches"] += sm["counts"][2]
        checks.append((sm["counts"][:2] == (NG_WARMUP, NG_WARMUP),
                       f"natgrad warmup counts {sm['counts']}"))
    stage("natgrad")
    result.update(gaps=gaps, warmup_bitwise=same, **counts)
    for cond, msg in checks:
        check(cond, msg)
    return result


# ---------------------------------------------------------------------------
# phase 12: the multi-seed battery
# ---------------------------------------------------------------------------

BAT_SEEDS = "1-10"
BAT_EARLY = 30          # epochs of the flagship battery held leaf by leaf
BAT_EPOCHS = 100        # epochs of the battery CLI's short runs
BAT_MB_EPOCHS = 50      # epochs of its minibatch run
BAT_CKPT_EPOCHS = 40    # epochs of its checkpointed runs, 2 segments
BAT_HELD_EPOCHS = 30    # the ID_TGP and DGP-2 CLI runs, fp64, card and CPU
BAT_ID_DRAWS, BAT_DGP_DRAWS = 11, 12   # their ReplicaCpuDraws seeds
REMAT_SEEDS = "1-3"     # the remat batteries: the flagship's, boston ID_TGP's
REMAT_EPOCHS = 20
REMAT_ID_DRAWS = 21
# The ID_TGP (seeds 1-2) and DGP-2 (seeds 1-10) battery CLIs on boston in
# fp64 after BAT_HELD_EPOCHS epochs, the card against the CPU on the same
# replica-wise draws (`ReplicaCpuDraws`), relative to the largest entry of
# the group in the CPU's run: 10x the gaps measured on an NVIDIA H100 80GB
# HBM3 at 700 W, floored at 10 rounding units.
BAT_CLI_LIMITS = {
    "ID_TGP": {"curve": 7.6e-8, "kld": 1.4e-9, "Z": 2.3e-7, "flow": 1.2e-6,
               "kernel/child/raw_lengthscale": 2.8e-8,
               "kernel/raw_outputscale": 1.2e-8,
               "likelihood/log_var_noise": 4.0e-9, "q_L": 3.1e-6,
               "q_mu": 1.5e-6, "ID_TGP(PE)/logL": 4.1e-8,
               "ID_TGP(PE)/rmse": 1.4e-7, "ID_TGP(BA)/logL": 1.4e-8,
               "ID_TGP(BA)/rmse": 1.2e-7},
    "DGP": {"curve": 4.5e-14, "kld": 2.3e-15, "layers/0/Z": 3.5e-10,
            "layers/0/kernel/child/raw_lengthscale": 2.1e-12,
            "layers/0/kernel/raw_outputscale": 9.4e-14,
            "layers/0/likelihood/log_var_noise": 2.3e-15,
            "layers/0/mean/W": 2.3e-15, "layers/0/q_L": 7.9e-9,
            "layers/0/q_mu": 1.1e-10, "layers/1/Z": 8.8e-13,
            "layers/1/kernel/child/raw_lengthscale": 3.2e-14,
            "layers/1/kernel/raw_outputscale": 6.9e-15,
            "layers/1/likelihood/log_var_noise": 2.3e-15,
            "layers/1/q_L": 2.4e-11, "layers/1/q_mu": 3.7e-12,
            "DGP-2/logL": 1.2e-14, "DGP-2/rmse": 1.4e-13}}
# The flagship battery's fp64 run on the card against the CPU's after
# BAT_EARLY epochs, and each replica against a `Trainer(seed=r)` on the
# card, relative to the largest entry of the group in the CPU's fp64 run:
# 10x the gaps measured on an NVIDIA H100 80GB HBM3 at 700 W.  A battery
# step's batched GEMMs, solves and reductions sum in another order than
# one replica's, and Adam amplifies it as on the CPU (q_L most: entries
# whose gradient is rounding noise take steps of its sign).
BAT_F64_LIMITS = {"gpu64_vs_cpu64": {
    "curve": 5.0e-6, "kld": 3.5e-6, "Z": 1.9e-4, "flow": 8.4e-5,
    "kernel/child/raw_lengthscale": 1.1e-5, "kernel/raw_outputscale": 2.1e-6,
    "likelihood/log_var_noise": 1.7e-7, "q_L": 4.0e-3, "q_mu": 2.0e-4}}
BAT_TRAINER_LIMITS = {"battery_vs_trainers": {
    "curve": 7.4e-7, "kld": 3.3e-7, "Z": 1.4e-5, "flow": 1.1e-5,
    "kernel/child/raw_lengthscale": 1.5e-6, "kernel/raw_outputscale": 3.0e-7,
    "likelihood/log_var_noise": 2.1e-8, "q_L": 9.0e-4, "q_mu": 2.8e-5}}


class ReplicaCpuDraws(CpuDraws):
    """`CpuDraws` that also serves a battery: under the replica map each
    replica r draws from its own seeded CPU generator (seed + 1 + r), so a
    battery on the card and one on the CPU see the same draws, replica by
    replica.

    A replica's draw is labelled by the state of the run's own generator of
    that replica (which then moves on by one number), and a label seen
    before gets the same values again: `spec.remat`'s recompute restores
    those generators' states before it reruns the map, so it sees the draws
    of the first pass, as it does without this class."""

    def __init__(self, seed):
        super().__init__(seed)
        self.seed, self.replicas, self.seen = seed, [], {}

    def __call__(self, kind, shape, p, generator, dtype, device):
        from tgp.pytorch_tpu_torch.flows import hypernet

        if not isinstance(generator, hypernet.ReplicaGenerators):
            return super().__call__(kind, shape, p, generator, dtype, device)
        R = len(generator.gens)
        while len(self.replicas) < R:
            self.replicas.append(torch.Generator().manual_seed(
                self.seed + 1 + len(self.replicas)))

        def draw(gen):
            if kind == "keep":
                return (torch.rand(shape, generator=gen, dtype=torch.float64)
                        < p).to(device)
            return torch.randn(shape, generator=gen,
                               dtype=torch.float64).to(device, dtype)

        def replayed(own):
            r = next(i for i, g in enumerate(generator.gens) if g is own)
            key = (r, bytes(own.get_state().numpy()))
            torch.rand(1, generator=own, device=own.device)
            if key not in self.seen:
                self.seen[key] = draw(self.replicas[r])
            return self.seen[key]

        return hypernet._generate(replayed, generator)


def battery_args(model, dataset, M, epochs, precision, platform, seeds=None,
                 extra=()):
    from tgp.pytorch_tpu_torch.experiments import battery as B

    return B.parse_args(["--model", model, "--dataset", dataset,
                         "--num_inducing", str(M), "--seeds", seeds or BAT_SEEDS,
                         "--epochs", str(epochs), "--precision", precision,
                         "--platform", platform, *extra])


def flagship_battery(precision, platform, epochs, seeds=None):
    """The flagship battery (power's table arch SAL(2), M=100, the CLI's
    per-seed splits, k-means and init) trained `epochs` full-batch steps by
    `train_multiseed`: the main path, its counts from 0.  Returns (cell,
    trained stack, summary of host values)."""
    from tgp.pytorch_tpu_torch import config as cfg
    from tgp.pytorch_tpu_torch.experiments import battery as B
    from tgp.pytorch_tpu_torch.ops import rbf_gram as R
    from tgp.pytorch_tpu_torch.train import multiseed as ms

    cfg.set_precision(precision)
    try:
        args = battery_args("TGP", "power", 100, epochs, precision, platform,
                            seeds)
        dev = B.device_of(args)
        cell = B.prepare(args, dev)
        # --- the main path: counts from 0, 1 + 1 a step -------------------
        R.LAUNCHES = R.BWD_LAUNCHES = R.BWD_TILE_LAUNCHES = 0
        out, curves = ms.train_multiseed(cell.spec, cell.params, cell.X,
                                         cell.Y, epochs, args.lr, device=dev)
        counts = (R.LAUNCHES, R.BWD_LAUNCHES, R.BWD_TILE_LAUNCHES)
        # ------------------------------------------------------------------
    finally:
        cfg.set_precision("fp32")
    values = {"curve": curves["elbo"].astype(np.float64),
              "kld": curves["kld"].astype(np.float64)}
    values.update((n, t.double().cpu().numpy()) for n, t in named_leaves(out))
    return cell, out, dict(values=values, counts=counts, steps=epochs,
                           device=dev.type)


def _battery_job(memo, *a):
    """`flagship_battery`'s summary in a worker process (three torch
    threads), its k-means centers those the main process computed."""
    from tgp.pytorch_tpu_torch import data

    torch.set_num_threads(3)
    data.kmeans_centers = cached_kmeans(memo)[1]
    return flagship_battery(*a)[2]


def cached_kmeans(memo):
    """`data.kmeans_centers` computed once for each split and M (host
    numpy, the same centers every time: the phase's runs of one split would
    repeat it), kept in `memo`; returns (the function, its cached form)."""
    from tgp.pytorch_tpu_torch import data

    fn = data.kmeans_centers

    def centers(X, M, **kw):
        key = (np.asarray(X).tobytes(), M, tuple(sorted(kw.items())))
        if key not in memo:
            memo[key] = fn(X, M, **kw)
        return memo[key].copy()

    return fn, centers


def battery_timing(spec, params, X, Y, tag, calls=3, steps=20,
                   profile_steps=5):
    """A battery's training step on the card, fp32: the median over `calls`
    train_multiseed calls of `steps` steps, and a profile of one call of
    `profile_steps` (device operations and busy time a step, and its launch
    counts).  The R generators' draws show in the operations."""
    from tgp.pytorch_tpu_torch.ops import rbf_gram as R
    from tgp.pytorch_tpu_torch.train import multiseed as ms

    def run(n):
        return ms.train_multiseed(spec, params, X, Y, n, 0.01,
                                  device=params_device(params))

    run(profile_steps)
    times = []
    for _ in range(calls):
        t0 = time.perf_counter()
        run(steps)
        times.append((time.perf_counter() - t0) / steps)
    R.LAUNCHES = R.BWD_LAUNCHES = R.BWD_TILE_LAUNCHES = 0
    prof = profile_device(lambda: run(profile_steps))
    counts = (R.LAUNCHES // 2, R.BWD_LAUNCHES // 2,     # warm-up + profiled
              R.BWD_TILE_LAUNCHES // 2)
    step_ms = 1e3 * float(np.median(times))
    n = profile_steps
    ops, busy = prof["device_ops"] / n, prof["device_busy_ms"] / n
    log(f"{tag}: step {step_ms:.3f} ms (median of {calls} x {steps}); "
        f"{ops:.1f} device ops, busy {busy:.3f} ms = {busy / step_ms:.1%} of "
        f"a step; Gram forward {prof['gram_ms'] / n * 1e3:.2f} us, "
        f"backward {prof['gram_bwd_ms'] / n * 1e3:.2f} us a step; "
        f"kernel calls {counts} in {n} steps")
    for name, t in prof["top_ms"]:
        log(f"    {t * 1e3 / n:9.2f} us a step  {name}")
    return dict(step_ms=step_ms, device_ops=ops, busy_ms=busy,
                busy_share=busy / step_ms, counts=counts, steps=n,
                top_ms=prof["top_ms"])


def params_device(params):
    from tgp.pytorch_tpu_torch.weights import tree_leaves
    return tree_leaves(params)[0].device


def id_cell(dev, seeds):
    """boston's ID_TGP battery (its table's hypernets, the CLI's splits,
    k-means and init) without the anchor fit, for timing the step."""
    from tgp.pytorch_tpu_torch import config as cfg
    from tgp.pytorch_tpu_torch.experiments import battery as B, flow_arch as FA
    from tgp.pytorch_tpu_torch.likelihoods import LikelihoodSpec
    from tgp.pytorch_tpu_torch.models import tgp as M
    from tgp.pytorch_tpu_torch.train import multiseed as ms

    cell = B.prepare(battery_args("SVGP", "boston", 100, 1, "fp32", "gpu",
                                  seeds), dev)
    np.random.seed(cfg.config_seed)
    flow, inits = FA.build_id_flow("boston", 13)
    spec = M.TGPSpec(Dy=1, Dx=13, M=100, N=float(cell.N_tr),
                     kernel=cell.spec.kernel,
                     likelihood=LikelihoodSpec("gaussian_flow", 1), flow=flow)
    params = ms.stack_trees([M.init_tgp_params(
        spec, cell.X[r], cell.params["Z"][r, 0].cpu().numpy(),
        variance_scale=1e-5, kernel_init={"length_scale": 2.0,
                                          "kernel_scale": 2.0},
        flow_inits=inits, device=dev) for r in range(len(cell.seeds))])
    return spec, params, cell.X, cell.Y


def battery_cli(dev, model, dataset, M, epochs, extra=(), seeds=None,
                draws=None, precision="fp32", platform="gpu"):
    """The battery CLI on the card (or `platform`) as a user runs it (its
    output kept out of the log but for the result lines), the counts from
    0; with `draws`, the hypernets' and the deep layers' draws come from
    it."""
    import contextlib
    import io

    from tgp.pytorch_tpu_torch.experiments import battery as B
    from tgp.pytorch_tpu_torch.flows import hypernet
    from tgp.pytorch_tpu_torch.ops import rbf_gram as R

    args = battery_args(model, dataset, M, epochs, precision, platform, seeds,
                        extra)
    orig = hypernet._draw
    if draws is not None:
        hypernet._draw = draws
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            # --- the main path: counts from 0 -----------------------------
            R.LAUNCHES = R.BWD_LAUNCHES = R.BWD_TILE_LAUNCHES = 0
            res = B.run(args)
            counts = (R.LAUNCHES, R.BWD_LAUNCHES, R.BWD_TILE_LAUNCHES)
            # --------------------------------------------------------------
    finally:
        hypernet._draw = orig
    tag = (f"battery {model} {dataset} {' '.join(extra)}".strip()
           + ("" if precision == "fp32" else f" {precision}")
           + ("" if platform == "gpu" else f" on the {platform.upper()}"))
    log(f"{tag}: {len(res.seeds)} seeds x {epochs} epochs in "
        f"{time.perf_counter() - t0:.1f} s (train {res.train_s:.1f} s); "
        f"kernel calls {res.kernel_calls}")
    for _, _, lines, _ in res.reports:
        for line in lines:
            if line.strip():
                log(f"    {line.strip()}")
    finite = np.isfinite(res.curves["elbo"]).all() and all(
        np.isfinite(v).all() for _, m, _, _ in res.reports for v in m.values())
    return res, dict(tag=tag, counts=counts, finite=bool(finite),
                     kernel_calls=res.kernel_calls, train_s=res.train_s,
                     values=bat_cli_values(res))


def bat_cli_values(res):
    """What a battery CLI run is held by, fp64 on the host, by name: the
    ELBO and KL curves (epochs, R), the trained leaves (R, ...) and each
    report's logL and RMSE (coverage draws its samples from each device's
    own generators)."""
    out = {"curve": np.asarray(res.curves["elbo"], np.float64),
           "kld": np.asarray(res.curves["kld"], np.float64)}
    out.update((n, t.detach().double().cpu().numpy())
               for n, t in named_leaves(res.params))
    for tag, m, _, _ in res.reports:
        for k in ("logL", "rmse"):
            out[f"{tag}/{k}"] = np.asarray(m[k], np.float64)
    return out


def _battery_cli_job(memo, draws_seed, *a, **kw):
    """`battery_cli`'s summary in a worker process (three torch threads),
    its k-means centers those the main process computed and its draws from
    a `ReplicaCpuDraws(draws_seed)`."""
    import contextlib
    import io

    from tgp.pytorch_tpu_torch import data

    torch.set_num_threads(3)
    data.kmeans_centers = cached_kmeans(memo)[1]
    with contextlib.redirect_stdout(io.StringIO()):
        return battery_cli(None, *a, draws=ReplicaCpuDraws(draws_seed),
                           **kw)[1]


def battery_phase(dev):
    """The multi-seed battery (`train/multiseed.py`,
    `experiments/battery.py`) on the card:
      (i) the Gram pair under `torch.func.vmap` over 10 replicas at the
          flagship's and boston's shapes: one forward launch and one
          backward call for all ten, against the kernel per replica and the
          plain version, the backward twice bitwise;
     (ii) the flagship battery (TGP, power seeds 1-10, SAL(2), M=100) for
          BAT_EARLY epochs on the card and on the CPU in fp64 and fp32: fp64
          held leaf by leaf, fp32 by the 4x rule against the CPU's fp64
          curve; each replica against `Trainer(seed=r)` on the card; the
          counts (1 and 1 a step), `eval_multiseed` (2 and 0 a call);
    (iii) the step at R=1 and R=10, fp32: the flagship, and the ID_TGP and
          DGP-2 batteries on boston whose R generators draw per replica;
     (iv) the battery CLI for BAT_EPOCHS epochs, fp32 (its default):
          boston SVGP, TGP at a non-step arch, ID_TGP (2 seeds: the anchor
          fit is 2000 epochs a seed) and DGP-2 on replica-wise `CpuDraws`,
          natgrad power SVGP, a minibatch run; finite results and their
          counts; ID_TGP and DGP-2 again in fp64 for BAT_HELD_EPOCHS, held
          against the same runs on the CPU (`BAT_CLI_LIMITS`);
      (v) `--ckpt`: stopped by --ckpt_stop_after and resumed, bitwise the
          uninterrupted run;
     (vi) `spec.remat` under the replica map, fp32, REMAT_EPOCHS steps: the
          flagship over power seeds REMAT_SEEDS, and boston ID_TGP (its
          nets' masks from `ReplicaCpuDraws`, replayed), bitwise the
          plain battery (parameters, curves, Adam moments, generators),
          2 forward launches and 1 backward call a step; each battery's
          peak memory above the resident, and its time on a second run."""
    import multiprocessing
    import shutil
    from concurrent.futures import ProcessPoolExecutor

    from tgp.pytorch_tpu_torch import config as cfg, data
    from tgp.pytorch_tpu_torch.data import ArrayDataset, DataLoader
    from tgp.pytorch_tpu_torch.experiments import battery as B
    from tgp.pytorch_tpu_torch.ops import rbf_gram as R
    from tgp.pytorch_tpu_torch.train import Trainer, multiseed as ms
    from tgp.pytorch_tpu_torch.weights import tree_leaves

    result, checks = {}, []
    counts = {"launches": 0, "bwd_launches": 0, "bwd_tile_launches": 0}
    t0 = time.perf_counter()

    def stage(name):
        log(f"phase 12: {name} done at {time.perf_counter() - t0:.1f} s")

    def add(c):
        counts["launches"] += c[0]
        counts["bwd_launches"] += c[1]
        counts["bwd_tile_launches"] += c[2]

    memo = {}
    kmeans, data.kmeans_centers = cached_kmeans(memo)
    # the flagship's k-means centers once, for the card's runs and the CPU's
    for seed in B.parse_seeds(BAT_SEEDS):
        X = data.return_dataset("power", 10 ** 9, None, seed=seed,
                                options={"shuffle_train": False})[1]["X_tr"]
        data.kmeans_centers(X, 100, n_init=10, seed=cfg.config_seed)
    stage("the flagship's k-means")
    # the ID_TGP and DGP-2 CLI runs held card against CPU (fp64, the same
    # replica-wise draws): (model, draws seed, seeds)
    held_cli = {"ID_TGP": (BAT_ID_DRAWS, "1-2"),
                "DGP": (BAT_DGP_DRAWS, BAT_SEEDS)}

    with ProcessPoolExecutor(
            max_workers=2, mp_context=multiprocessing.get_context("spawn")) as pool:
        cpu = {f"cpu{b}": pool.submit(_battery_job, memo, f"fp{b}", "cpu",
                                      BAT_EARLY, BAT_SEEDS)
               for b in ("64", "32")}
        cpu_cli = {m: pool.submit(_battery_cli_job, memo, d, m, "boston", 100,
                                  BAT_HELD_EPOCHS, (), seeds,
                                  precision="fp64", platform="cpu")
                   for m, (d, seeds) in held_cli.items()}

        # (i) the mapped Gram pair: ten replicas, one launch each way
        gen = torch.Generator(device=dev).manual_seed(12)
        folds = []
        for label, N, M, Dx, dtype in (("power 10 x (8611+100) fp32", 8611,
                                        100, 4, F32),
                                       ("boston 10 x (455+100) Dx=13 fp64",
                                        455, 100, 13, F64)):
            sc = min(1.0, 2.0 / Dx ** 0.5)
            X = sc * torch.randn(10, 1, N, Dx, generator=gen, device=dev,
                                 dtype=dtype)
            Z = sc * torch.randn(10, 1, M, Dx, generator=gen, device=dev,
                                 dtype=dtype)
            ks = torch.rand(10, 1, generator=gen, device=dev, dtype=dtype) + 0.5
            gs = [torch.randn(10, 1, n, M, generator=gen, device=dev,
                              dtype=dtype) for n in (N, M)]

            def mapped():
                leaves = [t.clone().requires_grad_(True) for t in (X, Z, ks)]
                Ks = torch.func.vmap(R.rbf_gram_pair)(*leaves)
                grads = torch.autograd.grad(Ks, leaves, gs)
                return [k.detach() for k in Ks], list(grads)

            R.LAUNCHES = R.BWD_LAUNCHES = R.BWD_TILE_LAUNCHES = 0
            Ks, grads = mapped()
            calls = (R.LAUNCHES, R.BWD_LAUNCHES)
            again = mapped()[1]
            tol = F32_TOL if dtype == F32 else F64_TOL
            gtol = F32_GRAD_TOL if dtype == F32 else F64_GRAD_TOL
            err = gerr = 0.0
            own_bits = True
            for r in range(10):
                ref = R.rbf_gram_pair_reference(X[r], Z[r], ks[r])
                own = R._launch_pair(X[r], Z[r], ks[r], pair=True)
                want = R.rbf_gram_pair_bwd(X[r], Z[r], ks[r], *ref, gs[0][r],
                                           gs[1][r])
                for k, o, w in zip(Ks, own, ref):
                    assert_close(f"{label} replica {r}", k[r], w, tol)
                    assert_close(f"{label} replica {r} own launch", k[r], o,
                                 tol)
                    own_bits &= torch.equal(k[r], o)
                    err = max(err, max_err(k[r], w))
                for g, w, nm in zip(grads, want, ("dX", "dZ", "dks")):
                    assert_close_scaled(f"{label} replica {r} {nm}", g[r], w,
                                        gtol)
                    gerr = max(gerr, max_err(g[r], w))
            same = all(torch.equal(a, b) for a, b in zip(grads, again))
            log(f"mapped pair {label}: kernel calls {calls}, forward err "
                f"{err:.2e} (bitwise the replicas' own launches: {own_bits}), "
                f"backward err {gerr:.2e}, two backward runs bitwise equal "
                f"{same}")
            checks.append((calls == (1, 1), f"{label}: {calls} kernel calls"))
            checks.append((same, f"{label}: two backward runs differ"))
            folds.append(dict(label=label, calls=calls, max_abs_err=err,
                              bwd_max_abs_err=gerr, bwd_bitwise=same,
                              own_launch_bitwise=own_bits))
        result["fold"] = folds
        stage("the mapped pair")

        # (ii) the flagship battery, card against the CPU
        runs, summ = {}, {}
        for b in ("64", "32"):
            runs[b] = flagship_battery(f"fp{b}", "gpu", BAT_EARLY, BAT_SEEDS)
            summ[f"gpu{b}"] = runs[b][2]
        cell64, out64, _ = runs["64"]
        # each replica against a Trainer(seed=r) on its split, fp64
        cfg.set_precision("fp64")
        try:
            tr_vals = {}
            for r in range(len(cell64.seeds)):
                loader = DataLoader(ArrayDataset(cell64.X[r], cell64.Y[r]),
                                    10 ** 9, shuffle=False)
                tr = Trainer(cell64.spec, ms.unstack_tree(cell64.params, r),
                             [loader], np.ones(1), seed=r, device=dev)
                tr.train(BAT_EARLY, 0.01, verbose_each=0)
                tr_vals[r] = tr
            trainers = {"curve": np.stack([tr_vals[r].loss_curve for r in
                                           tr_vals], axis=1),
                        "kld": np.stack([tr_vals[r].kld_curve for r in tr_vals],
                                        axis=1)}
            stacked = ms.stack_trees([tr_vals[r].params for r in tr_vals])
            trainers.update((n, t.detach().double().cpu().numpy())
                            for n, t in named_leaves(stacked))
            # eval_multiseed on the trained battery: 2 forward, 0 backward
            R.LAUNCHES = R.BWD_LAUNCHES = R.BWD_TILE_LAUNCHES = 0
            m = ms.eval_multiseed(cell64.spec, out64, cell64.X_test,
                                  cell64.Y_test, cell64.Y_std, device=dev)
            ev_calls = (R.LAUNCHES, R.BWD_LAUNCHES, R.BWD_TILE_LAUNCHES)
        finally:
            cfg.set_precision("fp32")
        add(ev_calls)
        checks.append((ev_calls[:2] == (2, 0), f"eval_multiseed: {ev_calls}"))
        checks.append((all(np.isfinite(v).all() for v in m.values()),
                       "eval_multiseed: finite"))
        log(f"flagship battery fp64, {BAT_EARLY} epochs: test NLL per seed "
            f"{np.round(-m['logL'][:, 0], 4).tolist()}; eval kernel calls "
            f"{ev_calls}")
        stage("the card's flagship runs")

        # (iv) the battery CLI
        cli = {}
        runs_cli = [("SVGP", "boston", 100, BAT_EPOCHS, (), BAT_SEEDS, None,
                     "fp32"),
                    ("TGP", "boston", 100, BAT_EPOCHS, ("--arch", "SAL_BCL:1"),
                     BAT_SEEDS, None, "fp32"),
                    ("SVGP", "power", 100, BAT_EPOCHS, ("--natgrad", "1.0"),
                     BAT_SEEDS, None, "fp32"),
                    ("SVGP", "boston", 100, BAT_MB_EPOCHS, ("--batch_size", "200"),
                     BAT_SEEDS, None, "fp32")]
        # ID_TGP and DGP-2: fp32 for BAT_EPOCHS, fp64 for BAT_HELD_EPOCHS
        runs_cli[2:2] = [(m, "boston", 100, ep, (), seeds,
                          ReplicaCpuDraws(d), prec)
                         for prec, ep in (("fp32", BAT_EPOCHS),
                                          ("fp64", BAT_HELD_EPOCHS))
                         for m, (d, seeds) in held_cli.items()]
        held_vals = {}
        for model, ds, M, ep, extra, seeds, draws, prec in runs_cli:
            res, sm = battery_cli(dev, model, ds, M, ep, extra, seeds, draws,
                                  precision=prec)
            values = sm.pop("values")
            if prec == "fp64":
                held_vals[model] = values
            add(sm["counts"])
            leaves = 2 if model == "DGP" else 1
            steps = ep * (3 if "--batch_size" in extra else 1)   # 455 = 2x200+55
            want = {"train": (leaves * steps, leaves * steps)}
            want.update((k, (2, 0)) for k in res.kernel_calls if k != "train")
            checks.append((sm["kernel_calls"] == want and sm["finite"]
                           and sm["counts"][:2] == tuple(map(sum, zip(
                               *sm["kernel_calls"].values()))),
                           f"{sm['tag']}: calls {sm['kernel_calls']}, counts "
                           f"{sm['counts']}, finite {sm['finite']}"))
            cli[sm["tag"]] = dict(sm, lines=[ln for _, _, lines, _ in res.reports
                                             for ln in lines if ln.strip()])
        result["cli"] = cli
        stage("the battery CLI")

        # (v) checkpoint resume, bitwise
        ck_dir = HERE / "build" / "battery_ckpt"
        shutil.rmtree(ck_dir, ignore_errors=True)
        ck_dir.mkdir(parents=True)
        base = ["--ckpt_each", str(BAT_CKPT_EPOCHS // 2), "--batch_size", "256"]
        stopped = 0
        try:
            battery_cli(dev, "SVGP", "boston", 100, BAT_CKPT_EPOCHS,
                        (*base, "--ckpt", str(ck_dir / "a.pt"),
                         "--ckpt_stop_after", "1"), "1-3")
        except SystemExit as e:
            stopped = e.code
        resumed = battery_cli(dev, "SVGP", "boston", 100, BAT_CKPT_EPOCHS,
                              (*base, "--ckpt", str(ck_dir / "a.pt")), "1-3")[0]
        straight = battery_cli(dev, "SVGP", "boston", 100, BAT_CKPT_EPOCHS,
                               (*base, "--ckpt", str(ck_dir / "b.pt")), "1-3")[0]
        shutil.rmtree(ck_dir, ignore_errors=True)
        same = (all(torch.equal(a, b) for a, b in zip(tree_leaves(resumed.params),
                                                     tree_leaves(straight.params)))
                and np.array_equal(resumed.curves["elbo"], straight.curves["elbo"])
                and all(np.array_equal(a, b) for a, b in zip(
                    resumed.reports[0][1].values(), straight.reports[0][1].values())))
        log(f"battery --ckpt: stopped with exit {stopped} after one segment, "
            f"resumed; bitwise the uninterrupted run: {same}")
        checks.append((stopped == 75 and same, "battery checkpoint resume differs"))
        result["ckpt_bitwise"] = same
        stage("checkpoint resume")

        # (vi) spec.remat under the replica map, fp32: bitwise the plain
        # battery, 2 forward launches and 1 backward call a step
        from tgp.pytorch_tpu_torch.flows import hypernet

        rcell = B.prepare(battery_args("TGP", "power", 100, REMAT_EPOCHS,
                                       "fp32", "gpu", REMAT_SEEDS), dev)
        rid = id_cell(dev, REMAT_SEEDS)
        remat = {}
        for name, (spec, params, X, Y), draws in (
                ("flagship", (rcell.spec, rcell.params, rcell.X, rcell.Y),
                 None),
                ("ID_TGP boston", rid, REMAT_ID_DRAWS)):
            def run(on):
                orig = hypernet._draw
                if draws is not None:
                    hypernet._draw = ReplicaCpuDraws(draws)
                torch.cuda.synchronize()
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                t1 = time.perf_counter()
                try:
                    # --- the main path: counts from 0 ---------------------
                    R.LAUNCHES = R.BWD_LAUNCHES = R.BWD_TILE_LAUNCHES = 0
                    got = ms.train_multiseed(
                        dataclasses.replace(spec, remat=on), params, X, Y,
                        REMAT_EPOCHS, 0.01, device=dev, return_state=True)
                    c = (R.LAUNCHES, R.BWD_LAUNCHES, R.BWD_TILE_LAUNCHES)
                    # ------------------------------------------------------
                finally:
                    hypernet._draw = orig
                torch.cuda.synchronize()
                add(c)
                return (got, c, time.perf_counter() - t1,
                        torch.cuda.max_memory_allocated() - base)

            # each run twice: the first checked, the second timed warm (a
            # process's first checkpoint pays one-time set-up)
            runs_r = {on: (run(on), run(on)) for on in (False, True)}
            warm = all(a[1] == b[1] for a, b in runs_r.values())
            ((p0, cv0, st0), c0, _, m0), (_, _, s0, _) = runs_r[False]
            ((p1, cv1, st1), c1, f1, m1), (_, _, s1, _) = runs_r[True]
            bitwise = (all(torch.equal(a, b) for a, b in
                           zip(tree_leaves(p0), tree_leaves(p1)))
                       and all(np.array_equal(cv0[k], cv1[k]) for k in cv0)
                       and all(torch.equal(a, b) for a, b in
                               zip(st0["opt_state"].mu + st0["opt_state"].nu,
                                   st1["opt_state"].mu + st1["opt_state"].nu))
                       and all(torch.equal(a, b) for a, b in
                               zip(st0["rngs"], st1["rngs"])))
            n = REMAT_EPOCHS
            log(f"{name} battery ({REMAT_SEEDS}) with remat, {n} steps: "
                f"parameters, curves, Adam moments and generators bitwise the "
                f"plain battery's: {bitwise}; counts {c1} (plain {c0}); "
                f"warm {s1:.3f} s (plain {s0:.3f} s; the first remat run "
                f"{f1:.3f} s); peak memory above the resident "
                f"{m1 / 2**20:.1f} MiB (plain {m0 / 2**20:.1f})")
            checks.append((bitwise and warm and c0[:2] == (n, n)
                           and c1[:2] == (2 * n, n),
                           f"remat battery {name}: bitwise {bitwise}, counts "
                           f"{c1}, plain {c0}, the warm runs' the same {warm}"))
            remat[name] = dict(bitwise=bitwise, counts=c1, plain_counts=c0,
                               seconds=s1, plain_seconds=s0, first_seconds=f1,
                               peak_bytes=m1, plain_peak_bytes=m0)
        result["remat"] = remat
        stage("remat")

        summ.update({k: f.result() for k, f in cpu.items()})
        cli_cpu = {m: f.result() for m, f in cpu_cli.items()}
    stage("the CPU's flagship runs")
    cli_gaps = {}
    for m, sm in cli_cpu.items():
        checks.append((sm["finite"], f"{sm['tag']}: finite"))
        cli_gaps[m] = held_gaps(
            {"cpu64": sm["values"], "gpu64": held_vals[m]},
            {"gpu64_vs_cpu64": ("gpu64", "cpu64")}, exp_group,
            {"gpu64_vs_cpu64": BAT_CLI_LIMITS[m]} if BAT_CLI_LIMITS[m]
            else {}, f"battery CLI {m} boston {BAT_HELD_EPOCHS} epochs", checks,
            logged=() if BAT_CLI_LIMITS[m] else ("gpu64_vs_cpu64",))
    result["cli_gaps"] = cli_gaps
    for k, sm in summ.items():
        checks.append((all(np.isfinite(v).all() for v in sm["values"].values()),
                       f"flagship battery {k}: finite"))
        if sm["device"] == "cuda":
            add(sm["counts"])
            checks.append((sm["counts"][:2] == (BAT_EARLY, BAT_EARLY),
                           f"flagship battery {k}: counts {sm['counts']}"))
    vals = {k: sm["values"] for k, sm in summ.items()}
    vals["trainers"] = trainers
    gaps = {"f64": held_gaps(vals, {"gpu64_vs_cpu64": ("gpu64", "cpu64")},
                             exp_group, BAT_F64_LIMITS,
                             f"flagship battery {BAT_EARLY} epochs", checks,
                             logged=() if BAT_F64_LIMITS else
                             ("gpu64_vs_cpu64",)),
            "trainers": held_gaps(vals, {"battery_vs_trainers": ("gpu64",
                                                                 "trainers")},
                                  exp_group, BAT_TRAINER_LIMITS,
                                  f"flagship battery {BAT_EARLY} epochs, "
                                  "against Trainer(seed=r) on the card", checks,
                                  logged=() if BAT_TRAINER_LIMITS else
                                  ("battery_vs_trainers",))}
    c64 = vals["cpu64"]["curve"]
    to64 = {r: float(np.abs(vals[r]["curve"] - c64).max() / np.abs(c64).max())
            for r in ("gpu32", "cpu32")}
    log(f"flagship battery fp32, the curves' gap to the CPU's fp64 over "
        f"{BAT_EARLY} epochs: card {to64['gpu32']:.3e}, CPU {to64['cpu32']:.3e}")
    checks.append((to64["gpu32"] <= max(4 * to64["cpu32"], 1e-5),
                   f"flagship battery fp32: the card's curves {to64['gpu32']} "
                   f"from fp64, the CPU's {to64['cpu32']}"))
    result.update(gaps=gaps, fp32_to_fp64=to64)

    # (iii) the step at R=1 and R=10
    cell32 = runs["32"][0]
    timing = {}
    for Rn in (1, 10):
        sub = ms.unstack_tree(cell32.params, slice(0, Rn))
        timing[f"flagship R={Rn}"] = battery_timing(
            cell32.spec, sub, cell32.X[:Rn], cell32.Y[:Rn],
            f"flagship battery R={Rn} fp32")
    id_spec, id_params, idX, idY = id_cell(dev, BAT_SEEDS)
    dgp = B.prepare(battery_args("DGP", "boston", 100, 1, "fp32", "gpu"), dev)
    for Rn in (1, 10):
        timing[f"ID_TGP R={Rn}"] = battery_timing(
            id_spec, ms.unstack_tree(id_params, slice(0, Rn)), idX[:Rn],
            idY[:Rn], f"ID_TGP boston battery R={Rn} fp32", steps=20)
        timing[f"DGP-2 R={Rn}"] = battery_timing(
            dgp.spec, ms.unstack_tree(dgp.params, slice(0, Rn)), dgp.X[:Rn],
            dgp.Y[:Rn], f"DGP-2 boston battery R={Rn} fp32", steps=20)
    for k, t in timing.items():
        leaves = 2 if k.startswith("DGP") else 1
        add(t["counts"])
        checks.append((t["counts"][:2]
                       == (leaves * t["steps"], leaves * t["steps"]),
                       f"{k}: counts {t['counts']} in {t['steps']} steps"))
    result["timing"] = timing
    stage("the step at R=1 and R=10")

    data.kmeans_centers = kmeans
    result.update(**counts)
    for cond, msg in checks:
        check(cond, msg)
    return result


# ---------------------------------------------------------------------------
# phase 13: L-BFGS and a run's runtime
# ---------------------------------------------------------------------------

LB_ITERS = 20             # L-BFGS iterations on the flagship
RESUME_STEPS = 20         # Adam steps before and after the checkpoint
RT_EPOCHS = 20            # the CLI's epochs with --checkpoint_dir
SWEEP_EPOCHS = 200        # the sweep cell's epochs
# The flagship's fp64 L-BFGS run on the card against the CPU's after
# LB_ITERS iterations, relative to the largest entry of each group in the
# CPU's run: 10x the gaps first measured (NVIDIA H100 80GB HBM3, 700 W),
# where the CPU's run from a start moved by 1e-15 sat 1.4e-13
# (curve) to 1.2e-11 (q_L) from the unmoved one: the solver amplifies
# rounding (both devices made the same 21 line-search trials).
LB_F64_LIMITS = {"gpu64_vs_cpu64": {
    "curve": 8.1e-12, "kld": 2.4e-11, "Z": 1.2e-10, "flow": 2.5e-11,
    "kernel/child/raw_lengthscale": 5.7e-11,
    "kernel/raw_outputscale": 7.0e-13, "likelihood/log_var_noise": 1.1e-10,
    "q_L": 9.3e-10, "q_mu": 1.7e-10}}
# compute_metrics with eval_device="cpu" against the card's, fp64, relative
EVAL_CPU_LIMIT = 1e-10


def lbfgs_run(device, precision, iters, move=0.0):
    """`bench.flagship_trainer` trained by L-BFGS for `iters` iterations
    (one train() call), every initial parameter scaled by (1 + move): its
    curves and parameters (fp64 on the host), the kernels' counts and the
    line search's host reads from 0, and the run's wall time."""
    from tgp.pytorch_tpu_torch import bench, config as cfg
    from tgp.pytorch_tpu_torch.ops import rbf_gram as R
    from tgp.pytorch_tpu_torch.train import lbfgs as LB
    from tgp.pytorch_tpu_torch.utils import step_timer

    cfg.set_precision(precision)
    try:
        tr = bench.flagship_trainer(device)
        with torch.no_grad():
            for _, t in named_leaves(tr.params):
                t.mul_(1 + move)
        timed = step_timer(lambda: tr.train(iters, 0.0, "lbfgs",
                                            verbose_each=0))
        # --- the main path: counts from 0, 1 forward + 1 backward an
        # evaluation (an iteration's start and each line-search trial)
        R.LAUNCHES = R.BWD_LAUNCHES = R.BWD_TILE_LAUNCHES = LB.HOST_READS = 0
        timed()
        counts = (R.LAUNCHES, R.BWD_LAUNCHES, R.BWD_TILE_LAUNCHES)
        reads = LB.HOST_READS
        # ---------------------------------------------------------------
    finally:
        cfg.set_precision("fp32")
    values = {n: np.asarray(c, np.float64) for n, c in
              (("curve", tr.loss_curve), ("kld", tr.kld_curve))}
    values.update((n, t.detach().double().cpu().numpy())
                  for n, t in named_leaves(tr.params))
    return dict(values=values, counts=counts, reads=reads, iters=iters,
                wall_s=timed.times[0], device=tr.device.type,
                stepsize=float(tr._opt_state_carry.linesearch.learning_rate))


def _lbfgs_job(*a, **kw):
    torch.set_num_threads(3)
    return lbfgs_run(*a, **kw)


def resume_check(dev, precision, ck_dir, checks, counts):
    """The flagship on the card: RESUME_STEPS Adam steps twice on one
    Trainer, against RESUME_STEPS, save, restore into a fresh Trainer and
    RESUME_STEPS more: the same bits (parameters, curve, generator); the
    save's and the restore's wall times.  Returns the restored Trainer."""
    from tgp.pytorch_tpu_torch import bench, config as cfg
    from tgp.pytorch_tpu_torch.ops import rbf_gram as R
    from tgp.pytorch_tpu_torch.train.checkpoint import (
        wait_for_checkpoints)
    from tgp.pytorch_tpu_torch.weights import tree_leaves

    n = RESUME_STEPS
    cfg.set_precision(precision)
    try:
        R.LAUNCHES = R.BWD_LAUNCHES = R.BWD_TILE_LAUNCHES = 0
        a = bench.flagship_trainer(dev)
        a.train(n, bench.LR, "adam", verbose_each=0)
        a.train(n, bench.LR, "adam", verbose_each=0)
        b = bench.flagship_trainer(dev)
        b.train(n, bench.LR, "adam", verbose_each=0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        b.save(str(ck_dir))
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        b.save(str(ck_dir), step=10 ** 6, async_save=True)
        async_s = time.perf_counter() - t0
        wait_for_checkpoints()
        c = bench.flagship_trainer(dev)
        t0 = time.perf_counter()
        step = c.restore(str(ck_dir), step=n)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        c.train(n, bench.LR, "adam", verbose_each=0)
        got = (R.LAUNCHES, R.BWD_LAUNCHES, R.BWD_TILE_LAUNCHES)
    finally:
        cfg.set_precision("fp32")
    counts["launches"] += got[0]
    counts["bwd_launches"] += got[1]
    counts["bwd_tile_launches"] += got[2]
    checks.append((got[:2] == (4 * n, 4 * n),
                   f"resume {precision}: counts {got} in {4 * n} steps"))
    same = (all(torch.equal(p, q) for p, q in zip(tree_leaves(a.params),
                                                 tree_leaves(c.params)))
            and np.array_equal(np.asarray(a.loss_curve[n:]),
                               np.asarray(c.loss_curve))
            and torch.equal(a._gen.get_state(), c._gen.get_state()))
    gap = max(float((p - q).detach().abs().max()
                    / (q.detach().abs().max() or 1.0))
              for p, q in zip(tree_leaves(a.params), tree_leaves(c.params)))
    nbytes = sum(t.numel() * t.element_size() for t in tree_leaves(c.params))
    log(f"resume {precision}: {n} + {n} Adam steps against {n}, save "
        f"({save_s * 1e3:.2f} ms; async {async_s * 1e3:.2f} ms to return), "
        f"restore ({restore_s * 1e3:.2f} ms), {n}: bitwise {same} (largest "
        f"leaf gap {gap:.3e}); step {step}, {nbytes} parameter bytes, "
        f"checkpoint file {(ck_dir / f'step_{n}').stat().st_size} bytes")
    checks.append((same and step == n and c.params["Z"].is_cuda,
                   f"resume {precision}: not bitwise (leaf gap {gap})"))
    return c, dict(bitwise=same, leaf_gap=gap, save_ms=save_s * 1e3,
                   async_save_ms=async_s * 1e3, restore_ms=restore_s * 1e3)


def runtime_phase(dev):
    """L-BFGS and a run's runtime on the card:
      (i) L-BFGS on the flagship (power split 1, SAL(2), M=100) for
          LB_ITERS iterations: fp64 on the card against the CPU, held leaf
          by leaf (beside the CPU's run from a start moved by 1e-15); fp32
          on the card and the CPU, finite, their gaps to fp64 logged;
          1 forward launch and 1 backward call an evaluation, the
          evaluations (iterations + trials) counted by the line search's
          host reads; the wall time an iteration, a profile, a Chrome trace
          by `utils.profiling.trace`;
     (ii) resume: Adam 20 + 20 against 20, save, restore into a fresh card
          Trainer, 20: bitwise, fp32 and fp64; the save and the restore;
    (iii) `eval_device="cpu"` against the card's `compute_metrics` (fp64,
          the same generator state), no launch on the host path;
     (iv) the CLI with `--checkpoint_dir` (boston SVGP, M=100, 20 epochs);
      (v) one sweep cell (`experiments.sweep`, boston SVGP, M=100, fp32)."""
    import contextlib
    import io
    import multiprocessing
    import shutil
    from concurrent.futures import ProcessPoolExecutor

    from tgp.pytorch_tpu_torch import config as cfg
    from tgp.pytorch_tpu_torch.experiments import main as pmain, sweep
    from tgp.pytorch_tpu_torch.ops import rbf_gram as R
    from tgp.pytorch_tpu_torch.train import checkpoint as C
    from tgp.pytorch_tpu_torch.train import lbfgs as LB
    from tgp.pytorch_tpu_torch.utils import trace
    from tgp.pytorch_tpu_torch.weights import tree_leaves

    result, checks = {}, []
    counts = {"launches": 0, "bwd_launches": 0, "bwd_tile_launches": 0}
    t0 = time.perf_counter()

    def stage(name):
        log(f"phase 13: {name} done at {time.perf_counter() - t0:.1f} s")

    # (i) L-BFGS on the flagship
    with ProcessPoolExecutor(
            max_workers=2, mp_context=multiprocessing.get_context("spawn")) as pool:
        n = LB_ITERS
        cpu = {"cpu64": pool.submit(_lbfgs_job, "cpu", "fp64", n),
               "cpu32": pool.submit(_lbfgs_job, "cpu", "fp32", n)}
        runs = {"gpu64": lbfgs_run(dev, "fp64", n),
                "gpu32": lbfgs_run(dev, "fp32", n)}
        cpu["cpu64_moved"] = pool.submit(_lbfgs_job, "cpu", "fp64", n,
                                         move=ULP_REL)
        runs.update({k: f.result() for k, f in cpu.items()})
    # timed alone: the CPU's runs above share the host that dispatches
    runs["gpu32_warm"] = lbfgs_run(dev, "fp32", n)
    stage("the flagship's L-BFGS runs")
    for k, r in runs.items():
        evals = r["reads"]
        trials = evals - r["iters"]
        log(f"L-BFGS {k}: {r['iters']} iterations, {trials} line-search "
            f"trials ({trials / r['iters']:.2f} an iteration), {evals} host "
            f"reads, kernel counts {r['counts']}, "
            f"{r['wall_s'] * 1e3 / r['iters']:.3f} ms an iteration, last stepsize {r['stepsize']:.6g}, ELBO "
            f"{r['values']['curve'][0]:.6f} -> {r['values']['curve'][-1]:.6f}")
        checks.append((all(np.isfinite(v).all() for v in r["values"].values()),
                       f"L-BFGS {k}: finite"))
        if r["device"] == "cuda":
            counts["launches"] += r["counts"][0]
            counts["bwd_launches"] += r["counts"][1]
            counts["bwd_tile_launches"] += r["counts"][2]
            checks.append((r["counts"][:2] == (evals, evals)
                           and trials >= r["iters"],
                           f"L-BFGS {k}: counts {r['counts']} against {evals} "
                           f"evaluations (iterations + trials)"))
    checks.append((runs["gpu64"]["reads"] == runs["cpu64"]["reads"],
                   "L-BFGS fp64: the card's line search made other trials "
                   "than the CPU's"))
    vals = {k: r["values"] for k, r in runs.items()}
    gaps = held_gaps(vals, {"gpu64_vs_cpu64": ("gpu64", "cpu64"),
                            "cpu64_moved_vs_cpu64": ("cpu64_moved", "cpu64")},
                     exp_group, LB_F64_LIMITS,
                     f"L-BFGS flagship fp64 {LB_ITERS} iterations", checks,
                     logged=("cpu64_moved_vs_cpu64",))
    course = curve_course(vals, ("gpu64", "cpu64_moved", "gpu32", "cpu32"),
                          "L-BFGS flagship")
    c64 = vals["cpu64"]["curve"]
    to64 = {r: float(np.abs(vals[r]["curve"] - c64).max() / np.abs(c64).max())
            for r in ("gpu32", "cpu32")}
    log(f"L-BFGS flagship fp32, the curves' gap to the CPU's fp64: card "
        f"{to64['gpu32']:.3e}, CPU {to64['cpu32']:.3e}")
    warm = runs["gpu32_warm"]
    iter_ms = warm["wall_s"] * 1e3 / warm["iters"]
    evals_per_iter = warm["reads"] / warm["iters"]
    result["lbfgs"] = dict(
        gaps=gaps, course=course, fp32_to_fp64=to64, iter_ms=iter_ms,
        evals_per_iter=evals_per_iter,
        runs={k: {kk: vv for kk, vv in r.items() if kk != "values"}
              for k, r in runs.items()})
    # a profile of 5 iterations (one phase) and a Chrome trace of 3
    from tgp.pytorch_tpu_torch import bench
    tr = bench.flagship_trainer(dev)
    reads = []

    def five():
        r0 = LB.HOST_READS
        tr.train(5, 0.0, "lbfgs", verbose_each=0)
        reads.append(LB.HOST_READS - r0)

    R.LAUNCHES = R.BWD_LAUNCHES = R.BWD_TILE_LAUNCHES = LB.HOST_READS = 0
    prof = profile_device(five)              # a warm-up call, then profiled
    counts["launches"] += R.LAUNCHES
    counts["bwd_launches"] += R.BWD_LAUNCHES
    counts["bwd_tile_launches"] += R.BWD_TILE_LAUNCHES
    checks.append(((R.LAUNCHES, R.BWD_LAUNCHES) == (sum(reads), sum(reads)),
                   f"L-BFGS profile: counts {(R.LAUNCHES, R.BWD_LAUNCHES)}, "
                   f"{reads} evaluations"))
    per_eval = {k: prof[k] / reads[-1] for k in ("device_ops",
                                                 "device_busy_ms")}
    log(f"L-BFGS flagship fp32 iteration {iter_ms:.3f} ms ({evals_per_iter:.2f}"
        f" evaluations an iteration, {iter_ms / evals_per_iter:.3f} ms an "
        f"evaluation); profiled: {per_eval['device_ops']:.1f} device ops and "
        f"{per_eval['device_busy_ms']:.3f} ms busy an evaluation")
    for name, ms in prof["top_ms"]:
        log(f"    {ms * 1e3:9.2f} us in 5 iterations  {name}")
    tdir = HERE / "build" / "lbfgs_trace"
    shutil.rmtree(tdir, ignore_errors=True)
    R.LAUNCHES = R.BWD_LAUNCHES = R.BWD_TILE_LAUNCHES = LB.HOST_READS = 0
    with trace(str(tdir)):
        tr.train(3, 0.0, "lbfgs", verbose_each=0)
    counts["launches"] += R.LAUNCHES
    counts["bwd_launches"] += R.BWD_LAUNCHES
    counts["bwd_tile_launches"] += R.BWD_TILE_LAUNCHES
    events = json.loads((tdir / "trace.json").read_text())["traceEvents"]
    in_trace = sum("rbf_gram_kernel" in e.get("name", "") for e in events)
    log(f"utils.profiling.trace: {len(events)} events in trace.json, "
        f"{in_trace} of them the Gram forward kernel ({R.LAUNCHES} launches)")
    # the profiler may drop an event (a run on an H100 traced 14 of 15
    # launches); the counter, not the trace, holds the launches
    checks.append((0 < in_trace <= R.LAUNCHES == LB.HOST_READS,
                   f"trace: {in_trace} Gram kernels traced, {R.LAUNCHES} "
                   f"launched, {LB.HOST_READS} evaluations"))
    result["lbfgs"].update(profile_per_eval=per_eval,
                           profile_top_ms=prof["top_ms"],
                           trace_events=len(events))
    stage("the L-BFGS profile and trace")

    # (ii) resume, (iii) eval_device
    ck_dir = HERE / "build" / "runtime_ckpt"
    shutil.rmtree(ck_dir, ignore_errors=True)
    result["resume"] = {}
    for prec in ("fp32", "fp64"):
        tr, result["resume"][prec] = resume_check(dev, prec, ck_dir / prec,
                                                  checks, counts)
    stage("resume")
    from tgp.pytorch_tpu_torch import bench
    cfg.set_precision("fp64")
    try:
        tr.save(str(ck_dir / "eval"))
        host = bench.flagship_trainer(dev)
        host.restore(str(ck_dir / "eval"))
        host.eval_device = "cpu"
        R.LAUNCHES = R.BWD_LAUNCHES = R.BWD_TILE_LAUNCHES = 0
        t1 = time.perf_counter()
        m_card = tr.compute_metrics()
        card_s = time.perf_counter() - t1
        card_counts = (R.LAUNCHES, R.BWD_LAUNCHES, R.BWD_TILE_LAUNCHES)
        t1 = time.perf_counter()
        m_host = host.compute_metrics()
        host_s = time.perf_counter() - t1
        host_counts = (R.LAUNCHES, R.BWD_LAUNCHES, R.BWD_TILE_LAUNCHES)
    finally:
        cfg.set_precision("fp32")
    counts["launches"] += host_counts[0]
    counts["bwd_launches"] += host_counts[1]
    counts["bwd_tile_launches"] += host_counts[2]
    checks.append((card_counts[:2] == (4, 0) and host_counts == card_counts,
                   f"eval_device: card {card_counts}, then {host_counts}"))
    ev = {}
    for split in ("train", "test"):
        n_rows = len(tr.test_loader.dataset if split == "test"
                     else tr.train_loader.dataset)
        for k in ("logL", "rmse", "coverage"):
            a, b = float(m_host[split][k][0]), float(m_card[split][k][0])
            ev[f"{split}/{k}"] = g = abs(a - b) / abs(b)
            lim = 1.0 / n_rows / abs(b) if k == "coverage" else EVAL_CPU_LIMIT
            log(f"eval_device cpu {split:5s} {k:8s} host {a:.15g} card {b:.15g}"
                f" relative gap {g:.3e} (limit {lim:.1e})")
            checks.append((np.isfinite(a) and g <= lim,
                           f"eval_device {split} {k}: host {a}, card {b}"))
    log(f"compute_metrics on the card {card_s * 1e3:.1f} ms, on the host "
        f"(eval_device='cpu') {host_s * 1e3:.1f} ms, fp64")
    result["eval_device"] = dict(gaps=ev, card_ms=card_s * 1e3,
                                 host_ms=host_s * 1e3)
    stage("eval_device")

    # (iv) the CLI with --checkpoint_dir
    cli_dir = ck_dir / "cli"
    R.LAUNCHES = R.BWD_LAUNCHES = R.BWD_TILE_LAUNCHES = 0
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            run = pmain.run(pmain.parse_args([
                "--model", "SVGP", "--dataset", "boston",
                "--train_test_seed_split", "1", "--num_inducing", "100",
                "--epochs", str(RT_EPOCHS), "--verbose_each", "0",
                "--checkpoint_dir", str(cli_dir)]))
    finally:
        cfg.set_precision("fp32")
    got = (R.LAUNCHES, R.BWD_LAUNCHES, R.BWD_TILE_LAUNCHES)
    counts["launches"] += got[0]
    counts["bwd_launches"] += got[1]
    counts["bwd_tile_launches"] += got[2]
    params, _, step, _ = C.load_checkpoint(str(cli_dir))
    same = all(torch.equal(p, q.cpu()) for p, q in
               zip(tree_leaves(params), tree_leaves(run.trainer.params)))
    log(f"CLI --checkpoint_dir: {run.line}; step_{step} holds the trained "
        f"parameters bitwise: {same}; kernel calls {run.kernel_calls}")
    checks.append((same and step == RT_EPOCHS and C.latest_step(str(cli_dir))
                   == RT_EPOCHS, "CLI --checkpoint_dir"))
    checks.append((run.kernel_calls == {"train": (RT_EPOCHS, RT_EPOCHS),
                                        "eval": (4, 0)}
                   and got[:2] == (RT_EPOCHS + 4, RT_EPOCHS),
                   f"CLI --checkpoint_dir: counts {got}, {run.kernel_calls}"))
    checks.append((np.isfinite(run.metrics["test"]["logL"]).all(),
                   "CLI --checkpoint_dir: finite"))
    result["cli"] = dict(line=run.line, kernel_calls=run.kernel_calls)
    stage("the CLI")

    # (v) one sweep cell
    out = ck_dir / "sweep.jsonl"
    R.LAUNCHES = R.BWD_LAUNCHES = R.BWD_TILE_LAUNCHES = 0
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            recs = sweep.main(["--models", "SVGP", "--datasets", "boston",
                               "--seeds", "1", "--num_inducing", "100",
                               "--epochs", str(SWEEP_EPOCHS), "--precision",
                               "fp32", "--out", str(out)])
    finally:
        cfg.set_precision("fp32")
    got = (R.LAUNCHES, R.BWD_LAUNCHES, R.BWD_TILE_LAUNCHES)
    counts["launches"] += got[0]
    counts["bwd_launches"] += got[1]
    counts["bwd_tile_launches"] += got[2]
    log(f"sweep cell: {json.dumps(recs)}; kernel counts {got}")
    lines = [json.loads(ln) for ln in out.read_text().splitlines()]
    checks.append((lines == recs and len(recs) == 1
                   and not any("error" in r for r in recs),
                   f"sweep: records {recs}"))
    checks.append((all(np.isfinite(v) for r in recs for v in r.values()
                       if isinstance(v, float)), "sweep: finite"))
    checks.append((got[:2] == (SWEEP_EPOCHS + 4, SWEEP_EPOCHS),
                   f"sweep: counts {got} in {SWEEP_EPOCHS} steps"))
    result["sweep"] = recs
    shutil.rmtree(ck_dir, ignore_errors=True)
    stage("the sweep cell")

    result.update(**counts)
    for cond, msg in checks:
        check(cond, msg)
    return result


# ---------------------------------------------------------------------------
# phase 14: the large corpora
# ---------------------------------------------------------------------------

AIR_ROWS = 2_058_097      # the airline corpus after filtering
AIR_TRAIN, AIR_TEST = 1_955_192, 102_905   # load_airline's fallback split
AIR_M = 500               # benchmarks/airline_scale.py's model and batch
AIR_BATCH = 10_000
AIR_STEPS = 196           # an epoch: 195 batches and the remainder of 5192
AIR_KMEANS_ROWS = 200_000  # its k-means: the first rows, n_init=1
AIR_HELD_ROWS = 100_000   # card against CPU: 2 epochs of 10 steps, fp64
YEAR_ROWS, YEAR_TRAIN = 60_000, 50_000   # a row cut of YearMSD's 515,345
YEAR_M = 100
YEAR_EPOCHS = 4           # 5 batches of 10000 an epoch: 20 steps
LARGE_LR = 0.01
# The card's fp64 runs against the CPU's after 20 steps, relative to the
# largest entry of each group in the CPU's run: 10x the gaps first measured
# (NVIDIA H100 80GB HBM3, 700 W), and at least 1e-14, a few units in the
# last place (the noise and the output scale agreed to the bit).
AIR_F64_LIMITS = {"gpu64_vs_cpu64": {
    "curve": 4.3e-14, "kld": 1.1e-12, "Z": 2.8e-11, "flow": 1.1e-14,
    "kernel/child/raw_lengthscale": 1.8e-14, "kernel/raw_outputscale": 1e-14,
    "likelihood/log_var_noise": 1e-14, "q_L": 1.2e-9, "q_mu": 2.4e-10}}
YEAR_F64_LIMITS = {"gpu64_vs_cpu64": {
    "curve": 1e-14, "kld": 1e-14, "Z": 1.6e-13, "flow": 1e-14,
    "kernel/child/raw_lengthscale": 1e-14, "kernel/raw_outputscale": 1e-14,
    "likelihood/log_var_noise": 1e-14, "q_L": 4.3e-13, "q_mu": 7.0e-14}}
# the host loop against the device-resident epoch where they are not
# bitwise equal (tests/test_minibatch_path.py's tolerance)
HOST_LOOP_TOL = dict(rtol=5e-5, atol=1e-6)


def write_table(path, data, fmts, chunk=100_000):
    """`data` as comma-separated lines, column j in printf format fmts[j],
    formatted a chunk of rows at a time."""
    line = ",".join(fmts) + "\n"
    with open(path, "w") as f:
        for i in range(0, data.shape[0], chunk):
            part = data[i:i + chunk]
            f.write((line * part.shape[0]) % tuple(part.ravel().tolist()))


def airline_table(n):
    """An airline-shaped table: 8 seeded features and the target,
    `benchmarks/airline_scale.py`'s synthetic rows."""
    rng = np.random.RandomState(0)
    X = rng.randn(n, 8)
    f = np.sin(X[:, :1]) + 0.3 * X[:, 1:2] * X[:, 2:3]
    return np.c_[X, f + 0.3 * rng.randn(n, 1)]


def year_table(n):
    """A YearMSD-shaped table: the year (1922-2011) in the first column,
    then 90 seeded features with spreads from 1 to 150, as the timbre
    averages and covariances spread."""
    rng = np.random.RandomState(1)
    scale = np.exp(rng.uniform(0.0, 5.0, 90))
    X = rng.randn(n, 90) * scale
    year = np.clip(np.round(1998 + 8 * np.tanh(X[:, :4].sum(1) / scale[:4].sum())
                            + 6 * rng.randn(n)), 1922, 2011)
    return np.c_[year, X]


def large_model(kind, X, Z0, device):
    """(spec, params) of phase 14's models, in the configured precision:
    airline_scale's (SAL(2), scale-RBF, 100 GH nodes, min_var 1e-8, M=500)
    or the CLI's year TGP (its table's SAL(5), M=100), both from
    `variance_scale` 1e-5 and lengthscale and output scale 2."""
    from tgp.pytorch_tpu_torch.experiments import flow_arch as FA
    from tgp.pytorch_tpu_torch.flows import generators as G, spec_from_list
    from tgp.pytorch_tpu_torch.likelihoods import LikelihoodSpec
    from tgp.pytorch_tpu_torch.models import tgp as M
    from tgp.pytorch_tpu_torch.ops import kernels as K

    np.random.seed(0)
    if kind == "airline":
        fspec, finits = spec_from_list(G.SAL(2))
        N = AIR_TRAIN
    else:
        arch, nb, _ = FA.resolve_tgp_arch("year")
        fspec, finits = FA.build_point_flow(arch, nb)
        N = YEAR_TRAIN
    spec = M.TGPSpec(Dy=1, Dx=X.shape[1], M=Z0.shape[0], N=float(N),
                     kernel=K.from_name("scale_rbf"),
                     likelihood=LikelihoodSpec("gaussian_flow", 1,
                                               quad_points=100),
                     flow=fspec, min_var=1e-8)
    params = M.init_tgp_params(
        spec, X[:AIR_BATCH], Z0, variance_scale=1e-5,
        kernel_init={"length_scale": 2.0, "kernel_scale": 2.0},
        flow_inits=finits, device=device)
    return spec, params


def large_trainer(spec, params, X, Y, Y_std, device, test=None, **kw):
    """A Trainer over (X, Y) in batches of 10000 (loader seed 0), S_test 20
    (airline_scale's), the test rows' loader when given."""
    from tgp.pytorch_tpu_torch.data import ArrayDataset, DataLoader
    from tgp.pytorch_tpu_torch.train import Trainer

    loaders = [DataLoader(ArrayDataset(X, Y), AIR_BATCH, seed=0)]
    if test is not None:
        loaders.append(DataLoader(ArrayDataset(*test), AIR_BATCH,
                                  shuffle=False))
    return Trainer(spec, params, loaders, Y_std, S_test=20, device=device,
                   **kw)


def large_run(kind, X, Y, Z0, Y_std, device, precision, epochs):
    """`epochs` epochs of the `kind` model on (X, Y) from its init: the
    curves and parameters (fp64 on the host), the kernels' counts from 0
    and the wall time."""
    from tgp.pytorch_tpu_torch import config as cfg
    from tgp.pytorch_tpu_torch.ops import rbf_gram as R

    cfg.set_precision(precision)
    try:
        spec, params = large_model(kind, X, Z0, "cpu")
        tr = large_trainer(spec, params, X, Y, Y_std, device)
        R.LAUNCHES = R.BWD_LAUNCHES = R.BWD_TILE_LAUNCHES = 0
        t0 = time.perf_counter()
        tr.train(epochs, LARGE_LR, "adam", verbose_each=0)
        wall = time.perf_counter() - t0
        counts = (R.LAUNCHES, R.BWD_LAUNCHES, R.BWD_TILE_LAUNCHES)
    finally:
        cfg.set_precision("fp32")
    values = {n: np.asarray(c, np.float64) for n, c in
              (("curve", tr.loss_curve), ("kld", tr.kld_curve))}
    values.update((n, t.detach().double().cpu().numpy())
                  for n, t in named_leaves(tr.params))
    return dict(values=values, counts=counts, wall_s=wall,
                steps=epochs * len(tr.train_loader), device=tr.device.type)


def _large_job(fn, *a):
    """A phase 14 job in a worker process (three torch threads)."""
    torch.set_num_threads(3)
    return fn(*a)


def _kmeans_job(X, M):
    from tgp.pytorch_tpu_torch.data import kmeans_centers

    t0 = time.perf_counter()
    Z = kmeans_centers(X, M, n_init=1)
    return Z, time.perf_counter() - t0


def leaf_gap(a, b):
    """The largest gap between two trees' leaves, relative to each leaf's
    largest entry in `b`."""
    from tgp.pytorch_tpu_torch.weights import tree_leaves

    return max(float((p - q).detach().abs().max()
                     / (q.detach().abs().max() or 1.0))
               for p, q in zip(tree_leaves(a), tree_leaves(b)))


LARGE_ROOT = HERE / "build" / "large_root"   # phase 14's TGP_DATA_ROOT


def airline_prepare(root):
    """Phase 14's airline table and k-means centers, in a worker: writes
    <root>/regression/airline/airline.csv, loads it (`load_airline(seed=1)`)
    and returns (Z0, the write's seconds, the k-means' seconds)."""
    from tgp.pytorch_tpu_torch.data import kmeans_centers, large

    torch.set_num_threads(1)
    d = Path(root) / "regression" / "airline"
    d.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    write_table(d / "airline.csv", airline_table(AIR_ROWS), ["%.6f"] * 9)
    write_s = time.perf_counter() - t0
    X = large.load_airline(seed=1, data_dir=str(d))["X_tr"]
    t0 = time.perf_counter()
    Z0 = kmeans_centers(X[:AIR_KMEANS_ROWS], AIR_M, n_init=1)
    return Z0, write_s, time.perf_counter() - t0


class LargePrep:
    """`airline_prepare` in a spawned worker with one BLAS thread, started
    before the phases that precede phase 14 so that its k-means (minutes
    on the host) runs beside them; `result()` waits for it, `stop()` ends
    the worker."""

    def __init__(self):
        import multiprocessing
        import os
        import shutil

        shutil.rmtree(LARGE_ROOT, ignore_errors=True)
        env = {k: "1" for k in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS",
                                "MKL_NUM_THREADS")}
        prev = {k: os.environ.get(k) for k in env}
        os.environ.update(env)            # the worker spawns with these
        try:
            self.pool = multiprocessing.get_context("spawn").Pool(1)
        finally:
            for k, v in prev.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        self.t0 = time.perf_counter()
        self.job = self.pool.apply_async(airline_prepare, (str(LARGE_ROOT),))

    def result(self):
        t = time.perf_counter()
        out = self.job.get()
        return out + (time.perf_counter() - t, t - self.t0)

    def stop(self):
        self.pool.terminate()
        self.pool.join()


def large_phase(dev, prep=None):
    """The large corpora on the card:
      (i) a synthetic airline.csv (2,058,097 rows, airline_scale's rows) in
          a data root of its own; its parse timed by the native parser
          (where it builds) and `np.loadtxt`, the same bits;
          `load_airline(seed=1)`: 1,955,192 training and 102,905 test rows;
     (ii) airline_scale's model (SAL(2), M=500 from k-means over the first
          200,000 rows, batch 10000, Adam at lr 0.01, fp32) trained on the
          device-resident path: a warm epoch, then 2 timed (196 steps an
          epoch, 1 forward launch and 1 backward call each), 10 steps
          profiled, the test rows' metrics (2 launches a batch);
    (iii) fp64 on the card against the CPU, 20 steps (100,000 rows);
     (iv) the host loop: an epoch with a `track_fn` and one with
          DEVICE_RESIDENT_BYTES = 0, each against the device-resident epoch
          from the same start and loader seed;
      (v) remat: an airline step's loss and gradients with and without it
          (2 forward launches and 1 backward call, peak memory and time
          logged), and a boston ID_TGP step (its table's nets, dropout 0.5)
          whose generator ends where a plain step's does;
     (vi) a YearMSD-shaped file (60,000 x 91) through
          `load_year(n_train=50000)`: 20 steps of the CLI's year TGP at
          M=100 in fp64 on the card against the CPU, and in fp32.
    `prep` is the `LargePrep` started before the earlier phases (the
    airline table and its k-means); None starts one here and waits."""
    import dataclasses
    import multiprocessing
    import os
    import shutil
    from concurrent.futures import ProcessPoolExecutor

    from tgp.pytorch_tpu_torch import config as cfg
    from tgp.pytorch_tpu_torch.data import large, native, return_dataset
    from tgp.pytorch_tpu_torch.experiments import flow_arch as FA
    from tgp.pytorch_tpu_torch.likelihoods import LikelihoodSpec
    from tgp.pytorch_tpu_torch.models import tgp as M
    from tgp.pytorch_tpu_torch.ops import kernels as K, rbf_gram as R
    from tgp.pytorch_tpu_torch.train import Trainer
    from tgp.pytorch_tpu_torch.weights import tree_leaves, tree_unflatten

    result, checks = {}, []
    counts = {"launches": 0, "bwd_launches": 0, "bwd_tile_launches": 0}
    t_phase = time.perf_counter()

    def stage(name):
        log(f"phase 14: {name} done at {time.perf_counter() - t_phase:.1f} s")

    def add(got):
        counts["launches"] += got[0]
        counts["bwd_launches"] += got[1]
        counts["bwd_tile_launches"] += got[2]

    own_prep = prep is None
    if own_prep:
        prep = LargePrep()
    root = LARGE_ROOT
    air_dir = root / "regression" / "airline"
    year_dir = root / "regression" / "uci"
    # the data root, and three BLAS threads in the workers (spawned with
    # this environment), restored at the end
    env = {"TGP_DATA_ROOT": str(root), "OMP_NUM_THREADS": "3",
           "OPENBLAS_NUM_THREADS": "3", "MKL_NUM_THREADS": "3"}
    prev_env = {k: os.environ.get(k) for k in env}

    def boston():
        """boston's split from the caller's data root, not the phase's."""
        os.environ.pop("TGP_DATA_ROOT")
        if prev_env["TGP_DATA_ROOT"] is not None:
            os.environ["TGP_DATA_ROOT"] = prev_env["TGP_DATA_ROOT"]
        try:
            return return_dataset("boston", 10000, seed=1)
        finally:
            os.environ["TGP_DATA_ROOT"] = str(root)

    os.environ.update(env)
    pool = ProcessPoolExecutor(
        max_workers=2, mp_context=multiprocessing.get_context("spawn"))
    try:
        # (i) the airline table (written in the worker) parsed
        Z0, write_s, km_s, wait_s, since_s = prep.result()
        log(f"the worker's airline table and k-means: ready {since_s:.1f} s "
            f"after it started, {wait_s:.1f} s waited here")
        year_dir.mkdir(parents=True)
        size = (air_dir / "airline.csv").stat().st_size
        have_native = native.available()
        parse = {"g++": shutil.which("g++"), "native": have_native,
                 "native_error": native._error, "write_s": write_s,
                 "bytes": size}
        if have_native:
            t0 = time.perf_counter()
            a = native.read_csv(str(air_dir / "airline.csv"))
            parse["native_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        b = np.loadtxt(air_dir / "airline.csv", delimiter=",")
        parse["numpy_s"] = time.perf_counter() - t0
        if have_native:
            checks.append((np.array_equal(a, b),
                           "airline.csv: the native parser's array is not "
                           "numpy's"))
            del a
        del b
        t0 = time.perf_counter()
        split = large.load_airline(seed=1)
        parse["load_airline_s"] = time.perf_counter() - t0
        X_tr, Y_tr = split["X_tr"], split["Y_tr"]
        X_te, Y_te = split["X_te"], split["Y_te"]
        log(f"airline.csv: {AIR_ROWS} rows, {size} bytes, written in "
            f"{write_s:.2f} s; g++ {parse['g++']}, native parser "
            f"{'built' if have_native else 'not built: ' + str(native._error)}"
            f"; parse {parse.get('native_s', float('nan')):.3f} s native, "
            f"{parse['numpy_s']:.3f} s np.loadtxt; load_airline (the native "
            f"parser, the split and the z-scores) in "
            f"{parse['load_airline_s']:.3f} s: {X_tr.shape[0]} "
            f"training and {X_te.shape[0]} test rows, "
            f"{(X_tr.nbytes + Y_tr.nbytes) / 1e6:.1f} MB of training data")
        checks.append((X_tr.shape == (AIR_TRAIN, 8) and Y_tr.shape ==
                       (AIR_TRAIN, 1) and X_te.shape == (AIR_TEST, 8),
                       f"load_airline: {X_tr.shape}, {X_te.shape}"))
        result["parse"] = parse
        stage("the airline table")

        # the year table
        t0 = time.perf_counter()
        write_table(year_dir / "YearPredictionMSD.txt", year_table(YEAR_ROWS),
                    ["%d"] + ["%.6f"] * 90)
        t1 = time.perf_counter()
        ysplit = large.load_year(n_train=YEAR_TRAIN)
        parse["load_year_s"] = time.perf_counter() - t1
        log(f"YearPredictionMSD.txt: {YEAR_ROWS} x 91 written and loaded "
            f"(the native parser; load_year {parse['load_year_s']:.3f} s) in "
            f"{time.perf_counter() - t0:.2f} s")
        Xy, Yy = ysplit["X_tr"], ysplit["Y_tr"]
        checks.append((Xy.shape == (YEAR_TRAIN, 90) and ysplit["X_te"].shape
                       == (YEAR_ROWS - YEAR_TRAIN, 90), f"load_year: {Xy.shape}"))
        km_year = pool.submit(_large_job, _kmeans_job, Xy, YEAR_M)
        log(f"k-means over {AIR_KMEANS_ROWS} airline rows, M={AIR_M}, "
            f"n_init=1: {km_s:.1f} s (the worker, one BLAS thread, beside "
            f"the earlier phases)")
        result.update(kmeans_s=km_s, prep_wait_s=wait_s)

        # (iii) fp64 on the card (the CPU's run follows the timed runs)
        held = (X_tr[:AIR_HELD_ROWS], Y_tr[:AIR_HELD_ROWS])
        runs = {"gpu64": large_run("airline", *held, Z0, split["Y_std"], dev,
                                   "fp64", 2)}

        # (ii) the device-resident path, fp32
        cfg.set_precision("fp32")
        try:
            spec, params = large_model("airline", X_tr, Z0, "cpu")
            tr = large_trainer(spec, params, X_tr, Y_tr, split["Y_std"], dev,
                               test=(X_te, Y_te))
            R.LAUNCHES = R.BWD_LAUNCHES = R.BWD_TILE_LAUNCHES = 0
            t0 = time.perf_counter()
            tr.train(1, LARGE_LR, "adam", verbose_each=0)
            warm_s = time.perf_counter() - t0
            got = (R.LAUNCHES, R.BWD_LAUNCHES, R.BWD_TILE_LAUNCHES)
            add(got)
            checks.append((got[:2] == (AIR_STEPS, AIR_STEPS),
                           f"airline warm epoch: counts {got}"))
            epoch1 = [t.detach().clone() for t in tree_leaves(tr.params)]
            epoch1_curve = list(tr.loss_curve)
            # --- the main path: counts from 0, 1 and 1 a step
            R.LAUNCHES = R.BWD_LAUNCHES = R.BWD_TILE_LAUNCHES = 0
            t0 = time.perf_counter()
            tr.train(2, LARGE_LR, "adam", verbose_each=0)
            timed_s = time.perf_counter() - t0
            got = (R.LAUNCHES, R.BWD_LAUNCHES, R.BWD_TILE_LAUNCHES)
            # -----------------------------------------------------------
            add(got)
            checks.append((got[:2] == (2 * AIR_STEPS, 2 * AIR_STEPS),
                           f"airline 2 epochs: counts {got}"))
            checks.append((np.isfinite(np.asarray(tr.loss_curve)).all(),
                           "airline fp32: finite ELBO"))
            train = dict(warm_epoch_s=warm_s, epoch_s=timed_s / 2,
                         steps_per_s=2 * AIR_STEPS / timed_s,
                         rows_per_s=2 * AIR_TRAIN / timed_s,
                         elbo=[float(v) for v in tr.loss_curve])
            log(f"airline fp32 device-resident: warm epoch {warm_s:.2f} s, "
                f"then {train['epoch_s']:.3f} s an epoch, "
                f"{train['steps_per_s']:.2f} steps/s, "
                f"{train['rows_per_s']:.0f} rows/s; ELBO "
                + ", ".join(f"{v:.1f}" for v in train["elbo"]))
            # 10 steps profiled: an epoch of the first 100,000 rows
            tr10 = large_trainer(spec, tr.params, X_tr[:AIR_HELD_ROWS],
                                 Y_tr[:AIR_HELD_ROWS], split["Y_std"], dev)
            R.LAUNCHES = R.BWD_LAUNCHES = R.BWD_TILE_LAUNCHES = 0
            prof = profile_device(lambda: tr10.train(1, LARGE_LR, "adam",
                                                     verbose_each=0))
            got = (R.LAUNCHES, R.BWD_LAUNCHES, R.BWD_TILE_LAUNCHES)
            add(got)
            n10 = AIR_HELD_ROWS // AIR_BATCH
            checks.append((got[:2] == (2 * n10, 2 * n10),
                           f"airline profile: counts {got}"))
            per_step = {k: prof[k] / n10 for k in ("device_ops",
                                                  "device_busy_ms",
                                                  "gram_ms", "gram_bwd_ms")}
            step_ms = 1e3 / train["steps_per_s"]
            log(f"airline step {step_ms:.3f} ms; profiled: "
                f"{per_step['device_ops']:.1f} device ops, busy "
                f"{per_step['device_busy_ms']:.3f} ms = "
                f"{per_step['device_busy_ms'] / step_ms:.1%} of a step; Gram "
                f"forward {per_step['gram_ms'] * 1e3:.2f} us, backward "
                f"{per_step['gram_bwd_ms'] * 1e3:.2f} us a step")
            for name, ms in prof["top_ms"]:
                log(f"    {ms * 1e3 / n10:9.2f} us a step  {name}")
            train.update(profile_per_step=per_step,
                         profile_top_ms=prof["top_ms"])
            # the test rows' metrics
            R.LAUNCHES = R.BWD_LAUNCHES = R.BWD_TILE_LAUNCHES = 0
            t0 = time.perf_counter()
            m = tr._metrics_for_loader(tr.test_loader)
            eval_s = time.perf_counter() - t0
            got = (R.LAUNCHES, R.BWD_LAUNCHES, R.BWD_TILE_LAUNCHES)
            add(got)
            n_eval = len(tr.test_loader)
            checks.append((got[:2] == (2 * n_eval, 0),
                           f"airline test metrics: counts {got}, {n_eval} "
                           f"batches"))
            checks.append((all(np.isfinite(v).all() for v in m.values()),
                           f"airline test metrics: {m}"))
            log(f"airline test rows ({AIR_TEST}, {n_eval} batches, "
                f"{eval_s:.2f} s): NLL {-float(m['logL'][0]):.4f}, RMSE "
                f"{float(m['rmse'][0]):.4f}, coverage "
                f"{float(m['coverage'][0]):.4f}")
            train["test"] = {k: float(v[0]) for k, v in m.items()}
            train["eval_s"] = eval_s
            result["airline"] = train
            stage("the device-resident training")

            # (iv) the host loop, one epoch from the start, loader seed 0
            result["host_loop"] = {}
            for mode in ("track_fn", "host_bytes"):
                calls = []
                h = large_trainer(spec, params, X_tr, Y_tr, split["Y_std"],
                                  dev, track_fn=(lambda t: calls.append(1))
                                  if mode == "track_fn" else None)
                if mode == "host_bytes":
                    h.DEVICE_RESIDENT_BYTES = 0
                R.LAUNCHES = R.BWD_LAUNCHES = R.BWD_TILE_LAUNCHES = 0
                t0 = time.perf_counter()
                h.train(1, LARGE_LR, "adam", verbose_each=0)
                s = time.perf_counter() - t0
                got = (R.LAUNCHES, R.BWD_LAUNCHES, R.BWD_TILE_LAUNCHES)
                add(got)
                same = all(torch.equal(p, q) for p, q in
                           zip(tree_leaves(h.params), epoch1))
                gap = leaf_gap(h.params, tree_unflatten(tr.params, epoch1))
                curve_same = (len(h.loss_curve) == AIR_STEPS and
                              float(h.loss_curve[-2]) == float(epoch1_curve[0]))
                log(f"airline host loop ({mode}): {s:.2f} s an epoch, "
                    f"{AIR_STEPS / s:.2f} steps/s (device-resident "
                    f"{train['steps_per_s']:.2f}); counts {got}; track_fn "
                    f"calls {len(calls)}; bitwise the device-resident epoch: "
                    f"{same} (largest leaf gap {gap:.3e}); its last full "
                    f"batch's ELBO the same: {curve_same}")
                checks.append((got[:2] == (AIR_STEPS, AIR_STEPS),
                               f"host loop {mode}: counts {got}"))
                if mode == "track_fn":
                    checks.append((len(calls) == AIR_STEPS,
                                   f"track_fn: {len(calls)} calls"))
                checks.append((same or all(
                    np.allclose(p.cpu().numpy(), q.cpu().numpy(),
                                **HOST_LOOP_TOL)
                    for p, q in zip(tree_leaves(h.params), epoch1)),
                    f"host loop {mode}: leaf gap {gap}"))
                result["host_loop"][mode] = dict(
                    epoch_s=s, steps_per_s=AIR_STEPS / s, bitwise=same,
                    leaf_gap=gap, curve_same=curve_same, calls=len(calls))
                del h
            stage("the host loop")

            # (v) remat: one airline step's loss and gradients
            Xb = torch.as_tensor(X_tr[:AIR_BATCH], dtype=torch.float32,
                                 device=dev)
            Yb = torch.as_tensor(Y_tr[:AIR_BATCH], dtype=torch.float32,
                                 device=dev)

            def value_and_grad(sp):
                leaves = [t.detach().clone().requires_grad_(True)
                          for t in tree_leaves(tr.params)]
                e = M.elbo(sp, tree_unflatten(tr.params, leaves), Xb, Yb)[0]
                g = torch.autograd.grad(-e, leaves, allow_unused=True,
                                        materialize_grads=True)
                return e.detach(), g

            remat = {}
            outs = {}
            for on in (False, True):
                sp = dataclasses.replace(spec, remat=on)
                R.LAUNCHES = R.BWD_LAUNCHES = R.BWD_TILE_LAUNCHES = 0
                value_and_grad(sp)                     # warm
                torch.cuda.synchronize()
                before = (R.LAUNCHES, R.BWD_LAUNCHES)
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                outs[on] = value_and_grad(sp)
                torch.cuda.synchronize()
                got = (R.LAUNCHES - before[0], R.BWD_LAUNCHES - before[1])
                peak = torch.cuda.max_memory_allocated() - base
                times = []
                for _ in range(5):
                    t0 = time.perf_counter()
                    value_and_grad(sp)
                    torch.cuda.synchronize()
                    times.append(time.perf_counter() - t0)
                # warm, held and timed
                add((R.LAUNCHES, R.BWD_LAUNCHES, R.BWD_TILE_LAUNCHES))
                checks.append(((R.LAUNCHES, R.BWD_LAUNCHES) ==
                               (7 * got[0], 7 * got[1]),
                               f"remat={on}: counts over 7 calls "
                               f"{(R.LAUNCHES, R.BWD_LAUNCHES)}, {got} held"))
                remat[on] = dict(counts=got, peak_bytes=peak,
                                 step_ms=1e3 * float(np.median(times)))
                checks.append((got == ((2, 1) if on else (1, 1)),
                               f"remat={on}: counts {got}"))
            same = (torch.equal(outs[False][0], outs[True][0]) and
                    all(torch.equal(a, b) for a, b in
                        zip(outs[False][1], outs[True][1])))
            log(f"airline step with remat: loss and gradients bitwise the "
                f"plain step's: {same}; counts {remat[True]['counts']} "
                f"(plain {remat[False]['counts']}); peak memory above the "
                f"resident {remat[True]['peak_bytes'] / 2**20:.1f} MiB "
                f"(plain {remat[False]['peak_bytes'] / 2**20:.1f}); "
                f"value and gradient {remat[True]['step_ms']:.3f} ms (plain "
                f"{remat[False]['step_ms']:.3f})")
            checks.append((same, "remat: the airline step is not bitwise"))
            result["remat"] = {"airline": {str(k): v for k, v in
                                           remat.items()}, "bitwise": same}
        finally:
            cfg.set_precision("fp32")

        cpu_air = pool.submit(_large_job, large_run, "airline", *held, Z0,
                              split["Y_std"], "cpu", "fp64", 2)

        # remat on boston ID_TGP: the masks replayed
        _, d = boston()
        np.random.seed(cfg.config_seed)
        flow, inits = FA.build_id_flow("boston", 13)
        bspec = M.TGPSpec(Dy=1, Dx=13, M=100, N=float(d["N_tr"]),
                          kernel=K.from_name("scale_rbf"),
                          likelihood=LikelihoodSpec("gaussian_flow", 1),
                          flow=flow)
        bparams = M.init_tgp_params(
            bspec, d["X_tr"], d["X_tr"][:100], variance_scale=1e-5,
            kernel_init={"length_scale": 2.0, "kernel_scale": 2.0},
            flow_inits=inits, device="cpu")
        id_tr, id_counts = {}, {}
        for on in (False, True):
            # a loader each: the one batch's order is the loader's first draw
            loaders, _ = boston()
            t = Trainer(dataclasses.replace(bspec, remat=on), bparams,
                        loaders, d["Y_std"], seed=5, device=dev)
            R.LAUNCHES = R.BWD_LAUNCHES = R.BWD_TILE_LAUNCHES = 0
            t.train(1, LARGE_LR, "adam", verbose_each=0)
            id_counts[on] = (R.LAUNCHES, R.BWD_LAUNCHES, R.BWD_TILE_LAUNCHES)
            add(id_counts[on])
            id_tr[on] = t
        id_same = (all(torch.equal(p, q) for p, q in
                       zip(tree_leaves(id_tr[False].params),
                           tree_leaves(id_tr[True].params)))
                   and torch.equal(id_tr[False]._gen.get_state(),
                                   id_tr[True]._gen.get_state()))
        log(f"boston ID_TGP step (nets 13 -> 25 -> 1, dropout 0.5) with "
            f"remat: parameters and the generator's state bitwise a plain "
            f"step's: {id_same}; counts {id_counts[True]} (plain "
            f"{id_counts[False]})")
        checks.append((id_same and {k: c[:2] for k, c in id_counts.items()}
                       == {False: (1, 1), True: (2, 1)},
                       f"remat ID_TGP: {id_same}, {id_counts}"))
        result["remat"]["id_tgp"] = dict(bitwise=id_same, counts={
            str(k): v for k, v in id_counts.items()})
        stage("remat")

        # (vi) year at Dx=90
        Z0y, kmy_s = km_year.result()
        cpu_year = pool.submit(_large_job, large_run, "year", Xy, Yy, Z0y,
                               ysplit["Y_std"], "cpu", "fp64", YEAR_EPOCHS)
        yruns = {"gpu64": large_run("year", Xy, Yy, Z0y, ysplit["Y_std"], dev,
                                    "fp64", YEAR_EPOCHS),
                 "gpu32": large_run("year", Xy, Yy, Z0y, ysplit["Y_std"], dev,
                                    "fp32", YEAR_EPOCHS)}
        runs["cpu64"] = cpu_air.result()
        yruns["cpu64"] = cpu_year.result()
        stage("the fp64 runs")
    finally:
        pool.shutdown(wait=True, cancel_futures=True)
        if own_prep:
            prep.stop()
        for k, v in prev_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        shutil.rmtree(root, ignore_errors=True)

    for tag, rs, limits in (("airline", runs, AIR_F64_LIMITS),
                            ("year", yruns, YEAR_F64_LIMITS)):
        for k, r in rs.items():
            log(f"{tag} {k}: {r['steps']} steps in {r['wall_s']:.2f} s, "
                f"counts {r['counts']}, ELBO "
                + ", ".join(f"{v:.6f}" for v in r["values"]["curve"]))
            checks.append((all(np.isfinite(v).all()
                               for v in r["values"].values()),
                           f"{tag} {k}: finite"))
            if r["device"] == "cuda":
                add(r["counts"])
                checks.append((r["counts"][:2] == (r["steps"], r["steps"]),
                               f"{tag} {k}: counts {r['counts']}"))
        vals = {k: r["values"] for k, r in rs.items()}
        gaps = held_gaps(vals, {"gpu64_vs_cpu64": ("gpu64", "cpu64")},
                         exp_group, limits, f"{tag} fp64 20 steps", checks)
        result[f"{tag}_f64"] = dict(gaps=gaps, runs={
            k: {kk: vv for kk, vv in r.items() if kk != "values"}
            for k, r in rs.items()})
    c64 = yruns["cpu64"]["values"]["curve"]
    to64 = float(np.abs(yruns["gpu32"]["values"]["curve"] - c64).max()
                 / np.abs(c64).max())
    log(f"year fp32 on the card: the curve {to64:.3e} from the CPU's fp64 "
        f"(logged); k-means over {YEAR_TRAIN} rows at Dx=90, M={YEAR_M}: "
        f"{kmy_s:.1f} s")
    result["year_f64"]["fp32_to_fp64"] = to64
    result["year_kmeans_s"] = kmy_s
    stage("the comparisons")
    result.update(**counts)
    for cond, msg in checks:
        check(cond, msg)
    return result


# ---------------------------------------------------------------------------
# phase 15: bf16, rbg and meshes
# ---------------------------------------------------------------------------
BF16_EPOCHS = 30          # kin8nm's bf16 runs, card and CPU
BF16_NAN_STEPS = 3        # the flagship's bf16 steps (its ELBO is NaN)
RBG_STEPS = 20            # boston ID_TGP under each stream
MESH_EPOCHS = 30          # the mesh runs (fp64)
MESH_BATCH = 1000         # power's 8611 rows: 8 batches of 1000 and 611
MESH_SEEDS = "1-3"        # the battery on dp=2: R=3 padded to 4
# Card against CPU, and a mesh against the run without one: 10x the largest
# gap first measured (NVIDIA H100 80GB HBM3, 700 W), each
# relative to its group's largest entry in the reference run.  bf16 runs
# part as far as bf16 rounding carries them: after 30 epochs the card's
# kin8nm run is as far from the CPU's as from the card's own fp32 run (a
# bf16 step of a cotangent where the two sums round apart moves the rest of
# the run), so its leaves are logged there, and the run is held where the
# card and the CPU still agree: the first ELBO (10x its gap, 7.2e-8) and
# the ELBO's gradient at the initial parameters leaf by leaf
# (BF16_GRAD_LIMITS: 10x the gaps, floored at 10 fp32 rounding units).
# The card's fp32 gradient, logged beside it, is as far as bf16 rounding
# moves it: 1.2e-3 to 5.1e-3 of each group, 6.1e-2 on Z.  Z's own gap,
# 3.4e-3, is one bf16 step of the K_zz cotangent where the two fp32 sums
# round apart.  The 30-epoch curve and KL are held at 10x their gaps.
BF16_FIRST_ELBO_LIMIT = 7.2e-7
BF16_GRAD_LIMITS = {"Z": 3.5e-2, "flow": 2.3e-6,
                    "kernel/child/raw_lengthscale": 7.8e-4,
                    "kernel/raw_outputscale": 1.2e-6,
                    "likelihood/log_var_noise": 1.2e-6, "q_L": 1.2e-6,
                    "q_mu": 8.6e-6}
BF16_LIMITS = {"curve": 1.9e-2, "kld": 2.4e-4}
MESH_LIMITS = {
    "dp": {"curve": 1.6e-11, "kld": 3.5e-11, "Z": 9.8e-10, "flow": 3.5e-12,
           "kernel/child/raw_lengthscale": 4.1e-11,
           "kernel/raw_outputscale": 1.4e-12,
           "likelihood/log_var_noise": 1.3e-12, "q_L": 1.9e-8,
           "q_mu": 1.2e-9},
    "ty": {"curve": 1.7e-9, "kld": 1.8e-10, "Z": 4.4e-8, "flow": 1.1e-7,
           "kernel/child/raw_lengthscale": 1.2e-9,
           "kernel/raw_outputscale": 1.5e-10,
           "likelihood/log_var_noise": 5.5e-11, "q_L": 1.4e-7,
           "q_mu": 9.4e-8},
    "battery": {"curve": 4.0e-12, "kld": 2.5e-11, "Z": 2.0e-10,
                "flow": 1.3e-12, "kernel/child/raw_lengthscale": 4.5e-12,
                "kernel/raw_outputscale": 4.6e-13,
                "likelihood/log_var_noise": 3.4e-14, "q_L": 5.5e-9,
                "q_mu": 1.1e-9}}


def rel_gaps(a, b, group=exp_group):
    """The largest |a - b| of each group of names, relative to the group's
    largest |b|."""
    scale, out = {}, {}
    for n in b:
        scale[group(n)] = max(scale.get(group(n), 0.0),
                              float(np.abs(b[n]).max()))
    for n in b:
        g = float(np.abs(np.asarray(a[n]) - b[n]).max()
                  / (scale[group(n)] or 1.0))
        out[group(n)] = max(out.get(group(n), 0.0), g)
    return out


def hold_gaps(gaps, limits, tag, checks):
    """Log each group's gap; hold it to `limits[group]` where a table is
    given (every group must have a limit then)."""
    for n, g in gaps.items():
        log(f"{tag} {n:32s} {g:.3e}"
            + ("" if limits is None else f" (limit {limits.get(n)})"))
        if limits is not None:
            checks.append((n in limits and g <= limits[n],
                           f"{tag} {n}: {g} (limit {limits.get(n)})"))


def trainer_values(tr):
    """A Trainer's curves and leaves, fp64 on the host, by name."""
    out = {"curve": np.asarray(tr.loss_curve, np.float64),
           "kld": np.asarray(tr.kld_curve, np.float64)}
    out.update((n, t.detach().double().cpu().numpy())
               for n, t in named_leaves(tr.params))
    return out


def stack_values(stack, curves):
    out = {"curve": np.asarray(curves["elbo"], np.float64),
           "kld": np.asarray(curves["kld"], np.float64)}
    out.update((n, t.detach().double().cpu().numpy())
               for n, t in named_leaves(stack))
    return out


def kin8nm_trainer(device, mesh=None):
    """The flagship's model (SAL(2), scale-RBF ARD, M=100, Z = the first 100
    rows, min_var 1e-8) on kin8nm split 1 (7372 rows, Dx=8), full batch:
    its bf16 K_zz is positive definite where power's is not."""
    from tgp.pytorch_tpu_torch import weights
    from tgp.pytorch_tpu_torch.data import return_dataset
    from tgp.pytorch_tpu_torch.train import Trainer

    loaders, d = return_dataset("kin8nm", 10000, seed=1)
    X = d["X_tr"]
    spec = dataclasses.replace(weights.flagship_spec(X.shape[0], Dx=X.shape[1]),
                               min_var=1e-8)
    params = weights.flagship_init(spec, X, variance_scale=1e-5, device=device)
    return Trainer(spec, params, loaders, d["Y_std"], mesh=mesh,
                   device=None if mesh is not None else device)


def first_gradient(tr):
    """The gradient of a Trainer's ELBO over its training rows at its
    initial parameters (a full-batch first step's, up to the rows' order),
    fp64 on the host, by leaf name."""
    from tgp.pytorch_tpu_torch.weights import tree_leaves

    ds = tr.train_loader.dataset
    grads = tr._value_and_grad(tr.params, tr._put(ds.X), tr._put(ds.Y),
                               tree_leaves(tr.params))[3]
    return {n: g.double().cpu().numpy()
            for (n, _), g in zip(named_leaves(tr.params), grads)}


def mesh_flagship(device, mesh=None):
    """`bench.flagship_trainer`'s model and init in minibatches of
    MESH_BATCH (8 full batches and the 611-row remainder an epoch)."""
    from tgp.pytorch_tpu_torch import weights
    from tgp.pytorch_tpu_torch.data import return_dataset
    from tgp.pytorch_tpu_torch.train import Trainer

    loaders, d = return_dataset("power", MESH_BATCH, seed=1)
    X = d["X_tr"]
    spec = dataclasses.replace(weights.flagship_spec(X.shape[0]), min_var=1e-8)
    params = weights.flagship_init(spec, X, variance_scale=1e-5, device=device)
    return Trainer(spec, params, loaders, d["Y_std"], mesh=mesh,
                   device=None if mesh is not None else device)


def mesh_runs(device, mesh_dp=None, mesh_ty=None):
    """Phase 15's three mesh runs (fp64, MESH_EPOCHS): the flagship in
    batches of MESH_BATCH on `mesh_dp`, phase 10's Dy=2 boston model on
    `mesh_ty`, and the flagship battery of MESH_SEEDS on `mesh_dp`; without
    meshes, the same runs on one process.  Each: (values, kernel counts
    from 0, md5 of the parameters)."""
    import hashlib

    from tgp.pytorch_tpu_torch import bench, config as cfg
    from tgp.pytorch_tpu_torch.experiments import battery as B
    from tgp.pytorch_tpu_torch.ops import rbf_gram as R
    from tgp.pytorch_tpu_torch.train import Trainer, multiseed as ms

    def md5(vals):
        return hashlib.md5(b"".join(np.ascontiguousarray(v).tobytes()
                                    for k, v in sorted(vals.items()))).hexdigest()

    out = {}
    cfg.set_precision("fp64")
    try:
        tr = mesh_flagship(device, mesh_dp)
        R.LAUNCHES = R.BWD_LAUNCHES = R.BWD_TILE_LAUNCHES = 0
        tr.train(MESH_EPOCHS, bench.LR, "adam", verbose_each=0)
        counts = (R.LAUNCHES, R.BWD_LAUNCHES, R.BWD_TILE_LAUNCHES)
        v = trainer_values(tr)
        out["dp"] = (v, counts, md5(v))

        spec, params, loaders, Y_std = surface_model("per_output", device)
        tr = Trainer(spec, params, loaders, Y_std, mesh=mesh_ty,
                     device=None if mesh_ty is not None else device)
        R.LAUNCHES = R.BWD_LAUNCHES = R.BWD_TILE_LAUNCHES = 0
        tr.train(MESH_EPOCHS, 0.01, "adam", verbose_each=0)
        counts = (R.LAUNCHES, R.BWD_LAUNCHES, R.BWD_TILE_LAUNCHES)
        v = trainer_values(tr)
        out["ty"] = (v, counts, md5(v))

        args = battery_args("TGP", "power", 100, MESH_EPOCHS, "fp64",
                            "gpu" if device.type == "cuda" else "cpu",
                            MESH_SEEDS)
        cell = B.prepare(args, device)
        R.LAUNCHES = R.BWD_LAUNCHES = R.BWD_TILE_LAUNCHES = 0
        stack, curves = ms.train_multiseed(cell.spec, cell.params, cell.X,
                                           cell.Y, MESH_EPOCHS, args.lr,
                                           mesh=mesh_dp, device=device)
        counts = (R.LAUNCHES, R.BWD_LAUNCHES, R.BWD_TILE_LAUNCHES)
        v = stack_values(stack, curves)
        out["battery"] = (v, counts, md5(v))
    finally:
        cfg.set_precision("fp32")
    return out


def _mesh_rank(workdir):
    """A rank of phase 15's two ranks on one card (gloo): `mesh_runs` on a
    dp=2 mesh and a ty=2 mesh; rank 0 writes the values to `workdir`.
    Returns each run's counts and md5 (JSON)."""
    import contextlib
    import io

    import torch.distributed as dist
    from tgp.pytorch_tpu_torch.parallel import make_mesh

    dp, ty = make_mesh(2, 1), make_mesh(1, 2)
    with contextlib.redirect_stdout(io.StringIO()):
        out = mesh_runs(dp.device, dp, ty)
    if dist.get_rank() == 0:
        np.savez(os.path.join(workdir, "mesh_values.npz"),
                 **{f"{k}|{n}": v for k, (vals, _, _) in out.items()
                    for n, v in vals.items()})
    return {k: dict(counts=list(c), md5=m) for k, (_, c, m) in out.items()}


def boston_id(device, seed):
    """A Trainer of boston's ID_TGP (SAL(1), nets 13 -> 25 -> 1, dropout
    0.5; M=100, Z = the first 100 rows), full batch, under the configured
    stream: every step draws dropout masks."""
    from tgp.pytorch_tpu_torch import config as cfg
    from tgp.pytorch_tpu_torch.data import return_dataset
    from tgp.pytorch_tpu_torch.experiments import flow_arch as FA
    from tgp.pytorch_tpu_torch.likelihoods import LikelihoodSpec
    from tgp.pytorch_tpu_torch.models import tgp as M
    from tgp.pytorch_tpu_torch.ops import kernels as K
    from tgp.pytorch_tpu_torch.train import Trainer

    loaders, d = return_dataset("boston", 10000, seed=1)
    np.random.seed(cfg.config_seed)
    flow, inits = FA.build_id_flow("boston", 13)
    spec = M.TGPSpec(Dy=1, Dx=13, M=100, N=float(d["N_tr"]),
                     kernel=K.from_name("scale_rbf"),
                     likelihood=LikelihoodSpec("gaussian_flow", 1), flow=flow)
    params = M.init_tgp_params(
        spec, d["X_tr"], d["X_tr"][:100], variance_scale=1e-5,
        kernel_init={"length_scale": 2.0, "kernel_scale": 2.0},
        flow_inits=inits, device="cpu")
    return Trainer(spec, params, loaders, d["Y_std"], seed=seed,
                   device=device)


def last_modules_phase(dev):
    """bf16, the rbg stream and meshes on the card:
      (i) bf16: the flagship's steps (1 forward launch, 1 backward call and
          1 bf16-route Gram each; its ELBO is NaN from the first step on the
          card and the CPU alike: K_zz with bf16 operands is not positive
          definite); kin8nm's flagship model BF16_EPOCHS epochs on the card
          against the CPU, both bf16 (the gap to the card's fp32 run
          logged); serving it at bucket 256 (0 launches, 2 bf16 Grams) and
          4096 (1 launch, 1 bf16 Gram);
     (ii) rbg on boston ID_TGP: the threefry Trainer's init, other curves,
          a resume bitwise with the impl read back from the checkpoint;
    (iii) a 1x1 mesh under NCCL (one process): MESH_EPOCHS fp64 flagship
          epochs bitwise the run without a mesh, with the same launches;
     (iv) two ranks on the one card under gloo (`parallel/launch.py`, the
          kernels built by this process first): `mesh_runs` on dp=2 and
          ty=2, the ranks' parameters bitwise equal, each held against the
          same runs without a mesh on the card, and each rank's launches
          (1 and 1 a step) added to the counts."""
    import shutil
    import tempfile

    from tgp.pytorch_tpu_torch import bench, config as cfg
    from tgp.pytorch_tpu_torch.ops import kernels as K, rbf_gram as R
    from tgp.pytorch_tpu_torch.parallel import launch, make_mesh, multihost
    from tgp.pytorch_tpu_torch.serve import Predictor
    from tgp.pytorch_tpu_torch.train import Trainer
    from tgp.pytorch_tpu_torch.weights import tree_leaves, tree_map

    result, checks = {}, []
    counts = {"launches": 0, "bwd_launches": 0, "bwd_tile_launches": 0}
    t0 = time.perf_counter()
    plat = "gpu" if dev.type == "cuda" else "cpu"     # cpu: a rehearsal

    def stage(name):
        log(f"phase 15: {name} done at {time.perf_counter() - t0:.1f} s")

    def add(c):
        counts["launches"] += c[0]
        counts["bwd_launches"] += c[1]
        counts["bwd_tile_launches"] += c[2]

    try:
        # (i) bf16 -----------------------------------------------------------
        cfg.set_precision("bf16")
        curves = {}
        for where in ("gpu", "cpu"):
            tr = bench.flagship_trainer(dev if where == "gpu" else "cpu")
            tr.nan_guard = False
            Kxz, Kzz = K.gram_pair(tr.spec.kernel, tr.params["kernel"],
                                   tr._put(tr.train_loader.dataset.X)[None],
                                   tr.params["Z"])
            eig = float(torch.linalg.eigvalsh(Kzz.detach().double()).min())
            R.LAUNCHES = R.BWD_LAUNCHES = R.BWD_TILE_LAUNCHES = K.BF16_GRAMS = 0
            tr.train(BF16_NAN_STEPS, bench.LR, "adam", verbose_each=0)
            c = (R.LAUNCHES, R.BWD_LAUNCHES, K.BF16_GRAMS)
            tile = R.BWD_TILE_LAUNCHES
            curves[where] = np.asarray(tr.loss_curve, np.float64)
            log(f"bf16 flagship on the {where}: K_zz's least eigenvalue "
                f"{eig:.4e} (bf16 operands), ELBO {curves[where].tolist()}, "
                f"counts {c}")
            if where == "gpu":
                add(c[:2] + (tile,))
                checks.append((c == (BF16_NAN_STEPS,) * 3,
                               f"bf16 flagship step counts {c}"))
                result["bf16_flagship"] = dict(counts=c, K_zz_min_eig=eig,
                                               curve=curves[where].tolist())
        checks.append((np.array_equal(np.isfinite(curves["gpu"]),
                                      np.isfinite(curves["cpu"])),
                       "bf16 flagship: the card and the CPU differ in where "
                       "the ELBO is finite"))
        runs, grads = {}, {}
        for tag, d, prec in (("gpu_bf16", dev, "bf16"), ("cpu_bf16", "cpu",
                                                        "bf16"),
                             ("gpu_fp32", dev, "fp32")):
            cfg.set_precision(prec)
            tr = kin8nm_trainer(d)
            grads[tag] = first_gradient(tr)
            R.LAUNCHES = R.BWD_LAUNCHES = R.BWD_TILE_LAUNCHES = K.BF16_GRAMS = 0
            t1 = time.perf_counter()
            tr.train(BF16_EPOCHS, bench.LR, "adam", verbose_each=0)
            if torch.device(d).type == "cuda":
                torch.cuda.synchronize()
            wall = time.perf_counter() - t1
            c = (R.LAUNCHES, R.BWD_LAUNCHES, K.BF16_GRAMS)
            tile = R.BWD_TILE_LAUNCHES
            runs[tag] = trainer_values(tr)
            log(f"kin8nm {tag}: {BF16_EPOCHS} epochs in {wall:.3f} s, "
                f"counts {c}, ELBO {runs[tag]['curve'][0]:.6f} -> "
                f"{runs[tag]['curve'][-1]:.6f}")
            checks.append((all(np.isfinite(v).all()
                               for v in runs[tag].values()),
                           f"kin8nm {tag}: finite"))
            if tag.startswith("gpu"):
                add(c[:2] + (tile,))
                want = (BF16_EPOCHS, BF16_EPOCHS,
                        BF16_EPOCHS if prec == "bf16" else 0)
                checks.append((c == want, f"kin8nm {tag}: counts {c}"))
            if tag == "gpu_bf16":
                served = tr
        grad_gaps = rel_gaps(grads["gpu_bf16"], grads["cpu_bf16"])
        hold_gaps(grad_gaps, BF16_GRAD_LIMITS,
                  "kin8nm bf16 first gradient card vs CPU", checks)
        grad32 = rel_gaps(grads["gpu_bf16"], grads["gpu_fp32"])
        log("kin8nm bf16 first gradient against the card's fp32 one "
            "(logged): " + ", ".join(f"{k} {v:.3e}" for k, v in
                                     grad32.items()))
        gaps = rel_gaps(runs["gpu_bf16"], runs["cpu_bf16"])
        hold_gaps({k: gaps[k] for k in BF16_LIMITS}, BF16_LIMITS,
                  "kin8nm bf16 card vs CPU", checks)
        hold_gaps({k: v for k, v in gaps.items() if k not in BF16_LIMITS},
                  None, f"kin8nm bf16 card vs CPU after {BF16_EPOCHS} "
                  "epochs (logged)", checks)
        e0 = [runs[k]["curve"][0] for k in ("gpu_bf16", "cpu_bf16")]
        first = abs(e0[0] - e0[1]) / abs(e0[1])
        log(f"kin8nm bf16 first ELBO, card vs CPU: {first:.3e} (limit "
            f"{BF16_FIRST_ELBO_LIMIT})")
        checks.append((first <= BF16_FIRST_ELBO_LIMIT,
                       f"kin8nm bf16 first ELBO: {first}"))
        gaps["first_elbo"] = first
        to32 = rel_gaps(runs["gpu_bf16"], runs["gpu_fp32"])
        log("kin8nm bf16 against the card's fp32 run (logged): "
            + ", ".join(f"{k} {v:.3e}" for k, v in to32.items()))
        result["bf16_kin8nm"] = dict(gaps=gaps, to_fp32=to32,
                                     grad_gaps=grad_gaps, grad_to_fp32=grad32)
        cfg.set_precision("bf16")
        pred = Predictor(served.spec,
                         tree_map(lambda t: t.detach(), served.params),
                         buckets=(256, 4096), device=dev)
        X = served.train_loader.dataset.X
        serve = {}
        for n, want in ((200, (0, 0, 2)), (3000, (1, 0, 1))):
            R.LAUNCHES = R.BWD_LAUNCHES = R.BWD_TILE_LAUNCHES = K.BF16_GRAMS = 0
            out = pred.predict(X[:n])
            c = (R.LAUNCHES, R.BWD_LAUNCHES, K.BF16_GRAMS)
            tile = R.BWD_TILE_LAUNCHES
            add(c[:2] + (tile,))
            serve[n] = c
            checks.append((c == want and np.isfinite(out["mean"]).all(),
                           f"bf16 request of {n} rows: counts {c}"))
        log(f"bf16 serving (kin8nm, M=100): counts (launches, backward, "
            f"bf16 Grams) at bucket 256 {serve[200]}, at 4096 {serve[3000]}")
        result["bf16_serving"] = {str(k): v for k, v in serve.items()}
        if plat == "gpu":
            # K_zz (100 x 100, Dx=4): the bf16 route against the fp32 kernel
            cfg.set_precision("bf16")
            tr = bench.flagship_trainer(dev)
            ls, ks = K._rbf_leaf(tr.spec.kernel, tr.params["kernel"],
                                 tr.params["Z"])
            Zs = (tr.params["Z"] / ls).detach().contiguous()
            ks = ks.detach()
            kzz = {"bf16_route": graph_ms(lambda: K._rbf(Zs, Zs, ks)),
                   "fp32_kernel": graph_ms(lambda: R.rbf_gram(Zs, Zs, ks))}
            R.LAUNCHES = K.BF16_GRAMS = 0
            log(f"K_zz 100x100: bf16 route {kzz['bf16_route'] * 1e3:.2f} us, "
                f"the fp32 kernel {kzz['fp32_kernel'] * 1e3:.2f} us")
            # a step's time: the flagship (its bf16 ELBO is NaN) and kin8nm
            steps = {}
            for name, make in (("flagship", bench.flagship_trainer),
                               ("kin8nm", kin8nm_trainer)):
                for prec in ("bf16", "fp32"):
                    cfg.set_precision(prec)
                    tr = make(dev)
                    tr.nan_guard = False
                    steps[f"{name}_{prec}"] = step_timing(
                        tr, prec, f"{name} {prec}")["step_ms"]
            result["bf16_timing"] = dict(K_zz_ms=kzz, step_ms=steps)
        cfg.set_precision("fp32")
        stage("bf16")

        # (ii) rbg -----------------------------------------------------------
        cfg.set_precision("fp32")
        trs = {}
        for impl in ("threefry2x32", "rbg"):
            cfg.set_rng_impl(impl)
            trs[impl] = boston_id(dev, 5)
        init_same = all(torch.equal(a, b) for a, b in zip(
            tree_leaves(trs["rbg"].params),
            tree_leaves(trs["threefry2x32"].params)))
        for impl, tr in trs.items():
            R.LAUNCHES = R.BWD_LAUNCHES = R.BWD_TILE_LAUNCHES = 0
            tr.train(RBG_STEPS, 0.01, "adam", verbose_each=0)
            add((R.LAUNCHES, R.BWD_LAUNCHES, R.BWD_TILE_LAUNCHES))
            checks.append(((R.LAUNCHES, R.BWD_LAUNCHES)
                           == (RBG_STEPS, RBG_STEPS),
                           f"rbg phase {impl}: counts"))
        ca = np.asarray(trs["rbg"].loss_curve, np.float64)
        cb = np.asarray(trs["threefry2x32"].loss_curve, np.float64)
        differ = not np.allclose(ca, cb)
        ck = tempfile.mkdtemp(prefix="rbg-", dir=str(HERE / "build"))
        try:
            cfg.set_rng_impl("rbg")
            a = boston_id(dev, 5)
            a.train(RBG_STEPS // 2, 0.01, "adam", verbose_each=0)
            a.save(ck)
            cfg.set_rng_impl("threefry2x32")
            b = boston_id(dev, 99)
            b.restore(ck)
            impl_back = b.rng_impl
            R.LAUNCHES = R.BWD_LAUNCHES = R.BWD_TILE_LAUNCHES = 0
            for t in (a, b):
                t.train(RBG_STEPS // 2, 0.01, "adam", verbose_each=0)
            add((R.LAUNCHES, R.BWD_LAUNCHES, R.BWD_TILE_LAUNCHES))
        finally:
            shutil.rmtree(ck, ignore_errors=True)
        resumed = all(torch.equal(x, y) for x, y in zip(
            tree_leaves(a.params), tree_leaves(b.params)))
        log(f"rbg boston ID_TGP: init the threefry Trainer's {init_same}; "
            f"curves differ {differ} (ELBO {ca[-1]:.4f} rbg, {cb[-1]:.4f} "
            f"threefry); resume bitwise {resumed}, impl read back "
            f"{impl_back!r}")
        checks.append((init_same and differ and resumed and impl_back == "rbg",
                       "rbg: init, streams, resume or impl"))
        result["rbg"] = dict(init_same=init_same, curves_differ=differ,
                             resume_bitwise=resumed, impl=impl_back,
                             elbo=[float(ca[-1]), float(cb[-1])])
        stage("rbg")

        # (iii) a 1x1 mesh under NCCL ----------------------------------------
        cfg.set_rng_impl("threefry2x32")
        cfg.set_precision("fp64")
        store = tempfile.mkdtemp(prefix="mesh-", dir=str(HERE / "build"))
        multihost.initialize(f"file://{store}/store", 1, 0, platform=plat)
        try:
            mesh = make_mesh(1, 1)
            backend = torch.distributed.get_backend()
            one = {}
            for tag, m in (("plain", None), ("mesh", mesh)):
                tr = bench.flagship_trainer(dev)
                if m is not None:
                    tr = Trainer(tr.spec, tr.params,
                                 [tr.train_loader, tr.test_loader], tr.Y_std,
                                 mesh=m)
                R.LAUNCHES = R.BWD_LAUNCHES = R.BWD_TILE_LAUNCHES = 0
                tr.train(MESH_EPOCHS, bench.LR, "adam", verbose_each=0)
                one[tag] = (tr, (R.LAUNCHES, R.BWD_LAUNCHES,
                                 R.BWD_TILE_LAUNCHES))
                add(one[tag][1])
        finally:
            multihost.shutdown()
            shutil.rmtree(store, ignore_errors=True)
            cfg.set_precision("fp32")
        same = all(torch.equal(x, y) for x, y in zip(
            tree_leaves(one["plain"][0].params),
            tree_leaves(one["mesh"][0].params)))
        log(f"1x1 mesh ({backend}): {MESH_EPOCHS} fp64 flagship epochs "
            f"bitwise the run without a mesh: {same}; counts "
            f"{one['mesh'][1]} (without {one['plain'][1]})")
        checks.append((same and backend == ("nccl" if plat == "gpu" else
                                            "gloo") and one["mesh"][1]
                       == one["plain"][1]
                       and one["plain"][1][:2] == (MESH_EPOCHS, MESH_EPOCHS),
                       "1x1 NCCL mesh: not bitwise, or other counts"))
        result["mesh_1x1"] = dict(backend=backend, bitwise=same,
                                  counts=one["mesh"][1])
        stage("the 1x1 NCCL mesh")

        # (iv) two ranks on the card under gloo ------------------------------
        work = tempfile.mkdtemp(prefix="ranks-", dir=str(HERE / "build"))
        try:
            built = R.build() if plat == "gpu" else ""
            log(f"kernels built by the parent before the ranks start: "
                f"{'rebuilt' if built else 'current'} "
                f"({', '.join(str(lib) for _, lib in R._UNITS)})")
            t1 = time.perf_counter()
            ranks = launch.run_ranks(2, "chip_smoke:_mesh_rank",
                                     {"workdir": work}, platform=plat,
                                     backend="gloo", timeout=600,
                                     workdir=work)
            ranks_s = time.perf_counter() - t1
            z = np.load(os.path.join(work, "mesh_values.npz"))
            mesh_vals = {}
            for key in z.files:
                run, n = key.split("|", 1)
                mesh_vals.setdefault(run, {})[n] = z[key]
        finally:
            shutil.rmtree(work, ignore_errors=True)
        log(f"two gloo ranks on the card: {ranks_s:.1f} s, " + json.dumps(ranks))
        single = mesh_runs(dev)
        steps = {"dp": MESH_EPOCHS * 9, "ty": MESH_EPOCHS,
                 "battery": MESH_EPOCHS}
        result["ranks"] = dict(seconds=ranks_s, ranks=ranks, gaps={})
        for run in ("dp", "ty", "battery"):
            bit = ranks[0][run]["md5"] == ranks[1][run]["md5"]
            checks.append((bit, f"gloo ranks: {run} parameters differ "
                                f"between the ranks"))
            for r in ranks:
                add(r[run]["counts"])
                checks.append((tuple(r[run]["counts"][:2])
                               == (steps[run], steps[run]),
                               f"gloo {run}: a rank's counts {r[run]['counts']}"))
            gaps = rel_gaps(mesh_vals[run], single[run][0])
            hold_gaps(gaps, None if MESH_LIMITS is None else MESH_LIMITS[run],
                      f"mesh {run} vs one process", checks)
            result["ranks"]["gaps"][run] = gaps
            add(single[run][1])
        stage("two gloo ranks")
    finally:
        cfg.set_precision("fp32")
        cfg.set_rng_impl("threefry2x32")
    result.update(**counts)
    for cond, msg in checks:
        check(cond, msg)
    return result


# ---------------------------------------------------------------------------
# phase 16: the library surface (the top-level names, TGP, both examples)
# ---------------------------------------------------------------------------

QS_EPOCHS = 2000          # the JAX quickstart's own length (not cut)
QS_HELD_EPOCHS = 30       # its fp64 runs, card against CPU
DEEP_EX_EPOCHS = 300      # the deep example's, of its 1500
DEEP_EX_EARLY = 30        # its shallow SVGP, held card against CPU
# `examples/quickstart.py` (the JAX package, JAX 0.9.0) on an Intel Xeon
# CPU, fp32, 2000 epochs: test logL -2.304 (printed to 3 decimals); the port's
# full-length test NLL must lie within 0.02 of it (PERF.md's boston rule)
JAX_QS_NLL = 2.304
QS_NLL_BAND = 0.02
# The quickstart's fp64 run after QS_HELD_EPOCHS epochs and the deep
# example's shallow SVGP (fp64) after DEEP_EX_EARLY, card against CPU,
# relative to the group's largest entry in the CPU's run: 10x the gaps
# measured on an NVIDIA H100 80GB HBM3 at 700 W, floored at 10 rounding
# units.  The shallow SVGP is chaotic later on: after 300 epochs the
# card's gaps (Z 5.6e-2, test logL 0.63 of its largest entry) were those of
# the CPU's start moved by 1e-15 (3.9e-2, 0.093), so it is held after
# DEEP_EX_EARLY, where the card lies as far from the CPU as that moved
# start (the curve 4.6e-6 against 2.6e-6, logged), within these limits.
QS_LIMITS = {
    "curve": 7.9e-9, "kld": 3.2e-10, "Z": 8.0e-8, "flow": 4.4e-7,
    "kernel/child/raw_lengthscale": 1.6e-9, "kernel/raw_outputscale": 1.1e-9,
    "likelihood/log_var_noise": 1.2e-10, "q_L": 2.6e-7, "q_mu": 6.2e-7,
    "train/logL": 1.1e-7, "train/rmse": 1.6e-8, "test/logL": 8.4e-8,
    "test/rmse": 6.2e-8}
DEEP_EX_LIMITS = {
    "curve": 4.7e-5, "kld": 9.4e-7, "Z": 9.7e-6,
    "kernel/child/raw_lengthscale": 5.0e-5, "kernel/raw_outputscale": 2.6e-7,
    "likelihood/log_var_noise": 4.9e-7, "q_L": 1.5e-4, "q_mu": 1.4e-5,
    "test/logL": 6.4e-5, "test/rmse": 2.1e-5}


def qs_values(res):
    """The quickstart run's curves, trained leaves and logL / RMSE on both
    splits (coverage draws from each device's own generator), fp64 on the
    host."""
    tr = res["trainer"]
    out = {"curve": np.asarray(tr.loss_curve, np.float64),
           "kld": np.asarray(tr.kld_curve, np.float64)}
    out.update((n, t.detach().double().cpu().numpy())
               for n, t in named_leaves(tr.params))
    for split in ("train", "test"):
        for k in ("logL", "rmse"):
            out[f"{split}/{k}"] = np.asarray(res["metrics"][split][k],
                                             np.float64)
    return out


def deep_ex_values(res):
    """The deep example's shallow SVGP (`deep_tgp.shallow`'s result): its
    curves, leaves and test logL / RMSE."""
    tr = res["trainer"]
    out = {"curve": np.asarray(tr.loss_curve, np.float64),
           "kld": np.asarray(tr.kld_curve, np.float64)}
    out.update((n, t.detach().double().cpu().numpy())
               for n, t in named_leaves(tr.params))
    for k in ("logL", "rmse"):
        out[f"test/{k}"] = np.asarray(res["metrics"][k], np.float64)
    return out


def _example_job(which, epochs, init_rel=0.0):
    """An example's run on the CPU in fp64 in a worker process (two torch
    threads, its printing kept out of the log): the quickstart's or the
    deep example's shallow SVGP's values; with `init_rel`, every initial parameter that
    `init_tgp_params` returns is scaled by (1 + init_rel)."""
    import contextlib
    import io

    import tgp.pytorch_tpu_torch.models as MM
    from tgp.pytorch_tpu_torch import config as cfg
    from tgp.pytorch_tpu_torch.examples import deep_tgp, quickstart
    from tgp.pytorch_tpu_torch.models import tgp as M
    from tgp.pytorch_tpu_torch.weights import tree_map

    torch.set_num_threads(2)
    init = M.init_tgp_params
    if init_rel:
        def moved(*a, **k):
            return tree_map(lambda t: t * (1 + init_rel), init(*a, **k))
        M.init_tgp_params = MM.init_tgp_params = moved
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            if which == "quickstart":
                return qs_values(quickstart.run(
                    epochs, "cpu", precision="fp64", verbose_each=0,
                    checkpoint_dir=str(HERE / "build" / "qs_cpu_ckpt")))
            cfg.set_precision("fp64")
            return deep_ex_values(deep_tgp.shallow(epochs, "cpu"))
    finally:
        M.init_tgp_params = MM.init_tgp_params = init


def surface_api_phase(dev):
    """The JAX package's library surface through the port's public names,
    on the card:
      (i) the quickstart (`examples.quickstart.run`, the JAX example's
          model through `tgp.pytorch_tpu_torch`'s top-level names: boston
          split 1, SAL(2), scale-RBF, M=50 from k-means with n_init=10,
          100 Gauss-Hermite nodes, fp32) for its full QS_EPOCHS: the counts
          from 0 over the run, 1 forward launch and 1 backward call a step,
          2 forward an evaluation batch (train, test), 1 for the served
          request; the request again alone (1 and 0); the checkpoint's
          params and JSON spec read back bitwise; `TGP`'s five methods
          bitwise the functional calls, one forward launch each; the test
          NLL within QS_NLL_BAND of the JAX quickstart's;
     (ii) the quickstart in fp64 for QS_HELD_EPOCHS on the card against the
          CPU (a worker), beside the CPU's run from a start moved by 1e-15;
    (iii) the deep example (`examples.deep_tgp.run`, fp64) for
          DEEP_EX_EPOCHS: 1 and 1 a shallow SVGP step, L=2 and 2 a deep
          step, 2 forward an evaluation batch of each (train, test); the
          deep layer finite; its shallow SVGP (no draws,
          `deep_tgp.shallow`) trained alone for DEEP_EX_EARLY epochs, held
          against the CPU's, beside the CPU's from a moved start."""
    import multiprocessing
    import shutil
    from concurrent.futures import ProcessPoolExecutor

    from tgp.pytorch_tpu_torch import TGP
    from tgp.pytorch_tpu_torch import config as cfg
    from tgp.pytorch_tpu_torch.examples import deep_tgp, quickstart
    from tgp.pytorch_tpu_torch.models import tgp as M
    from tgp.pytorch_tpu_torch.models.serialization import spec_from_json
    from tgp.pytorch_tpu_torch.ops import rbf_gram as R
    from tgp.pytorch_tpu_torch.train.checkpoint import load_checkpoint
    from tgp.pytorch_tpu_torch.weights import tree_leaves

    result, checks = {}, []
    counts = {"launches": 0, "bwd_launches": 0, "bwd_tile_launches": 0}
    t0 = time.perf_counter()

    def stage(name):
        log(f"phase 16: {name} done at {time.perf_counter() - t0:.1f} s")

    def add(c):
        counts["launches"] += c[0]
        counts["bwd_launches"] += c[1]
        counts["bwd_tile_launches"] += c[2]

    ck_dir = HERE / "build" / "quickstart_ckpt"
    shutil.rmtree(ck_dir, ignore_errors=True)
    with ProcessPoolExecutor(
            max_workers=2, mp_context=multiprocessing.get_context("spawn")) as pool:
        cpu = {"quickstart": {r: pool.submit(_example_job, "quickstart",
                                             QS_HELD_EPOCHS, rel)
                              for r, rel in (("cpu64", 0.0),
                                             ("cpu64_ulp", ULP_REL))},
               "deep": {r: pool.submit(_example_job, "deep", DEEP_EX_EARLY,
                                       rel)
                        for r, rel in (("cpu64", 0.0),
                                       ("cpu64_ulp", ULP_REL))}}
        try:
            # (i) the quickstart, full width and length, fp32
            t1 = time.perf_counter()
            # --- the main path: counts from 0 -----------------------------
            R.LAUNCHES = R.BWD_LAUNCHES = R.BWD_TILE_LAUNCHES = 0
            qs = quickstart.run(QS_EPOCHS, dev, checkpoint_dir=str(ck_dir))
            c = (R.LAUNCHES, R.BWD_LAUNCHES, R.BWD_TILE_LAUNCHES)
            # --------------------------------------------------------------
            qs_s = time.perf_counter() - t1
            add(c)
            want = (QS_EPOCHS + 2 * 2 + 1, QS_EPOCHS)
            checks.append((c[:2] == want, f"quickstart: counts {c}, want {want}"))
            R.LAUNCHES = R.BWD_LAUNCHES = R.BWD_TILE_LAUNCHES = 0
            again = qs["predictor"].predict(qs["data"]["X_tr"][:10],
                                            samples=100)
            req = (R.LAUNCHES, R.BWD_LAUNCHES, R.BWD_TILE_LAUNCHES)
            add(req)
            checks.append((req[:2] == (1, 0), f"quickstart request: {req}"))
            checks.append((all(np.isfinite(v).all() for v in again.values()),
                           "quickstart request: finite"))
            params, _, step, extra = load_checkpoint(str(ck_dir))
            ck_same = (step == QS_EPOCHS and all(
                torch.equal(a, b.detach().cpu()) for a, b in
                zip(tree_leaves(params), tree_leaves(qs["trainer"].params)))
                and spec_from_json(extra["spec"]) == qs["spec"])
            checks.append((ck_same, "quickstart: the checkpoint differs"))
            nll = -float(qs["metrics"]["test"]["logL"][0])
            log(f"quickstart on the card, {QS_EPOCHS} epochs fp32 in "
                f"{qs_s:.1f} s: test NLL {nll:.4f} (the JAX quickstart "
                f"{JAX_QS_NLL} on a CPU), RMSE "
                f"{float(qs['metrics']['test']['rmse'][0]):.4f}, coverage "
                f"{float(qs['metrics']['test']['coverage'][0]):.4f}; counts "
                f"{c}; a request {req}; checkpoint bitwise {ck_same}")
            checks.append((np.isfinite(nll) and abs(nll - JAX_QS_NLL)
                           <= QS_NLL_BAND,
                           f"quickstart test NLL {nll} against JAX's "
                           f"{JAX_QS_NLL}"))
            # TGP's five methods on the trained model, one launch each
            model = TGP(qs["spec"], {k: v for k, v in
                                     qs["trainer"].params.items()})
            d = qs["data"]
            Xd = torch.as_tensor(d["X_tr"], dtype=torch.float32, device=dev)
            Yd = torch.as_tensor(d["Y_tr"], dtype=torch.float32, device=dev)
            Ys = torch.as_tensor(d["Y_std"], dtype=torch.float32, device=dev)
            calls = {"elbo": (Xd, Yd), "marginal_qf": (Xd,),
                     "predictive_distribution": (Xd,),
                     "test_log_likelihood": (Xd, Yd, Ys),
                     "sample_predictive": (Xd, 100)}
            wrap = {}
            with torch.no_grad():
                for name, args in calls.items():
                    outs, cs = [], []
                    for fn in (getattr(model, name), lambda *a: getattr(
                            M, name)(model.spec, model.params, *a)):
                        extra_args = ((torch.Generator(device=dev)
                                       .manual_seed(7),)
                                      if name == "sample_predictive" else ())
                        R.LAUNCHES = R.BWD_LAUNCHES = R.BWD_TILE_LAUNCHES = 0
                        o = fn(*args, *extra_args)
                        cs.append((R.LAUNCHES, R.BWD_LAUNCHES,
                                   R.BWD_TILE_LAUNCHES))
                        add(cs[-1])
                        outs.append(o if isinstance(o, tuple) else (o,))
                    same = all(torch.equal(a, b) for a, b in zip(*outs))
                    wrap[name] = dict(bitwise=same, counts=cs[0])
                    checks.append((same and [c[:2] for c in cs]
                                   == [(1, 0), (1, 0)],
                                   f"TGP.{name}: bitwise {same}, counts {cs}"))
            log(f"TGP's methods on the card against the functional calls: "
                f"{wrap}")
            result["quickstart"] = dict(
                epochs=QS_EPOCHS, seconds=qs_s, counts=c, request=req,
                test_nll=nll, jax_nll=JAX_QS_NLL,
                rmse=float(qs["metrics"]["test"]["rmse"][0]),
                coverage=float(qs["metrics"]["test"]["coverage"][0]),
                checkpoint_bitwise=ck_same, tgp_methods=wrap)
            stage("the quickstart")

            # (ii) the quickstart in fp64 against the CPU
            R.LAUNCHES = R.BWD_LAUNCHES = R.BWD_TILE_LAUNCHES = 0
            q64 = quickstart.run(QS_HELD_EPOCHS, dev, precision="fp64",
                                 checkpoint_dir=str(ck_dir), verbose_each=0)
            c64 = (R.LAUNCHES, R.BWD_LAUNCHES, R.BWD_TILE_LAUNCHES)
            add(c64)
            checks.append((c64[:2] == (QS_HELD_EPOCHS + 5, QS_HELD_EPOCHS),
                           f"quickstart fp64: counts {c64}"))
            qvals = {"gpu64": qs_values(q64)}
            stage("the quickstart in fp64")

            # (iii) the deep example
            t1 = time.perf_counter()
            # --- the main path: counts from 0 -----------------------------
            R.LAUNCHES = R.BWD_LAUNCHES = R.BWD_TILE_LAUNCHES = 0
            dx = deep_tgp.run(DEEP_EX_EPOCHS, dev)
            cd = (R.LAUNCHES, R.BWD_LAUNCHES, R.BWD_TILE_LAUNCHES)
            # --------------------------------------------------------------
            dx_s = time.perf_counter() - t1
            R.LAUNCHES = R.BWD_LAUNCHES = R.BWD_TILE_LAUNCHES = 0
            early = deep_tgp.shallow(DEEP_EX_EARLY, dev)
            ce = (R.LAUNCHES, R.BWD_LAUNCHES, R.BWD_TILE_LAUNCHES)
            E = DEEP_EX_EPOCHS
            for c, want, what in (
                    (cd, (E + 2 * E + 2 * 2 + 2 * 2, E + 2 * E),
                     f"deep example, {E} epochs"),
                    (ce, (DEEP_EX_EARLY + 2 * 2, DEEP_EX_EARLY),
                     f"its shallow SVGP, {DEEP_EX_EARLY} epochs")):
                add(c)
                checks.append((c[:2] == want, f"{what}: counts {c}, want {want}"))
            dm = dx["deep"]["metrics"]
            finite = (np.isfinite(dx["deep"]["trainer"].loss_curve).all()
                      and all(np.isfinite(v).all() for v in dm.values()))
            checks.append((finite, "deep example: the deep layer not finite"))
            log(f"deep example on the card, {E} epochs fp64 in {dx_s:.1f} s: "
                f"shallow SVGP test logL "
                f"{float(dx['shallow']['metrics']['logL'][0]):+.4f}, 2-layer "
                f"deep {float(dm['logL'][0]):+.4f}; counts {cd}")
            dvals = {"gpu64": deep_ex_values(early)}
            result["deep_example"] = dict(
                epochs=E, seconds=dx_s, counts=cd, shallow_counts=ce,
                shallow_logL=float(dx["shallow"]["metrics"]["logL"][0]),
                deep_logL=float(dm["logL"][0]))
            stage("the deep example")
        finally:
            cfg.set_precision("fp32")
        qvals.update((r, f.result()) for r, f in cpu["quickstart"].items())
        dvals.update((r, f.result()) for r, f in cpu["deep"].items())
    shutil.rmtree(ck_dir, ignore_errors=True)
    shutil.rmtree(HERE / "build" / "qs_cpu_ckpt", ignore_errors=True)
    pairs = {"gpu64_vs_cpu64": ("gpu64", "cpu64"),
             "cpu64_ulp_vs_cpu64": ("cpu64_ulp", "cpu64")}
    result["gaps"] = {
        "quickstart": held_gaps(
            qvals, pairs, exp_group,
            {"gpu64_vs_cpu64": QS_LIMITS} if QS_LIMITS else {},
            f"quickstart {QS_HELD_EPOCHS} epochs", checks,
            logged=("cpu64_ulp_vs_cpu64",) + (() if QS_LIMITS else
                                              ("gpu64_vs_cpu64",))),
        "deep_example": held_gaps(
            dvals, pairs, exp_group,
            {"gpu64_vs_cpu64": DEEP_EX_LIMITS} if DEEP_EX_LIMITS else {},
            f"deep example's SVGP {DEEP_EX_EARLY} epochs", checks,
            logged=("cpu64_ulp_vs_cpu64",) + (() if DEEP_EX_LIMITS else
                                              ("gpu64_vs_cpu64",)))}
    result.update(**counts)
    for cond, msg in checks:
        check(cond, msg)
    return result


def kmeans_timing(rows=AIR_ROWS, M=100, n_init=10):
    """The experiment CLI's k-means (`data.kmeans_centers(X_tr, M,
    n_init=10)`) over load_airline's training rows of a synthetic
    airline.csv, timed on the host CPU: a JSON line after each of the
    n_init runs (its Lloyd iterations and seconds) and one for the whole.

        python -c "import chip_smoke as c; c.kmeans_timing()"
    """
    import os
    import shutil

    from tgp.pytorch_tpu_torch import config as cfg
    from tgp.pytorch_tpu_torch.data import kmeans, large

    root = HERE / "build" / "kmeans_root"
    d = root / "regression" / "airline"
    d.mkdir(parents=True, exist_ok=True)
    try:
        write_table(d / "airline.csv", airline_table(rows), ["%.6f"] * 9)
        X = large.load_airline(seed=1, data_dir=str(d))["X_tr"]
    finally:
        shutil.rmtree(root, ignore_errors=True)
    iters, runs = [0], []
    step, single = kmeans._lloyd_step, kmeans._kmeans_single

    def counted_step(*a):
        iters[0] += 1
        return step(*a)

    def timed_single(*a):
        t0, i0 = time.perf_counter(), iters[0]
        out = single(*a)
        runs.append(dict(run=len(runs), lloyd_iterations=iters[0] - i0,
                         seconds=time.perf_counter() - t0, inertia=out[1]))
        print(json.dumps(runs[-1]), flush=True)
        return out

    kmeans._lloyd_step, kmeans._kmeans_single = counted_step, timed_single
    try:
        t0 = time.perf_counter()
        kmeans.kmeans_centers(X, M, n_init=n_init, seed=cfg.config_seed)
        s = time.perf_counter() - t0
    finally:
        kmeans._lloyd_step, kmeans._kmeans_single = step, single
    rec = dict(rows=int(X.shape[0]), Dx=int(X.shape[1]), M=M, n_init=n_init,
               seconds=s, lloyd_iterations=iters[0],
               cpu_count=os.cpu_count())
    print(json.dumps(rec), flush=True)
    return rec


# Phases 9, 11, 12 and 16 run in a second process beside the main sequence's
# phases 6-8 and 10 onwards: the script is bound by the host (Python's
# launches, the CPU references, fits and k-means), and on a slow host the
# phases one after another took 1312 s of the 1200 s it may take.  Each
# phase's launch counts are its own process's; its CPU references' bits do
# not depend on the load: each worker fixes torch's thread count.  Timings
# taken while both run share the host.
SIDE_PHASES = ("classification", "deep and natgrad", "battery",
               "library surface")


def _side_main(out_path, *names) -> int:
    """The phases `names` on the card in this process, their results and
    seconds written to out_path as JSON; a failed check raises (non-zero
    exit)."""
    from tgp.pytorch_tpu_torch import config as cfg

    cfg.set_precision("fp32")
    dev = torch.device("cuda", 0)
    fns = {"classification": classification_phase,
           "deep and natgrad": deep_natgrad_phase, "battery": battery_phase,
           "library surface": surface_api_phase}
    results, seconds = {}, {}
    for name in names:
        t = time.perf_counter()
        results[name] = fns[name](dev)
        seconds[name] = round(time.perf_counter() - t, 1)
        log(f"{name} phase {seconds[name]:.1f} s (beside the main sequence)")
    Path(out_path).write_text(json.dumps(dict(results=results,
                                              seconds=seconds),
                                         default=_jsonable))
    return 0


def _descendants(pid: int) -> list:
    """The processes below `pid`, read from /proc (children first, then
    theirs)."""
    out = []
    try:
        tids = os.listdir(f"/proc/{pid}/task")
    except OSError:
        return out
    for tid in tids:
        try:
            with open(f"/proc/{pid}/task/{tid}/children") as f:
                kids = [int(k) for k in f.read().split()]
        except OSError:
            continue
        for k in kids:
            out += [k] + _descendants(k)
    return out


class SidePhases:
    """`_side_main` of the phases `names` in a child process (`python -c`,
    from this file's directory, its output on this process's), started once
    the kernels are built; `result()` waits for it and fails if it failed,
    `stop()` ends it and the workers it spawned."""

    def __init__(self, names=SIDE_PHASES):
        (HERE / "build").mkdir(exist_ok=True)
        self.names = names
        self.path = HERE / "build" / "side_phases.json"
        self.path.unlink(missing_ok=True)
        self.proc = subprocess.Popen(
            [sys.executable, "-c", "import sys, chip_smoke as c; "
             "sys.exit(c._side_main(*sys.argv[1:]))", str(self.path),
             *names], cwd=str(HERE))

    def result(self):
        rc = self.proc.wait(timeout=1200)
        check(rc == 0, f"phases {', '.join(self.names)}: exit {rc}")
        return json.loads(self.path.read_text())

    def stop(self):
        import signal

        if self.proc.poll() is None:
            for pid in [self.proc.pid] + _descendants(self.proc.pid):
                try:
                    os.kill(pid, signal.SIGKILL)
                except ProcessLookupError:
                    pass
        self.proc.wait()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    import signal

    # a SIGTERM unwinds, so that the workers and the side process are ended
    signal.signal(signal.SIGTERM, lambda *_: sys.exit(143))
    from tgp.pytorch_tpu_torch import config as cfg
    from tgp.pytorch_tpu_torch.ops import rbf_gram as R

    cfg.set_precision("fp32")
    dev = torch.device("cuda", 0)
    smi = nvidia_smi()
    name = torch.cuda.get_device_name(0)
    log(f"device: {name}; torch {torch.__version__}, CUDA {torch.version.cuda}; "
        f"{smi}")
    cpu = host_cpu()
    log("host CPU (the CPU references): " + json.dumps(cpu))

    t0 = time.perf_counter()
    ptxas = R.build()
    build_s = time.perf_counter() - t0
    log(f"built {', '.join(lib.name for _, lib in R._UNITS)} in {build_s:.2f} s")
    for line in ptxas.splitlines():
        if "registers" in line or "Compiling entry" in line or "spill" in line:
            log("  ptxas:", line.strip())

    phase_s = {}

    def timed(tag, fn, *args):
        t1 = time.perf_counter()
        out = fn(*args)
        phase_s[tag] = round(time.perf_counter() - t1, 1)
        log(f"{tag} phase {phase_s[tag]:.1f} s")
        return out

    first = FirstCalls()
    try:
        rows, big = timed("kernel", kernel_phase, dev)
        first.check()
    finally:
        first.stop()
    serving = timed("serving", serving_phase, dev)
    serving["bayes"] = timed("Bayesian serving", bayes_serving_phase, dev)
    grad = timed("gradient", gradient_phase, dev)
    training = timed("training", training_phase, dev)
    # phases 9, 11, 12 and 16 in a second process, and phase 14's airline table
    # and k-means in a worker, beside phases 6-8, 10 and 13
    side = SidePhases()
    try:
        prep = LargePrep()
        try:
            experiment = timed("experiment", experiment_phase, dev)
            idtgp = timed("ID_TGP", id_phase, dev)
            wgp = timed("WGP", wgp_phase, dev)
            surface = timed("model surface", surface_phase, dev)
            runtime = timed("L-BFGS and runtime", runtime_phase, dev)
            large = timed("large corpora", large_phase, dev, prep)
        finally:
            prep.stop()
        last = timed("bf16, rbg and meshes", last_modules_phase, dev)
        t1 = time.perf_counter()
        beside = side.result()
        log(f"waited {time.perf_counter() - t1:.1f} s for phases "
            f"{', '.join(SIDE_PHASES)}")
    finally:
        side.stop()
    phase_s.update(beside["seconds"])
    classification, deep, battery, api = (beside["results"][n]
                                          for n in SIDE_PHASES)
    paths = (serving, serving["bayes"], grad, training, experiment, idtgp, wgp,
             classification, surface, deep, battery, runtime, large, last,
             api)

    fp32_rows = [r for r in rows if "fp32" in r["shape"]]
    train = next(r for r in rows if r["shape"] == "pair 8611+100 fp32")
    # the backward's designs on the paths `bwd_design` sends them to: the
    # flagship's fp32 pair takes the block pass, boston's and DGP-2's fp64
    # Grams (Dx = 13), the battery's R Dy = 10 and YearMSD's fp64 the tile
    # pass
    tile_calls = {tag: p["bwd_tile_launches"] for tag, p in (
        ("gradient", grad), ("training", training), ("experiment", experiment),
        ("deep and natgrad", deep), ("battery", battery), ("large corpora", large))}
    log("tile-pass calls by phase: " + json.dumps(tile_calls))
    check(tile_calls["gradient"] == 0 and tile_calls["training"] == 0,
          f"the flagship's fp32 steps went through the tile pass: {tile_calls}")
    check(all(tile_calls[k] > 0 for k in ("experiment", "deep and natgrad",
                                          "battery", "large corpora")),
          f"a path the rule gives the tile pass did not run it: {tile_calls}")
    dgp = next(r for r in rows if r["shape"] == "pair 455+100 Dy=13 Dx=13 fp64")
    tile_launches = sum(p["bwd_tile_launches"] for p in paths)
    common = dict(route="cuda", library_ms=None)
    record = {"kernels": [
        dict(name="rbf_gram", source="tgp/pytorch_tpu_torch/csrc/rbf_gram.cu",
             replaces="tgp/pytorch_tpu/ops/pallas/rbf_gram.py:85",
             launches=sum(p["launches"] for p in paths),
             max_abs_err=max(r["max_abs_err"] for r in fp32_rows + [big]),
             ms=train["ms"], plain_ms=train["plain_ms"],
             bound_ms=train["bound_ms"], bound_by=train["bound_by"], **common),
        dict(name="rbf_gram_bwd",
             source="tgp/pytorch_tpu_torch/csrc/rbf_gram_bwd.cu",
             replaces="tgp/pytorch_tpu/ops/pallas/rbf_gram.py:114",
             launches=sum(p["bwd_launches"] for p in paths) - tile_launches,
             max_abs_err=max(r["bwd_max_abs_err"] for r in fp32_rows),
             ms=train["bwd_ms"], plain_ms=train["bwd_plain_ms"],
             bound_ms=train["bwd_bound_ms"], bound_by=train["bwd_bound_by"],
             **common),
        dict(name="rbf_gram_bwd_tile",
             source="tgp/pytorch_tpu_torch/csrc/rbf_gram_bwd.cu",
             replaces="tgp/pytorch_tpu/ops/pallas/rbf_gram.py:114",
             launches=tile_launches,
             max_abs_err=max(r["tile_max_abs_err"] for r in rows
                             if r["tile_max_abs_err"] is not None),
             ms=dgp["tile_ms"], plain_ms=dgp["bwd_plain_ms"],
             bound_ms=dgp["bwd_bound_ms"], bound_by=dgp["bwd_bound_by"],
             **common),
    ]}
    out_dir = HERE / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(dict(
        device=name, nvidia_smi=smi, host_cpu=cpu, torch=torch.__version__,
        cuda=torch.version.cuda, build_s=build_s, kernel_rows=rows,
        big_gram=big, serving=serving, gradient=grad, training=training,
        experiment=experiment, id_tgp=idtgp, wgp=wgp,
        classification=classification, surface=surface, deep_natgrad=deep,
        battery=battery, runtime=runtime, large=large,
        last_modules=last, library_surface=api, phase_s=phase_s,
        record=record),
        indent=1,
        default=_jsonable))

    log("phase seconds: " + json.dumps(phase_s))
    log(smi)
    log(json.dumps(record))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--bwd-compare"]:
        sys.exit(compare_main(sys.argv[2]))
    sys.exit(main())
