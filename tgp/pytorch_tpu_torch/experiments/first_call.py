"""Does the port's CPU path give the same bits on a process's first call?

    python -m tgp.pytorch_tpu_torch.experiments.first_call \\
        [--case wgp|gram-wgp|gram-dgp|gram-lbfgs|gram-cls|vml] \\
        [--processes 200] [--parallel 5] [--threads 2] [--root DIR] \\
        [--mkl-dynamic-false]

Starts `--processes` fresh Python processes, `--parallel` at a time, each
with `torch.set_num_threads(--threads)`, as `chip_smoke.py`'s CPU workers
(`--mkl-dynamic-false` turns MKL's dynamic threading off, as the script did
until the cause was found), and in each makes the same call twice:

  * `wgp`: the CLI's first ELBO, `--model WGP --warp_arch log_exp
    --dataset boston --train_test_seed_split 1 --num_inducing 100 --epochs 1
    --precision fp32 --platform cpu`;
  * `gram-*`: the plain Gram pair (`ops.rbf_gram.rbf_gram_pair_reference`)
    on seeded inputs at the shapes and dtype of the first call that torch
    splits across threads into MKL's vector math on four of `chip_smoke.py`'s
    CPU references: `gram-wgp` (1, 455, 13) x (1, 100, 13) fp32 (WGP
    log_exp), `gram-dgp` (13, 455, 13) x (13, 100, 13) fp64 (DGP-2),
    `gram-lbfgs` (1, 8611, 4) x (1, 100, 4) fp64 (the L-BFGS flagship; its
    CPU worker runs 3 threads) and `gram-cls` (1, 1080, 4) x (1, 50, 4) fp32
    (binary TGP); the value is the md5 of K_xz.

Prints one JSON object: for the first calls and for the later calls, each
distinct value with the number of processes that gave it.  One value in
each is the port's promise; `--root` runs the port of another checkout
(its `tgp/` is imported) with this script.

`--case vml` runs one process that shows why a first call could move (an
MKL build whose VML entries read `mkl_vml_serv_cpu_detect`'s static, as
torch 2.13's x86 wheel): the static before and after the port loads, the
branch MKL detects before it maps it, the kernels that VML's exp table
gives for HA at the mapped and at the unmapped branch, and each kernel's
largest relative error against torch's exp on the plain Gram's exponent
at `gram-wgp`'s and `gram-dgp`'s shapes, and the md5 of K_xz with the
first of 2 threads' chunks on the unmapped kernel (the odd first call of
`gram-wgp` and `gram-dgp` at 2 threads, when the main thread read the
static between MKL's two stores).
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CASES = {
    # name: (Dy, N, M, Dx, dtype)
    "gram-wgp": (1, 455, 100, 13, "float32"),
    "gram-dgp": (13, 455, 100, 13, "float64"),
    "gram-lbfgs": (1, 8611, 100, 4, "float64"),
    "gram-cls": (1, 1080, 50, 4, "float32"),
}

CALLS = 2

WGP_ARGV = ["--model", "WGP", "--warp_arch", "log_exp", "--dataset", "boston",
            "--train_test_seed_split", "1", "--num_inducing", "100",
            "--epochs", "1", "--precision", "fp32", "--platform", "cpu",
            "--verbose_each", "0"]


def child(case: str, threads: int) -> None:
    """One process's calls; prints their values as a JSON list."""
    import hashlib

    import torch

    torch.set_num_threads(threads)
    if case == "vml":
        out = vml_report()
    elif case == "wgp":
        import contextlib
        import io

        from tgp.pytorch_tpu_torch.experiments import main as E

        out = []
        for _ in range(CALLS):
            with contextlib.redirect_stdout(io.StringIO()):
                run = E.run(E.parse_args(WGP_ARGV))
            out.append(repr(float(run.trainer.loss_curve[0])))
    else:
        from tgp.pytorch_tpu_torch.ops import rbf_gram as R

        X, Z, ks = inputs(case)
        out = [hashlib.md5(R.rbf_gram_pair_reference(X, Z, ks)[0].numpy()
                           .tobytes()).hexdigest() for _ in range(CALLS)]
    print(json.dumps(out), flush=True)


def inputs(case: str):
    """The seeded (X, Z, ks) of a `gram-*` case."""
    import numpy as np
    import torch

    Dy, N, M, Dx, dt = CASES[case]
    X = torch.from_numpy(np.random.RandomState(0).randn(Dy, N, Dx) / 2).to(
        getattr(torch, dt))
    return X, X[:, :M].contiguous(), torch.full((Dy,), 2.0, dtype=X.dtype)


def vml_report() -> dict:
    """See the module's docstring (`--case vml`)."""
    import ctypes
    import hashlib

    import torch

    lib = ctypes.CDLL(os.path.join(os.path.dirname(torch.__file__), "lib",
                                   "libtorch_cpu.so"))
    fn = ctypes.cast(lib.mkl_vml_serv_cpu_detect, ctypes.c_void_p).value
    code = ctypes.string_at(fn, 6)
    if code[:2] != b"\x8b\x05":                  # mov disp32(%rip), %eax
        raise RuntimeError(f"unknown mkl_vml_serv_cpu_detect: {code.hex()}")
    cell = ctypes.c_int.from_address(
        fn + 6 + int.from_bytes(code[2:], "little", signed=True))
    out = {"before_load": cell.value}
    from tgp.pytorch_tpu_torch.ops import rbf_gram as R

    out["after_load"] = mapped = cell.value
    detect = lib.mkl_serv_vml_cpu_detect
    detect.argtypes, detect.restype = [], ctypes.c_int
    out["detected"] = detected = detect()
    kernel = ctypes.CFUNCTYPE(None, ctypes.c_int64, ctypes.c_void_p,
                              ctypes.c_void_p)
    for case in ("gram-wgp", "gram-dgp"):
        X, Z, ks = inputs(case)
        x = (-0.5 * R.sq_dist(X, Z)).flatten()
        ref = torch.exp(x)
        p = "s" if x.dtype == torch.float32 else "d"
        ttab = (ctypes.c_void_p * 18).in_dll(lib, f"mkl_vml_kernel_{p}Exp_ttab")
        names = {ctypes.cast(getattr(lib, f"mkl_vml_kernel_{p}Exp_{v}"),
                             ctypes.c_void_p).value: v
                 for v in (f"{c}{a}" for c in ("EX", "E2", "H8", "L9", "Z0")
                           for a in ("HAynn", "LAynn", "EPnnn"))
                 if hasattr(lib, f"mkl_vml_kernel_{p}Exp_{v}")}
        for side, branch in (("mapped", mapped), ("unmapped", detected)):
            # VML's table index for HA (mode 2): branch + 6 * (2 - 1)
            ptr = ttab[branch + 6]
            r = torch.empty_like(x)
            kernel(ptr)(x.numel(), x.data_ptr(), r.data_ptr())
            out[f"{case} {x.dtype} {side}"] = dict(
                kernel=f"{p}Exp_{names.get(ptr, hex(ptr))}",
                max_rel_err=float(((r.double() - ref.double()).abs()
                                   / ref.double()).max()))
        half = (x.numel() + 1) // 2          # torch's first of 2 chunks
        odd = torch.cat([r[:half], ref[half:]]).reshape(
            X.shape[0], X.shape[1], Z.shape[1])
        out[f"{case} odd K_xz md5"] = hashlib.md5(
            (ks[:, None, None] * odd).numpy().tobytes()).hexdigest()
    return out


def one(root: str, args) -> list:
    env = dict(os.environ, PYTHONPATH=root)
    if args.mkl_dynamic_false:
        env["MKL_DYNAMIC"] = "FALSE"
    res = subprocess.run(
        [sys.executable, "-P", str(Path(__file__).resolve()), "--child",
         "--case", args.case, "--threads", str(args.threads)],
        cwd=root, env=env, capture_output=True, text=True, timeout=600)
    if res.returncode != 0:
        raise RuntimeError(f"a process failed ({res.returncode}):\n"
                           f"{res.stderr[-2000:]}")
    return json.loads(res.stdout.strip().splitlines()[-1])


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--case", default="wgp", choices=["wgp", *CASES, "vml"])
    p.add_argument("--processes", type=int, default=200)
    p.add_argument("--parallel", type=int, default=5)
    p.add_argument("--threads", type=int, default=2)
    p.add_argument("--root", default=str(Path(__file__).resolve().parents[3]))
    p.add_argument("--mkl-dynamic-false", action="store_true")
    p.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.child:
        child(args.case, args.threads)
        return {}
    root = str(Path(args.root).resolve())
    if args.case == "vml":
        out = one(root, args)
        print(json.dumps(out), flush=True)
        return out
    with ThreadPoolExecutor(args.parallel) as pool:
        runs = list(pool.map(lambda _: one(root, args), range(args.processes)))
    summary = dict(
        case=args.case, root=root, processes=args.processes,
        parallel=args.parallel, threads=args.threads,
        mkl_dynamic_false=args.mkl_dynamic_false,
        first=dict(collections.Counter(r[0] for r in runs)),
        later=dict(collections.Counter(v for r in runs for v in r[1:])))
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
