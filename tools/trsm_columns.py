"""Time the port's triangular solves on the card, by the width of the
right-hand side.

`ops/linalg.tril_solve` calls cuBLAS's batched trsm
(`torch.linalg.solve_triangular`) and splits a right-hand side wider than
`linalg.TRSM_COLUMNS` columns (summed over the batch) into column blocks.
For each width n this times, on a (batch, m, n) right-hand side and a
(batch, m, m) lower-triangular factor:

  * `plain`: solve_triangular on the right-hand side as it is laid out
    (rows contiguous, as `marginal_qf` hands K_zx to the solve);
  * `transposed`: solve_triangular on a (batch, n, m) tensor's transpose
    (columns contiguous, the layout of the blocks `tril_solve` cuts);
  * `tril_solve`: the port's function, blocked where the rule says so.

Each is timed between CUDA events: once when the first call takes over a
second, else the median of 3 calls after it.  One JSON line per width, with
the card's name and power limit; `--out` writes them to a file too.

    python tools/trsm_columns.py --dtype fp32 --n 204800,409600,614400
    python tools/trsm_columns.py --dtype fp64 --n 45500,409600
"""

import argparse
import json
import pathlib
import subprocess
import sys

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from tgp.pytorch_tpu_torch.ops import linalg  # noqa: E402


def timed_ms(fn):
    def once():
        t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0.record()
        fn()
        t1.record()
        torch.cuda.synchronize()
        return t0.elapsed_time(t1)

    first = once()
    if first > 1000.0:
        return first
    return sorted(once() for _ in range(3))[1]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dtype", choices=("fp32", "fp64"), default="fp32")
    ap.add_argument("--batch", type=int, default=13)
    ap.add_argument("--m", type=int, default=100)
    ap.add_argument("--n", default="409600",
                    help="comma-separated right-hand-side widths")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("trsm_columns: no CUDA device is available", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    dtype = torch.float64 if args.dtype == "fp64" else torch.float32
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    g = torch.Generator(device=dev).manual_seed(0)
    A = torch.randn(args.batch, args.m, args.m, generator=g, device=dev,
                    dtype=dtype)
    L = torch.linalg.cholesky(A @ A.transpose(-1, -2) / args.m
                              + torch.eye(args.m, device=dev, dtype=dtype))
    torch.linalg.solve_triangular(L, L, upper=False)           # warm-up
    lines = []
    for n in (int(v) for v in args.n.split(",")):
        B = torch.randn(args.batch, args.m, n, generator=g, device=dev,
                        dtype=dtype)
        Bt = B.transpose(-1, -2).contiguous().transpose(-1, -2)
        rec = dict(dtype=args.dtype, batch=args.batch, m=args.m, n=n,
                   columns=args.batch * n, trsm_columns=linalg.TRSM_COLUMNS,
                   blocked=args.batch * n > linalg.TRSM_COLUMNS, device=smi)
        rec["plain_ms"] = timed_ms(
            lambda: torch.linalg.solve_triangular(L, B, upper=False))
        rec["transposed_ms"] = timed_ms(
            lambda: torch.linalg.solve_triangular(L, Bt, upper=False))
        rec["tril_solve_ms"] = timed_ms(lambda: linalg.tril_solve(L, B))
        print(json.dumps(rec), flush=True)
        lines.append(rec)
        del B, Bt
        torch.cuda.empty_cache()
    if args.out:
        out = pathlib.Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        with out.open("a") as f:
            f.writelines(json.dumps(r) + "\n" for r in lines)
    return 0


if __name__ == "__main__":
    sys.exit(main())
