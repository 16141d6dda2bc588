"""Start the ranks of a mesh as local processes and collect what each
returns.

    results = run_ranks(4, "package.module:function", {"arg": 1},
                        workdir="build/ranks")

Each rank is `python -c` in a process of its own, with one math thread: it
joins the process group through a FileStore in `workdir` (no port to
race for), calls `function(**kwargs)` and prints its JSON-able result on a
line of its own.  `run_ranks` returns the results in rank order; a rank
that fails, or outlives `timeout`, raises RuntimeError with the end of its
output, and every child is killed before it returns or raises.

The ranks run on the card (`platform="gpu"`, the default), where the Gram
kernels are built by the parent before any rank starts, so that no two
ranks run nvcc into the same files; `backend="gloo"` lets the ranks share
one card.  CPU ranks (gloo) are asked for with `platform="cpu"`; without a
card and without it, `run_ranks` raises before it starts a rank.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

_PREFIX = "RANK_RESULT "

_CHILD = """
import json, sys, torch
torch.set_num_threads(1)
from tgp.pytorch_tpu_torch.parallel import multihost
a = json.loads(sys.argv[1])
multihost.initialize(a["address"], a["n"], a["rank"], platform=a["platform"],
                     backend=a["backend"])
import importlib
mod, fn = a["target"].split(":")
try:
    out = getattr(importlib.import_module(mod), fn)(**a["kwargs"])
finally:
    multihost.shutdown()
print("RANK_RESULT " + json.dumps(out), flush=True)
"""


def run_ranks(n: int, target: str, kwargs: dict | None = None, *,
              platform: str = "gpu", backend: str | None = None,
              timeout: float = 600.0, workdir: str | None = None,
              env: dict | None = None):
    """Run `target` ("module:function") on n ranks; returns their results
    in rank order (see the module's docstring).  The ranks run on the
    card unless `platform="cpu"` asks for the CPU; without a card, the
    default raises RuntimeError before any rank starts."""
    if platform == "gpu":
        import torch

        from ..ops import rbf_gram

        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass "
                               "platform='cpu' to run the ranks on the CPU")
        rbf_gram.build()
    root = str(Path(__file__).resolve().parents[3])
    work = tempfile.mkdtemp(prefix="ranks-", dir=workdir)
    address = f"file://{os.path.join(work, 'store')}"
    child_env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    child_env.update(env or {})
    child_env["PYTHONPATH"] = os.pathsep.join(
        [root] + [p for p in child_env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    procs, logs = [], []
    try:
        for r in range(n):
            arg = json.dumps(dict(address=address, n=n, rank=r,
                                  platform=platform, backend=backend,
                                  target=target, kwargs=kwargs or {}))
            log = open(os.path.join(work, f"rank{r}.log"), "w+")
            logs.append(log)
            procs.append(subprocess.Popen(
                [sys.executable, "-c", _CHILD, arg], stdout=log,
                stderr=subprocess.STDOUT, env=child_env, cwd=root))
        deadline = time.monotonic() + timeout
        while any(p.poll() is None for p in procs):
            failed = [r for r, p in enumerate(procs)
                      if p.poll() not in (None, 0)]
            if failed or time.monotonic() > deadline:
                break
            time.sleep(0.05)
        results = []
        for r, (p, log) in enumerate(zip(procs, logs)):
            log.seek(0)
            text = log.read()
            if p.poll() != 0:
                why = ("timed out" if p.poll() is None
                       else f"exit code {p.returncode}")
                raise RuntimeError(f"rank {r} of {n} ({target}) {why}:\n"
                                   f"{text[-4000:]}")
            lines = [ln for ln in text.splitlines() if ln.startswith(_PREFIX)]
            results.append(json.loads(lines[-1][len(_PREFIX):]))
        return results
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
        shutil.rmtree(work, ignore_errors=True)
