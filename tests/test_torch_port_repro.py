"""The port's CPU path gives the same bits on a process's first call.

torch's CPU exp (and log, sqrt, erf, ...) on float and double tensors calls
MKL's vector math (VML), which takes its code branch from a static that
`mkl_vml_serv_cpu_detect` fills on first use with two stores, the branch as
detected and then the branch mapped to VML's tables.  A thread that reads
the static between the two stores runs MKL's AVX2 branch at EP accuracy
instead of the AVX-512 HA branch torch asks for.  In a fresh process the
first call that torch splits across threads is where two threads first
meet there: on the port's CPU path that is the plain Gram's exp on K_xz,
whose first chunk then came out up to 1.5e-4 off in fp32.  The port fills
the static when it loads (`config.settle_cpu_math`).

The cases run in one fresh subprocess.  It finds the static through the
first instruction of `mkl_vml_serv_cpu_detect` (a rip-relative load of it),
checks that loading the port fills it, then, trial after trial, sets it back
to -1 (a fresh process's state), loads the port's `config` again and makes
the first call: the plain Gram pair at the shapes and dtype of four of
`chip_smoke.py`'s CPU references, at their thread counts.  Every trial must
give the bits of a later call.  Without the fill at load, the fp32 cases
move in about 1 trial in 60.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from tgp.pytorch_tpu_torch import config as pcfg

ROOT = Path(__file__).resolve().parents[1]

# name: (Dy, N, M, Dx, dtype, threads, trials): boston's WGP log_exp fp32,
# the binary TGP fp32 (M=50), DGP-2 fp64 (13 outputs) and the L-BFGS
# flagship fp64 (power, 3 threads); the fp64 trials cost 12 ms each alone,
# and every trial several times that beside the suite's other workers
CASES = {
    "wgp-fp32": (1, 455, 100, 13, "float32", 2, 300),
    "binary-tgp-fp32": (1, 1080, 50, 4, "float32", 2, 300),
    "dgp2-fp64": (13, 455, 100, 13, "float64", 2, 30),
    "lbfgs-flagship-fp64": (1, 8611, 100, 4, "float64", 3, 30),
}

_CHILD = r"""
import ctypes, importlib, json, os, sys
import numpy as np
import torch

lib = ctypes.CDLL(os.path.join(os.path.dirname(torch.__file__), "lib",
                               "libtorch_cpu.so"))
fn = ctypes.cast(lib.mkl_vml_serv_cpu_detect, ctypes.c_void_p).value
code = ctypes.string_at(fn, 6)
assert code[:2] == b"\x8b\x05", code.hex()        # mov disp32(%rip), %eax
cell = ctypes.c_int.from_address(
    fn + 6 + int.from_bytes(code[2:], "little", signed=True))
out = {"before_load": cell.value}
import tgp.pytorch_tpu_torch.config as cfg
from tgp.pytorch_tpu_torch.ops import rbf_gram as R
out["after_load"] = cell.value
for name, (Dy, N, M, Dx, dt, nt, trials) in json.loads(sys.argv[1]).items():
    torch.set_num_threads(nt)
    X = torch.from_numpy(np.random.RandomState(0).randn(Dy, N, Dx) / 2).to(
        getattr(torch, dt))
    Z, ks = X[:, :M].contiguous(), torch.full((Dy,), 2.0, dtype=X.dtype)
    R.rbf_gram_pair_reference(X, Z, ks)
    ref = R.rbf_gram_pair_reference(X, Z, ks)[0]
    moved = 0
    for _ in range(trials):
        cell.value = -1                  # MKL's static as in a fresh process
        importlib.reload(cfg)            # the port loading
        moved += not torch.equal(R.rbf_gram_pair_reference(X, Z, ks)[0], ref)
    out[name] = moved
print(json.dumps(out))
"""


@pytest.fixture(autouse=True)
def _port_state():
    """The cases run in a subprocess: torch's thread count and the port's
    precision here stay as they were."""
    prev, nt = pcfg.precision(), torch.get_num_threads()
    yield
    pcfg.set_precision(prev)
    torch.set_num_threads(nt)


@pytest.fixture(scope="module")
def child():
    res = subprocess.run(
        [sys.executable, "-c", _CHILD, json.dumps(CASES)], cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(ROOT)),
        capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


def test_loading_the_port_fills_mkls_branch_cache(child):
    assert child["before_load"] == -1       # importing torch leaves it empty
    assert child["after_load"] != -1


@pytest.mark.parametrize("case", list(CASES))
def test_first_call_gives_the_bits_of_later_calls(child, case):
    trials = CASES[case][-1]
    assert child[case] == 0, (
        f"{case}: the first call after a fresh load moved in {child[case]} "
        f"of {trials} trials")
