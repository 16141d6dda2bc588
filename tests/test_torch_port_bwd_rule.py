"""The rule that chooses the backward kernel's design by shape
(`ops/rbf_gram.py::bwd_design`), on the CPU: a plain function of the
dtype, the shape, the SM count and the tile pass's kernel for the shape,
no card needed.  Which kernel of the tile pass takes a shape is the CUDA
source's own plan (`tile_kind`); the tests marked `cuda` hold the table
below to it on the card.

Its thresholds come from one `chip_smoke.py --bwd-compare` call on an
NVIDIA H100 80GB HBM3 (132 SMs) timing both designs at every
`KERNEL_SHAPES` shape (PERF.md, the VJP's row).  `KERNEL_SHAPES` is read
from `chip_smoke.py`'s source, not imported (the script sets process-wide
state when imported).
"""

import ast
from pathlib import Path

import pytest
import torch

from tgp.pytorch_tpu_torch.ops import rbf_gram as R

F32, F64 = torch.float32, torch.float64
SMS = 132           # the H100's SMs


def _kernel_shapes():
    src = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    tree = ast.parse(src.read_text())
    node = next(n for n in tree.body if isinstance(n, ast.Assign)
                and getattr(n.targets[0], "id", "") == "KERNEL_SHAPES")
    return eval(compile(ast.Expression(node.value), str(src), "eval"),
                {"F32": F32, "F64": F64})


# the design at each KERNEL_SHAPES shape on 132 SMs; the rest take the block
# pass (the flagship's pairs, the single Grams, kin8nm's, the CLI's M = 20,
# the protocol's, airline's M = 500)
TILE = {
    "pair 455+100 Dx=13 fp64", "pair 51+100 Dx=13 fp64",
    "pair 455+100 Dy=13 Dx=13 fp64", "pair 5100+100 Dy=13 Dx=13 fp64",
    "pair 45500+100 Dy=13 Dx=13 fp64", "pair 7373+100 Dy=8 Dx=8 fp32",
    "pair 737300+100 Dy=8 Dx=8 fp32", "pair 8611+100 Dy=10 fp32",
    "pair 455+100 Dy=10 Dx=13 fp64", "pair 10000+100 Dx=90 fp32",
    "pair 10000+100 Dx=90 fp64",
}
# the tile pass takes every KERNEL_SHAPES shape, Z whole in shared memory:
# fp64 and these fp32 shapes (Dx > 16, or airline's M = 500) with its
# fragment kernel, the other fp32 shapes with its quad kernel
FRAGMENT_FP32 = {
    "pair 10000+20 Dx=17 fp32", "pair 740+20 Dx=17 fp32",
    "pair 10000+500 Dx=8 fp32", "pair 5192+500 Dx=8 fp32",
    "pair 10000+100 Dx=90 fp32",
}
KERNEL_SHAPES = _kernel_shapes()
IDS = [s[0] for s in KERNEL_SHAPES]


def _kind(label, dtype):
    return (R.FRAGMENT if dtype == F64 or label in FRAGMENT_FP32
            else R.QUAD)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the plan is the CUDA source's")


def test_the_tables_name_kernel_shapes():
    assert (TILE | FRAGMENT_FP32) <= set(IDS)


@pytest.mark.parametrize("shape", KERNEL_SHAPES, ids=IDS)
def test_rule_at_every_kernel_shape(shape):
    label, Dy, N, M, Dx, dtype, pair = shape
    want = "tile" if label in TILE else "block"
    assert R.bwd_design(dtype, Dy, N, M, Dx, SMS, _kind(label, dtype),
                        pair) == want


@pytest.mark.parametrize("shape", KERNEL_SHAPES, ids=IDS)
def test_a_shape_the_tile_pass_refuses_takes_the_block_pass(shape):
    _, Dy, N, M, Dx, dtype, pair = shape
    assert R.bwd_design(dtype, Dy, N, M, Dx, SMS, R.REFUSED, pair) == "block"


def test_fp32_takes_the_tile_pass_past_one_wave_of_the_block_pass():
    # more than 128 rows an SM (blocks of at most 64 rows, two an SM), where
    # the quad kernel takes the shape
    for sms in (66, 132):
        edge = 128 * sms
        assert R.bwd_design(F32, 1, edge - 100, 100, 4, sms, R.QUAD) == "block"
        assert R.bwd_design(F32, 1, edge - 99, 100, 4, sms, R.QUAD) == "tile"
        assert R.bwd_design(F32, 2, edge // 2, 100, 4, sms, R.QUAD,
                            False) == "block"
        assert R.bwd_design(F32, 2, edge // 2 + 1, 100, 4, sms, R.QUAD,
                            False) == "tile"
        assert R.bwd_design(F32, 1, 4 * edge, 500, 8, sms,
                            R.FRAGMENT) == "block"


def test_the_rule_depends_on_nothing_but_its_arguments():
    args = (F64, 13, 455, 100, 13, SMS, R.FRAGMENT, True)
    assert {R.bwd_design(*args) for _ in range(3)} == {"tile"}
    assert R.bwd_design(F32, 13, 455, 100, 13, SMS, R.QUAD, True) == "block"


def test_a_cpu_tensor_never_reaches_a_design():
    X, Z = torch.zeros(1, 4, 2, dtype=F64), torch.zeros(1, 3, 2, dtype=F64)
    ks, g = torch.ones(1, dtype=F64), torch.zeros(1, 4, 3, dtype=F64)
    for design in ("block", "tile"):
        with pytest.raises(ValueError, match="CUDA"):
            R._launch_bwd(X, Z, ks, g, design=design)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", KERNEL_SHAPES, ids=IDS)
def test_tile_kind_at_every_kernel_shape(shape):
    # Z, its norms and its dZ sums stay in shared memory, not in chunks,
    # with the kernel the table above gives the rule
    _card()
    label, _, _, M, Dx, dtype, _ = shape
    assert R.tile_kind(dtype, M, Dx) == _kind(label, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype, M, Dx", [(F64, 300, 50), (F64, 500, 8),
                                          (F64, 100, 128), (F32, 2000, 4)])
def test_shapes_the_tile_pass_refuses_take_the_block_pass(dtype, M, Dx):
    _card()
    kind = R.tile_kind(dtype, M, Dx)
    assert kind == R.REFUSED
    assert R.bwd_design(dtype, 10, 100000, M, Dx, SMS, kind, True) == "block"
