"""The control fails the comparison: the reference with the scene math's
matrix products on TF32 operands, the precision one step below the
configuration's, put in the program's place, at a size a test run holds
(on the card, bench_h100/limits.py reads it at the cells' own sizes)."""

import pytest

from bench_h100 import limits
from bench_h100.harness import check

from .conftest import cell_from_files, tiny

CELLS = {
    "cyl65536_b4_512.distant": lambda: tiny(cell_from_files(
        "cyl65536_b4_512", "distant", "cyl65536_b4_512.distant"),
        size=48, segments=64),
    "cyl65536_b4_512.deferred": lambda: tiny("cyl65536_b4_512.deferred",
                                             size=48, segments=64),
    "cyl512_b16_256.orbit": lambda: tiny(cell_from_files(
        "cyl512_b16_256", "orbit", "cyl512_b16_256.orbit"), size=48,
        segments=16),
    "cyl512_b16_256.deferred": lambda: tiny(cell_from_files(
        "cyl512_b16_256", "deferred", "cyl512_b16_256.deferred"), size=48,
        segments=16),
}


@pytest.mark.parametrize("name", sorted(CELLS))
@pytest.mark.parametrize("seed", [1, 2 ** 31 + 5, 3 * 10 ** 9])
def test_control_fails_the_cells_limits(name, seed):
    cell = CELLS[name]()
    values = limits.control_numbers(cell, seed, "cpu")
    assert not check.judge(values, cell.limits), values


def test_tf32_rounding_keeps_ten_mantissa_bits():
    import torch
    from bench_h100.reference.scene import tf32
    x = torch.tensor([1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -12, 3.14159265])
    got = tf32(x)
    assert got[0] == 1.0 and got[1] == 1.0 + 2 ** -10
    assert got[2] == 1.0                      # below TF32's last bit
    assert abs(float(got[3]) - 3.14159265) <= 2 ** -10 * 4
