"""The control of each cell, the reference in the precision below the one
its configuration states (``control``: fp8 below bf16, TF32 below fp32)
put in the program's place, comes out not correct, while the program
passes. On the CPU at tiny widths (the program in fp32 there); on the card
(``cuda`` marker) at the cell's own size on three seeds."""

from __future__ import annotations

import pytest
import torch

from conftest import CELLS, tiny_cell


def _fails(readings: dict, limits: dict) -> bool:
    return any(readings[k] > limits[k]["limit"] for k in limits)


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_where_the_program_passes(name):
    from portbench.calibrate import readings

    cell = tiny_cell(name)
    got = readings(cell, 2 ** 31 + 9, "cpu", controls=True)
    assert not _fails(got["program"], cell.limits["numbers"]), got
    assert _fails(got["control"], cell.limits["numbers"]), got


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cell's own size runs on the card")
    from portbench.calibrate import readings
    from portbench.harness.cell import resolve, with_pending

    cell = resolve(name, with_pending())
    for seed in (101, 2 ** 31 + 102, 103):
        got = readings(cell, seed, "cuda", controls=True)
        assert not _fails(got["program"], cell.limits["numbers"]), got
        assert _fails(got["control"], cell.limits["numbers"]), got
        torch.cuda.empty_cache()
