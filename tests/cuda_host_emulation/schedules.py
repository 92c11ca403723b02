"""The emulation's two schedules (``emulation_schedule`` in
``cuda_runtime.h``), for the tests that run kernel sources through it."""

import torch


def both_schedules(lib, launch):
    """``launch()`` under both schedules (a block's warps and lanes first to
    last with late copies, then last to first with early ones): a missing
    barrier or wait shows in one of them at least, so the two results must
    be bitwise equal. Returns the first."""
    runs = []
    for second in (0, 1):
        lib.emulation_schedule(second)
        try:
            runs.append(launch())
        finally:
            lib.emulation_schedule(0)
    for a, b in zip(*runs):
        assert torch.equal(a.view(torch.uint8), b.view(torch.uint8)), \
            "the emulation's schedule changes the result"
    return runs[0]
