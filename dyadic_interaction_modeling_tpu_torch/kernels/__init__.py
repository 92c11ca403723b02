"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

Every wrapper dispatches on its inputs' device: a CPU tensor goes to the
plain version, a CUDA tensor to the kernel (built from ``csrc/`` at first
use, see ``build.py``); anything else raises. ``LAUNCHES`` counts the kernel
launches of each wrapper, so a run can show that its path went through the
kernels.
"""

from __future__ import annotations

from typing import Dict

LAUNCHES: Dict[str, int] = {"decode_attention": 0, "flash_attention_fwd": 0,
                             "flash_attention_bwd": 0, "nearest_code": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
