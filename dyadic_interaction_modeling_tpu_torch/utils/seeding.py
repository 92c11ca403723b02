"""Seeding.

Counterpart of ``dyadic_interaction_modeling_tpu/utils/seeding.py:17`` (the
reference seeds Python, numpy and torch in ``Pirender/util/trainer.py:19-30``).
Where the JAX package returns a root ``PRNGKey``, torch keeps global
generators, which this seeds.
"""

from __future__ import annotations

import random

import numpy as np
import torch


def set_random_seed(seed: int) -> None:
    """Seed Python's, numpy's and torch's generators, every CUDA device's
    included where CUDA is present."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    if torch.cuda.is_available():
        torch.cuda.manual_seed_all(seed)
