"""The guard that the run measured the port alone: no JAX and no JAX
package in the process. Names are compared whole, by their top-level part:
the port's package name begins with the JAX package's."""

from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "dyadic_interaction_modeling_tpu")


def forbidden_loaded(modules: Iterable[str] = None) -> List[str]:
    names = sys.modules if modules is None else modules
    tops = {m.split(".")[0] for m in names}
    return sorted(t for t in tops if t in FORBIDDEN)
