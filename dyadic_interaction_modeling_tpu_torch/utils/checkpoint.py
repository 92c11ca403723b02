"""Best-validation checkpoints and the graft of one model's weights into
another, on port-layout state_dicts.

Counterpart of ``dyadic_interaction_modeling_tpu/utils/checkpoint.py``:
``BestCheckpointKeeper`` (:110, train_vq.py:165-170 semantics) saves with
``torch.save`` where the JAX package writes orbax trees, and
``partial_load`` (:64) grafts by top-level module as there, but strictly:
keys are dropped only by name, and any other key the target has no place
for raises.
"""

from __future__ import annotations

import os
from typing import Dict, Iterable, List, Optional

import torch
from torch import nn


class BestCheckpointKeeper:
    """Saves ``module``'s state_dict to ``save_dir/best_model.pt`` whenever
    the metric (a loss or a distance: lower is better) improves on the best
    seen."""

    def __init__(self, save_dir: str):
        self.path = os.path.join(save_dir, "best_model.pt")
        self.best: Optional[float] = None

    def update(self, metric: float, module: nn.Module) -> bool:
        better = self.best is None or metric < self.best
        if better:
            self.best = metric
            os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
            torch.save(module.state_dict(), self.path)
        return better


def partial_load(model: nn.Module, loaded: Dict[str, torch.Tensor],
                 drop_prefixes: Iterable[str] = ()) -> List[str]:
    """Graft ``loaded`` into ``model`` by top-level module: every top-level
    module that ``loaded`` holds replaces the model's whole, the others keep
    their initialisation, and the result loads with ``strict=True``.

    Keys under ``drop_prefixes`` are dropped (say, the parts of an SLM that
    SLMFT has no module for); any other key the model lacks, and a top-level
    module that ``loaded`` holds only in part, raise ``ValueError``. Returns
    the dropped keys."""
    prefixes = tuple(drop_prefixes)
    own = model.state_dict()
    dropped = [k for k in loaded if k.startswith(prefixes)] if prefixes else []
    kept = {k: v for k, v in loaded.items() if k not in set(dropped)}
    foreign = sorted(k for k in kept if k not in own)
    if foreign:
        raise ValueError(f"partial_load: {len(foreign)} keys have no place in "
                         f"{type(model).__name__}: {foreign[:5]}")
    tops = {k.split(".")[0] for k in kept}
    partial = sorted(k for k in own if k.split(".")[0] in tops and k not in kept)
    if partial:
        raise ValueError(f"partial_load: the checkpoint holds modules {sorted(tops)} "
                         f"only in part, missing {partial[:5]}")
    model.load_state_dict({**own, **kept}, strict=True)
    return dropped
