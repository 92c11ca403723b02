"""Best-validation checkpoints, reference checkpoints, and the graft of one
model's weights into another, on port-layout state_dicts.

Counterpart of ``dyadic_interaction_modeling_tpu/utils/checkpoint.py``:
``BestCheckpointKeeper`` (:110, train_vq.py:165-170 semantics) saves with
``torch.save`` where the JAX package writes orbax trees;
``partial_load`` (:64) grafts by top-level module as there, but strictly:
keys are dropped only by name, and any other key the target has no place
for raises; ``load_torch_checkpoint`` (:95) reads a reference ``.pt`` /
``.pth.tar``, and ``normalize_legacy_keys`` is the JAX package's
``utils/torch_import.py:31``. The port keeps the reference's key layout, so
``model_state_dict`` only has to undo what a reference file may add: the
``{'state_dict': ...}`` wrapper, nn.DataParallel's ``module.`` prefix and the
``gamma``/``beta`` spelling of a LayerNorm (finetune_s2s_pretrain.py:50-57).
"""

from __future__ import annotations

import os
from typing import Any, Callable, Dict, Iterable, List, Mapping, Optional

import torch
from torch import nn


class BestCheckpointKeeper:
    """Saves ``module``'s state_dict to ``save_dir/best_model.pt`` whenever
    the metric (a loss or a distance: lower is better) improves on the best
    seen. In a process group every rank takes rank 0's metric, so all agree,
    ``state_dict`` (a callable, for a sharded model: every rank gathers) is
    called on every rank, and rank 0 alone writes."""

    def __init__(self, save_dir: str):
        self.path = os.path.join(save_dir, "best_model.pt")
        self.best: Optional[float] = None

    def update(self, metric: float, module: nn.Module,
               state_dict: Optional[Callable[[], Dict]] = None) -> bool:
        import torch.distributed as dist

        rank0 = True
        if dist.is_initialized():
            box = [float(metric)]
            dist.broadcast_object_list(box, src=0)
            metric, rank0 = box[0], dist.get_rank() == 0
        better = self.best is None or metric < self.best
        if better:
            self.best = metric
            sd = state_dict() if state_dict is not None else module.state_dict()
            if rank0:
                os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
                torch.save(sd, self.path)
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


def _legacy_key(k: str) -> str:
    k = k.replace("module.", "")
    if k.endswith(".gamma"):
        return k[: -len(".gamma")] + ".weight"
    if k.endswith(".beta"):
        return k[: -len(".beta")] + ".bias"
    return k


def normalize_legacy_keys(state_dict: Mapping[str, Any]) -> Dict[str, Any]:
    """``module.`` stripped, ``gamma`` -> ``weight`` and ``beta`` -> ``bias``
    (finetune_s2s_pretrain.py:50-57)."""
    return {_legacy_key(k): v for k, v in state_dict.items()}


def load_torch_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """A reference checkpoint's state_dict: the file's ``state_dict`` entry
    when it has one (``save_checkpoint``, baseTrainer.py:26-42), else the
    file itself."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    return payload.get("state_dict", payload)


def model_state_dict(state_dict: Mapping[str, torch.Tensor], model: nn.Module
                     ) -> Dict[str, torch.Tensor]:
    """``state_dict`` under ``model``'s own keys: both sides' keys are compared
    after ``normalize_legacy_keys``, so a ``module.`` prefix and either
    spelling of a LayerNorm (``weight``/``bias`` or the x-transformers
    ``gamma``/``beta`` that the port keeps) land on the model's key. Keys
    the model lacks keep their normalized name."""
    own = {_legacy_key(k): k for k in model.state_dict()}
    return {own.get(k, k): v for k, v in normalize_legacy_keys(state_dict).items()}


def load_reference(model: nn.Module, path: str,
                   drop_prefixes: Optional[Iterable[str]] = None) -> None:
    """Loads a reference-layout checkpoint file into ``model``: with
    ``strict=True`` when ``drop_prefixes`` is None, else by ``partial_load``
    (those keys dropped by name, any other foreign key raising)."""
    sd = model_state_dict(load_torch_checkpoint(path), model)
    if drop_prefixes is None:
        model.load_state_dict(sd, strict=True)
    else:
        partial_load(model, sd, drop_prefixes)
