"""Process groups, device meshes and the sharding rules behind ``--mesh``.

Counterpart of ``dyadic_interaction_modeling_tpu/parallel/mesh.py`` on
``torch.distributed``. The JAX package runs one process over a
``jax.sharding.Mesh`` and lets XLA insert the collectives; PyTorch runs one
process a device (the reference's ``mp.spawn`` + ``init_process_group`` +
DDP, ``train_vq.py:42-102``), so here:

* ``init_distributed`` joins a process group (NCCL on the card, gloo on the
  CPU) from explicit arguments or from ``torchrun``'s environment;
* ``make_mesh`` returns a ``DeviceMesh`` with a ``data`` axis (and a
  ``model`` axis, innermost);
* ``data_sharding`` / ``shard_batch`` give each rank its contiguous slice of
  dim 0 of the global batch, which every rank builds alike;
* ``replicate`` broadcasts rank 0's parameters and buffers;
* ``tp_param_spec`` / ``tp_param_shardings`` hold the JAX rules
  (``mesh.py:104-129``: attention q / k / v, the feed-forward's first
  linear and the logits column-parallel, attention out and the second
  feed-forward linear row-parallel, each only where the sharded width is at
  least ``min_width`` and divides evenly) as a ``parallelize_module`` plan;
* ``fsdp_param_spec`` / ``fsdp_param_shardings`` hold the JAX FSDP rule (a
  parameter of at least ``min_size`` elements is sharded) as the modules to
  ``fully_shard``.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist
import torch.nn as nn

from ..utils.logging import main_process as is_master  # rank 0, or the only process


def init_distributed(init_method: Optional[str] = None, world_size: Optional[int] = None,
                     rank: Optional[int] = None, device: str = "cuda") -> bool:
    """Join a process group, once a process: the explicit ``init_method``
    (``tcp://host:port``), ``world_size`` and ``rank``, or ``torchrun``'s
    ``WORLD_SIZE`` / ``RANK`` / ``MASTER_ADDR`` environment. NCCL when
    ``device`` is the card (each rank on card ``LOCAL_RANK``, else its
    rank), gloo on the CPU. Returns whether a group is up."""
    if dist.is_initialized():
        return True
    if world_size is None:
        if "WORLD_SIZE" not in os.environ:
            return False
        world_size, rank, init_method = int(os.environ["WORLD_SIZE"]), int(
            os.environ["RANK"]), "env://"
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank)))
    dist.init_process_group("nccl" if on_card else "gloo", init_method=init_method,
                            world_size=world_size, rank=rank)
    return True


def make_mesh(axes: Sequence[str] = ("data",), shape: Optional[Sequence[int]] = None,
              device: str = "cuda"):
    """A ``DeviceMesh`` over the process group's ranks: by default one
    ``data`` axis over all of them; ``axes=("data", "model"), shape=(n,
    m)`` for data x tensor parallel (``model`` innermost, so a TP group is
    neighbouring ranks)."""
    from torch.distributed.device_mesh import init_device_mesh

    if shape is None:
        shape = [dist.get_world_size()] + [1] * (len(axes) - 1)
    return init_device_mesh(torch.device(device).type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def data_sharding(mesh, n: int, axis: str = "data") -> slice:
    """The rows of a global batch of ``n`` that this rank holds: a
    contiguous slice of dim 0, ``n`` divided evenly over the ``axis``."""
    k, r = mesh.size(mesh.mesh_dim_names.index(axis)), mesh.get_local_rank(axis)
    if n % k:
        raise ValueError(f"batch size {n} is not divisible by the data axis ({k}); "
                         "pick --batch-size as a multiple")
    return slice(r * (n // k), (r + 1) * (n // k))


def shard_batch(mesh, batch, axis: str = "data"):
    """This rank's slice of dim 0 of every array or tensor in a batch (a
    tensor, an array, or a dict / tuple / list of them); other leaves pass
    through."""
    leaves = _leaves(batch)
    if not leaves:
        return batch
    rows = data_sharding(mesh, leaves[0].shape[0], axis)

    def cut(x):
        if isinstance(x, dict):
            return {k: cut(v) for k, v in x.items()}
        if isinstance(x, (tuple, list)):
            return type(x)(cut(v) for v in x)
        return x[rows] if hasattr(x, "shape") and getattr(x, "ndim", 0) else x

    return cut(batch)


def _leaves(x) -> list:
    if isinstance(x, dict):
        return [y for v in x.values() for y in _leaves(v)]
    if isinstance(x, (tuple, list)):
        return [y for v in x for y in _leaves(v)]
    return [x] if hasattr(x, "shape") and getattr(x, "ndim", 0) else []


@torch.no_grad()
def replicate(mesh, module: nn.Module) -> nn.Module:
    """The parameters and buffers of the mesh's first rank on every rank of
    a 1-D mesh (of every rank of the group for a mesh of more axes)."""
    group = mesh.get_group() if mesh.ndim == 1 else None
    src = dist.get_global_rank(group, 0) if group is not None else 0
    for t in list(module.parameters()) + list(module.buffers()):
        dist.broadcast(t.data, src=src, group=group)
    return module


# Megatron pairing, as the JAX rules name it (mesh.py:104-105); the port's
# modules carry x-transformers' names, where ``w1`` is ``ff.0.0`` and ``w2``
# is ``ff.3``
_TP_COLUMN = ("to_q", "to_k", "to_v", "ff.0.0", "to_logits")
_TP_ROW = ("to_out", "ff.3")


def _named(path: str, names: Sequence[str]) -> bool:
    return any(path == n or path.endswith("." + n) for n in names)


def tp_param_spec(path: str, module: nn.Module, model_axis_size: int,
                  min_width: int = 64) -> Optional[str]:
    """The tensor-parallel rule for one module of the SLM-family stacks:
    ``"colwise"`` (its output features sharded), ``"rowwise"`` (its input
    features sharded) or None (replicated). Only ``nn.Linear`` shards."""
    if not isinstance(module, nn.Linear):
        return None
    if (_named(path, _TP_COLUMN) and module.out_features % model_axis_size == 0
            and module.out_features >= min_width):
        return "colwise"
    if (_named(path, _TP_ROW) and module.in_features % model_axis_size == 0
            and module.in_features >= min_width):
        return "rowwise"
    return None


def tp_param_shardings(module: nn.Module, model_axis_size: int,
                       min_width: int = 64) -> Dict[str, object]:
    """A ``parallelize_module`` plan under ``tp_param_spec``. Each sharded
    linear takes a replicated input and gives a replicated output (a
    column-parallel one all-gathers, a row-parallel one all-reduces), so the
    code around it runs as it is."""
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.parallel import ColwiseParallel, RowwiseParallel

    plan = {}
    for path, sub in module.named_modules():
        spec = tp_param_spec(path, sub, model_axis_size, min_width)
        if spec == "colwise":
            plan[path] = ColwiseParallel(output_layouts=Replicate())
        elif spec == "rowwise":
            plan[path] = RowwiseParallel(input_layouts=Replicate())
    return plan


def fsdp_param_spec(param: torch.Tensor, data_axis_size: int,
                    min_size: int = 16384) -> bool:
    """The FSDP rule: a parameter of at least ``min_size`` elements is
    sharded over the data axis (``fully_shard`` splits dim 0, padding an
    uneven split); smaller ones stay with their parent's group."""
    return param.numel() >= min_size and data_axis_size > 1


def fsdp_param_shardings(module: nn.Module, data_axis_size: int,
                         min_size: int = 16384) -> List[str]:
    """The submodules to ``fully_shard``, deepest first and the root last:
    for each module that holds, as its own parameter, one that
    ``fsdp_param_spec`` shards, the layer it belongs to: its nearest
    ancestor (or itself) that is an entry of an ``nn.ModuleList`` (a stack's
    layer) and has a forward of its own; a parameter in no such layer goes
    with the root. ``fully_shard`` gathers a group only around its module's
    forward, and the port's code reads many a parameter outside its
    holder's forward (a positional table's ``emb.weight``, the VQ codebook,
    a conv block's ``conv.weight``, the tokenizers' ``encode_indices``),
    never outside a stack layer's."""
    modules = dict(module.named_modules())
    paths = set()
    for path, sub in modules.items():
        if not path or not any(fsdp_param_spec(p, data_axis_size, min_size)
                               for p in sub.parameters(recurse=False)):
            continue
        cand = path
        while cand:
            parent = cand.rpartition(".")[0]
            if (isinstance(modules[parent], nn.ModuleList)
                    and not isinstance(modules[cand], (nn.ModuleList, nn.ModuleDict))):
                paths.add(cand)
                break
            cand = parent
    return sorted(paths, key=lambda p: (-p.count("."), p)) + [""]
