"""``--mesh SPEC``: the training layouts of the CLIs.

Counterpart of ``dyadic_interaction_modeling_tpu/parallel/plan.py``. The
specs and their errors are the JAX package's:

* ``--mesh auto``            data parallel over every visible device (every
  card; on the CPU the group's ranks, else one, as JAX counts a CPU host)
* ``--mesh data=N``          data parallel over N
* ``--mesh data=N,model=K``  data x Megatron tensor parallel (``model``
  innermost)
* ``--mesh fsdp`` / ``fsdp=N``  parameters, gradients and Adam moments
  sharded over the data axis

The port runs one process a device, the reference's idiom
(``train_vq.py:42``): a CLI given ``--mesh`` outside a process group
spawns its ranks (``launch``) and each joins the group (NCCL on the card,
gloo with ``--device cpu``); under ``torchrun`` (``WORLD_SIZE`` set) it
joins the group it is given. Every rank builds the same global batch
(``--batch-size`` stays the global batch) and keeps its slice of dim 0, and
``shard_state`` wraps the model: ``DistributedDataParallel`` (dp, gradients
averaged over the ranks), ``parallelize_module`` with the TP plan of
``mesh.tp_param_shardings`` (tp; with more than one data rank also
``fully_shard`` over the data axis), or ``fully_shard`` on the modules
``mesh.fsdp_param_shardings`` names, then the root (fsdp). The optimizer
is built after the wrap. Where the loss is a mean of per-sample terms of
equal weight the sharded step is the single-process step; where it couples
the samples of a batch (InfoNCE) or weighs them unequally (a masked mean
over ragged clips), each rank's loss is its shard's, as under the
reference's DDP. Only rank 0 writes checkpoints and run records.
"""

from __future__ import annotations

import dataclasses
import os
import socket
from typing import Callable, Iterable, Iterator, Optional, Sequence

import torch
import torch.distributed as dist
import torch.nn as nn

from ..ops.positional import batch_row_offset
from .mesh import (
    _leaves,
    data_sharding,
    fsdp_param_shardings,
    init_distributed,
    make_mesh,
    shard_batch,
    tp_param_shardings,
)

_BAD_SPEC = "expected 'auto', 'fsdp[=N]', 'data=N' or 'data=N,model=K'"


def visible_devices(device: str = "cuda") -> int:
    """Devices ``auto`` and a bare ``fsdp`` take: the cards, or on the CPU
    the ranks of the group this process is in (``WORLD_SIZE`` under
    ``torchrun``), else 1, as JAX counts a plain CPU host."""
    if torch.device(device).type == "cuda":
        return torch.cuda.device_count()
    if dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", 1))


@dataclasses.dataclass
class MeshPlan:
    layout: str  # "dp" | "tp" | "fsdp"
    data_par: int
    model_par: int = 1
    device: str = "cuda"
    fsdp_min_size: int = 16384
    _mesh: object = None

    @property
    def world_size(self) -> int:
        return self.data_par * self.model_par

    @property
    def mesh(self):
        """The ``DeviceMesh`` (built at first use, inside the group)."""
        if self._mesh is None:
            if self.model_par > 1:
                self._mesh = make_mesh(("data", "model"), (self.data_par, self.model_par),
                                       self.device)
            else:
                self._mesh = make_mesh(("data",), (self.data_par,), self.device)
        return self._mesh

    @classmethod
    def parse(cls, spec: Optional[str], device: str = "cuda") -> Optional["MeshPlan"]:
        """A ``--mesh`` spec -> a plan; None or '' -> None (one process)."""
        if not spec:
            return None
        s = spec.strip().lower()
        n_dev = visible_devices(device)
        if s == "auto":
            return cls("dp", n_dev, device=device)
        if s.startswith("fsdp"):
            n = int(s.split("=", 1)[1]) if "=" in s else n_dev
            _check_devices(n, device, spec)
            return cls("fsdp", n, device=device)
        kv = {}
        for part in s.split(","):
            if "=" not in part:
                raise ValueError(f"bad --mesh spec {spec!r}: {_BAD_SPEC}")
            k, v = part.split("=", 1)
            kv[k.strip()] = int(v)
        data = kv.pop("data", None)
        model = kv.pop("model", 1)
        if data is None or kv:
            raise ValueError(f"bad --mesh spec {spec!r}: {_BAD_SPEC}")
        _check_devices(data * model, device, spec)
        return cls("tp" if model > 1 else "dp", data, model, device=device)

    def describe(self) -> str:
        axes = f"data={self.data_par}" + (f" x model={self.model_par}" if self.model_par > 1
                                          else "")
        return f"{self.layout} mesh ({axes})"

    # --- placement

    def shard_state(self, model: nn.Module) -> nn.Module:
        """The model to step: DDP around it (dp), or the model itself with
        its parameters made DTensors (tp, fsdp). Build the optimizer after
        this, over ``model``'s parameters. DDP looks for parameters a step
        leaves unused, as the reference's wraps do (the renderer's warp
        stage never reaches its editing net)."""
        if self.layout == "dp":
            from torch.nn.parallel import DistributedDataParallel

            ids = [torch.cuda.current_device()] if torch.device(self.device).type == "cuda" \
                else None
            return DistributedDataParallel(model, device_ids=ids, find_unused_parameters=True)
        from torch.distributed.fsdp import fully_shard

        if self.layout == "tp":
            from torch.distributed.tensor.parallel import parallelize_module

            parallelize_module(model, self.mesh["model"],
                               tp_param_shardings(model, self.model_par))
            if self.data_par > 1:
                fully_shard(model, mesh=self.mesh["data"])
            return model
        modules = dict(model.named_modules())
        for path in fsdp_param_shardings(model, self.data_par, self.fsdp_min_size):
            fully_shard(modules[path], mesh=self.mesh)
        return model

    def state_dict(self, model: nn.Module) -> dict:
        """The full (unsharded) state_dict on the CPU, the keys of the
        unwrapped module; every rank must call it."""
        from torch.distributed.checkpoint.state_dict import StateDictOptions, get_model_state_dict

        inner = model.module if hasattr(model, "module") and self.layout == "dp" else model
        if self.layout == "dp":
            return {k: v.detach().cpu() for k, v in inner.state_dict().items()}
        return get_model_state_dict(inner, options=StateDictOptions(full_state_dict=True,
                                                                    cpu_offload=True,
                                                                    broadcast_from_rank0=False))

    # --- batch feeding

    def shard_train_batch(self, batch):
        """This rank's slice of dim 0 of a global batch (a ValueError when
        the batch does not divide over the data axis)."""
        leaves = _leaves(batch)
        b = leaves[0].shape[0] if leaves else 0
        if b % self.data_par:
            raise ValueError(f"batch size {b} is not divisible by the data axis "
                             f"({self.data_par}); pick --batch-size as a multiple")
        return shard_batch(self.mesh, batch)

    def batches(self, it: Iterable) -> Iterator:
        """Each batch's slice for this rank. While the caller holds a slice,
        the VQ-VAEs' batch-indexed positional quirk counts its rows from the
        slice's first row in the global batch (``batch_row_offset``), so a
        rank's rows are encoded as in the single-process batch."""
        for batch in it:
            local = self.shard_train_batch(batch)
            leaves = _leaves(batch)
            start = data_sharding(self.mesh, leaves[0].shape[0]).start if leaves else 0
            with batch_row_offset(start):
                yield local


def _check_devices(needed: int, device: str, spec: str) -> None:
    """An explicit count may take every card, or on the CPU (a rank is a
    process) every core."""
    have = torch.cuda.device_count() if torch.device(device).type == "cuda" \
        else max(visible_devices(device), os.cpu_count() or 1)
    if needed > have:
        raise ValueError(f"--mesh {spec!r} needs {needed} devices but only {have} are "
                         "visible (on the CPU, with --device cpu, a rank is a process)")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, main: Callable, argv: Sequence[str], init_method: str,
               world: int, device: str, threads: int) -> None:
    torch.set_num_threads(threads)
    init_distributed(init_method, world, rank, device)
    try:
        main(list(argv))
    finally:
        dist.destroy_process_group()


def launch(plan: Optional[MeshPlan], main: Callable, argv: Sequence[str]) -> Optional[int]:
    """Run ``main(argv)`` on every rank of ``plan`` when this process is in
    no group yet: one rank in this process when the plan takes one device
    (a group of one), else ``plan.world_size`` processes spawned with
    ``torch.multiprocessing.spawn`` (``tcp://localhost`` on a free port, the
    CPU's threads split over them). Returns None where the caller is already
    a rank (in a group, or under ``torchrun``) and should train; else 0 when
    every rank has finished."""
    if plan is None or init_distributed(device=plan.device):
        return None
    init_method = f"tcp://localhost:{_free_port()}"
    threads = max(1, torch.get_num_threads() // plan.world_size)
    if plan.world_size == 1:
        _rank_main(0, main, argv, init_method, 1, plan.device, torch.get_num_threads())
        return 0
    import torch.multiprocessing as mp

    mp.spawn(_rank_main, args=(main, list(argv), init_method, plan.world_size, plan.device,
                               threads), nprocs=plan.world_size, join=True)
    return 0


__all__ = ["MeshPlan", "launch", "visible_devices"]
