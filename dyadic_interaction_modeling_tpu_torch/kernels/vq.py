"""K4: nearest-codebook argmin (``csrc/vq_argmin.cu``) and its plain version.

Replaces ``dyadic_interaction_modeling_tpu/ops/pallas/vq.py:49``
``pallas_nearest_code``. See the CUDA source for the design and its bound.
"""

from __future__ import annotations

import torch

from . import LAUNCHES
from .build import extension

MAX_E_DIM = 256  # the widest latent the kernel is built, tested and timed for


def nearest_code_plain(z: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """argmin_c |z|^2 + |e_c|^2 - 2 z.e_c in fp32, ties to the lowest index
    (``ops/quantizer.py:64-71`` of the JAX package, which keeps |z|^2), also
    under an autocast that would take the product to a lower precision."""
    z32, e32 = z.float(), codebook.float()
    with torch.autocast(z.device.type, enabled=False):
        d = ((z32 * z32).sum(dim=1, keepdim=True) + (e32 * e32).sum(dim=1)[None, :]
             - 2.0 * (z32 @ e32.T))
    return torch.argmin(d, dim=1).to(torch.int32)


def _kernel(z: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    for name, x in (("z", z), ("codebook", codebook)):
        if x.dtype != torch.float32 or x.dim() != 2 or not x.is_contiguous():
            raise ValueError(f"nearest_code: {name} must be a contiguous 2-d "
                             f"float32 tensor, got {x.dtype} {tuple(x.shape)}")
    if codebook.device != z.device or z.shape[1] != codebook.shape[1]:
        raise ValueError("nearest_code: z and codebook must share device and "
                         f"width, got {z.device}/{tuple(z.shape)} and "
                         f"{codebook.device}/{tuple(codebook.shape)}")
    if codebook.shape[0] == 0:
        raise ValueError("nearest_code: needs a non-empty codebook")
    # int32 indices as a stride-2 view of the kernel's 64-bit keys
    out = extension().vq_argmin(z, codebook)
    LAUNCHES["nearest_code"] += 1
    return out


def nearest_code(z: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """(N, e_dim) fp32 latents x (n_e, e_dim) fp32 codebook -> (N,) int32
    nearest-code indices. CUDA tensors run the kernel, CPU tensors the plain
    version; e_dim is at most ``MAX_E_DIM``, the kernel's limit, on every
    device."""
    if z.dim() == 2 and z.shape[1] > MAX_E_DIM:
        raise ValueError(f"nearest_code: needs e_dim <= {MAX_E_DIM}, got e_dim = "
                         f"{z.shape[1]}")
    if z.device.type == "cuda":
        return _kernel(z, codebook)
    if z.device.type == "cpu":
        return nearest_code_plain(z, codebook)
    raise ValueError(f"nearest_code: unsupported device {z.device}")
