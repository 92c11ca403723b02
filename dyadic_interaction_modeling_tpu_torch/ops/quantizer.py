"""Vector quantization, the VQ-VAE bottleneck (reference quantizer.py:14-91).

Counterpart of ``dyadic_interaction_modeling_tpu/ops/quantizer.py:52-148``
(``vq_distances`` :101).
``nearest_code`` runs the K4 kernel on CUDA tensors and its plain version on
CPU tensors (``kernels/vq.py``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels.vq import nearest_code as _nearest_code


class VQResult(NamedTuple):
    z_q: torch.Tensor         # (B, C, L) straight-through quantized latents
    loss: torch.Tensor        # scalar commitment + codebook loss
    perplexity: torch.Tensor  # scalar codebook-usage perplexity
    indices: torch.Tensor     # (B, L) int32 code indices


def nearest_code(z_flat: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """Nearest-codebook int32 indices for (N, e_dim) against (n_e, e_dim),
    computed in fp32; ties go to the lowest index."""
    return _nearest_code(z_flat.float().contiguous(), codebook.float().contiguous())


def vq_quantize(z: torch.Tensor, codebook: torch.Tensor,
                beta: float = 0.25) -> VQResult:
    """Functional quantize: z (B, L, e_dim), codebook (n_e, e_dim)."""
    b, l, e_dim = z.shape
    n_e = codebook.shape[0]
    idx = nearest_code(z.reshape(-1, e_dim), codebook)
    z_q = codebook[idx.long()].reshape(b, l, e_dim).to(z.dtype)
    loss = (beta * (z_q.detach() - z).square().mean()
            + (z_q - z.detach()).square().mean())
    z_q_st = z + (z_q - z).detach()
    one_hot_mean = F.one_hot(idx.long(), n_e).float().mean(dim=0)
    perplexity = torch.exp(-(one_hot_mean * torch.log(one_hot_mean + 1e-10)).sum())
    return VQResult(z_q=z_q_st.transpose(1, 2), loss=loss,
                    perplexity=perplexity, indices=idx.reshape(b, l))


def vq_distances(z_bcl: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """Squared distances of every latent to every code, the reference's
    ``get_distance``: z (B, C, L) -> (B, L, n_e), in fp32."""
    b, c, l = z_bcl.shape
    z = z_bcl.transpose(1, 2).reshape(-1, c).float()
    e = codebook.float()
    d = (z * z).sum(dim=1, keepdim=True) + (e * e).sum(dim=1)[None, :] - 2.0 * (z @ e.T)
    return d.reshape(b, l, -1)


def vq_codebook_lookup(indices: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """Reference ``get_codebook_entry``: gather codebook rows."""
    return codebook[indices.long()]


class VectorQuantizer(nn.Module):
    """Codebook module; ``embedding`` keeps the reference's nn.Embedding key
    (``quantize.embedding.weight``), initialised U(-1/n_e, 1/n_e)."""

    def __init__(self, n_e: int, e_dim: int, beta: float = 0.25):
        super().__init__()
        self.beta = beta
        self.embedding = nn.Embedding(n_e, e_dim)
        nn.init.uniform_(self.embedding.weight, -1.0 / n_e, 1.0 / n_e)

    def forward(self, z: torch.Tensor) -> VQResult:
        return vq_quantize(z, self.embedding.weight.to(z.dtype), self.beta)

    def get_distance(self, z_bcl: torch.Tensor) -> torch.Tensor:
        return vq_distances(z_bcl, self.embedding.weight)

    def get_codebook_entry(self, indices: torch.Tensor) -> torch.Tensor:
        return vq_codebook_lookup(indices, self.embedding.weight)
