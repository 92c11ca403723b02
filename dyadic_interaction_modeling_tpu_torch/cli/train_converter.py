"""EmocaConverter training (reference ``code/train_converter.py``), on the
GPU by default.

    python -m dyadic_interaction_modeling_tpu_torch.cli.train_converter --synthetic \\
        [--device cpu] [--vertice-dim N] [--mouth-map lve.txt] [--clip-len L] \\
        [--epochs N] [--save-path DIR] [KEY VALUE ...]

The twin of ``dyadic_interaction_modeling_tpu/cli/train_converter.py``: the
EMOCA-to-mesh converter, its speaker VQ frozen, trained on MSE plus
``--mouth-weight`` (5) times the mouth region's MSE (train_converter.py:34)
by AdamW (lr 1e-5, weight decay 0.01, torch's default as the reference
leaves it) without clipping (the reference clips before ``backward``, when
the gradients are still zero, so its clip does nothing). Each epoch prints
the mean loss and keeps the state_dict of the lowest (``best_model.pt``
under ``--save-path``). Only ``--synthetic`` data (8 BIWI-shaped clips of
``--clip-len`` frames, 24 as the JAX CLI, EMOCA from synthetic ViCo
motion); the real pairing of BIWI meshes with EMOCA is not in the JAX
package either. Trailing ``KEY VALUE`` pairs override
``vq_listener_defaults()`` (the speaker VQ's widths).
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..config import vq_listener_defaults
from ..data.synthetic import synthetic_biwi_dataset, synthetic_vico_dataset
from ..engine.train_state import clip_by_global_norm, make_optimizer
from ..models.slm import CONVERTER_FROZEN, EmocaConverter
from ..utils.checkpoint import BestCheckpointKeeper
from .common import get_parser as common_parser
from .common import load_config


def get_parser():
    parser = common_parser("EmocaConverter training")
    parser.add_argument("--lr", type=float, default=1e-5)
    parser.add_argument("--weight-decay", type=float, default=0.01)
    parser.add_argument("--clip-norm", type=float, default=0.0)
    parser.add_argument("--mouth-weight", type=float, default=5.0)
    parser.add_argument("--mouth-map", type=str, default=None,
                        help="path to the lve.txt region file")
    parser.add_argument("--vertice-dim", type=int, default=70110)
    parser.add_argument("--clip-len", type=int, default=24,
                        help="frames of each synthetic clip")
    parser.add_argument("--seed", type=int, default=0)
    return parser


def converter_loss(out: torch.Tensor, verts: torch.Tensor,
                   mouth_map: Optional[Sequence[int]], mouth_weight: float) -> torch.Tensor:
    """MSE, plus ``mouth_weight`` times the MSE of the ``mouth_map``
    vertices."""
    mse = (out - verts).square().mean()
    if mouth_map is not None:
        b, l = out.shape[0], out.shape[1]
        mse = mse + mouth_weight * (out.reshape(b, l, -1, 3)[:, :, mouth_map]
                                    - verts.reshape(b, l, -1, 3)[:, :, mouth_map]
                                    ).square().mean()
    return mse


def make_converter_step(model: EmocaConverter, optimizer: torch.optim.Optimizer,
                        clip_norm: float, mouth_map=None, mouth_weight: float = 5.0
                        ) -> Callable:
    """(template, emoca, verts) -> the step's loss (a device tensor)."""
    params = [p for group in optimizer.param_groups for p in group["params"]]

    def step(template, emoca, verts) -> torch.Tensor:
        optimizer.zero_grad(set_to_none=True)
        loss = converter_loss(model(template, emoca), verts, mouth_map, mouth_weight)
        loss.backward()
        if clip_norm > 0:
            clip_by_global_norm(params, clip_norm)
        optimizer.step()
        return loss.detach()

    return step


def synthetic_batches(vertice_dim: int, length: int, n_clips: int = 8):
    """The JAX CLI's clips, one a batch: ((1, vertice_dim) template,
    (1, L, 56) EMOCA, (1, L, vertice_dim) vertices) numpy arrays."""
    items, _ = synthetic_biwi_dataset(n_clips=n_clips, length=length,
                                      n_vertices=vertice_dim // 3)
    motion = synthetic_vico_dataset(n_clips=n_clips, min_len=length, max_len=length)
    return [(item["template"][None], motion[i][1][:length][None], item["vertice"][None])
            for i, item in enumerate(items)]


def main(argv=None):
    args = get_parser().parse_args(argv)
    if not args.synthetic:
        raise SystemExit("real converter data loading requires the BIWI/EMOCA pairing "
                         "pipeline; run with --synthetic or provide a custom loader")
    vq_cfg = load_config(args, vq_listener_defaults)
    mouth_map = None
    if args.mouth_map:
        with open(args.mouth_map) as f:
            mouth_map = [int(i) for i in f.read().split(", ")]
    torch.manual_seed(args.seed)
    model = EmocaConverter(vq_cfg, vertice_dim=args.vertice_dim).to(args.device)
    optimizer = make_optimizer(model, args.lr, args.weight_decay, CONVERTER_FROZEN)
    step = make_converter_step(model, optimizer, args.clip_norm, mouth_map, args.mouth_weight)
    batches = [tuple(torch.as_tensor(x, device=args.device) for x in b)
               for b in synthetic_batches(args.vertice_dim, args.clip_len)]
    keeper = BestCheckpointKeeper(args.save_path or "./runs_converter/model")
    for epoch in range(args.epochs or 10):
        model.train()
        val = float(np.mean([float(step(*b)) for b in batches]))
        print(f"epoch {epoch}: loss {val:.6f}", flush=True)
        if keeper.update(val, model):
            print(f"epoch {epoch}: new best {val:.6f}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
