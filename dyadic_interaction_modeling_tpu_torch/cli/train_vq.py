"""Stage-1 VQ-VAE tokenizer training (reference ``code/train_vq.py``), on
the GPU by default.

    python -m dyadic_interaction_modeling_tpu_torch.cli.train_vq \\
        --synthetic [--device cpu] [--save-path DIR] [KEY VALUE ...]

Builds the listener ``VQAutoEncoder`` of ``vq_listener_defaults()`` (hidden
384, 6 + 6 layers, 8 heads, a 512 x 128 codebook) from a seeded random init
and trains it in fp32 on single-stream clips, each batch dense and padded by
repeating the last frame to a power-of-two length of at most 1024
(``data.loader.vq_collate``). Clips of 512 frames or more take K2/K3 in
every attention layer (``ops/transformer.py``). Each epoch it trains,
validates and saves the state_dict of the best validation ``rec_loss``
(``best_model.pt`` under ``--save-path``), which the SLM CLIs load with
``--speaker-vq`` / ``--listener-vq``.

Reference quirk, kept: AdamW runs with torch's default weight decay 0.01,
not the config's 0.002 (train_vq.py:112); ``adamw_config_weight_decay True``
takes the config's. Trailing ``KEY VALUE`` pairs override the config
(``epochs``, ``base_lr``, ``batch_size``, widths).
"""

from __future__ import annotations

import argparse

import torch

from ..config import merge_cfg_from_list, vq_listener_defaults
from ..data.loader import PaddedBatchLoader, vq_collate
from ..data.synthetic import synthetic_vico_dataset
from ..engine.train_state import make_optimizer
from ..engine.vq_engine import make_vq_eval_step, make_vq_train_step, train_epoch, validate
from ..models.vq_vae import VQAutoEncoder
from ..utils.checkpoint import BestCheckpointKeeper


def get_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="train the stage-1 VQ-VAE")
    parser.add_argument("--synthetic", action="store_true",
                        help="train on synthetic ViCo-shaped listener clips")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--save-path", type=str, default="./runs_vq/model")
    parser.add_argument("opts", nargs=argparse.REMAINDER,
                        help="KEY VALUE overrides of vq_listener_defaults()")
    return parser


def vq_train_cfg(opts=()):
    """``vq_listener_defaults()`` with the training-only keys, then the
    ``KEY VALUE`` overrides."""
    cfg = vq_listener_defaults()
    cfg.update(adamw_config_weight_decay=False, print_freq=500)
    return merge_cfg_from_list(cfg, list(opts)) if opts else cfg


def _batches(loader, device):
    for dense in loader:
        yield torch.as_tensor(dense, device=device)


def main(argv=None):
    args = get_parser().parse_args(argv)
    if not args.synthetic:
        raise SystemExit("only --synthetic data is wired into the torch port yet")
    cfg = vq_train_cfg(args.opts)
    if cfg.in_dim != 56:
        raise SystemExit("the torch port trains the 56-d listener VQ only; the "
                         "audio-visual speaker VQ is not ported yet")
    torch.manual_seed(cfg.manual_seed)
    model = VQAutoEncoder(cfg).to(args.device)
    # train_vq.py:112 passes no weight_decay to AdamW (torch's default 0.01)
    wd = cfg.weight_decay if cfg.adamw_config_weight_decay else 0.01
    optimizer = make_optimizer(model, cfg.base_lr, wd)
    step = make_vq_train_step(model, optimizer, cfg.quant_loss_weight)
    eval_step = make_vq_eval_step(model, cfg.quant_loss_weight)
    # the listener stream of each synthetic clip; train and val share the set,
    # as the JAX package's synthetic run does
    clips = synthetic_vico_dataset(n_clips=32, min_len=24, max_len=64)
    motion = [(item[1],) for item in clips.items]
    train_loader = PaddedBatchLoader(motion, cfg.batch_size, shuffle=True,
                                     collate=vq_collate)
    val_loader = PaddedBatchLoader(motion, cfg.batch_size_val, shuffle=False,
                                   collate=vq_collate)
    keeper = BestCheckpointKeeper(args.save_path)
    for epoch in range(cfg.epochs):
        train_loader.set_epoch(epoch)
        logs = train_epoch(_batches(train_loader, args.device), step, epoch,
                           cfg.print_freq)
        val = validate(_batches(val_loader, args.device), eval_step)
        print(f"epoch {epoch}: train {logs} val "
              + " ".join(f"{k} {v:.4f}" for k, v in val.items()), flush=True)
        if keeper.update(val["rec_loss"], model):
            print(f"epoch {epoch}: new best rec_loss {val['rec_loss']:.4f}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
