"""Seq2seq ListenerGenerator training on ViCo without pretraining (reference
``code/train_s2s.py``), on the GPU by default.

    python -m dyadic_interaction_modeling_tpu_torch.cli.train_s2s \\
        [--synthetic] [--config FILE.yaml] [--device cpu] [--use-ids] \\
        [--continuous] [--epochs N] [--save-path DIR] [KEY VALUE ...]

Builds ``ListenerGenerator`` (``listener_generator_defaults()``, both VQs
``lg_vq_cfg``) from a seeded random init and trains it on CE plus the
continuous loss with the speaker VQ and the listener VQ's encoder and
quantizer frozen (``LG_FROZEN``), AdamW (lr 1e-5, weight decay 0.01, torch's
default as the reference leaves it) and no clipping (the reference's epoch
loop passes clip 0, train_s2s.py:80, :96). ``--use-ids`` conditions on the
speaker and listener ids. Each epoch prints the validation loss and token
perplexity (``engine.s2s_engine.evaluate_epoch``) and saves the state_dict of
the best validation loss (``best_model.pt`` under ``--save-path``).
``--continuous`` trains ``ContinuousSeq2Seq`` (MSE of the next frame) instead,
the branch the reference keeps dormant (train_s2s.py:97). The model reads
``src[..., :56]``, the speaker motion, as the JAX package's ``_batches``.
The run record goes beside the checkpoint (``utils.observability``, the JAX
CLI's tags): ``train/loss`` (the token branch's last step), ``val/loss`` and
``learning_rate`` each epoch in ``scalars.jsonl``, and ``hparams.json``.
Data: ``finetune_s2s_pretrain.make_loaders`` (``--synthetic``, or the ViCo
files under ``../data``). ``--mesh`` (JAX ``train_s2s.py:60``, ``:124``)
trains both branches on several devices, one process each
(``parallel.MeshPlan``; ``--batch-size`` the global batch, rank 0 writing).
"""

from __future__ import annotations

from typing import Iterable, Iterator

import torch

from ..config import lg_vq_cfg, listener_generator_defaults
from ..engine.s2s_engine import (evaluate_continuous_epoch, evaluate_epoch,
                                 make_continuous_train_step, make_lg_train_step,
                                 train_continuous_epoch, train_epoch)
from ..engine.train_state import freeze, make_optimizer
from ..models.listener_generator import LG_FROZEN, ContinuousSeq2Seq, ListenerGenerator
from ..utils.checkpoint import BestCheckpointKeeper
from ..utils.observability import run_writer
from .common import get_parser as common_parser
from .common import load_config, state_dict_fn, training_mesh
from .finetune_s2s_pretrain import make_loaders


def lg_batches(loader: Iterable, device) -> Iterator:
    """``pad_collate`` batches as (src[..., :56], tgt, mask, speaker_ids,
    listener_ids) tensors on ``device``."""
    for src, tgt, _lens, mask, (sp, li), _names in loader:
        yield tuple(torch.as_tensor(x, device=device) for x in (src[..., :56], tgt, mask,
                                                                sp, li))


def get_parser():
    parser = common_parser("ListenerGenerator training")
    parser.add_argument("--batch-size", type=int, default=4)
    parser.add_argument("--lr", type=float, default=1e-5)
    parser.add_argument("--weight-decay", type=float, default=0.01)
    parser.add_argument("--clip-norm", type=float, default=0.0)
    parser.add_argument("--use-ids", action="store_true",
                        help="condition on the speaker and listener id embeddings")
    parser.add_argument("--continuous", action="store_true",
                        help="train the continuous (MSE) seq2seq instead of the token "
                             "generator")
    parser.add_argument("--seed", type=int, default=0)
    return parser


def _sharded(plan, batches):
    return plan.batches(batches) if plan else batches


def _main_continuous(args, cfg, plan) -> int:
    """The continuous branch (x_engine.train_continuous_epoch): the best
    validation MSE is kept."""
    torch.manual_seed(args.seed)
    model = ContinuousSeq2Seq(cfg, dim_in=56).to(args.device)
    stepped = plan.shard_state(model) if plan else model
    step = make_continuous_train_step(
        stepped, make_optimizer(model, args.lr, args.weight_decay), args.clip_norm)
    train_loader, val_loader = make_loaders(args, args.batch_size)
    save_dir = args.save_path or "./runs_s2s_cont/model"
    keeper = BestCheckpointKeeper(save_dir)
    writer = run_writer(save_dir, hparams=cfg)
    try:
        for epoch in range(cfg.get("epochs", 10)):
            train_loader.set_epoch(epoch)
            model.train()
            train_continuous_epoch(_sharded(plan, (b[:3] for b in lg_batches(
                train_loader, args.device))), step, epoch)
            model.eval()
            val = evaluate_continuous_epoch(model, (b[:3] for b in lg_batches(val_loader,
                                                                               args.device)))
            print(f"epoch {epoch}: val MSE {val:.5f}", flush=True)
            writer.add_scalar("val/loss", val, epoch + 1)
            writer.add_scalar("learning_rate", args.lr, epoch + 1)
            if keeper.update(val, model, state_dict_fn(plan, model)):
                print(f"epoch {epoch}: new best {val:.5f}", flush=True)
    finally:
        writer.close()
    return 0


def main(argv=None) -> int:
    args = get_parser().parse_args(argv)
    plan, launched = training_mesh(args, main, argv)
    if launched is not None:
        return launched
    cfg = load_config(args, listener_generator_defaults)
    if args.continuous:
        return _main_continuous(args, cfg, plan)
    vq_cfg = lg_vq_cfg(cfg, args.synthetic)
    torch.manual_seed(args.seed)
    model = ListenerGenerator(cfg, vq_cfg, vq_cfg, with_ids=args.use_ids).to(args.device)
    freeze(model, LG_FROZEN)
    stepped = plan.shard_state(model) if plan else model
    step = make_lg_train_step(stepped, make_optimizer(model, args.lr, args.weight_decay,
                                                      LG_FROZEN),
                              args.clip_norm, args.use_ids)
    train_loader, val_loader = make_loaders(args, args.batch_size)
    save_dir = args.save_path or "./runs_s2s/model"
    keeper = BestCheckpointKeeper(save_dir)
    writer = run_writer(save_dir, hparams=cfg)
    try:
        for epoch in range(cfg.get("epochs", 10)):
            train_loader.set_epoch(epoch)
            model.train()
            loss = train_epoch(_sharded(plan, lg_batches(train_loader, args.device)), step,
                               epoch)
            model.eval()
            val = evaluate_epoch(model, lg_batches(val_loader, args.device), args.use_ids)
            print(f"epoch {epoch}: train loss {loss:.4f} val loss {val['loss']:.4f} "
                  f"perplexity {val['perplexity']:.4f}", flush=True)
            writer.add_scalar("train/loss", loss, epoch + 1)
            writer.add_scalar("val/loss", val["loss"], epoch + 1)
            writer.add_scalar("learning_rate", args.lr, epoch + 1)
            if keeper.update(val["loss"], model, state_dict_fn(plan, model)):
                print(f"epoch {epoch}: new best val {val['loss']:.4f}", flush=True)
    finally:
        writer.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
