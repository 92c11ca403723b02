"""Dyadic SLM pretraining on CANDOR (reference ``code/train_s2s_pretrain.py``),
on the GPU by default.

    python -m dyadic_interaction_modeling_tpu_torch.cli.train_s2s_pretrain \\
        [--synthetic] [--config FILE.yaml] [--device cpu] [--dtype bfloat16] \\
        [--speaker-vq PATH] [--listener-vq PATH] [--vq-token-cache] \\
        [--prefetch N] [--epochs N] [--save-path DIR] [KEY VALUE ...]

Builds SLM from a seeded random init, loads the speaker and listener VQs
when given (``VQAutoEncoder`` checkpoints in the reference's layout: the
``train_vq`` twin's ``best_model.pt`` or a reference ``.pt`` / ``.pth.tar``,
``{'state_dict': ...}``, ``module.`` and ``gamma``/``beta`` keys accepted,
loaded with ``strict=True``), freezes their encoders and quantizers, and
trains with AdamW (lr 1e-5, weight decay 0.01, the reference's torch
defaults) and a global-norm clip of 1.0 (x_engine_pt.py:37-38). Each epoch
it trains, reports the validation loss and saves the best state_dict
(``best_model.pt`` under ``--save-path``), with the run record beside it
(``utils.observability``, the JAX CLI's tags: ``train/`` the last step's
logs, ``val/`` the validation logs and their sum ``val/loss``,
``learning_rate``). Trailing ``KEY VALUE`` pairs
override ``slm_defaults()`` (``epochs`` sets the number of epochs).

Data: with ``--synthetic``, synthetic CANDOR-shaped clips; else the CANDOR
utterance pickles in the reference's layout under
``../data/candor_processed/speaker`` and ``../data/candor_processed/listener``
(relative to the working directory, as the reference and the JAX package
read them), split 95/5 by conversation (``candor_split``).
``--vq-token-cache`` tokenizes each clip once with the frozen VQs and reuses
the codes in every later epoch (``engine.pt_engine.VQTokenCache``; the same
codes, the VQ encoders and K4 run only in the first epoch); ``--prefetch N``
reads and collates N batches ahead on a background thread. ``--mesh``
(JAX ``train_s2s_pretrain.py:111``) trains on several devices, one process
each (``parallel.MeshPlan``): ``--batch-size`` stays the global batch and
each rank steps its slice, so InfoNCE contrasts the clips of a rank's slice
and the masking noise is drawn per rank, as under the reference's DDP; every
rank validates on the whole split and rank 0 writes.
"""

from __future__ import annotations

import os

import torch

from ..config import slm_defaults, vq_cfg_for
from ..data.datasets import CandorDataset, candor_split
from ..data.loader import PaddedBatchLoader
from ..data.synthetic import synthetic_candor_dataset
from ..engine.pt_engine import VQTokenCache, evaluate_epoch, make_slm_train_step, train_epoch
from ..engine.train_state import freeze, make_optimizer
from ..models.slm import SLM, SLM_FROZEN
from ..utils.checkpoint import BestCheckpointKeeper, load_reference
from ..utils.observability import run_writer
from .common import get_parser as common_parser
from .common import load_config, prefetched, slm_batches, state_dict_fn, training_mesh

VAL_KEYS = ("l_ce_s", "l_ce_l", "l_cont_s", "l_cont_l", "nce")


def get_parser():
    parser = common_parser("SLM dyadic pretraining")
    parser.add_argument("--speaker-vq", type=str, default=None,
                        help="speaker VQAutoEncoder checkpoint, reference layout")
    parser.add_argument("--listener-vq", type=str, default=None,
                        help="listener VQAutoEncoder checkpoint, reference layout")
    parser.add_argument("--batch-size", type=int, default=32)
    parser.add_argument("--lr", type=float, default=1e-5)
    parser.add_argument("--weight-decay", type=float, default=0.01)
    parser.add_argument("--clip-norm", type=float, default=1.0)
    parser.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"],
                        help="autocast dtype of the forward; parameters stay fp32")
    parser.add_argument("--vq-token-cache", action="store_true",
                        help="tokenize each clip once with the frozen VQs and reuse "
                             "the codes across epochs")
    parser.add_argument("--seed", type=int, default=0)
    return parser


def load_pretrained_vqs(model, speaker_vq=None, listener_vq=None) -> None:
    """The reference-trained VQs into the model's ``speaker_vq`` and
    ``listener_vq`` (seq2seq_pretrain.py:86-93), strictly."""
    for name, path in (("speaker_vq", speaker_vq), ("listener_vq", listener_vq)):
        if path:
            load_reference(getattr(model, name), path)


def make_loaders(args, batch_size: int):
    if args.synthetic:
        train, val = synthetic_candor_dataset(n_clips=32), synthetic_candor_dataset(
            n_clips=8, seed=1)
    else:
        tr, va = candor_split("../data/candor_processed/speaker",
                              "../data/candor_processed/listener")
        train, val = CandorDataset(tr), CandorDataset(va)
    return (PaddedBatchLoader(train, batch_size, shuffle=True),
            PaddedBatchLoader(val, batch_size, shuffle=False))


def main(argv=None):
    args = get_parser().parse_args(argv)
    plan, launched = training_mesh(args, main, argv)
    if launched is not None:
        return launched
    slm_cfg = load_config(args, slm_defaults)
    vq_cfg = vq_cfg_for(slm_cfg, args.synthetic)

    torch.manual_seed(args.seed)
    model = SLM(slm_cfg, vq_cfg)
    load_pretrained_vqs(model, args.speaker_vq, args.listener_vq)
    model = model.to(args.device)
    freeze(model, SLM_FROZEN)
    stepped = plan.shard_state(model) if plan else model
    optimizer = make_optimizer(model, args.lr, args.weight_decay, SLM_FROZEN)
    amp = torch.bfloat16 if args.dtype == "bfloat16" else None
    step = make_slm_train_step(stepped, optimizer, args.clip_norm, amp,
                               with_vq_tokens=args.vq_token_cache)
    cache = VQTokenCache(model, amp) if args.vq_token_cache else None
    train_loader, val_loader = make_loaders(args, args.batch_size)
    train_loader = prefetched(train_loader, args.prefetch)
    gen = torch.Generator(device=args.device).manual_seed(args.seed)
    save_path = args.save_path or "./runs_pretrain/model"
    os.makedirs(save_path, exist_ok=True)
    writer = run_writer(save_path, hparams=slm_cfg)
    keeper = BestCheckpointKeeper(save_path)
    try:
        for epoch in range(slm_cfg.get("epochs", 10)):
            train_loader.set_epoch(epoch)
            model.train()
            batches = slm_batches(train_loader, args.device, cache=cache)
            logs = train_epoch(plan.batches(batches) if plan else batches, step, gen, epoch)
            model.eval()
            val = evaluate_epoch(model, slm_batches(val_loader, args.device), gen, amp)
            val_loss = sum(val[k] for k in VAL_KEYS)
            print(f"epoch {epoch}: train {logs} val loss {val_loss:.4f} {val}", flush=True)
            writer.add_scalars(logs, epoch + 1, prefix="train/")
            writer.add_scalars(val, epoch + 1, prefix="val/")
            writer.add_scalar("val/loss", val_loss, epoch + 1)
            writer.add_scalar("learning_rate", args.lr, epoch + 1)
            if keeper.update(val_loss, model, state_dict_fn(plan, model)):
                print(f"epoch {epoch}: new best {val_loss:.4f}", flush=True)
    finally:
        writer.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
