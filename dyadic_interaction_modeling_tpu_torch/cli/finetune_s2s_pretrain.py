"""SLMFT listener finetune on ViCo (reference ``code/finetune_s2s_pretrain.py``),
on the GPU by default.

    python -m dyadic_interaction_modeling_tpu_torch.cli.finetune_s2s_pretrain \\
        [--synthetic] [--config FILE.yaml] [--device cpu] [--dtype bfloat16] \\
        [--pretrained PATH] [--speaker-vq PATH] [--listener-vq PATH] \\
        [--vq-token-cache] [--prefetch N] [--epochs N] [--save-path DIR] \\
        [KEY VALUE ...]

Builds SLMFT from a seeded random init and loads, when given, the speaker
and listener VQs and then a pretrained SLM, all checkpoints in the
reference's layout (the twins' ``best_model.pt`` or reference files:
``{'state_dict': ...}``, ``module.`` and ``gamma``/``beta`` keys accepted).
SLMFT's speaker VQ has no decoder, so a speaker VQ's decoder keys are
dropped; the pretrained SLM is grafted by top-level module with the parts
SLMFT has no module for dropped by name (``SLM_ONLY``). Both VQs stay
frozen; AdamW (lr 1e-5, weight decay 0.01, torch's default as the reference
leaves it) with a global-norm clip of 1.0 trains the rest on teacher-forced
listener codes whose inputs are 15% corrupted. Each epoch it runs the FD
battery on teacher-forced validation predictions (``print_metrics``) and
saves the state_dict of the best FD, pose plus expression (``best_model.pt``
under ``--save-path``), with the run record beside it
(``utils.observability``, the JAX CLI's tags: ``train/`` the last step's
logs, ``val/`` the battery's scalars, ``learning_rate``). Trailing ``KEY
VALUE`` pairs override ``slm_defaults()`` (``epochs`` sets the number of
epochs).

Data: with ``--synthetic``, synthetic ViCo-shaped clips; else the ViCo
files in the reference's layout, ``../data/vico_processed_30fps`` and
``../data/RLD_data.csv`` relative to the working directory, as the
reference and the JAX package read them: the train split to train, the test
split to validate. ``--vq-token-cache`` and ``--prefetch`` as in the
``train_s2s_pretrain`` twin. ``--mesh`` (JAX ``finetune_s2s_pretrain.py:92``)
trains on several devices, one process each (``parallel.MeshPlan``;
``--batch-size`` the global batch, each rank validating on the whole test
split, rank 0 writing).
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import slm_defaults, vq_cfg_for
from ..data.datasets import ViCoDataset
from ..data.loader import PaddedBatchLoader
from ..data.synthetic import synthetic_vico_dataset
from ..engine.pt_engine import (VQTokenCache, evaluate_finetune_epoch,
                                make_slm_train_step, train_epoch)
from ..engine.train_state import freeze, make_optimizer
from ..metrics.reporting import print_metrics
from ..models.slm import SLM_ONLY, SLMFT, SLMFT_FROZEN
from ..utils.checkpoint import BestCheckpointKeeper, load_reference
from ..utils.observability import run_writer
from .common import get_parser as common_parser
from .common import load_config, prefetched, slm_batches, state_dict_fn, training_mesh


def get_parser():
    parser = common_parser("SLMFT listener finetune")
    parser.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"],
                        help="autocast dtype of the forward; parameters stay fp32")
    parser.add_argument("--pretrained", type=str, default=None,
                        help="SLM checkpoint (the train_s2s_pretrain twin's, or a "
                             "reference one)")
    parser.add_argument("--speaker-vq", type=str, default=None,
                        help="speaker VQAutoEncoder checkpoint, reference layout")
    parser.add_argument("--listener-vq", type=str, default=None,
                        help="listener VQAutoEncoder checkpoint, reference layout")
    parser.add_argument("--batch-size", type=int, default=4)
    parser.add_argument("--lr", type=float, default=1e-5)
    parser.add_argument("--weight-decay", type=float, default=0.01)
    parser.add_argument("--clip-norm", type=float, default=1.0)
    parser.add_argument("--vq-token-cache", action="store_true",
                        help="tokenize each clip once with the frozen VQs and reuse "
                             "the codes across epochs")
    parser.add_argument("--seed", type=int, default=0)
    return parser


def load_weights(model: SLMFT, speaker_vq=None, listener_vq=None, pretrained=None):
    """The VQs first, then the pretrained SLM over them (the JAX package's
    order, finetune_s2s_pretrain.py:84-89)."""
    if speaker_vq:
        load_reference(model.speaker_vq, speaker_vq, drop_prefixes=("decoder.",))
    if listener_vq:
        load_reference(model.listener_vq, listener_vq)
    if pretrained:
        load_reference(model, pretrained, drop_prefixes=SLM_ONLY)


def make_loaders(args, batch_size: int):
    if args.synthetic:
        train, val = synthetic_vico_dataset(n_clips=16), synthetic_vico_dataset(
            n_clips=8, seed=3)
    else:
        train = ViCoDataset("../data/vico_processed_30fps", "../data/RLD_data.csv", "train")
        val = ViCoDataset("../data/vico_processed_30fps", "../data/RLD_data.csv", "test")
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
    model = SLMFT(slm_cfg, vq_cfg)
    load_weights(model, args.speaker_vq, args.listener_vq, args.pretrained)
    model = model.to(args.device)
    freeze(model, SLMFT_FROZEN)
    stepped = plan.shard_state(model) if plan else model
    optimizer = make_optimizer(model, args.lr, args.weight_decay, SLMFT_FROZEN)
    amp = torch.bfloat16 if args.dtype == "bfloat16" else None
    step = make_slm_train_step(stepped, optimizer, args.clip_norm, amp,
                               with_vq_tokens=args.vq_token_cache)
    cache = VQTokenCache(model, amp) if args.vq_token_cache else None
    train_loader, val_loader = make_loaders(args, args.batch_size)
    train_loader = prefetched(train_loader, args.prefetch)
    gen = torch.Generator(device=args.device).manual_seed(args.seed)
    save_dir = args.save_path or "./runs_vico_ft/model"
    keeper = BestCheckpointKeeper(save_dir)
    writer = run_writer(save_dir, hparams=slm_cfg)
    try:
        for epoch in range(slm_cfg.get("epochs", 10)):
            train_loader.set_epoch(epoch)
            model.train()
            batches = slm_batches(train_loader, args.device, cache=cache)
            logs = train_epoch(plan.batches(batches) if plan else batches, step, gen, epoch)
            model.eval()
            y_true, y_pred, xs, _ = evaluate_finetune_epoch(
                model, slm_batches(val_loader, args.device, with_names=True), gen, amp)
            m = print_metrics(y_true, y_pred, xs, verbose=False)
            fd = m["fid_pose"] + m["fid_exp"]
            print(f"epoch {epoch}: train {logs} FD pose {m['fid_pose']:.4f} exp "
                  f"{m['fid_exp']:.4f}", flush=True)
            writer.add_scalars(logs, epoch + 1, prefix="train/")
            writer.add_scalars({k: float(v) for k, v in m.items() if np.ndim(v) == 0},
                               epoch + 1, prefix="val/")
            writer.add_scalar("learning_rate", args.lr, epoch + 1)
            if keeper.update(fd, model, state_dict_fn(plan, model)):
                print(f"epoch {epoch}: new best FD {fd:.4f}", flush=True)
    finally:
        writer.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
