"""SLMFT listener finetune (reference ``code/finetune_s2s_pretrain.py``), on
the GPU by default.

    python -m dyadic_interaction_modeling_tpu_torch.cli.finetune_s2s_pretrain \\
        --synthetic [--device cpu] [--dtype bfloat16] [--pretrained PATH] \\
        [--speaker-vq PATH] [--listener-vq PATH] [--save-path DIR] [KEY VALUE ...]

Builds SLMFT from a seeded random init and loads, when given, the speaker
and listener VQs (port-layout ``VQAutoEncoder`` state_dicts, as the
``train_vq`` twin writes them; SLMFT's speaker VQ has no decoder, so a
speaker VQ's decoder keys are dropped) and then a pretrained SLM (the
``train_s2s_pretrain`` twin's state_dict), grafted by top-level module with
the parts SLMFT has no module for dropped by name (``SLM_ONLY``). Both VQs
stay frozen; AdamW (lr 1e-5, weight decay 0.01, torch's default as the
reference leaves it) with a global-norm clip of 1.0 trains the rest on
teacher-forced listener codes whose inputs are 15% corrupted. Each epoch it
runs the FD battery on teacher-forced validation predictions
(``print_metrics``) and saves the state_dict of the best FD, pose plus
expression (``best_model.pt`` under ``--save-path``). Trailing ``KEY
VALUE`` pairs override ``slm_defaults()`` (``epochs`` sets the number of
epochs).
"""

from __future__ import annotations

import argparse

import torch

from ..config import merge_cfg_from_list, slm_defaults, vq_cfg_for
from ..data.loader import PaddedBatchLoader, slm_batch_from_collated
from ..data.synthetic import synthetic_vico_dataset
from ..engine.pt_engine import evaluate_finetune_epoch, make_slm_train_step, train_epoch
from ..engine.train_state import make_optimizer
from ..metrics.reporting import print_metrics
from ..models.slm import SLM_ONLY, SLMFT, SLMFT_FROZEN
from ..utils.checkpoint import BestCheckpointKeeper, partial_load


def get_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="SLMFT listener finetune")
    parser.add_argument("--synthetic", action="store_true",
                        help="finetune on synthetic ViCo-shaped clips")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"],
                        help="autocast dtype of the forward; parameters stay fp32")
    parser.add_argument("--pretrained", type=str, default=None,
                        help="SLM state_dict (.pt) from the train_s2s_pretrain twin")
    parser.add_argument("--speaker-vq", type=str, default=None,
                        help="speaker VQAutoEncoder state_dict (.pt), port layout")
    parser.add_argument("--listener-vq", type=str, default=None,
                        help="listener VQAutoEncoder state_dict (.pt), port layout")
    parser.add_argument("--batch-size", type=int, default=4)
    parser.add_argument("--lr", type=float, default=1e-5)
    parser.add_argument("--weight-decay", type=float, default=0.01)
    parser.add_argument("--clip-norm", type=float, default=1.0)
    parser.add_argument("--save-path", type=str, default="./runs_vico_ft/model")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("opts", nargs=argparse.REMAINDER,
                        help="KEY VALUE overrides of slm_defaults()")
    return parser


def _load(path):
    return torch.load(path, map_location="cpu", weights_only=True)


def load_weights(model: SLMFT, speaker_vq=None, listener_vq=None, pretrained=None):
    """The VQs first, then the pretrained SLM over them (the JAX package's
    order, finetune_s2s_pretrain.py:84-89)."""
    if speaker_vq:
        partial_load(model.speaker_vq, _load(speaker_vq), drop_prefixes=("decoder.",))
    if listener_vq:
        model.listener_vq.load_state_dict(_load(listener_vq), strict=True)
    if pretrained:
        partial_load(model, _load(pretrained), drop_prefixes=SLM_ONLY)


def _batches(loader, device, with_ids=False):
    for collated in loader:
        batch = tuple(torch.as_tensor(x, device=device)
                      for x in slm_batch_from_collated(collated))
        yield batch + (collated[5],) if with_ids else batch


def main(argv=None):
    args = get_parser().parse_args(argv)
    if not args.synthetic:
        raise SystemExit("only --synthetic data is wired into the torch port yet")
    slm_cfg = slm_defaults()
    if args.opts:
        slm_cfg = merge_cfg_from_list(slm_cfg, args.opts)
    vq_cfg = vq_cfg_for(slm_cfg, args.synthetic)

    torch.manual_seed(args.seed)
    model = SLMFT(slm_cfg, vq_cfg)
    load_weights(model, args.speaker_vq, args.listener_vq, args.pretrained)
    model = model.to(args.device)
    optimizer = make_optimizer(model, args.lr, args.weight_decay, SLMFT_FROZEN)
    amp = torch.bfloat16 if args.dtype == "bfloat16" else None
    step = make_slm_train_step(model, optimizer, args.clip_norm, amp)
    train_loader = PaddedBatchLoader(synthetic_vico_dataset(n_clips=16), args.batch_size,
                                     shuffle=True)
    val_loader = PaddedBatchLoader(synthetic_vico_dataset(n_clips=8, seed=3),
                                   args.batch_size, shuffle=False)
    gen = torch.Generator(device=args.device).manual_seed(args.seed)
    keeper = BestCheckpointKeeper(args.save_path)
    for epoch in range(slm_cfg.get("epochs", 10)):
        train_loader.set_epoch(epoch)
        model.train()
        logs = train_epoch(_batches(train_loader, args.device), step, gen, epoch)
        model.eval()
        y_true, y_pred, xs, _ = evaluate_finetune_epoch(
            model, _batches(val_loader, args.device, with_ids=True), gen, amp)
        m = print_metrics(y_true, y_pred, xs, verbose=False)
        fd = m["fid_pose"] + m["fid_exp"]
        print(f"epoch {epoch}: train {logs} FD pose {m['fid_pose']:.4f} exp "
              f"{m['fid_exp']:.4f}", flush=True)
        if keeper.update(fd, model):
            print(f"epoch {epoch}: new best FD {fd:.4f}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
