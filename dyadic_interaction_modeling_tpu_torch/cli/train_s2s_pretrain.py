"""Dyadic SLM pretraining (reference ``code/train_s2s_pretrain.py``), on the
GPU by default.

    python -m dyadic_interaction_modeling_tpu_torch.cli.train_s2s_pretrain \\
        --synthetic [--device cpu] [--dtype bfloat16] [--speaker-vq PATH] \\
        [--listener-vq PATH] [--save-path DIR] [KEY VALUE ...]

Builds SLM from a seeded random init, loads the speaker and listener VQs
when given (port-layout ``VQAutoEncoder`` state_dicts, ``strict=True``),
freezes their encoders and quantizers, and trains with AdamW (lr 1e-5,
weight decay 0.01, the reference's torch defaults) and a global-norm clip
of 1.0 (x_engine_pt.py:37-38). Each epoch it trains, reports the validation
loss and saves the best state_dict (``best_model.pt`` under
``--save-path``). Trailing ``KEY VALUE`` pairs override ``slm_defaults()``
(``epochs`` sets the number of epochs).
"""

from __future__ import annotations

import argparse
import os

import torch

from ..config import merge_cfg_from_list, slm_defaults, vq_cfg_for
from ..data.loader import PaddedBatchLoader, slm_batch_from_collated
from ..data.synthetic import synthetic_candor_dataset
from ..engine.pt_engine import evaluate_epoch, make_slm_train_step, train_epoch
from ..engine.train_state import make_optimizer
from ..models.slm import SLM, SLM_FROZEN

VAL_KEYS = ("l_ce_s", "l_ce_l", "l_cont_s", "l_cont_l", "nce")


def get_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="SLM dyadic pretraining")
    parser.add_argument("--synthetic", action="store_true",
                        help="train on synthetic CANDOR-shaped clips")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--speaker-vq", type=str, default=None,
                        help="speaker VQAutoEncoder state_dict (.pt), port layout")
    parser.add_argument("--listener-vq", type=str, default=None,
                        help="listener VQAutoEncoder state_dict (.pt), port layout")
    parser.add_argument("--batch-size", type=int, default=32)
    parser.add_argument("--lr", type=float, default=1e-5)
    parser.add_argument("--weight-decay", type=float, default=0.01)
    parser.add_argument("--clip-norm", type=float, default=1.0)
    parser.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"],
                        help="autocast dtype of the forward; parameters stay fp32")
    parser.add_argument("--save-path", type=str, default="./runs_pretrain/model")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("opts", nargs=argparse.REMAINDER,
                        help="KEY VALUE overrides of slm_defaults()")
    return parser


def _batches(loader, device):
    for collated in loader:
        yield tuple(torch.as_tensor(x, device=device)
                    for x in slm_batch_from_collated(collated))


def main(argv=None):
    args = get_parser().parse_args(argv)
    if not args.synthetic:
        raise SystemExit("only --synthetic data is wired into the torch port yet")
    slm_cfg = slm_defaults()
    if args.opts:
        slm_cfg = merge_cfg_from_list(slm_cfg, args.opts)
    vq_cfg = vq_cfg_for(slm_cfg, args.synthetic)

    torch.manual_seed(args.seed)
    model = SLM(slm_cfg, vq_cfg)
    for vq, path in (("speaker_vq", args.speaker_vq), ("listener_vq", args.listener_vq)):
        if path:
            getattr(model, vq).load_state_dict(
                torch.load(path, map_location="cpu", weights_only=True), strict=True)
    model = model.to(args.device)
    optimizer = make_optimizer(model, args.lr, args.weight_decay, SLM_FROZEN)
    amp = torch.bfloat16 if args.dtype == "bfloat16" else None
    step = make_slm_train_step(model, optimizer, args.clip_norm, amp)
    train_loader = PaddedBatchLoader(synthetic_candor_dataset(n_clips=32),
                                     args.batch_size, shuffle=True)
    val_loader = PaddedBatchLoader(synthetic_candor_dataset(n_clips=8, seed=1),
                                   args.batch_size, shuffle=False)
    gen = torch.Generator(device=args.device).manual_seed(args.seed)
    os.makedirs(args.save_path, exist_ok=True)
    best = float("inf")
    for epoch in range(slm_cfg.get("epochs", 10)):
        train_loader.set_epoch(epoch)
        model.train()
        logs = train_epoch(_batches(train_loader, args.device), step, gen, epoch)
        model.eval()
        val = evaluate_epoch(model, _batches(val_loader, args.device), gen, amp)
        val_loss = sum(val[k] for k in VAL_KEYS)
        print(f"epoch {epoch}: train {logs} val loss {val_loss:.4f} {val}", flush=True)
        if val_loss < best:
            best = val_loss
            torch.save(model.state_dict(), os.path.join(args.save_path, "best_model.pt"))
            print(f"epoch {epoch}: new best {val_loss:.4f}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
