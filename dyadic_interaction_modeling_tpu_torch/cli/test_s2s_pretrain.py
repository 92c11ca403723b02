"""Listener evaluation with best-of-N sampling (reference
``code/test_s2s_pretrain.py``), on the GPU by default.

    python -m dyadic_interaction_modeling_tpu_torch.cli.test_s2s_pretrain \
        [--synthetic] [--config FILE.yaml] [--device cpu] [--state-dict PATH] \
        [KEY VALUE ...]

Builds SLMFT, loads a checkpoint in the reference's layout when given (the
finetune twin's ``best_model.pt`` or a reference ``.pt`` such as
``best_vico_causal.pt``: ``{'state_dict': ...}``, ``module.`` and
``gamma``/``beta`` keys accepted, loaded with ``strict=True``; else a
random init from ``--seed``), generates best-of-N by per-clip FD, prints the
metric battery and pickles the predictions (``l2l_listener_predictions.pkl``
layout). The clips are the finetune twin's validation set: synthetic with
``--synthetic``, else the test split of the ViCo files under ``../data``.
Trailing ``KEY VALUE`` pairs override ``slm_defaults()``.
"""

from __future__ import annotations

import logging
import pickle

import torch

from ..config import slm_defaults, vq_cfg_for
from ..data.loader import slm_batch_from_collated
from ..engine.pt_engine import evaluate_test_epoch, make_slmft_generator
from ..metrics.reporting import print_metrics, print_metrics_full
from ..models.slm import SLMFT
from ..utils.checkpoint import load_reference
from .common import get_parser as common_parser
from .common import load_config
from .finetune_s2s_pretrain import make_loaders

log = logging.getLogger(__name__)


def get_parser():
    parser = common_parser("SLMFT best-of-N evaluation")
    parser.add_argument("--state-dict", type=str, default=None,
                        help="SLMFT checkpoint in the reference's layout")
    parser.add_argument("--beam-size", type=int, default=10)
    parser.add_argument("--batch-size", type=int, default=4)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--out", type=str, default="l2l_listener_predictions.pkl")
    return parser


def main(argv=None):
    args = get_parser().parse_args(argv)
    slm_cfg = load_config(args, slm_defaults)
    vq_cfg = vq_cfg_for(slm_cfg, args.synthetic)

    torch.manual_seed(args.seed)
    model = SLMFT(slm_cfg, vq_cfg)
    if args.state_dict:
        load_reference(model, args.state_dict)
    else:
        log.warning("no --state-dict given: evaluating random init")
    model = model.to(args.device).eval()

    _, loader = make_loaders(args, args.batch_size)
    batches = (slm_batch_from_collated(c) + (c[5],) for c in loader)
    gen = make_slmft_generator(model)
    rng = torch.Generator(device=args.device).manual_seed(args.seed)
    y_true, y_pred, xs, ids = evaluate_test_epoch(
        model, gen, batches, rng, beam_size=args.beam_size, device=args.device)
    print_metrics(y_true, y_pred, xs)
    print_metrics_full(y_true, y_pred, xs)
    with open(args.out, "wb") as f:
        pickle.dump({"y_true": y_true, "y_pred": y_pred, "x": xs, "ids": ids}, f)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
