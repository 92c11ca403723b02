"""Listener evaluation with best-of-N sampling (reference
``code/test_s2s_pretrain.py``), on the GPU by default.

    python -m dyadic_interaction_modeling_tpu_torch.cli.test_s2s_pretrain \
        --synthetic [--device cpu] [--state-dict PATH] [KEY VALUE ...]

Builds SLMFT, loads a state_dict in the port's (reference) key layout when
given (else a random init from ``--seed``), generates best-of-N by per-clip
FD, prints the metric battery and pickles the predictions
(``l2l_listener_predictions.pkl`` layout). Trailing ``KEY VALUE`` pairs
override ``slm_defaults()``.
"""

from __future__ import annotations

import argparse
import logging
import pickle

import torch

from ..config import merge_cfg_from_list, slm_defaults, vq_cfg_for
from ..data.loader import PaddedBatchLoader, slm_batch_from_collated
from ..data.synthetic import synthetic_vico_dataset
from ..engine.pt_engine import evaluate_test_epoch, make_slmft_generator
from ..metrics.reporting import print_metrics, print_metrics_full
from ..models.slm import SLMFT

log = logging.getLogger(__name__)


def get_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="SLMFT best-of-N evaluation")
    parser.add_argument("--synthetic", action="store_true",
                        help="evaluate on synthetic ViCo-shaped clips")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--state-dict", type=str, default=None,
                        help="SLMFT state_dict (.pt) in the port's key layout")
    parser.add_argument("--beam-size", type=int, default=10)
    parser.add_argument("--batch-size", type=int, default=4)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--out", type=str, default="l2l_listener_predictions.pkl")
    parser.add_argument("opts", nargs=argparse.REMAINDER,
                        help="KEY VALUE overrides of slm_defaults()")
    return parser


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
    if args.state_dict:
        model.load_state_dict(torch.load(args.state_dict, map_location="cpu",
                                         weights_only=True))
    else:
        log.warning("no --state-dict given: evaluating random init")
    model = model.to(args.device).eval()

    loader = PaddedBatchLoader(synthetic_vico_dataset(n_clips=8, seed=3),
                               args.batch_size, shuffle=False)
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
