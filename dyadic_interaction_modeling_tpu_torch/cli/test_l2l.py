"""Scoring of exported listener predictions without a model (reference
``code/test_l2l.py``): a predictions pickle (``y_true``, ``y_pred``, ``x``,
as ``test_s2s_pretrain --out`` writes it) through ``print_metrics`` and
``print_metrics_full``.

    python -m dyadic_interaction_modeling_tpu_torch.cli.test_l2l \\
        [--predictions l2l_listener_predictions.pkl]
"""

from __future__ import annotations

import pickle

from ..metrics.reporting import print_metrics, print_metrics_full
from .common import get_parser


def main(argv=None) -> int:
    parser = get_parser("score exported listener predictions")
    parser.add_argument("--predictions", type=str, default="l2l_listener_predictions.pkl")
    args = parser.parse_args(argv)
    with open(args.predictions, "rb") as f:
        payload = pickle.load(f)
    y_true, y_pred, xs = payload["y_true"], payload["y_pred"], payload["x"]
    print(f"scoring {len(y_true)} clips from {args.predictions}", flush=True)
    print_metrics(y_true, y_pred, xs)
    print_metrics_full(y_true, y_pred, xs)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
