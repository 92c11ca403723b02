"""Seq2seq ListenerGenerator evaluation (reference ``code/test_s2s.py``):
autoregressive generation of every validation clip and the metric battery,
on the GPU by default.

    python -m dyadic_interaction_modeling_tpu_torch.cli.test_s2s \\
        [--synthetic] [--device cpu] [--checkpoint PATH] [--greedy] \\
        [--batch-size N] [KEY VALUE ...]

``--checkpoint`` is the ``train_s2s`` twin's ``best_model.pt`` or a
reference seq2seq ``.pt`` (``utils.checkpoint.load_reference``: the speaker
VQ's decoder, which no forward uses, and the id conditioning, which
generation does not use, are dropped by name); without it the model is a
seeded random init. A clip of length l is encoded (``encode_context``: the
speaker VQ's features, the encoder), l - 1 codes are sampled from its first
listener code (``generate_tokens``: top-k 10%, temperature 1, from a
``torch.Generator`` seeded with ``--seed``; ``--greedy`` takes the argmax)
and VQ-decoded, and the battery (``print_metrics``) compares them with
frames 1..l-1 of the listener. Trailing ``KEY VALUE`` pairs override
``listener_generator_defaults()``.
"""

from __future__ import annotations

import torch

from ..config import lg_vq_cfg, listener_generator_defaults
from ..metrics.reporting import print_metrics
from ..models.listener_generator import LG_ID_PARTS, LG_REFERENCE_ONLY, ListenerGenerator
from ..models.xtrans import generate_tokens
from ..utils.checkpoint import load_reference
from .common import get_parser as common_parser
from .common import load_config
from .finetune_s2s_pretrain import make_loaders
from .train_s2s import lg_batches


def get_parser():
    parser = common_parser("ListenerGenerator evaluation")
    parser.add_argument("--checkpoint", type=str, default=None,
                        help="the train_s2s twin's state_dict or a reference seq2seq .pt")
    parser.add_argument("--batch-size", type=int, default=4)
    parser.add_argument("--greedy", action="store_true", help="argmax decoding")
    parser.add_argument("--seed", type=int, default=1)
    return parser


@torch.no_grad()
def predict(model: ListenerGenerator, batches, generator=None, greedy: bool = False):
    """(y_true, y_pred, x) lists of per-clip numpy arrays of length len - 1."""
    y_true, y_pred, xs = [], [], []
    for src, tgt, mask in batches:
        enc, prompt = model.encode_context(src, tgt, mask)
        toks = generate_tokens(model.generator.decoder.net, prompt, src.shape[1] - 1, enc,
                               mask, generator, greedy)
        motion = model.decode_tokens_to_motion(toks).float().cpu().numpy()
        lens = mask.sum(dim=1).cpu().numpy()
        tgt_np, src_np = tgt.cpu().numpy(), src.cpu().numpy()
        for j in range(src_np.shape[0]):
            lj = int(lens[j])
            y_true.append(tgt_np[j, 1:lj])
            y_pred.append(motion[j, : lj - 1])
            xs.append(src_np[j, : lj - 1])
    return y_true, y_pred, xs


def main(argv=None) -> int:
    args = get_parser().parse_args(argv)
    cfg = load_config(args, listener_generator_defaults)
    vq_cfg = lg_vq_cfg(cfg, args.synthetic)
    torch.manual_seed(0)
    model = ListenerGenerator(cfg, vq_cfg, vq_cfg, with_ids=False)
    if args.checkpoint:
        load_reference(model, args.checkpoint, drop_prefixes=LG_REFERENCE_ONLY + LG_ID_PARTS)
    else:
        print("no --checkpoint given: evaluating a random init", flush=True)
    model = model.to(args.device).eval()
    _, val_loader = make_loaders(args, args.batch_size)
    gen = torch.Generator(device=args.device).manual_seed(args.seed)
    y_true, y_pred, xs = predict(model, (b[:3] for b in lg_batches(val_loader, args.device)),
                                 gen, args.greedy)
    print_metrics(y_true, y_pred, xs)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
