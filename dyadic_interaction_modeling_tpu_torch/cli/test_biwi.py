"""BIWI speaker evaluation (reference ``code/test_biwi.py``), on the GPU by
default.

    python -m dyadic_interaction_modeling_tpu_torch.cli.test_biwi \\
        (--synthetic | --data-root DIR [--hubert-checkpoint PATH] [--split S]) \\
        [--device cpu] [--checkpoint PATH | --torch-checkpoint PATH] \\
        [--out-dir DIR] [--vertice-dim N] [--mouth-map F] [--upper-map F] \\
        [KEY VALUE ...]

The twin of ``dyadic_interaction_modeling_tpu/cli/test_biwi.py``. Builds
SpeakerSLMFT from a seeded random init, or loads ``--checkpoint`` (the
port's own state_dict, ``strict=True``) or ``--torch-checkpoint`` (a
reference file such as ``best_model_biwi_finetune*.pt``, the parts no
forward touches dropped by name, ``SPEAKER_SLMFT_REFERENCE_ONLY``). Each
clip runs the teacher-forced forward, as the reference's best-of-50 loop
does (x_engine_pt.py:319-336: its 50 "samples" are one deterministic
decode, so ``--beam-size`` changes nothing), and its ground-truth and
predicted EMOCA go to ``gt/`` and ``pred/`` under ``--out-dir`` as
``.npy``. The predictions then go through the BiLSTM mesh head and LVE /
FDD are printed, with ``--synthetic`` (mouth and upper maps of half the
vertices each) or when both region files (``--mouth-map`` /
``--upper-map``, the reference's lve.txt / fdd.txt) are given.

Data: ``--synthetic`` makes 4 BIWI-shaped clips of 16 frames
(``data.synthetic.synthetic_biwi_dataset``, EMOCA from synthetic ViCo
motion, Gaussian audio features), as the JAX CLI does. ``--data-root``
reads the ``--split`` of a raw BIWI tree (``wav/``, ``vertices_npy/``,
``emoca_biwi/``, ``templates.pkl``) through ``read_biwi_emoca_data``, its
audio through the port's HuBERT extractor on ``--device``
(``make_hubert_extractor``: ``--hubert-checkpoint``, else a random-init
trunk from ``--seed``, with a warning), one clip a batch, each cut to its
shorter of vertices and EMOCA; an empty split stops. Trailing
``KEY VALUE`` pairs override ``slm_defaults()``.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..config import slm_defaults, vq_cfg_for
from ..data.datasets import BiwiEmocaDataset, read_biwi_emoca_data
from ..data.synthetic import synthetic_biwi_dataset, synthetic_vico_dataset
from ..engine.pt_engine import speaker_ids_from_names
from ..metrics.reporting import print_biwi_metrics
from ..models.hubert import make_hubert_extractor
from ..models.slm import SPEAKER_SLMFT_REFERENCE_ONLY, SpeakerSLMFT
from ..utils.checkpoint import load_reference
from .common import get_parser as common_parser
from .common import load_config

SYNTHETIC_CLIPS, SYNTHETIC_LEN = 4, 16


def get_parser():
    parser = common_parser("BIWI speaker evaluation")
    parser.add_argument("--checkpoint", type=str, default=None,
                        help="the port's SpeakerSLMFT state_dict")
    parser.add_argument("--torch-checkpoint", type=str, default=None,
                        help="reference-layout .pt (best_model_biwi_finetune*.pt)")
    parser.add_argument("--beam-size", type=int, default=50,
                        help="the reference's beam; its loop is one deterministic decode")
    parser.add_argument("--out-dir", type=str, default="./biwi_out")
    parser.add_argument("--vertice-dim", type=int, default=70110)
    parser.add_argument("--mouth-map", type=str, default=None,
                        help="vertex-index file (reference lve.txt) enabling LVE")
    parser.add_argument("--upper-map", type=str, default=None,
                        help="vertex-index file (reference fdd.txt) enabling FDD")
    parser.add_argument("--data-root", type=str, default=None,
                        help="raw BIWI tree (wav/ vertices_npy/ emoca_biwi/ templates.pkl)")
    parser.add_argument("--hubert-checkpoint", type=str, default=None,
                        help="torch HuBERT checkpoint for the audio features "
                             "(s3prl Upstream / fairseq / HF layouts)")
    parser.add_argument("--split", type=str, default="test", choices=["train", "val", "test"])
    parser.add_argument("--seed", type=int, default=0)
    return parser


def synthetic_batches(vertice_dim: int, n_clips: int = SYNTHETIC_CLIPS,
                      length: int = SYNTHETIC_LEN):
    """The JAX CLI's synthetic clips, one a batch: ((1, L, vertice_dim)
    vertices, (1, L, 56) EMOCA, (1, L, 768) audio, (1, vertice_dim)
    template, [name]) numpy arrays, and the templates by subject."""
    n_v = vertice_dim // 3
    items, templates = synthetic_biwi_dataset(n_clips=n_clips, length=length, n_vertices=n_v)
    emoca_src = synthetic_vico_dataset(n_clips=n_clips, min_len=length, max_len=length)
    batches = []
    for i, item in enumerate(items):
        audio = np.random.default_rng(i).standard_normal((length, 768)).astype(np.float32)
        batches.append((item["vertice"][None], emoca_src[i][1][:length][None], audio[None],
                        item["template"][None], [item["name"]]))
    return batches, templates


def file_batches(data_root: str, split: str, extract):
    """The ``split`` of the BIWI tree at ``data_root``, one clip a batch as
    ``synthetic_batches`` gives them, each cut to its shorter of vertices and
    EMOCA, and the templates by subject."""
    parts = dict(zip(("train", "val", "test"), read_biwi_emoca_data(data_root, extract)[:3]))
    ds = BiwiEmocaDataset(parts[split], data_type=split, read_audio=True)
    if len(ds) == 0:
        raise SystemExit(f"no clips in split {split!r} under {data_root}")
    batches, templates = [], {}
    for i in range(len(ds)):
        audio, vertice, template, emoca, name = ds[i]
        n = min(len(vertice), len(emoca))
        batches.append((vertice[:n][None], emoca[:n][None], audio[:n][None], template[None],
                        [name]))
        templates["_".join(name.split("_")[:-1])] = template
    return batches, templates


def _region(path):
    """A region file's vertex indices, separated by commas or white space."""
    if not path:
        return None
    with open(path) as f:
        return [int(i) for i in f.read().replace(",", " ").split()]


def main(argv=None):
    args = get_parser().parse_args(argv)
    if not args.synthetic and not args.data_root:
        raise SystemExit("pass --data-root pointing at the BIWI tree (wav/ vertices_npy/ "
                         "emoca_biwi/ templates.pkl) or run with --synthetic")
    slm_cfg = load_config(args, slm_defaults)
    vq_cfg = vq_cfg_for(slm_cfg, args.synthetic)
    n_v = args.vertice_dim // 3
    if args.synthetic:
        batches, templates = synthetic_batches(args.vertice_dim)
        mouth_map, upper_map = list(range(n_v // 2)), list(range(n_v // 2, n_v))
    else:
        extract, _ = make_hubert_extractor(args.hubert_checkpoint, device=args.device,
                                           seed=args.seed)
        if not args.hubert_checkpoint:
            print("no --hubert-checkpoint: extracting with a random-init HuBERT trunk "
                  "(pipeline runs only)", flush=True)
        batches, templates = file_batches(args.data_root, args.split, extract)
        mouth_map, upper_map = _region(args.mouth_map), _region(args.upper_map)
    torch.manual_seed(args.seed)
    model = SpeakerSLMFT(slm_cfg, vq_cfg, vertice_dim=args.vertice_dim)
    if args.checkpoint:
        load_reference(model, args.checkpoint)
    elif args.torch_checkpoint:
        load_reference(model, args.torch_checkpoint, drop_prefixes=SPEAKER_SLMFT_REFERENCE_ONLY)
    else:
        print("no --checkpoint given: evaluating random init", flush=True)
    model = model.to(args.device).eval()

    for sub in ("gt", "pred"):
        os.makedirs(os.path.join(args.out_dir, sub), exist_ok=True)
    dev = args.device
    y_pred, gt_mesh, pred_mesh, names = [], [], [], []
    with torch.no_grad():
        for verts, emoca, audio, template, bnames in batches:
            v, e, a, t = (torch.as_tensor(x, device=dev) for x in (verts, emoca, audio, template))
            mask = torch.ones(v.shape[:2], dtype=torch.bool, device=dev)
            pred = model(v, e, a, mask, t, speaker_ids_from_names(bnames, dev)).pred
            mesh = model.mesh_head(pred) + t[:, None, :]
            pred, mesh = pred.float().cpu().numpy(), mesh.float().cpu().numpy()
            gt = emoca[:, 1:]
            for j, name in enumerate(bnames):
                stem = name.replace(".wav", ".npy")
                np.save(os.path.join(args.out_dir, "gt", stem), gt[j])
                np.save(os.path.join(args.out_dir, "pred", stem), pred[j])
                y_pred.append(pred[j])
                gt_mesh.append(verts[j, 1:])
                pred_mesh.append(mesh[j])
                names.append(name)
    print(f"wrote {len(y_pred)} clips to {args.out_dir}", flush=True)
    if mouth_map and upper_map:
        m = print_biwi_metrics(gt_mesh, pred_mesh, names, templates, mouth_map, upper_map,
                               n_vertices=n_v, verbose=False)
        print(f"LVE {m['lve']:.6e} FDD {m['fdd']:.6e}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
