"""PIRender batch inference (reference ``Pirender/inference_newmodel.py:339-405``
and the reenactment demo ``Pirender/inference.py:62-125``), on the GPU by
default.

    python -m dyadic_interaction_modeling_tpu_torch.cli.render_inference \\
        [--checkpoint PT] [--source-image IMG --coeff-dir DIR | --synthetic] \\
        [--out DIR] [--resolution N] [--semantic-radius R] [--batch-size B] \\
        [--device cpu]
    python -m dyadic_interaction_modeling_tpu_torch.cli.render_inference \\
        --video --vox-root ROOT [--cross-id] [--max-videos N] [--checkpoint PT] ...

Renders fake and warp frames (``{out}/fake/``, ``{out}/warp/``, PNG) from a
source image driven by an exported EMOCA coefficient directory (the
postprocess / emoca2flame layout). ``--synthetic`` writes a random source
image and a 6-frame coefficient directory under ``{out}/_synthetic_in``
first. ``--video`` renders every test video of a prepared VoxCeleb LMDB root
(``render.data.VoxVideoDataset``, 73-d Deep3DFace windows) from its own
first frame, or with ``--cross-id`` from another person's, and writes
gt | warp | fake side by side (an mp4 through cv2, else a PNG directory).

Weights: ``--checkpoint`` and ``--torch-checkpoint`` both read a
reference-layout ``.pt`` (``Pirender/trainers/base.py``: ``net_G_ema``, else
``net_G``, else a bare state_dict), loaded with ``strict=True``; the model's
widths, spectral norm included, come from the state_dict. Without one the
generator is random from seed 0, at the JAX CLI's widths (descriptor 32 and
2 mapping layers with ``--synthetic``, else 256 and 3). The JAX CLI's
``--checkpoint`` reads an orbax directory, which the port does not.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ..render.data import VoxVideoDataset, load_coeff_dir_clip
from ..render.generator import FaceGenerator, face_generator_from_state_dict
from ..render.image_io import read_rgb, write_png
from ..render.inference import render_clip, render_video_reenactment, write_frames
from ..utils.logging import get_logger


def load_generator_state(path: str):
    """A reference-layout PIRender ``.pt``: its ``net_G_ema``, else
    ``net_G``, else the file as a state_dict."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    if any(k.startswith("mapping_net") for k in payload):
        return payload
    return payload.get("net_G_ema") or payload.get("net_G") or payload


def build_generator(args, flame_coeff_nc: int, coeff_nc: int = 73, logger=None):
    """The checkpoint's generator, or a random one from seed 0; eval mode,
    on ``args.device``."""
    path = args.checkpoint or getattr(args, "torch_checkpoint", None)
    if path:
        model = face_generator_from_state_dict(load_generator_state(path))
    else:
        torch.manual_seed(0)
        model = FaceGenerator(flame_coeff_nc=flame_coeff_nc, coeff_nc=coeff_nc,
                              descriptor_nc=32 if args.synthetic else 256,
                              mapping_layers=2 if args.synthetic else 3)
        if logger:
            logger.warning("no --checkpoint: rendering with a random generator")
    return model.eval().to(args.device)


def load_source_image(path: str, resolution: int) -> np.ndarray:
    return read_rgb(path, (resolution, resolution)).astype(np.float32) / 127.5 - 1.0


def synthetic_inputs(root: str, resolution: int, frames: int = 6):
    """The JAX CLI's synthetic inputs: a random source PNG and a coefficient
    directory of ``frames`` frames (pose 6 + exp 50), from RandomState(0)."""
    rng = np.random.RandomState(0)
    os.makedirs(root, exist_ok=True)
    src = os.path.join(root, "source.png")
    write_png(src, rng.randint(0, 255, (resolution, resolution, 3), dtype=np.uint8))
    coeff_dir = os.path.join(root, "clip0")
    for i in range(frames):
        d = os.path.join(coeff_dir, f"{i:06d}")
        os.makedirs(d, exist_ok=True)
        np.save(os.path.join(d, "pose.npy"), rng.randn(6).astype(np.float32) * 0.1)
        np.save(os.path.join(d, "exp.npy"), rng.randn(50).astype(np.float32) * 0.3)
    return src, coeff_dir


def get_parser():
    parser = argparse.ArgumentParser(description="PIRender inference")
    parser.add_argument("--checkpoint", type=str, default=None,
                        help="reference-layout PIRender .pt (net_G_ema / net_G / "
                             "a state_dict)")
    parser.add_argument("--torch-checkpoint", type=str, default=None,
                        help="the same as --checkpoint (the JAX CLI's name for a "
                             "reference .pt)")
    parser.add_argument("--source-image", type=str, default=None)
    parser.add_argument("--coeff-dir", type=str, default=None)
    parser.add_argument("--out", type=str, default="./render_out")
    parser.add_argument("--resolution", type=int, default=64)
    parser.add_argument("--coeff-nc", type=int, default=58,
                        help="kept from the JAX CLI; the widths come from the data and "
                             "the checkpoint")
    parser.add_argument("--semantic-radius", type=int, default=13)
    parser.add_argument("--synthetic", action="store_true")
    parser.add_argument("--video", action="store_true",
                        help="whole-video reenactment over a prepared VoxCeleb LMDB "
                             "root (--vox-root): gt|warp|fake side by side")
    parser.add_argument("--vox-root", type=str, default=None,
                        help="prepared LMDB root ({root}/{res} env + test_list.txt)")
    parser.add_argument("--cross-id", action="store_true",
                        help="drive a random other person's source frame (with crop "
                             "renormalization)")
    parser.add_argument("--max-videos", type=int, default=0,
                        help="cap on rendered test videos (0 = all)")
    parser.add_argument("--batch-size", type=int, default=8)
    parser.add_argument("--device", default="cuda",
                        help="torch device; cpu renders on the CPU")
    return parser


def _video_reenactment(args, logger):
    if not args.vox_root:
        raise SystemExit("--video needs --vox-root <prepared LMDB root>")
    ds = VoxVideoDataset(args.vox_root, resolution=args.resolution,
                         semantic_radius=args.semantic_radius, cross_id=args.cross_id)
    model = build_generator(args, 73, logger=logger)
    written = render_video_reenactment(model, ds, args.out, batch_size=args.batch_size,
                                       max_videos=args.max_videos, logger=logger)
    logger.info(f"wrote {len(written)} reenactment video(s) under {args.out} "
                f"(cross_id={args.cross_id})")
    return written


def main(argv=None):
    args = get_parser().parse_args(argv)
    logger = get_logger()
    if args.video:
        return _video_reenactment(args, logger)
    if args.synthetic and (args.source_image is None or args.coeff_dir is None):
        args.source_image, args.coeff_dir = synthetic_inputs(
            os.path.join(args.out, "_synthetic_in"), args.resolution)
    coeffs = load_coeff_dir_clip(args.coeff_dir)
    src = load_source_image(args.source_image, args.resolution)
    model = build_generator(args, coeffs.shape[-1], logger=logger)
    if model.mapping_net.pre.in_channels != coeffs.shape[-1]:
        logger.warning(f"coefficient dim mismatch: checkpoint expects "
                       f"{model.mapping_net.pre.in_channels}, data has {coeffs.shape[-1]}")
    out = render_clip(model, src, coeffs, semantic_radius=args.semantic_radius,
                      batch_size=args.batch_size)
    for kind in ("fake_image", "warp_image"):
        write_frames(os.path.join(args.out, kind.split("_")[0]), out[kind])
    logger.info(f"rendered {out['fake_image'].shape[0]} frames to {args.out} "
                f"(fake/ + warp/)")
    return out


if __name__ == "__main__":
    main()
