"""Intuitive control demo (reference ``Pirender/intuitive_control.py``), on the
GPU by default.

    python -m dyadic_interaction_modeling_tpu_torch.cli.intuitive_control \\
        [--checkpoint PT] [--source-image IMG | --synthetic] [--controls DIR] \\
        [--out DIR] [--num N] [--resolution N] [--device cpu]

Walks the driving coefficients between control presets, rotation (the pose
dims) then expression (the exp dims), and renders each step from one source
image: for every preset, ``--num`` frames go linearly from the current
coefficients to the preset (intuitive_control.py:110-135), the whole window
holds the interpolated vector, and the generator renders it; the frames are
written as ``{out}/{i:05d}.png``. Presets come from ``expression.mat`` and
``rotation.mat`` in ``--controls`` (the reference's keys, read with scipy),
or else from built-in small offsets. The coefficient layout is the DIM
56-d one: [0:6] pose, [6:56] expression.

Weights as in ``render_inference``: ``--checkpoint`` reads a reference-layout
``.pt`` and sets the widths (the coefficient width included, whatever
``--coeff-nc`` says); without one the generator is random from seed 0, at
``--coeff-nc`` and the JAX CLI's widths.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ..render.image_io import write_png
from ..render.inference import to_uint8_frame
from ..utils.logging import get_logger
from .render_inference import build_generator, load_source_image

EXP_ORDER = ["expression_center", "expression_mouth", "expression_center",
             "expression_eyebrow", "expression_center", "expression_eyes",
             "expression_center"]
ROT_ORDER = ["rotation_center", "rotation_left", "rotation_center",
             "rotation_right", "rotation_center"]


def synthetic_controls(coeff_nc: int, rng) -> dict:
    ctr = np.zeros(coeff_nc, np.float32)
    out = {"expression_center": ctr[6:], "rotation_center": ctr[:6]}
    for name, scale in (("expression_mouth", 1.0), ("expression_eyebrow", 0.7),
                        ("expression_eyes", 0.5)):
        out[name] = rng.normal(0, scale, coeff_nc - 6).astype(np.float32)
    for name, yaw in (("rotation_left", -0.4), ("rotation_right", 0.4)):
        r = np.zeros(6, np.float32)
        r[1] = yaw
        out[name] = r
    return out


def load_mat_controls(path: str) -> dict:
    from scipy.io import loadmat

    out = {}
    for fname, keys in (("expression.mat", ["expression_center", "expression_mouth",
                                            "expression_eyebrow", "expression_eyes"]),
                        ("rotation.mat", ["rotation_center", "rotation_left",
                                          "rotation_right"])):
        mat = loadmat(os.path.join(path, fname))
        for k in keys:
            if k in mat:
                out[k] = np.asarray(mat[k], np.float32).reshape(-1)
    return out


def get_parser():
    parser = argparse.ArgumentParser(description="PIRender intuitive control")
    parser.add_argument("--checkpoint", type=str, default=None,
                        help="reference-layout PIRender .pt (net_G_ema / net_G / "
                             "a state_dict)")
    parser.add_argument("--source-image", type=str, default=None)
    parser.add_argument("--controls", type=str, default=None,
                        help="dir with expression.mat / rotation.mat presets")
    parser.add_argument("--out", type=str, default="./control_out")
    parser.add_argument("--num", type=int, default=10,
                        help="interpolation steps per control")
    parser.add_argument("--resolution", type=int, default=64)
    parser.add_argument("--coeff-nc", type=int, default=58)
    parser.add_argument("--semantic-radius", type=int, default=13)
    parser.add_argument("--synthetic", action="store_true")
    parser.add_argument("--device", default="cuda",
                        help="torch device; cpu renders on the CPU")
    return parser


def main(argv=None):
    args = get_parser().parse_args(argv)
    logger = get_logger()
    rng = np.random.RandomState(0)
    if args.synthetic and args.source_image is None:
        os.makedirs(args.out, exist_ok=True)
        args.source_image = os.path.join(args.out, "_source.png")
        write_png(args.source_image,
                  rng.randint(0, 255, (args.resolution, args.resolution, 3), dtype=np.uint8))
    src = load_source_image(args.source_image, args.resolution)
    model = build_generator(args, args.coeff_nc, logger=logger)
    coeff_nc = model.mapping_net.pre.in_channels
    controls = (load_mat_controls(args.controls) if args.controls
                else synthetic_controls(coeff_nc, rng))
    window = 2 * args.semantic_radius + 1
    dev = next(model.parameters()).device
    img = torch.as_tensor(src, device=dev).permute(2, 0, 1)[None]
    coeff = np.zeros(coeff_nc, np.float32)
    frames = []

    def sweep(order, lo, hi):
        current = coeff[lo:hi].copy()
        for name in order:
            target = controls.get(name)
            if target is None:
                continue
            target = target[: hi - lo]
            for i in range(args.num):
                val = (target - current) * i / (args.num - 1) + current
                coeff[lo:hi] = val
                sem = torch.as_tensor(np.repeat(coeff[:, None], window, axis=1)[None],
                                      device=dev)
                with torch.inference_mode():
                    fake = model(img, sem)["fake_image"]
                frames.append(fake[0].float().permute(1, 2, 0).cpu().numpy())
            current = val

    sweep(ROT_ORDER, 0, 6)              # rotation control (pose dims)
    sweep(EXP_ORDER, 6, coeff_nc)       # expression control
    os.makedirs(args.out, exist_ok=True)
    for i, f in enumerate(frames):
        write_png(os.path.join(args.out, f"{i:05d}.png"), to_uint8_frame(f))
    logger.info(f"intuitive control: wrote {len(frames)} frames to {args.out}")
    return len(frames)


if __name__ == "__main__":
    main()
