"""PIRender batch inference (reference ``Pirender/inference_newmodel.py`` and
``inference.py``).

Counterpart of ``dyadic_interaction_modeling_tpu/render/inference.py`` with
its numpy-in, numpy-out contract: a source frame (H, W, 3) and coefficient
windows in, (T, H, W, 3) fake and warp frames in [-1, 1] out, rendered on
the model's device in batches under ``torch.inference_mode()``. The model
renders in eval mode. Frames are written as PNG through ``image_io``.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

from .data import load_coeff_dir_clip, semantic_window
from .image_io import write_png


def _device(model) -> torch.device:
    return next(model.parameters()).device


def render_windows(model, source_image: np.ndarray, windows: np.ndarray,
                   batch_size: int = 8) -> Dict[str, np.ndarray]:
    """Render (T, C, W) coefficient windows against one source frame (the
    VoxVideoDataset contract). The JAX package pads the last block to keep
    one compiled program; eager PyTorch needs no padding, and every norm is
    per sample, so the frames are the same."""
    dev = _device(model)
    fakes, warps = [], []
    with torch.inference_mode():
        src = torch.as_tensor(np.asarray(source_image, np.float32), device=dev)
        src = src.permute(2, 0, 1)[None]
        for i in range(0, windows.shape[0], batch_size):
            w = torch.as_tensor(np.asarray(windows[i:i + batch_size], np.float32), device=dev)
            out = model(src.expand(w.shape[0], -1, -1, -1), w)
            fakes.append(out["fake_image"].float().permute(0, 2, 3, 1).cpu().numpy())
            warps.append(out["warp_image"].float().permute(0, 2, 3, 1).cpu().numpy())
    return {"fake_image": np.concatenate(fakes), "warp_image": np.concatenate(warps)}


def render_clip(model, source_image: np.ndarray, coeffs: np.ndarray,
                semantic_radius: int = 13, batch_size: int = 8) -> Dict[str, np.ndarray]:
    """source_image (H, W, 3) in [-1, 1]; coeffs (T, C). Returns
    {'fake_image': (T, H, W, 3), 'warp_image': (T, H, W, 3)}."""
    windows = np.stack([semantic_window(coeffs, i, semantic_radius)
                        for i in range(coeffs.shape[0])])
    return render_windows(model, source_image, windows, batch_size)


def to_uint8_video(video: np.ndarray) -> np.ndarray:
    """(T, H, W, 3) in [-1, 1] -> uint8, the write2video conversion
    (Pirender/inference.py:44-46), clipped."""
    return ((np.clip(video, -1, 1) + 1) / 2.0 * 255.0).astype(np.uint8)


def to_uint8_frame(frame: np.ndarray) -> np.ndarray:
    """A frame in [-1, 1] -> uint8 as the render CLIs write it."""
    return ((np.clip(frame, -1, 1) + 1) * 127.5).astype(np.uint8)


def write_frames(out_dir: str, frames: np.ndarray) -> None:
    """(T, H, W, 3) in [-1, 1] -> ``out_dir/{i:05d}.png``."""
    os.makedirs(out_dir, exist_ok=True)
    for i, frame in enumerate(frames):
        write_png(os.path.join(out_dir, f"{i:05d}.png"), to_uint8_frame(frame))


def write_reenactment_video(out_base: str, *videos: np.ndarray,
                            fps: int = 15) -> str:
    """Twin of ``write2video`` (Pirender/inference.py:40-60): the (T, H, W, 3)
    videos side by side (the reference's order: gt, warp, fake) as
    ``{out_base}.mp4`` at ``fps`` through cv2, or where cv2 does not import
    as PNG frames in ``{out_base}/``. Returns the path written."""
    cat = np.concatenate([to_uint8_video(v) for v in videos], axis=2)
    try:
        import cv2
    except ImportError:
        cv2 = None
    if cv2 is None:
        os.makedirs(out_base, exist_ok=True)
        for i, frame in enumerate(cat):
            write_png(os.path.join(out_base, f"{i:05d}.png"), frame)
        return out_base
    out_name = out_base + ".mp4"
    h, w = cat.shape[1:3]
    out = cv2.VideoWriter(out_name, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    for frame in cat:
        out.write(frame[:, :, ::-1])
    out.release()
    return out_name


def render_video_reenactment(model, dataset, out_dir: str, batch_size: int = 8,
                             max_videos: int = 0, logger=None) -> list:
    """The reenactment loop (Pirender/inference.py:99-125): each test video
    rendered from its (same- or cross-id) source frame, written as a
    gt | warp | fake video. ``dataset`` is a ``render.data.VoxVideoDataset``.
    Returns the written paths."""
    os.makedirs(out_dir, exist_ok=True)
    written = []
    n = len(dataset) if not max_videos else min(max_videos, len(dataset))
    for _ in range(n):
        data = dataset.load_next_video()
        out = render_windows(model, data["source_image"], data["target_semantics"],
                             batch_size=batch_size)
        path = write_reenactment_video(
            os.path.join(out_dir, data["video_name"].replace("/", "_")),
            data["target_images"], out["warp_image"], out["fake_image"])
        if logger:
            logger.info(f"write results to video {path}")
        written.append(path)
    return written


def render_coeff_dir(model, source_image: np.ndarray, clip_dir: str,
                     out_dir: Optional[str] = None, semantic_radius: int = 13,
                     batch_size: int = 8) -> Dict[str, np.ndarray]:
    """Render an exported coefficient directory (the postprocess
    ``export_emoca_dirs`` / ``merge_biwi_to_emoca`` layout); with ``out_dir``
    also the PNG frames under ``fake/`` and ``warp/``."""
    coeffs = load_coeff_dir_clip(clip_dir)
    out = render_clip(model, source_image, coeffs, semantic_radius, batch_size)
    if out_dir:
        for kind in ("fake_image", "warp_image"):
            write_frames(os.path.join(out_dir, kind.split("_")[0]), out[kind])
    return out
