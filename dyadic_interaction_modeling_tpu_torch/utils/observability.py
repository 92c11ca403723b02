"""Run records of the training CLIs: scalars, hparams, image grids.

Counterpart of ``dyadic_interaction_modeling_tpu/utils/observability.py``,
the reference's tensorboardX surface (``train_vq.py:68,147-149,230-233``;
``Pirender/util/meters.py:103``, ``trainers/base.py:95-145``). A
``MetricsWriter`` always writes files that need no viewer, the JAX writer's:

* ``scalars.jsonl``: one ``{"step": n, "tag": ..., "value": ...}`` a line,
* ``hparams.json``: the run's config, flattened,
* ``images/<tag>_<step:09d>.png``: snapshot grids (``render.image_io``, no
  Pillow needed).

When ``torch.utils.tensorboard`` imports (it needs the ``tensorboard``
package) the same records also go to event files for ``tensorboard
--logdir``.
"""

from __future__ import annotations

import json
import os
from typing import Mapping, Optional, Sequence

import numpy as np

from ..render.image_io import write_png


def make_grid(images: np.ndarray, nrow: int = 8, pad: int = 2,
              pad_value: float = 1.0) -> np.ndarray:
    """(N, H, W, C) -> (H', W', C) grid, ``nrow`` images a row
    (torchvision's layout)."""
    images = np.asarray(images)
    n, h, w, c = images.shape
    nrow = max(1, min(nrow, n))
    ncol = (n + nrow - 1) // nrow
    grid = np.full((ncol * (h + pad) + pad, nrow * (w + pad) + pad, c),
                   pad_value, dtype=images.dtype)
    for idx in range(n):
        r, col = divmod(idx, nrow)
        y, x = r * (h + pad) + pad, col * (w + pad) + pad
        grid[y:y + h, x:x + w] = images[idx]
    return grid


def to_uint8(img: np.ndarray, value_range=(-1.0, 1.0)) -> np.ndarray:
    lo, hi = value_range
    img = (np.clip(np.asarray(img, dtype=np.float32), lo, hi) - lo) / (hi - lo)
    return (img * 255.0 + 0.5).astype(np.uint8)


def save_png(path: str, img_uint8: np.ndarray) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    write_png(path, img_uint8)


class MetricsWriter:
    """Scalar, hparams and image-grid writer; ``close`` it when done."""

    def __init__(self, log_dir: str, hparams: Optional[Mapping] = None,
                 use_tensorboard: bool = True):
        self.log_dir = log_dir
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(log_dir, "scalars.jsonl"), "a")
        self._tb = None
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:
                SummaryWriter = None
            if SummaryWriter is not None:
                self._tb = SummaryWriter(log_dir=log_dir)
        if hparams is not None:
            self.add_hparams(hparams)

    def add_scalar(self, tag: str, value, step: int) -> None:
        self._jsonl.write(json.dumps(
            {"step": int(step), "tag": tag, "value": float(value)}) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            self._tb.add_scalar(tag, float(value), int(step))

    def add_scalars(self, scalars: Mapping[str, float], step: int,
                    prefix: str = "") -> None:
        for k, v in scalars.items():
            self.add_scalar(f"{prefix}{k}", v, step)

    def add_hparams(self, hparams: Mapping) -> None:
        flat = {str(k): (v if isinstance(v, (int, float, bool, str)) else str(v))
                for k, v in dict(hparams).items()}
        with open(os.path.join(self.log_dir, "hparams.json"), "w") as f:
            json.dump(flat, f, indent=1, sort_keys=True)
        if self._tb is not None:
            self._tb.add_hparams(flat, {})

    def add_image_grid(self, tag: str, images: Sequence[np.ndarray], step: int,
                       nrow: int = 8, value_range=(-1.0, 1.0)) -> str:
        """``images``: (N, H, W, C) batches stacked row-wise into one grid
        (input / warp / fake / gt rows, trainers/base.py:95-145). Returns the
        written PNG's path."""
        batch = np.concatenate([np.asarray(b) for b in images], axis=0)
        nrow = max(nrow, batch.shape[0] // len(images))
        grid = to_uint8(make_grid(batch, nrow=nrow), value_range)
        if grid.shape[-1] == 1:
            grid = np.repeat(grid, 3, axis=-1)
        path = os.path.join(self.log_dir, "images", f"{tag}_{step:09d}.png")
        save_png(path, grid)
        if self._tb is not None:
            self._tb.add_image(tag, grid, int(step), dataformats="HWC")
        return path

    def close(self) -> None:
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()


class NullWriter:
    """The run record of a rank other than 0: every call writes nothing."""

    def __getattr__(self, name):
        return lambda *a, **k: None


def run_writer(log_dir: str, hparams: Optional[Mapping] = None):
    """A ``MetricsWriter`` in the main process (rank 0 of a process group,
    or the only process), a ``NullWriter`` on the other ranks."""
    from .logging import main_process

    return MetricsWriter(log_dir, hparams=hparams) if main_process() else NullWriter()
