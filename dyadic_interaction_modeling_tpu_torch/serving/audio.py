"""Streaming audio front-end: a raw 16 kHz waveform stream -> per-frame
features.

Counterpart of ``dyadic_interaction_modeling_tpu/serving/audio.py``. The
serving sessions take audio features a motion frame; offline those come
from the HuBERT / wav2vec2 trunk over the whole clip, linearly interpolated
to the frame count (reference dataset/biwi.py:83-113). The trunk's
transformer is bidirectional, so a live stream gets TRAILING-WINDOW
extraction:

* a ring buffer on the model's device holds each session's raw samples;
* chunk ``k`` (frames ``[k*chunk, (k+1)*chunk)``) is emitted once the
  stream reaches its end boundary plus ``lookahead`` frames of future
  audio (lookahead / fps seconds of latency for real right context);
* the window is always ``window_frames`` motion frames of samples, left
  zero-padded while the stream is younger (HF's padding of short clips),
  so the trunk sees one shape;
* the trunk's output over the window is interpolated (align_corners) to
  ``window_frames`` rows and the chunk's rows are emitted.

Contract (``tests/test_torch_speech_serving.py``): chunk ``k``'s emission
depends only on the samples, never on how ``push`` sliced them, and when
the window covers the whole stream it equals the offline extraction of the
prefix.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from ..models.wav2vec2 import Wav2Vec2Model, linear_interpolation


class StreamingAudioFrontend:
    """Motion-frame-aligned features from a raw waveform stream.

    ``model``: the (HuBERT / wav2vec2) trunk, on the device the window runs
    on. ``fps``: the motion frame rate (30 ViCo, 25 BIWI). ``chunk``: frames
    emitted a step (the session's feed chunk). ``window_frames``: trailing
    context in motion frames, at least ``chunk + lookahead``.
    ``lookahead``: frames of future audio needed before a chunk is emitted.
    ``batch``: sessions in lockstep, one waveform row each."""

    def __init__(self, model: Wav2Vec2Model, *, fps: int = 30, chunk: int = 8,
                 window_frames: int = 60, lookahead: int = 2, sample_rate: int = 16000,
                 batch: int = 1):
        if window_frames < chunk + lookahead:
            raise ValueError("window_frames must cover chunk + lookahead")
        self.model = model
        self.fps = fps
        self.chunk = chunk
        self.window_frames = window_frames
        self.lookahead = lookahead
        self.sample_rate = sample_rate
        self.batch = batch
        self.device = next(model.parameters()).device
        self.window_samples = self._boundary(window_frames)
        self._buf = torch.zeros(batch, 0, device=self.device)
        self._dropped = 0     # absolute sample index of _buf[:, 0]
        self._next_chunk = 0  # the next chunk to emit

    def _boundary(self, frame: int) -> int:
        """The sample index of a motion-frame boundary (frame / fps s)."""
        return int(round(frame * self.sample_rate / self.fps))

    @property
    def frames_emitted(self) -> int:
        return self._next_chunk * self.chunk

    def push(self, samples) -> Optional[torch.Tensor]:
        """Appends (batch, n) raw samples (numpy or a tensor); returns the
        (batch, m * chunk, hidden) features of every chunk they complete on
        the model's device, or None when they complete none."""
        samples = torch.as_tensor(samples, dtype=torch.float32, device=self.device)
        samples = samples.reshape(1, -1) if samples.dim() == 1 else samples
        if samples.shape[0] != self.batch:
            raise ValueError(f"expected {self.batch} waveform rows")
        self._buf = torch.cat([self._buf, samples], dim=1)
        out: List[torch.Tensor] = []
        while (feats := self._try_emit()) is not None:
            out.append(feats)
        return torch.cat(out, dim=1) if out else None

    @torch.no_grad()
    def _try_emit(self) -> Optional[torch.Tensor]:
        k = self._next_chunk
        end_abs = self._boundary((k + 1) * self.chunk + self.lookahead)
        if self._dropped + self._buf.shape[1] < end_abs:
            return None
        start_abs = end_abs - self.window_samples
        # the drop below never discards samples a later window needs
        assert self._dropped <= max(0, start_abs)
        window = self._buf[:, max(0, start_abs) - self._dropped: end_abs - self._dropped]
        if window.shape[1] < self.window_samples:  # a young stream: zeros on the left
            window = torch.nn.functional.pad(window, (self.window_samples - window.shape[1], 0))
        feats = linear_interpolation(self.model(window, "none"), 1, 1,
                                     output_len=self.window_frames)
        # the window's last row is frame end_frame - 1: the chunk's rows
        hi = self.window_frames - self.lookahead
        self._next_chunk += 1
        # bounded memory: drop the samples the next window cannot reach
        next_start = max(0, self._boundary((k + 2) * self.chunk + self.lookahead)
                         - self.window_samples)
        if next_start > self._dropped:
            self._buf = self._buf[:, next_start - self._dropped:]
            self._dropped = next_start
        return feats[:, hi - self.chunk: hi]
