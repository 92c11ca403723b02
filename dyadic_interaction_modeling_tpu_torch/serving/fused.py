"""The live avatar round with every piece of state on the device.

Counterpart of ``dyadic_interaction_modeling_tpu/serving/fused.py``.
``StreamingAvatarPipeline`` (``avatar.py``) downloads the codes every round,
decodes them, and smooths and windows on the host. ``FusedAvatarPipeline``
runs the whole chain on the device,

    feed chunk -> generate chunk codes -> masked VQ decode -> smoothing ->
    semantic windows -> FaceGenerator render -> uint8 frames,

with the session's caches and sampler, the token buffer (B, capacity) and
the raw and smoothed coefficient buffers (B, max_frames, C, fp32) resident
there. A round uploads one speaker chunk through pinned memory and enqueues
one download of its codes and frames; nothing in between waits for the
device (every offset comes from the host's round counter), so with
``pipeline_depth=1`` the host is a round ahead of the card. The round runs
eagerly, one launch per operation; nothing in it would stop capturing it
as one CUDA graph.

Exactness. The round reproduces ``StreamingAvatarPipeline``'s emissions
(``vq_granularity`` = chunk) frame for frame by processing each stage in
chunk-aligned blocks at a fixed lag in rounds:

* codes: the session's own ``_feed`` and ``_generate`` (round 1 runs
  through the session's ``feed``, ``start`` and ``generate``, and the
  pipeline then takes over its state), the same generator and noise, so the
  codes are bitwise the composable pipeline's under one seed;
* raw coefficients: ``lookahead % chunk == 0`` makes every frame of a block
  share one horizon, so block ``j`` = ``[c(j - 1), cj)`` is one slice of the
  round-``j + la/c`` decode of the whole buffer with lengths ``k c``;
* smoothing: the window-w moving average with the zero/copy edge quirk
  (postprocess2emoca.py:24), in fp32 on the device (the host twin sums in
  float64; interior frames agree to ~1e-6);
* windows: radius-r windows clamped at 0, as ``semantic_window`` clamps.

Stage lags (rounds, chunk c): raw ``d_raw = la/c``, smoothing ``d_sm =
d_raw + ceil((w - w//2 - 1)/c)``, windows and render ``d_win = d_sm +
ceil(r/c)``: with c = 8, la = 8, w = 10, r = 13 a frame renders 4 rounds
after its chunk is fed, 5 with the double-buffered download. Blocks before
validity are written from clamped offsets with garbage that the first valid
round overwrites before anything reads it, and their renders are not
emitted. ``flush()`` downloads the buffers once and finishes the tail with
the host operators of ``avatar.py``, seeded from the round counter, so a
stream ends with the offline semantics, as the composable pipeline's does.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from ..models.slm import SLMFT
from .avatar import (
    Download,
    StreamingCoeffDecoder,
    StreamingRenderer,
    StreamingSemanticWindower,
    StreamingSmoother,
    listener_decode_fn,
    upload,
)
from .streaming import NoiseFn, StreamingListenerSession


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


class FusedAvatarPipeline:
    """The live listener avatar with its state on the device (module
    docstring). Arguments as ``StreamingAvatarPipeline``'s and the
    session's where they overlap: ``renderer`` (a ``FaceGenerator``) and
    ``source_images`` (B, H, W, 3) are required; ``seed`` and ``noise`` are
    the session's. ``pipeline_depth=1`` double-buffers the download."""

    def __init__(self, model: SLMFT, *, renderer, source_images, batch: int = 1,
                 chunk: int = 8, max_frames: int = 1024, max_tokens: Optional[int] = None,
                 seed: int = 0, temperature: float = 1.0, filter_frac: float = 0.1,
                 greedy: bool = False, noise: Optional[NoiseFn] = None, prompt=None,
                 vq_lookahead: int = 8, smooth_window: int = 10, edge_mode: str = "zero",
                 semantic_radius: int = 13, render_outputs=("fake_image",),
                 render_uint8: bool = True, pipeline_depth: int = 1):
        if vq_lookahead <= 0 or vq_lookahead % chunk:
            raise ValueError(
                "the fused round needs lookahead to be a positive multiple "
                "of the chunk so every frame of a block shares one decode "
                "horizon (use StreamingAvatarPipeline otherwise)")
        if smooth_window % 2 or edge_mode not in ("zero", "copy"):
            raise ValueError("smoothing params must match "
                             "postprocess.smooth_logits_matrix (even window,"
                             " zero/copy edges)")
        src = np.asarray(source_images, np.float32)
        if src.ndim != 4 or src.shape[0] != batch:
            raise ValueError(
                f"source_images must be (batch={batch}, H, W, C) - one "
                f"source face per avatar stream - got {src.shape}")
        self.model = model
        self.renderer = renderer
        self.chunk = chunk
        self.batch = batch
        self.lookahead = vq_lookahead
        self.smooth_window = smooth_window
        self.edge_mode = edge_mode
        self.radius = semantic_radius
        self.render_outputs = tuple(render_outputs)
        self.render_uint8 = render_uint8
        self.pipeline_depth = pipeline_depth
        self._coeff_dim = model.vq_cfg.in_dim

        # stage lags in rounds (chunk-aligned blocks; module docstring)
        smooth_lag = smooth_window - smooth_window // 2 - 1
        self.d_raw = vq_lookahead // chunk
        self.d_sm = self.d_raw + _ceil_div(smooth_lag, chunk)
        self.d_win = self.d_sm + _ceil_div(semantic_radius, chunk)

        self.session = StreamingListenerSession(
            model, batch=batch, chunk=chunk, max_frames=max_frames, max_tokens=max_tokens,
            seed=seed, temperature=temperature, filter_frac=filter_frac, greedy=greedy,
            noise=noise)
        self.device = self.session.device
        self.prompt = (np.zeros((batch, 1), np.int32) if prompt is None
                       else np.asarray(prompt, np.int32))
        self.k = 0                       # rounds completed
        self._inflight: List[Dict] = []  # rounds whose download is under way
        self._flushed = False
        self._cap_tok = self.session.max_tokens
        self._src = src
        self._renderer = StreamingRenderer(renderer, src, frames_per_call=chunk,
                                           outputs=self.render_outputs, as_uint8=render_uint8)
        self._tokens = self._raw = self._smoothed = None  # built in round 1
        # gather offsets of a block's frames: w smoothing taps, 2r + 1 window taps
        lo = smooth_window // 2
        t = torch.arange(chunk, device=self.device)[:, None]
        self._sm_taps = t + torch.arange(smooth_window, device=self.device)[None] - lo
        self._win_taps = t + torch.arange(-semantic_radius, semantic_radius + 1,
                                          device=self.device)[None]
        self._block = torch.arange(chunk, device=self.device)
        # taps clamp at 0 as ``semantic_window`` does; the clamp at the buffer's
        # end only keeps the gathers of blocks before validity in bounds
        self._last = self.session.max_frames - 1

    @property
    def frames_fed(self) -> int:
        return self.k * self.chunk

    @property
    def latency_frames(self) -> int:
        """Worst-case added latency beyond the chunk cadence: frame t
        renders ``d_win`` rounds (+1 if double-buffered) after its chunk."""
        return (self.d_win + (1 if self.pipeline_depth else 0)) * self.chunk

    def _empty_out(self) -> Dict[str, np.ndarray]:
        dt = np.uint8 if self.render_uint8 else np.float32
        out = {"tokens": np.zeros((self.batch, 0), np.int32)}
        for key in self.render_outputs:
            out[key] = np.zeros((self.batch, 0, *self._src.shape[1:]), dt)
        return out

    def push(self, speaker_chunk, audio_chunk) -> Dict[str, np.ndarray]:
        """Feed one full (B, chunk, ...) speaker chunk; returns newly final
        codes and rendered frames (the frames empty in the first ``d_win +
        pipeline_depth`` rounds). A short final chunk is not taken: stop
        pushing and ``flush()``."""
        if self._flushed:
            raise ValueError("pipeline already flushed")
        if (self.k + 1) * self.chunk > self.session.max_frames:
            raise ValueError("context capacity exceeded; raise max_frames")
        if (self.k + 1) * self.chunk + self.prompt.shape[1] > self._cap_tok:
            raise ValueError("token capacity exceeded; raise max_tokens")
        if self.k == 0:
            return self._first_round(speaker_chunk, audio_chunk)
        sp = upload(speaker_chunk, self.device, self.model.dtype)
        au = upload(audio_chunk, self.device, self.model.dtype)
        if sp.shape[1] != self.chunk:
            raise ValueError(f"push expects chunks of {self.chunk} frames, got {sp.shape[1]}")
        self.k += 1
        tok_block, frames = self._round(sp, au)
        self._inflight.append({"k": self.k, "tokens": Download(tok_block),
                               "frames": {key: Download(v) for key, v in frames.items()}})
        return self._drain(final=False)

    def _first_round(self, speaker_chunk, audio_chunk) -> Dict[str, np.ndarray]:
        """Round 1 through the session (feed, prompt, first chunk); the
        buffers start from its codes."""
        s, b = self.session, self.batch
        s.feed(speaker_chunk, audio_chunk)
        s.start(self.prompt)
        toks = s.generate(self.chunk)
        self.k = 1
        self._tokens = torch.zeros(b, self._cap_tok, dtype=torch.long, device=self.device)
        self._tokens[:, : self.chunk] = toks
        shape = (b, s.max_frames, self._coeff_dim)
        self._raw = torch.zeros(shape, dtype=torch.float32, device=self.device)
        self._smoothed = torch.zeros(shape, dtype=torch.float32, device=self.device)
        out = self._empty_out()
        out["tokens"] = toks.cpu().numpy().astype(np.int32)
        return out

    @torch.no_grad()
    def _round(self, sp: torch.Tensor, au: torch.Tensor):
        """Round k (>= 2) on the device: the codes (B, c) and the frames of
        block k - d_win."""
        s, c, k, b = self.session, self.chunk, self.k, self.batch
        s._feed(sp, au, c)
        tok_block = s._generate(c)
        self._tokens[:, (k - 1) * c: k * c] = tok_block

        # the masked decode of the whole buffer; raw block k - d_raw
        lengths = torch.full((b,), k * c, dtype=torch.long, device=self.device)
        coeffs = self.model.decode_tokens_to_motion(self._tokens, lengths)
        off = max(0, (k - self.d_raw - 1) * c)
        self._raw[:, off: off + c] = coeffs[:, off: off + c].float()

        # smoothing, block k - d_sm: the w-tap mean, edge frames t < w // 2
        off = max(0, (k - self.d_sm - 1) * c)
        taps = (self._sm_taps + off).clamp(0, self._last)
        sm = self._raw[:, taps.reshape(-1)].reshape(b, c, self.smooth_window, -1).mean(dim=2)
        t = self._block + off
        edge = (torch.zeros_like(sm) if self.edge_mode == "zero" else self._raw[:, t])
        sm = torch.where((t < self.smooth_window // 2)[None, :, None], edge, sm)
        self._smoothed[:, off: off + c] = sm

        # windows and the render, block k - d_win
        off = max(0, (k - self.d_win - 1) * c)
        taps = (self._win_taps + off).clamp(0, self._last)
        wins = self._smoothed[:, taps.reshape(-1)].reshape(b, c, 2 * self.radius + 1, -1)
        sems = wins.transpose(2, 3).reshape(b * c, self._coeff_dim, 2 * self.radius + 1)
        return tok_block, self._renderer.render(sems)

    def _drain(self, final: bool) -> Dict[str, np.ndarray]:
        keep = 0 if final else self.pipeline_depth
        out = self._empty_out()
        toks, frames = [out["tokens"]], {key: [out[key]] for key in self.render_outputs}
        while len(self._inflight) > keep:
            item = self._inflight.pop(0)
            toks.append(item["tokens"].numpy().astype(np.int32))
            if item["k"] > self.d_win:     # renders before validity are garbage
                for key in self.render_outputs:
                    frames[key].append(item["frames"][key].numpy())
        out["tokens"] = np.concatenate(toks, axis=1)
        for key in self.render_outputs:
            out[key] = np.concatenate(frames[key], axis=1)
        return out

    def flush(self) -> Dict[str, np.ndarray]:
        """Drain the rounds under way, then finish the tail with the host
        operators of the composable pipeline, seeded from the device
        buffers (module docstring)."""
        if self._flushed:
            raise ValueError("pipeline already flushed")
        self._flushed = True
        head = self._drain(final=True)
        if self.k == 0:
            return head
        c, k = self.chunk, self.k
        tokens = self._tokens.cpu().numpy().astype(np.int32)
        raw, smoothed = self._raw.cpu().numpy(), self._smoothed.cpu().numpy()
        n_raw = c * max(0, k - self.d_raw)
        n_sm = c * max(0, k - self.d_sm)
        n_win = c * max(0, k - self.d_win)

        dec = StreamingCoeffDecoder(
            listener_decode_fn(self.model), batch=self.batch, capacity=self._cap_tok,
            lookahead=self.lookahead, granularity=c, coeff_dim=self._coeff_dim)
        dec._tokens = tokens[:, : k * c]
        dec._emitted = n_raw
        raw_tail = dec.flush()

        sm = StreamingSmoother(self.smooth_window, self.edge_mode)
        sm._frames = [raw[:, t].astype(np.float64) for t in range(n_raw)]
        sm._emitted = n_sm
        sm_out = np.concatenate([sm.push(raw_tail), sm.flush()], axis=-2)

        wd = StreamingSemanticWindower(self.radius)
        wd._frames = [smoothed[:, t] for t in range(n_sm)]
        wd._emitted = n_win
        windows = wd.push(sm_out) + wd.flush()

        rd = StreamingRenderer(self.renderer, self._src, frames_per_call=c,
                               outputs=self.render_outputs, as_uint8=self.render_uint8)
        tail = rd.push(windows)
        tail = {key: np.concatenate([tail[key], rd.flush()[key]], axis=1)
                for key in self.render_outputs}
        out = {"tokens": head["tokens"]}
        for key in self.render_outputs:
            out[key] = np.concatenate([head[key], tail[key]], axis=1)
        return out
