"""End-to-end live avatar serving: speaker motion and audio in, rendered
listener frames out.

Counterpart of ``dyadic_interaction_modeling_tpu/serving/avatar.py``. The
reference runs this chain as three offline scripts over saved files
(generate codes, ``postprocess2emoca.py`` smoothing and export, PIRender's
``inference_newmodel.py``); here it runs incrementally around a
``StreamingListenerSession``:

1. ``StreamingCoeffDecoder`` turns listener codes into EMOCA coefficient
   frames. The VQ motion decoder is bidirectional over the codes, so frame
   ``t`` is final once ``lookahead`` later frames' codes exist; it is decoded
   from the masked prefix of the fixed-capacity token buffer
   (``SLMFT.decode_tokens_to_motion`` with lengths), the per-sample
   semantics of the reference's B = 1 eval loop. The buffer is decoded at
   its full capacity, so at the serving capacity (1024 tokens) the decoder's
   masked self-attention runs through the flash-attention kernel.
2. ``StreamingSmoother``: the streaming twin of
   ``postprocess.smooth_logits_matrix`` (window-10 moving average with the
   reference's zero-edge quirk), numpy in float64.
3. ``StreamingSemanticWindower``: the streaming twin of
   ``render.data.semantic_window`` (radius-13 windows clamped at the clip's
   ends), numpy.
4. ``StreamingRenderer``: a fixed-batch ``FaceGenerator`` stage turning
   final windows into frames on the model's device.

Every operator's emissions depend only on the stream's content, never on
how the pushes slice it, and concatenated they equal the offline functions.
The added latency is ``lookahead + (window - window // 2 - 1) + radius``
frames (8 + 4 + 13 = 25 with the defaults) on top of the chunk cadence.
Emitted frames are NHWC numpy, ``(B, m, H, W, 3)``, as in the JAX package;
the generator is NCHW and the frames are permuted on the device.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from ..models.slm import SLMFT
from .streaming import StreamingListenerSession, model_device


class StreamingSmoother:
    """Streaming twin of ``postprocess.smooth_logits_matrix``.

    Emits each frame's smoothed value as soon as it is final:

    * frames ``[0, window//2)`` are edge frames (zero or copy, per
      ``edge_mode``) - final immediately;
    * frame ``t >= window//2`` takes the centered moving average
      ``mean(x[t - w//2 : t + w - w//2])`` - final once frame
      ``t + w - w//2 - 1`` has arrived;
    * remaining tail frames are edge frames - final at ``flush()`` (only
      then is the clip length known).

    For every total length T (including T < window, the reference's
    all-edges case) and every push granularity, the concatenated emissions
    equal ``smooth_logits_matrix(x, window, edge_mode)`` - edge frames
    bit-identically, interior frames to float64 round-off (the offline
    np.convolve scales before summing). Only even windows are supported:
    the reference formula (postprocess2emoca.py:24) is shape-inconsistent
    for odd windows and is only ever used with 10.
    """

    def __init__(self, window: int = 10, edge_mode: str = "zero"):
        if window % 2 != 0:
            raise ValueError("smoothing window must be even (reference uses 10)")
        if edge_mode not in ("zero", "copy"):
            raise ValueError(f"unknown edge_mode {edge_mode!r}")
        self.window = window
        self.edge_mode = edge_mode
        self._frames: List[np.ndarray] = []   # raw frames, each (..., C)
        self._emitted = 0

    @property
    def latency_frames(self) -> int:
        return self.window - self.window // 2 - 1

    def push(self, frames: np.ndarray) -> np.ndarray:
        """frames (..., n, C); returns newly finalized frames (..., m, C)."""
        frames = np.asarray(frames, dtype=np.float64)
        for k in range(frames.shape[-2]):
            self._frames.append(frames[..., k, :])
        return self._drain(final=False)

    def flush(self) -> np.ndarray:
        """Finalize the tail (edge frames) once the stream has ended."""
        return self._drain(final=True)

    def _edge_value(self, i: int) -> np.ndarray:
        raw = self._frames[i]
        return np.zeros_like(raw) if self.edge_mode == "zero" else raw.copy()

    def _empty(self) -> np.ndarray:
        if self._frames:
            s = self._frames[0].shape
            return np.zeros(s[:-1] + (0, s[-1]), np.float64)
        return np.zeros((0, 0), np.float64)

    def _drain(self, final: bool) -> np.ndarray:
        w, lo = self.window, self.window // 2
        t = len(self._frames)
        out = []
        while self._emitted < t:
            i = self._emitted
            if i < lo:
                out.append(self._edge_value(i))
            elif i + (w - lo - 1) <= t - 1:
                stack = np.stack(self._frames[i - lo: i - lo + w], axis=-2)
                out.append(stack.mean(axis=-2))
            elif final:
                out.append(self._edge_value(i))
            else:
                break
            self._emitted += 1
        return np.stack(out, axis=-2) if out else self._empty()


class StreamingSemanticWindower:
    """Streaming twin of ``render.data.semantic_window``: frame ``t``'s
    (..., C, 2r+1) coefficient window finalizes once frame ``t + radius``
    exists (lower indices clamp at 0 as frames arrive; upper clamping only
    matters for the tail, which finalizes at ``flush()`` with the true clip
    length). Emissions equal the offline function on the full clip."""

    def __init__(self, radius: int = 13):
        self.radius = radius
        self._frames: List[np.ndarray] = []   # each (..., C)
        self._emitted = 0

    @property
    def latency_frames(self) -> int:
        return self.radius

    def push(self, frames: np.ndarray) -> List[np.ndarray]:
        frames = np.asarray(frames, dtype=np.float32)
        for k in range(frames.shape[-2]):
            self._frames.append(frames[..., k, :])
        return self._drain(final=False)

    def flush(self) -> List[np.ndarray]:
        return self._drain(final=True)

    def _drain(self, final: bool) -> List[np.ndarray]:
        t = len(self._frames)
        out = []
        while self._emitted < t:
            i = self._emitted
            if not final and i + self.radius > t - 1:
                break
            idx = [min(max(j, 0), t - 1)
                   for j in range(i - self.radius, i + self.radius + 1)]
            window = np.stack([self._frames[j] for j in idx], axis=-2)
            out.append(np.swapaxes(window, -1, -2).astype(np.float32))
            self._emitted += 1
        return out


class StreamingCoeffDecoder:
    """Streaming code -> coefficient-frame decode with bounded lookahead.

    Frame ``t`` is emitted once its horizon ``H(t) = g * ceil((t + la + 1)
    / g)`` frames of codes exist, decoded from the masked prefix
    ``codes[:, : H(t) * fq]`` of the padded buffer - exactly that prefix,
    whatever the push slicing, so emissions are reproducible. ``granularity``
    g trades latency for decodes: with 1 every frame has its own prefix;
    with the session's chunk a whole chunk shares one horizon (one decode a
    chunk). ``lookahead=None`` defers everything to ``flush()``, which
    decodes from the whole sequence (the offline clip decode) and clamps
    surviving horizons to the clip length.

    ``decode_fn(tokens (B, capacity*fq), n_tokens (B,)) -> (B, capacity, C)``
    abstracts the model (``listener_decode_fn``). ``coeff_dim`` gives empty
    emissions before the first decode their real trailing dim; without it
    they have a placeholder dim of 1.
    """

    def __init__(self, decode_fn, *, batch: int, capacity: int,
                 lookahead: Optional[int] = 8, granularity: int = 1,
                 tokens_per_frame: int = 1, coeff_dim: Optional[int] = None):
        self.decode_fn = decode_fn
        self.batch = batch
        self.capacity = capacity
        self.lookahead = lookahead
        self.granularity = granularity
        self.fq = tokens_per_frame
        self._tokens = np.zeros((batch, 0), np.int32)
        self._emitted = 0
        self._coeff_dim = coeff_dim or 1

    @property
    def latency_frames(self) -> int:
        """Worst-case finalization lag behind the code stream."""
        if self.lookahead is None:
            return 0
        return self.lookahead + self.granularity - 1

    @property
    def frames_available(self) -> int:
        return self._tokens.shape[1] // self.fq

    def push(self, tokens) -> np.ndarray:
        """tokens (B, n*fq) newly generated codes; returns newly finalized
        coefficient frames (B, m, C)."""
        tokens = np.asarray(tokens, np.int32)
        # validated before any change: an overflowing push leaves the state
        # intact, so the caller can catch it and flush
        if self._tokens.shape[1] + tokens.shape[1] > self.capacity * self.fq:
            raise ValueError("token capacity exceeded; raise capacity")
        self._tokens = np.concatenate([self._tokens, tokens], axis=1)
        if self.lookahead is None:
            return self._empty()
        g, a = self.granularity, self.frames_available
        return self._decode_upto(g * (a // g) - self.lookahead, final=False)

    def flush(self) -> np.ndarray:
        """Finalize the tail from the full final sequence (the offline
        decode of the whole code stream for those frames)."""
        return self._decode_upto(self.frames_available, final=True)

    def _horizon(self, t: int) -> int:
        g = self.granularity
        return g * -(-(t + self.lookahead + 1) // g)

    def _decode_upto(self, hi: int, final: bool) -> np.ndarray:
        if hi <= self._emitted:
            return self._empty()
        total = self.frames_available
        out, cached_n, coeffs = [], None, None
        for t in range(self._emitted, hi):
            n_ctx = total if (final or self.lookahead is None) else self._horizon(t)
            if n_ctx != cached_n:  # one decode per distinct horizon
                coeffs = self._decode_prefix(n_ctx)
                cached_n = n_ctx
            out.append(coeffs[:, t: t + 1])
        self._emitted = hi
        res = np.concatenate(out, axis=1)
        self._coeff_dim = res.shape[-1]
        return res

    def _decode_prefix(self, n_frames: int) -> np.ndarray:
        pad = self.capacity * self.fq - self._tokens.shape[1]
        toks = np.pad(self._tokens, ((0, 0), (0, pad)))
        n_tok = np.full((self.batch,), n_frames * self.fq, np.int32)
        return self.decode_fn(toks, n_tok).float().cpu().numpy()

    def _empty(self) -> np.ndarray:
        return np.zeros((self.batch, 0, self._coeff_dim), np.float32)


def listener_decode_fn(model: SLMFT):
    """The masked listener-VQ decode of a fixed-capacity token buffer:
    ``(tokens (B, cap*fq), n_tok (B,)) -> (B, cap, C)`` on the model's
    device."""
    dev = model_device(model)

    @torch.no_grad()
    def decode(tokens, n_tok) -> torch.Tensor:
        return model.decode_tokens_to_motion(torch.as_tensor(tokens, device=dev).long(),
                                             torch.as_tensor(n_tok, device=dev).long())

    return decode


def to_uint8_frames(x: torch.Tensor) -> torch.Tensor:
    """Frames in [-1, 1] -> uint8 on their device by the PNG formula
    ``(clip(x, -1, 1) + 1) * 127.5``, truncated (``render.inference.
    to_uint8_frame``)."""
    return ((x.float().clamp(-1.0, 1.0) + 1.0) * 127.5).to(torch.uint8)


class Download:
    """A device tensor's copy to the host, started now and read later: on the
    card a ``non_blocking`` copy into pinned memory and an event after it (a
    copy into pageable memory would wait for the device at once); on the
    CPU the tensor itself."""

    def __init__(self, x: torch.Tensor):
        self._event = None
        if x.is_cuda:
            self._host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
            self._host.copy_(x, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host = x.contiguous()

    def numpy(self) -> np.ndarray:
        if self._event is not None:
            self._event.synchronize()
        return self._host.numpy()


def upload(x, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """A host array to the device without waiting for the device: through
    pinned memory and a ``non_blocking`` copy on the card."""
    t = torch.as_tensor(np.asarray(x))
    if device.type == "cuda":
        return t.pin_memory().to(device, dtype, non_blocking=True)
    return t.to(device, dtype)


class StreamingRenderer:
    """Fixed-batch PIRender stage: buffers final (B, C, 2r+1) windows and
    renders ``frames_per_call`` of them at a time (B * frames_per_call images
    a call); ``flush`` pads the last call with its last window and discards
    the padding.

    ``outputs`` selects which generator images leave the device (a serving
    stream wants ``("fake_image",)``) and ``as_uint8`` converts to display
    bytes on the device (``to_uint8_frames``): together they cut the
    download eightfold. ``pipeline_depth=1`` double-buffers the download:
    ``push`` enqueues this round's render and its copy to the host, then
    hands back the previous round's frames, so the copy of round t overlaps
    the render of round t + 1. That costs ``frames_per_call`` frames of
    latency; the emitted stream is the same (``flush`` drains the buffer).
    The model renders as it is given (call ``eval()`` first: with spectral
    norm a module in training mode steps its power iteration).
    """

    def __init__(self, model, source_images: np.ndarray, *, frames_per_call: int = 8,
                 outputs=("fake_image", "warp_image"), as_uint8: bool = False,
                 pipeline_depth: int = 0):
        self.model = model
        self.device = model_device(model)
        self.batch = source_images.shape[0]
        self.frames_per_call = frames_per_call
        self.outputs = tuple(outputs)
        self.as_uint8 = as_uint8
        self.pipeline_depth = pipeline_depth
        self._src_hw = tuple(source_images.shape[1:])
        self._inflight: List[tuple] = []   # ({output: Download}, n_valid)
        # the source tile is the same every call: (B * r, 3, H, W), built once
        r = frames_per_call
        src = torch.as_tensor(np.asarray(source_images, np.float32), device=self.device)
        self._imgs = src.permute(0, 3, 1, 2).repeat_interleave(r, dim=0).contiguous()
        self._pending: List[np.ndarray] = []            # each (B, C, W)

    @torch.no_grad()
    def render(self, sems: torch.Tensor) -> Dict[str, torch.Tensor]:
        """(B * r, C, 2r+1) windows on the device -> {output: (B, r, H, W, 3)}
        on the device, uint8 with ``as_uint8``, else fp32."""
        out = self.model(self._imgs, sems)
        res = {}
        for k in self.outputs:
            x = to_uint8_frames(out[k]) if self.as_uint8 else out[k].float()
            res[k] = x.permute(0, 2, 3, 1).contiguous().reshape(
                self.batch, self.frames_per_call, *x.shape[2:], x.shape[1])
        return res

    def push(self, windows: List[np.ndarray]) -> Dict[str, np.ndarray]:
        self._pending.extend(windows)
        return self._drain(final=False)

    def flush(self) -> Dict[str, np.ndarray]:
        return self._drain(final=True)

    def _drain(self, final: bool) -> Dict[str, np.ndarray]:
        acc: Dict[str, List[np.ndarray]] = {k: [] for k in self.outputs}
        r = self.frames_per_call
        while len(self._pending) >= r or (final and self._pending):
            block, self._pending = self._pending[:r], self._pending[r:]
            n_valid = len(block)
            block = block + [block[-1]] * (r - n_valid)   # flush padding
            sems = upload(np.stack(block, axis=1).reshape(self.batch * r, *block[0].shape[1:]),
                          self.device, torch.float32)
            res = self.render(sems)
            self._inflight.append(({k: Download(v) for k, v in res.items()}, n_valid))
        keep = 0 if final else self.pipeline_depth
        while len(self._inflight) > keep:
            res, n_valid = self._inflight.pop(0)
            for k in self.outputs:
                acc[k].append(res[k].numpy()[:, :n_valid])
        if not acc[self.outputs[0]]:
            dt = np.uint8 if self.as_uint8 else np.float32
            return {k: np.zeros((self.batch, 0, *self._src_hw), dt) for k in self.outputs}
        return {k: np.concatenate(v, axis=1) for k, v in acc.items()}


class StreamingAvatarPipeline:
    """The full live listener avatar: speaker motion and audio chunks in,
    rendered listener frames out.

    session: a fresh ``StreamingListenerSession`` (its batch and chunk set
    the cadence; one listener code per fed frame). prompt: (B, P) seed codes,
    consumed on the first ``push`` (zeros by default, the cold start).
    vq_lookahead: frames of future codes before a coefficient frame is final
    (None: only at flush, the offline decode). vq_granularity: the decode's
    horizon rounding (the session's chunk gives one decode a chunk).
    smooth_window / edge_mode: ``postprocess.smooth_logits_matrix``'s.
    semantic_radius: PIRender's window radius. renderer / source_images:
    an optional ``FaceGenerator`` stage and one (H, W, 3) source face per
    stream; without them the pipeline streams smoothed windows only.
    """

    def __init__(self, session: StreamingListenerSession, *, prompt=None,
                 vq_lookahead: Optional[int] = 8, vq_granularity: int = 1,
                 smooth_window: int = 10, edge_mode: str = "zero",
                 semantic_radius: int = 13, renderer=None, source_images=None,
                 render_frames_per_call: int = 8,
                 render_outputs=("fake_image", "warp_image"),
                 render_uint8: bool = False, render_pipeline_depth: int = 0):
        self.session = session
        b = session.batch
        self.prompt = (np.zeros((b, 1), np.int32) if prompt is None
                       else np.asarray(prompt, np.int32))
        self._started = False
        self.decoder = StreamingCoeffDecoder(
            listener_decode_fn(session.model), batch=b, capacity=session.max_tokens,
            lookahead=vq_lookahead, granularity=vq_granularity,
            coeff_dim=session.model.vq_cfg.in_dim)
        self.smoother = StreamingSmoother(smooth_window, edge_mode)
        self.windower = StreamingSemanticWindower(semantic_radius)
        self.renderer = None
        if renderer is not None:
            src = np.asarray(source_images)
            if src.ndim != 4 or src.shape[0] != b:
                raise ValueError(
                    f"source_images must be (batch={b}, H, W, C) - one "
                    f"source face per session stream - got {src.shape}")
            self.renderer = StreamingRenderer(
                renderer, src, frames_per_call=render_frames_per_call,
                outputs=render_outputs, as_uint8=render_uint8,
                pipeline_depth=render_pipeline_depth)

    @property
    def latency_frames(self) -> int:
        """Added pipeline latency beyond the session's chunk cadence."""
        render_lag = (0 if self.renderer is None else
                      self.renderer.pipeline_depth * self.renderer.frames_per_call)
        return (self.decoder.latency_frames + self.smoother.latency_frames
                + self.windower.latency_frames + render_lag)

    def push(self, speaker_chunk, audio_chunk,
             n_valid: Optional[int] = None) -> Dict[str, np.ndarray]:
        """Feed one speaker chunk, generate that many listener codes, and run
        every later stage as far as finality allows. Returns each stage's
        newly final output (possibly empty): tokens (B, n), coeffs (B, m, C),
        smoothed (B, m', C), windows (a list of (B, C, 2r+1)) and the
        renderer's outputs (B, m'', H, W, 3)."""
        self.session.feed(speaker_chunk, audio_chunk, n_valid=n_valid)
        if not self._started:
            self.session.start(self.prompt)
            self._started = True
        n = self.session.chunk if n_valid is None else n_valid
        tokens = self.session.generate(n).cpu().numpy().astype(np.int32)
        out = {"tokens": tokens}
        out["coeffs"] = self.decoder.push(tokens)
        out["smoothed"] = self.smoother.push(out["coeffs"])
        out["windows"] = self.windower.push(out["smoothed"])
        if self.renderer is not None:
            out.update(self.renderer.push(out["windows"]))
        return out

    def flush(self) -> Dict[str, np.ndarray]:
        """Finalize every stage's tail once the stream has ended."""
        out = {"tokens": np.zeros((self.session.batch, 0), np.int32)}
        out["coeffs"] = self.decoder.flush()
        sm_head = self.smoother.push(out["coeffs"])
        out["smoothed"] = np.concatenate([sm_head, self.smoother.flush()], axis=-2)
        out["windows"] = self.windower.push(out["smoothed"]) + self.windower.flush()
        if self.renderer is not None:
            head = self.renderer.push(out["windows"])
            tail = self.renderer.flush()
            for k in self.renderer.outputs:
                out[k] = np.concatenate([head[k], tail[k]], axis=1)
        return out
