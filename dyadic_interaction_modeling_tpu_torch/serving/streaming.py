"""Streaming dyadic listener generation: a live session around SLMFT.

Counterpart of ``dyadic_interaction_modeling_tpu/serving/streaming.py``. The
reference encodes a whole speaker clip, then decodes the whole listener
response (``x_engine_pt.py:232-277``). SLMFT's speaker encoders are causal,
so frame t's encoding never changes as later frames arrive, and a live
session can interleave the two with no recomputation:

* speaker motion + audio chunks stream in through the causal KV-cached
  encoder extension (``ContinuousTransformerWrapper.extend``), one pass a
  chunk, and their cross-attention K/V are appended to preallocated caches;
* listener codes stream out through the cached ``decode_step`` of offline
  generation: the self step is K1 bounded by the token count, the cross step
  K1 under the key mask ``arange(max_frames) < frames fed``.

Fed the whole clip, a session gives ``generate_tokens``' tokens; fed part of
it, the decoder attends only to the frames that have arrived. The caches sit
on the device of the model's parameters and are updated in place; the
counters are host ints. There is no compiled program here, so ``round`` is
``feed`` then ``generate`` (kept for the JAX package's API).
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import torch

from ..models.slm import SLMFT
from ..models.xtrans import init_decoder_cache, per_row, sample_tokens

# injected sampling noise: called with the (B, vocab) shape of each step's
# logits, returns that step's Gumbel noise (to hold a stream against another
# implementation); None draws it from the session's torch.Generator
NoiseFn = Callable[[Tuple[int, int]], torch.Tensor]


def model_device(model: torch.nn.Module) -> torch.device:
    return next(model.parameters()).device


def head_dims(cfg) -> Tuple[int, Optional[int]]:
    """(dim_head, kv_heads or None) of an SLM config."""
    return cfg.get("attn_dim_head", 64), cfg.get("attn_kv_heads", 0) or None


def cross_caches(cfg, batch: int, length: int, dtype, device
                 ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """One (k, v) pair of (batch, kv heads, length, dim_head) zeros a decoder
    layer, for the context's cross-attention K/V."""
    dh, kvh = head_dims(cfg)
    shape = (batch, kvh or cfg.dec_heads, length, dh)
    return [(torch.zeros(shape, dtype=dtype, device=device),
             torch.zeros(shape, dtype=dtype, device=device)) for _ in range(cfg.dec_depth)]


def write_cross(caches, kv, t) -> None:
    """Write a chunk's per-layer cross K/V (B, KVH, C, Dh) at [t, t+C) of the
    caches; ``t`` an int or a (B,) tensor of each row's own start."""
    for (ck, cv), (k, v) in zip(caches, kv):
        c = k.shape[2]
        if per_row(t):
            rows = torch.arange(k.shape[0], device=k.device)[:, None]
            pos = t[:, None] + torch.arange(c, device=k.device)
            ck[rows, :, pos] = k.transpose(1, 2)
            cv[rows, :, pos] = v.transpose(1, 2)
        else:
            ck[:, :, t: t + c] = k
            cv[:, :, t: t + c] = v


class TokenStream:
    """What the listener and speaker sessions share: the context's cross K/V
    caches, the decoder's self-attention cache, the host counters, the
    sampling, ``start``, ``generate`` and ``tokens``. A subclass's ``feed``
    appends context rows (``write_cross``) and advances ``_t_ctx``."""

    _chunk_name = "chunk"

    def __init__(self, model, batch: int, chunk: int, max_frames: int,
                 max_tokens: Optional[int], seed: int, temperature: float,
                 filter_frac: float, greedy: bool, noise: Optional[NoiseFn]):
        c = model.cfg
        self.model = model
        self.batch, self.chunk, self.max_frames = batch, chunk, max_frames
        self.max_tokens = max_tokens or max_frames
        self.greedy, self.temperature, self.filter_frac = greedy, temperature, filter_frac
        self.device = model_device(model)
        dh, kvh = head_dims(c)
        self._cross = cross_caches(c, batch, max_frames, model.dtype, self.device)
        self._dec = init_decoder_cache(batch, self.max_tokens, c.dec_depth, c.dec_heads, dh,
                                       model.dtype, kvh, self.device)
        self._t_ctx = self._t_dec = 0
        self._logits: Optional[torch.Tensor] = None
        self._generator = torch.Generator(device=self.device).manual_seed(seed)
        self._noise = noise
        self._tokens: List[torch.Tensor] = []

    @property
    def frames_fed(self) -> int:
        return self._t_ctx

    @property
    def tokens_generated(self) -> int:
        return sum(t.shape[1] for t in self._tokens)

    def _as_input(self, x) -> torch.Tensor:
        return torch.as_tensor(x, device=self.device).to(self.model.dtype)

    def _check_chunk(self, x: torch.Tensor, what: str) -> None:
        if x.shape[1] != self.chunk:
            raise ValueError(f"{what} expects chunks of {self.chunk} frames, "
                             f"got {x.shape[1]} (pad and pass n_valid)")
        if self._t_ctx + self.chunk > self.max_frames:
            raise ValueError("context capacity exceeded; raise max_frames")

    def _ctx_mask(self) -> torch.Tensor:
        keep = torch.arange(self.max_frames, device=self.device) < self._t_ctx
        return keep[None].expand(self.batch, -1).contiguous()

    @torch.no_grad()
    def start(self, prompt) -> None:
        """Consume the (B, P) prompt codes (the reference seeds generation
        with the first code of the stream); needs at least one fed frame."""
        if self._t_ctx == 0:
            raise ValueError(f"feed at least one {self._chunk_name} before start()")
        prompt = torch.as_tensor(prompt, device=self.device).long()
        if self._t_dec + prompt.shape[1] > self.max_tokens:
            raise ValueError("token capacity exceeded; raise max_tokens")
        mask = self._ctx_mask()
        for i in range(prompt.shape[1]):
            self._logits = self.model.stream_decode_step(prompt[:, i: i + 1], self._dec,
                                                         self._t_dec, self._cross, mask)
            self._t_dec += 1

    @torch.no_grad()
    def _generate(self, n: int) -> torch.Tensor:
        mask = self._ctx_mask()
        toks = torch.empty(self.batch, n, dtype=torch.long, device=self.device)
        for i in range(n):
            noise = (None if self.greedy or self._noise is None
                     else self._noise(tuple(self._logits.shape)))
            toks[:, i] = tok = sample_tokens(self._logits, self.greedy, self.temperature,
                                             self.filter_frac, noise, self._generator)
            self._logits = self.model.stream_decode_step(tok[:, None], self._dec,
                                                         self._t_dec, self._cross, mask)
            self._t_dec += 1
        self._tokens.append(toks)
        return toks

    def generate(self, n: int) -> torch.Tensor:
        """Sample the next ``n`` codes (B, n) against the context fed so
        far."""
        if self._logits is None:
            raise ValueError("call start(prompt) before generate()")
        if self._t_dec + n > self.max_tokens:
            raise ValueError("token capacity exceeded; raise max_tokens")
        return self._generate(n)

    def tokens(self) -> torch.Tensor:
        """Every code generated so far, (B, T)."""
        if not self._tokens:
            return torch.zeros(self.batch, 0, dtype=torch.long, device=self.device)
        return torch.cat(self._tokens, dim=1)

    def _tokens_or(self, tokens) -> torch.Tensor:
        return (self.tokens() if tokens is None
                else torch.as_tensor(tokens, device=self.device)).long()


class StreamingListenerSession(TokenStream):
    """A live dyadic session (``batch`` streams in lockstep) around SLMFT.

    chunk: speaker frames a ``feed`` (pad a short final chunk and pass
    ``n_valid``); max_frames / max_tokens: context and listener-token
    capacity; temperature / filter_frac / greedy: the sampling controls of
    ``generate_tokens``; seed: the session's ``torch.Generator``; noise:
    injected sampling noise (``NoiseFn``).
    """

    _chunk_name = "speaker chunk"

    def __init__(self, model: SLMFT, *, batch: int = 1, chunk: int = 8,
                 max_frames: int = 1024, max_tokens: Optional[int] = None, seed: int = 0,
                 temperature: float = 1.0, filter_frac: float = 0.1, greedy: bool = False,
                 noise: Optional[NoiseFn] = None):
        super().__init__(model, batch, chunk, max_frames, max_tokens, seed, temperature,
                         filter_frac, greedy, noise)
        c, dt = model.cfg, model.dtype
        dh, kvh = head_dims(c)
        self._enc_s = init_decoder_cache(batch, max_frames, c.enc_depth, c.enc_heads, dh, dt,
                                         kvh, self.device)
        self._enc_j = init_decoder_cache(batch, max_frames, c.enc_depth, c.enc_heads, dh, dt,
                                         kvh, self.device)

    @torch.no_grad()
    def _feed(self, sp: torch.Tensor, au: torch.Tensor, n_valid: int) -> torch.Tensor:
        ctx = self.model.encode_context_chunk(sp, au, self._enc_s, self._enc_j, self._t_ctx)
        write_cross(self._cross, self.model.stream_cross_kv(ctx), self._t_ctx)
        self._t_ctx += n_valid
        return ctx

    def feed(self, speaker_chunk, audio_chunk, n_valid: Optional[int] = None) -> torch.Tensor:
        """Stream in a (B, chunk, dim_in) speaker-motion chunk and its
        (B, chunk, dim_audio) audio features; ``n_valid < chunk`` marks a
        short final chunk (its tail is ignored and overwritten by a later
        feed). Returns the chunk's decoder-context rows."""
        sp, au = self._as_input(speaker_chunk), self._as_input(audio_chunk)
        self._check_chunk(sp, "feed")
        return self._feed(sp, au, self.chunk if n_valid is None else int(n_valid))

    def round(self, speaker_chunk, audio_chunk, n: Optional[int] = None,
              n_valid: Optional[int] = None) -> torch.Tensor:
        """One serving round: ``feed`` a chunk, then ``generate(n)`` codes
        (default ``chunk``). Needs ``start()``."""
        if self._logits is None:
            raise ValueError("call feed + start(prompt) before round()")
        n = self.chunk if n is None else n
        sp, au = self._as_input(speaker_chunk), self._as_input(audio_chunk)
        self._check_chunk(sp, "round")
        if self._t_dec + n > self.max_tokens:
            raise ValueError("token capacity exceeded; raise max_tokens")
        self._feed(sp, au, self.chunk if n_valid is None else int(n_valid))
        return self._generate(n)

    @torch.no_grad()
    def motion(self, tokens: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Listener codes VQ-decoded to motion (B, T, 56). The VQ decoder is
        bidirectional over the codes, so a stream re-decodes a trailing
        window; this decodes the whole prefix."""
        return self.model.decode_tokens_to_motion(self._tokens_or(tokens))
