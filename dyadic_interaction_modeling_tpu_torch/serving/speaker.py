"""Streaming audio-driven talking-head session around SpeakerSLMFT (BIWI).

Counterpart of ``dyadic_interaction_modeling_tpu/serving/speaker.py``. The
reference's speaker pipeline is offline (``test_biwi.py``), but its decoder
context has no temporal mixing: a frame's row is the speaker embedding and
that frame's audio features (``seq2seq_pretrain.py:699-704``). So a live
session is exact by construction: audio features stream in, their
cross-attention K/V are appended to preallocated caches, and EMOCA codes
stream out through the cached ``decode_step`` of offline generation (K1 for
the self and the cross step). Fed the whole clip, it gives
``generate_tokens``' tokens; fed part of it, those of the clip cut there.
``mesh`` decodes the codes through ``SpeakerSLMFT.stream_decode_emoca``,
whose BiLSTM head is bidirectional over the prefix.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..models.slm import SpeakerSLMFT
from .streaming import NoiseFn, TokenStream, write_cross


class StreamingSpeakerSession(TokenStream):
    """Live talking-head generation (``batch`` streams in lockstep).

    chunk: audio frames a ``feed``; max_frames / max_tokens: context and
    EMOCA-token capacity; speaker_ids: (batch,) subject conditioning, fixed
    for the session (None: the zero embedding, the reference's
    ``speaker_id=None``); temperature / filter_frac / greedy / seed / noise:
    as ``StreamingListenerSession``."""

    _chunk_name = "audio chunk"

    def __init__(self, model: SpeakerSLMFT, *, batch: int = 1, chunk: int = 8,
                 max_frames: int = 1024, max_tokens: Optional[int] = None,
                 speaker_ids=None, seed: int = 0, temperature: float = 1.0,
                 filter_frac: float = 0.1, greedy: bool = False,
                 noise: Optional[NoiseFn] = None):
        super().__init__(model, batch, chunk, max_frames, max_tokens, seed, temperature,
                         filter_frac, greedy, noise)
        self._sids = (None if speaker_ids is None
                      else torch.as_tensor(speaker_ids, device=self.device).long())

    @torch.no_grad()
    def feed(self, audio_chunk, n_valid: Optional[int] = None) -> None:
        """Stream in a (B, chunk, dim_audio) audio-feature chunk; ``n_valid``
        marks a short final chunk."""
        au = self._as_input(audio_chunk)
        self._check_chunk(au, "feed")
        ctx = self.model.stream_speaker_context(au, self._sids)
        write_cross(self._cross, self.model.stream_cross_kv(ctx), self._t_ctx)
        self._t_ctx += self.chunk if n_valid is None else int(n_valid)

    @torch.no_grad()
    def mesh(self, template, tokens: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Codes -> ((B, T, vertice_dim) mesh, (B, T, 56) EMOCA)."""
        return self.model.stream_decode_emoca(self._tokens_or(tokens),
                                              self._as_input(template))
