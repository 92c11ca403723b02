"""Streaming serving over the SLM family.

Counterpart of ``dyadic_interaction_modeling_tpu/serving/``: the listener
session (``streaming.py``), the pool of listener sessions (``pool.py``),
the BIWI speaker session (``speaker.py``), the audio front-end that turns a
raw waveform stream into their per-frame features (``audio.py``), and the
live avatar pipelines that render a session's codes (``avatar.py``, and
``fused.py`` with every piece of state on the device).
"""

from .audio import StreamingAudioFrontend
from .avatar import (
    StreamingAvatarPipeline,
    StreamingCoeffDecoder,
    StreamingRenderer,
    StreamingSemanticWindower,
    StreamingSmoother,
)
from .fused import FusedAvatarPipeline
from .pool import StreamingSessionPool
from .speaker import StreamingSpeakerSession
from .streaming import StreamingListenerSession

__all__ = ["FusedAvatarPipeline", "StreamingAudioFrontend", "StreamingAvatarPipeline",
           "StreamingCoeffDecoder", "StreamingListenerSession", "StreamingRenderer",
           "StreamingSemanticWindower", "StreamingSessionPool", "StreamingSmoother",
           "StreamingSpeakerSession"]
