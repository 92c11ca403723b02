"""Streaming serving sessions over the SLM family.

Counterpart of ``dyadic_interaction_modeling_tpu/serving/``: the listener
session (``streaming.py``), the pool of listener sessions (``pool.py``),
the BIWI speaker session (``speaker.py``) and the audio front-end that
turns a raw waveform stream into their per-frame features (``audio.py``).
The avatar pipelines wait for the port of ``render/`` (ROADMAP.md,
queue 1).
"""

from .audio import StreamingAudioFrontend
from .pool import StreamingSessionPool
from .speaker import StreamingSpeakerSession
from .streaming import StreamingListenerSession

__all__ = ["StreamingAudioFrontend", "StreamingListenerSession", "StreamingSessionPool",
           "StreamingSpeakerSession"]
