"""Streaming serving sessions over the SLM family.

Counterpart of ``dyadic_interaction_modeling_tpu/serving/``: the listener
session (``streaming.py``), the pool of listener sessions (``pool.py``) and
the BIWI speaker session (``speaker.py``). The audio front-end waits for the
port of wav2vec2 / HuBERT, the avatar pipelines for the port of ``render/``
(ROADMAP.md, queue 1).
"""

from .pool import StreamingSessionPool
from .speaker import StreamingSpeakerSession
from .streaming import StreamingListenerSession

__all__ = ["StreamingListenerSession", "StreamingSessionPool", "StreamingSpeakerSession"]
