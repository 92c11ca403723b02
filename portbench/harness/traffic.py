"""Seeded synthetic clips, made on the device in bulk.

The design is frozen from ``data/synthetic.py`` at commit
b5205ad5a7d96ed2c2fe9e7fed8fc49e99a4e0cc (``_smooth_motion``,
``synthetic_vico_clip``): motion is a sum of ``n_waves`` sinusoids per
channel at 30 fps, frequencies U(0.2, 3) Hz, phases U(0, 2 pi), amplitudes
U(0.2, 1) x 0.3; audio features are N(0, 1) x 0.1. Here both streams move
(the ViCo generator there holds the speaker's motion at ones), and all clips
of a call are drawn at once by a ``torch.Generator`` on the device, so the
same seed gives the same clips on one kind of device."""

from __future__ import annotations

import math

import torch

MOTION_DIM, AUDIO_DIM = 56, 768


def generator(seed: int, stream: int, device) -> torch.Generator:
    """An independent generator for each use (weights, clips, noise) of one
    run's seed."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + 7919 * stream) % (2 ** 63 - 1))
    return g


def smooth_motion(g: torch.Generator, clips: int, length: int, dim: int, device,
                  n_waves: int = 4, scale: float = 0.3) -> torch.Tensor:
    """(clips, length, dim) fp32 band-limited motion."""
    shape = (clips, n_waves, 1, dim)
    freqs = torch.rand(shape, generator=g, device=device) * 2.8 + 0.2
    phases = torch.rand(shape, generator=g, device=device) * (2 * math.pi)
    amps = (torch.rand(shape, generator=g, device=device) * 0.8 + 0.2) * scale
    t = (torch.arange(length, device=device, dtype=torch.float32) / 30.0)[None, None, :, None]
    return (amps * torch.sin(2 * math.pi * freqs * t + phases)).sum(dim=1)


def dyadic_clips(g: torch.Generator, clips: int, length: int, device):
    """(speaker motion, listener motion, audio): (B, L, 56), (B, L, 56),
    (B, L, 768) fp32, and the (B, L) bool mask of valid frames (all valid:
    every clip has ``length`` frames)."""
    speaker = smooth_motion(g, clips, length, MOTION_DIM, device)
    listener = smooth_motion(g, clips, length, MOTION_DIM, device)
    audio = torch.randn(clips, length, AUDIO_DIM, generator=g, device=device) * 0.1
    mask = torch.ones(clips, length, dtype=torch.bool, device=device)
    return speaker, listener, audio, mask


def av_clips(g: torch.Generator, clips: int, length: int, device) -> torch.Tensor:
    """(B, L, 56 + 768): listener motion || audio features, the speaker
    VQ-VAE's audio-visual input as ``train_vq``'s synthetic stream makes it."""
    motion = smooth_motion(g, clips, length, MOTION_DIM, device)
    audio = torch.randn(clips, length, AUDIO_DIM, generator=g, device=device) * 0.1
    return torch.cat([motion, audio], dim=-1)
