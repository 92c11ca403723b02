"""The speech path on the card at full width: the wav2vec2-base trunk
against the CPU, and ``CodeTalker.predict`` against a run on K4's plain
version.

Marked ``cuda`` (skipped where no card is present). On the card:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_speech_cuda.py
"""

from __future__ import annotations

import pytest
import torch

from torch_card import (BIWI_L, BIWI_VDIM, TRAIN_STEPS, WARMUP_STEPS,  # noqa: F401
                        assert_k4_on_path, card, codetalker_training, counted, ct_batch,
                        k4_calls, launches, speech_audio)

pytestmark = pytest.mark.cuda


def test_wav2vec2_trunk_matches_the_cpu(card):
    """The wav2vec2-base trunk (7 conv layers of 512, 12 layers of 768 with
    12 heads, FF 3072), seeded, fp32, over 4 BIWI-length waveforms of 77,200
    samples: (4, 2 BIWI_L, 768) features on the card within 1e-4 of the
    CPU's largest magnitude on the same weights."""
    from dyadic_interaction_modeling_tpu_torch.models.wav2vec2 import Wav2Vec2Model

    torch.manual_seed(0)
    model = Wav2Vec2Model().eval()
    audio = speech_audio(4, seed=31)
    with torch.no_grad():
        ref = model(audio, "BIWI", frame_num=BIWI_L)
        out = model.to("cuda")(audio.to("cuda"), "BIWI", frame_num=BIWI_L).cpu()
    err = float((out - ref).abs().max() / ref.abs().max())
    assert tuple(out.shape) == (4, 2 * BIWI_L, 768) and err <= 1e-4, err


def test_codetalker_predict(card):
    """``CodeTalker.predict`` of one clip of BIWI_L frames from weights after
    WARMUP_STEPS + TRAIN_STEPS training steps (``feat_map`` moved from its
    zero init): K4 once a frame, no K1/K2/K3, K4 on its own latents; every
    frame's codes equal to those of a run on the plain version, and its
    motion within 1e-4 of that run's largest magnitude."""
    model, step, batch = codetalker_training()
    for _ in range(WARMUP_STEPS + TRAIN_STEPS):
        step(*batch)
    model.eval()
    audio, template, _, one_hot = ct_batch(seed=43)
    with counted() as got, k4_calls() as calls:
        motion = model.predict(audio, template, one_hot)
    assert got == launches(nearest_code=BIWI_L)
    assert_k4_on_path(calls)
    with k4_calls(plain=True) as plain_calls:
        ref = model.predict(audio, template, one_hot)
    assert len(calls) == len(plain_calls) and all(
        torch.equal(a[2], b[2]) for a, b in zip(calls, plain_calls))
    err = float((motion - ref).abs().max() / ref.abs().max())
    assert tuple(motion.shape) == (1, BIWI_L, BIWI_VDIM) and err <= 1e-4, err
