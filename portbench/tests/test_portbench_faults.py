"""A run with the timed path broken underneath comes out not correct, once
for each fault the cells can have: a code altered where it is produced
(greedy or sampled); a step that leaves the state unchanged; half of the
batch left out, the mean taken over the rest. (No cell runs on more than
one chip: no exchange between chips to leave out.) The look for a card is
skipped: the runs are on the CPU at tiny widths, the program in fp32."""

from __future__ import annotations

import time

import pytest
import torch

from conftest import tiny_cell

GEN = "slm_vico.gen_bo10_c256"
TRAIN = ["slm_vico.pretrain_b32", "vq_speaker_av.train_l1024"]


def _run(name):
    from portbench.harness.runner import run_cell

    return run_cell(tiny_cell(name), 2 ** 31 + 5, 0.3, False, "cpu", time.perf_counter())


def test_sound_runs_are_correct():
    for name in [GEN] + TRAIN:
        assert _run(name)["correct"] is True


def test_a_code_altered_where_it_is_produced(monkeypatch):
    from dyadic_interaction_modeling_tpu_torch.models import xtrans

    real = xtrans.sample_tokens
    calls = {"n": 0}

    def altered(logits, greedy=False, *args, **kwargs):
        tok = real(logits, greedy, *args, **kwargs)
        calls["n"] += 1
        if calls["n"] % 9 == 5:  # one position in nine: the least likely code
            tok = logits.float().argmin(dim=-1)
        return tok

    monkeypatch.setattr(xtrans, "sample_tokens", altered)
    out = _run(GEN)
    assert out["correct"] is False
    assert out["check"]["logit_gap"]["value"] > out["check"]["logit_gap"]["limit"]


def test_a_sampled_code_altered_where_it_is_produced(monkeypatch):
    from dyadic_interaction_modeling_tpu_torch.models import xtrans

    real = xtrans.sample_tokens
    calls = {"n": 0}

    def altered(logits, greedy=False, *args, **kwargs):
        tok = real(logits, greedy, *args, **kwargs)
        if not greedy:
            calls["n"] += 1
            if calls["n"] % 9 == 5:  # one sampled position in nine: outside the top k
                tok = logits.float().argmin(dim=-1)
        return tok

    monkeypatch.setattr(xtrans, "sample_tokens", altered)
    out = _run(GEN)
    assert out["correct"] is False
    assert out["check"]["logit_gap"]["value"] <= out["check"]["logit_gap"]["limit"]
    assert out["check"]["topk_gap"]["value"] > out["check"]["topk_gap"]["limit"]


@pytest.mark.parametrize("name", TRAIN)
def test_a_step_that_leaves_the_state_unchanged(name, monkeypatch):
    monkeypatch.setattr(torch.optim.AdamW, "step", lambda self, closure=None: None)
    assert _run(name)["correct"] is False


@pytest.mark.parametrize("name", TRAIN)
def test_half_of_the_batch_left_out(name, monkeypatch):
    from dyadic_interaction_modeling_tpu_torch.engine import pt_engine, vq_engine

    make_slm, make_vq = pt_engine.make_slm_train_step, vq_engine.make_vq_train_step

    def slm_half(*args, **kwargs):
        step = make_slm(*args, **kwargs)

        def half(batch, generator=None, noise=None):
            n = batch[0].shape[0] // 2
            return step(tuple(x[:n] for x in batch), generator,
                        None if noise is None else tuple(x[:n] for x in noise))
        return half

    def vq_half(*args, **kwargs):  # half the clips, or half the frames of one clip
        step = make_vq(*args, **kwargs)
        return lambda x: step(x[: x.shape[0] // 2] if x.shape[0] > 1 else x[:, : x.shape[1] // 2])

    monkeypatch.setattr(pt_engine, "make_slm_train_step", slm_half)
    monkeypatch.setattr(vq_engine, "make_vq_train_step", vq_half)
    assert _run(name)["correct"] is False
