"""The cell ``dsv2_lite.gen_b512_p512_g256`` on the CPU at tiny widths (the
program in fp32 there; its tiny shape in ``portbench/conftest.py``, so the
tests over ``CELLS`` resolve, rehearse and hold the control of it too): a
token altered where it is produced makes a run not correct; the control's
gaps stand far above the program's; the work counts and the two new
readers' bounds by hand."""

from __future__ import annotations

import time

import pytest

from conftest import tiny_cell
from portbench.harness.cell import BENCH, file_module
from portbench.harness.peaks import HBM_BYTES_PER_S, PEAK_FLOPS

DSV2 = "dsv2_lite.gen_b512_p512_g256"
SEED = 2 ** 31 + 77


def _run(name):
    from portbench.harness.runner import run_cell

    return run_cell(tiny_cell(name), SEED, 0.3, False, "cpu", time.perf_counter())


def test_the_new_readers_apply_to_the_dsv2_cell_alone():
    from portbench.harness.cell import manifest

    for m in manifest()["per_layer"]:
        if m["name"] in ("mla_roofline.gen", "moe_roofline.gen"):
            assert m["workloads"] == [DSV2] and m["layer"] == "kernels"
    assert tiny_cell(DSV2).config["deployment"].startswith("one H100")


@pytest.mark.parametrize("greedy", [True, False])
def test_a_token_altered_where_it_is_produced(greedy, monkeypatch):
    from dyadic_interaction_modeling_tpu_torch.models import xtrans

    real = xtrans.sample_tokens
    calls = {"n": 0}

    def altered(logits, is_greedy=False, *args, **kwargs):
        tok = real(logits, is_greedy, *args, **kwargs)
        if is_greedy == greedy:
            calls["n"] += 1
            if calls["n"] % 5 == 3:  # the least likely token
                tok = logits.float().argmin(dim=-1)
        return tok

    monkeypatch.setattr(xtrans, "sample_tokens", altered)
    out = _run(DSV2)
    name = "logit_gap" if greedy else "topk_gap"
    assert out["correct"] is False
    assert out["check"][name]["value"] > out["check"][name]["limit"]


def test_the_controls_gaps_stand_far_above_the_programs():
    """At tiny widths the fp8 control's gaps are small in absolute terms
    (logits of 64-wide rows are ~0.05): they are held against the program's
    fp32 readings, which are rounding alone."""
    from portbench.calibrate import readings

    got = readings(tiny_cell(DSV2), 2 ** 31 + 9, "cpu", controls=True)
    prog, ctrl = got["program"], got["control"]
    assert max(prog["logit_gap"], prog["topk_gap"]) < 1e-5
    assert max(ctrl.values()) > 1e3 * max(prog["logit_gap"], prog["topk_gap"], 1e-9)
    assert 0.0 <= prog["route_ties"] <= 1.0


def test_k5_bound_by_hand():
    mla = file_module(BENCH / "metrics" / "mla_roofline.gen.py")
    # 3 launches of 2 cache rows, 5 live keys, 4 query rows, Dk 6, Dv 4:
    # bytes 2 * 2 * (5*6 + 4*(6 + 4)) = 280, operations 2*10*2*4*5 = 800
    want = 3 * max(280 / HBM_BYTES_PER_S, 800 / PEAK_FLOPS["bfloat16"])
    assert mla.bound([(3, 2, 5, 4, 6, 4)]) == pytest.approx(want)


def test_expert_gemm_bound_by_hand():
    moe = file_module(BENCH / "metrics" / "moe_roofline.gen.py")
    # 2 GEMMs of 6 pairs, 4 -> 3, 5 experts: bytes 2 * (5*12 + 6*7) = 204,
    # operations 2*6*4*3 = 144
    want = 2 * max(204 / HBM_BYTES_PER_S, 144 / PEAK_FLOPS["bfloat16"])
    assert moe.bound([(2, 6, 4, 3, 5)]) == pytest.approx(want)
    assert moe.NAME.search("cutlass::GemmUniversal<cutlass::gemm::GroupProblemShape<int>>")


def test_dsv2_counts_by_hand():
    """A dense layer and an expert layer at tiny widths: the decode steps'
    K5 shapes, the expert GEMMs of the decode steps and of each prefill
    chunk, and the parameter bytes of one decode step."""
    from portbench.counts import dsv2_lite

    cfg = dict(hidden_size=4, num_attention_heads=2, qk_nope_head_dim=2, qk_rope_head_dim=2,
               v_head_dim=2, kv_lora_rank=3, moe_intermediate_size=2, n_routed_experts=3,
               num_experts_per_tok=2, n_shared_experts=1, num_hidden_layers=2,
               first_k_dense_replace=1, moe_layer_freq=1, intermediate_size=5, vocab_size=7)
    tr = {"sequences": 3, "prompt": 4, "tokens": 3, "prefill_tokens": 8}
    w = dsv2_lite.work(cfg, tr)
    assert w["token_steps"] == 3
    assert w["k5"] == [(2, 3, 5, 2, 5, 3), (2, 3, 6, 2, 5, 3)]
    # decode: 2 steps of 3 rows x 2 pairs; prefill: chunks of 2 rows and 1 row
    assert [m[:2] for m in w["moe"]] == [(2, 6), (2, 6), (1, 16), (1, 16), (1, 8), (1, 8)]
    # attention 4*8 + 4*5 + 3*8 + 4*4 = 92 a layer; dense 3*4*5 = 60; experts
    # 3*4*2*3 = 72, shared 24, gate 12; head 28; embedding rows 3*4 = 12
    weights = 2 * (2 * 92 + 60 + 72 + 24 + 12 + 28 + 12)
    latent = 2 * 5 * 2 * 3
    keys = 5 + 6
    assert w["bytes"] == (2 * weights + latent * 4 + 2 * (weights + latent) + latent * keys
                          + 4 * 3 * 7 * 3)
