"""The work of ``slm_vico``'s cells, a unit at a time (a generate call, a
training step), at the traffic's shapes: model operations, the bytes a
call needs, and the shapes each hand-written kernel is launched at."""

from __future__ import annotations

from . import flops as F


def _es(dtype: str) -> int:
    return 2 if dtype == "bfloat16" else 4


def generate(cfg: dict, tr: dict) -> dict:
    """One best-of-N call: encode (both VQ encoders, encoder_s and
    encoder_joint causally), the token loop (L - 1 cached steps of N x B0
    rows), the VQ decode of every sampled code."""
    slm, vq = cfg["slm"], cfg["vq"]
    b0, n, l = tr["clips"], tr["samples"], tr["frames"]
    rows, steps = n * b0, l - 1
    dtype = cfg["precision"]["serve_dtype"]
    es = _es(dtype)
    inner = slm["dec_heads"] * slm["attn_dim_head"]
    d = slm["dim"] + slm["dim_audio"]
    # step t (0..L-2) attends t + 1 cached tokens: (L - 1) L / 2 in all
    live = steps * (steps + 1) / 2.0
    flops = (2 * F.vq_encoder(vq, b0, l)
             + F.x_encoder(slm, b0, l, slm["dim_in"], True)
             + F.x_encoder(slm, b0, l, slm["dim"], True)
             + F.x_decoder_context(slm, b0 * l)
             + F.x_decoder_tokens(slm, rows * steps, live / steps, l)
             + F.vq_decoder(vq, rows, steps, vq["in_dim"]))
    dec_params = (slm["dec_depth"] * (6 * d * inner + 2 * d * 4 * d)
                  + d * slm["num_tokens"] * 2)
    kv_entry = 2 * inner * es                        # one position's K and V of a layer
    self_reads = slm["dec_depth"] * rows * live * kv_entry
    cross_reads = slm["dec_depth"] * steps * b0 * l * kv_entry
    weights = steps * dec_params * es
    cache_writes = slm["dec_depth"] * rows * steps * kv_entry
    outputs = rows * steps * (vq["in_dim"] * es + 8)
    h, dh = slm["dec_heads"], slm["attn_dim_head"]
    k1 = [  # (count, cache rows, query rows a cache row, keys read, D, mask bytes)
        *[(slm["dec_depth"], rows * h, 1, t + 1, dh, 0) for t in range(steps)],
        (slm["dec_depth"] * steps, b0 * h, n, l, dh, b0 * l),
    ]
    return {"dtype": dtype, "flops": flops,
            "bytes": self_reads + cross_reads + weights + cache_writes + outputs,
            "token_steps": steps, "k1": k1}


def train(cfg: dict, tr: dict) -> dict:
    """One SLM pretraining step: the frozen VQ encoders forward; the
    trainable encoders (encoder_s, encoder_l, encoder_joint over 2L and over
    2B), the decoder over 2B rows of L - 1 tokens and both VQ decoders,
    forward and backward."""
    slm, vq = cfg["slm"], cfg["vq"]
    b, l = tr["clips"], tr["frames"]
    frozen = 2 * F.vq_encoder(vq, b, l)
    trainable = (2 * F.x_encoder(slm, b, l, slm["dim_in"], False)
                 + F.x_encoder(slm, b, 2 * l, slm["dim"], False)
                 + F.x_encoder(slm, 2 * b, l, slm["dim"], False)
                 + F.x_decoder_context(slm, 2 * b * l)
                 + F.x_decoder_tokens(slm, 2 * b * (l - 1), l / 2.0, l)
                 + 2 * F.vq_decoder(vq, b, l - 1, vq["in_dim"]))
    h, dh = slm["enc_heads"], slm["attn_dim_head"]
    # (count, rows, L, D, causal, keys kept a row, rows of the key mask);
    # in the autocast dtype; every clip is whole, so the masks keep every key
    k23 = [
        (2 * slm["enc_depth"], b * h, l, dh, False, l, b),
        (slm["enc_depth"], b * h, 2 * l, dh, False, 2 * l, b),
        (slm["enc_depth"], 2 * b * h, l, dh, False, l, 2 * b),
        (slm["dec_depth"], 2 * b * slm["dec_heads"], l - 1, dh, True, l - 1, 0),
    ]
    return {"dtype": cfg["precision"]["train_autocast"] or "float32",
            "flops": frozen + 3 * trainable, "k23": k23}


def work(cfg: dict, tr: dict) -> dict:
    return generate(cfg, tr) if tr["kind"] == "generate" else train(cfg, tr)
