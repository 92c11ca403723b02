"""Operation counts of the layers the configurations are built from, at
given shapes: 2 operations a multiply-add, forward only. A training step
counts a trainable layer three times (forward, and the gradients of its
input and of its weights) and a frozen one once."""

from __future__ import annotations


def linear(rows: float, d_in: int, d_out: int) -> float:
    return 2.0 * rows * d_in * d_out


def attention(rows: float, inner: int, keys: float) -> float:
    """Scores and the weighted sum of values for ``rows`` query positions,
    each attending ``keys`` keys over ``inner`` = heads x head width."""
    return 4.0 * rows * inner * keys


def vq_transformer(frames: float, hs: int, inter: int, layers: int, keys: float) -> float:
    per = (linear(frames, hs, 3 * hs) + linear(frames, hs, hs)
           + linear(frames, hs, inter) + linear(frames, inter, hs)
           + attention(frames, hs, keys))
    return layers * per


def vq_encoder(vq: dict, clips: int, length: int) -> float:
    """vertice_mapping, the k=5 conv, the embedding, the transformer over
    each clip's frames, the projection to the codes' latents and the
    distances to every code."""
    f = float(clips * length)
    hs, fz = vq["hidden_size"], vq["face_quan_num"] * vq["zquant_dim"]
    return (linear(f, vq["in_dim"], hs) + linear(f, 5 * hs, hs) + linear(f, hs, hs)
            + vq_transformer(f, hs, vq["intermediate_size"], vq["num_hidden_layers"], length)
            + linear(f, hs, fz) + linear(f * vq["face_quan_num"], vq["zquant_dim"], vq["n_embed"]))


def vq_decoder(vq: dict, rows: int, length: int, out_dim: int) -> float:
    f = float(rows * length)
    hs, fz = vq["hidden_size"], vq["face_quan_num"] * vq["zquant_dim"]
    return (linear(f, fz, hs) + linear(f, 5 * hs, hs) + linear(f, hs, hs)
            + vq_transformer(f, hs, vq["intermediate_size"], vq["num_hidden_layers"], length)
            + linear(f, hs, out_dim))


def x_encoder(slm: dict, clips: int, length: int, d_in: int, causal: bool) -> float:
    """ContinuousTransformerWrapper: project_in, then per layer q, k, v,
    out, the feedforward (x4) and attention (a causal query attends its
    prefix: (L + 1) / 2 keys on average)."""
    f = float(clips * length)
    d, inner = slm["dim"], slm["enc_heads"] * slm["attn_dim_head"]
    keys = (length + 1) / 2 if causal else length
    per = (3 * linear(f, d, inner) + linear(f, inner, d) + linear(f, d, 4 * d)
           + linear(f, 4 * d, d) + attention(f, inner, keys))
    return linear(f, d_in, d) + slm["enc_depth"] * per


def x_decoder_tokens(slm: dict, tokens: float, self_keys: float, ctx_keys: float) -> float:
    """The decoder's work for ``tokens`` token positions, each attending
    ``self_keys`` earlier tokens and ``ctx_keys`` context frames: self q, k,
    v, out; cross q, out; feedforward; attention; logits. The context's
    cross keys and values are counted apart (``x_decoder_context``)."""
    d = slm["dim"] + slm["dim_audio"]
    inner = slm["dec_heads"] * slm["attn_dim_head"]
    per = (3 * linear(tokens, d, inner) + linear(tokens, inner, d)
           + linear(tokens, d, inner) + linear(tokens, inner, d)
           + linear(tokens, d, 4 * d) + linear(tokens, 4 * d, d)
           + attention(tokens, inner, self_keys) + attention(tokens, inner, ctx_keys))
    return slm["dec_depth"] * per + linear(tokens, d, slm["num_tokens"])


def x_decoder_context(slm: dict, frames: float) -> float:
    d = slm["dim"] + slm["dim_audio"]
    inner = slm["dec_heads"] * slm["attn_dim_head"]
    return slm["dec_depth"] * 2 * linear(frames, d, inner)
