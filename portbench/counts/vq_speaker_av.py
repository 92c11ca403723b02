"""The work of a ``vq_speaker_av`` training step at the traffic's shapes."""

from __future__ import annotations

from . import flops as F


def work(cfg: dict, tr: dict) -> dict:
    """Encoder, both decoders (motion 56, audio 768), forward and backward;
    the code distances forward only."""
    vq = cfg["vq"]
    b, l = tr["clips"], tr["frames"]
    fq = vq["face_quan_num"]
    dist = F.linear(b * l * fq, vq["zquant_dim"], vq["n_embed"])
    trainable = (F.vq_encoder(vq, b, l) - dist
                 + F.vq_decoder(vq, b, l, 56) + F.vq_decoder(vq, b, l, 768))
    heads = vq["num_attention_heads"]
    layers = 3 * vq["num_hidden_layers"]
    d = vq["hidden_size"] // heads
    return {"dtype": cfg["precision"]["train_autocast"] or "float32", "flops": 3 * trainable + dist,
            "k23": [(layers, b * heads, l, d, False, l, 0)]}
