"""The torch port's wav2vec2 / HuBERT trunk against the JAX package on the
CPU, at tiny widths: the trunk's forward under both ``feat_extract_norm``s
with the BIWI trim, the vocaset interpolation and SpecAugment's
``masked_spec_embed``; ``processor_normalize``, ``linear_interpolation``
and ``compute_mask_indices``; ``load_hf_wav2vec2`` against HF's own model;
the HuBERT importer on s3prl / fairseq / HF state_dicts built here.

The JAX params come from a seeded port model through the JAX package's own
importer (``hf_wav2vec2_to_flax``: the port keeps HF's names), and the
port's bridge must give that state_dict back exactly. Features within 1e-4
of their largest magnitude."""

import re

import jax
import numpy as np
import pytest
import torch

from dyadic_interaction_modeling_tpu.models import hubert as JH
from dyadic_interaction_modeling_tpu.models import wav2vec2 as JW
from dyadic_interaction_modeling_tpu_torch.models import hubert as TH
from dyadic_interaction_modeling_tpu_torch.models import wav2vec2 as TW
from dyadic_interaction_modeling_tpu_torch.utils import weights as W

TOL = 1e-4


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(out, ref, tol=TOL):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(out), ref, rtol=tol,
                               atol=tol * max(1.0, float(np.abs(ref).max())))


def _tiny(mod, norm="group", **kw):
    args = dict(conv_dim=(32, 32), conv_kernel=(10, 3), conv_stride=(5, 2), hidden_size=32,
                num_hidden_layers=2, num_attention_heads=2, intermediate_size=64,
                num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4,
                feat_extract_norm=norm, conv_bias=norm == "layer")
    args.update(kw)
    return mod.W2VConfig(**args)


def _port_and_jax(norm="group", seed=0, **kw):
    torch.manual_seed(seed)
    tm = TW.Wav2Vec2Model(_tiny(TW, norm, **kw)).eval()
    with torch.no_grad():  # non-trivial norms, so the test sees their weights
        for name, p in tm.named_parameters():
            if "norm" in name:
                p.add_(0.1 * torch.randn_like(p))
    sd = {k: v.numpy() for k, v in tm.state_dict().items()}
    jcfg = _tiny(JW, norm, **kw)
    params = jax.tree_util.tree_map(np.asarray, JW.hf_wav2vec2_to_flax(sd, jcfg))
    back = W.jax_wav2vec2_to_state_dict(params)
    assert set(back) == set(sd)
    for k in sd:
        np.testing.assert_array_equal(back[k].numpy(), sd[k], err_msg=k)
    return tm, JW.Wav2Vec2Model(jcfg), params


@pytest.mark.parametrize("norm,dataset,frame_num", [
    ("group", "none", None), ("group", "BIWI", None), ("group", "BIWI", 6),
    ("layer", "BIWI", 6), ("group", "vocaset", 7), ("layer", "vocaset", None)])
def test_trunk_matches_jax(norm, dataset, frame_num):
    """The BIWI trim (even count, at most 2 * frame_num), the vocaset
    interpolation 50 -> 30 fps or to frame_num, both feature norms."""
    tm, jm, params = _port_and_jax(norm)
    audio = np.random.default_rng(1).standard_normal((2, 1810)).astype(np.float32)
    ref = np.asarray(jm.apply(params, audio, dataset, frame_num))
    with torch.no_grad():
        out = tm(torch.from_numpy(audio), dataset, frame_num).numpy()
    assert out.shape == ref.shape
    if dataset == "BIWI":
        assert out.shape[1] % 2 == 0 and (frame_num is None or out.shape[1] <= 2 * frame_num)
    _close(out, ref)


def test_mask_time_indices_match_jax():
    tm, jm, params = _port_and_jax()
    audio = np.random.default_rng(2).standard_normal((3, 1600)).astype(np.float32)
    with torch.no_grad():
        t = tm.feature_extractor(torch.from_numpy(audio)).shape[1] - 1  # the BIWI trim
    mask = JW.compute_mask_indices(np.random.default_rng(3), (3, t), 0.3, 3, min_masks=1)
    assert mask.any()
    ref = np.asarray(jm.apply(params, audio, "BIWI", None, mask))
    with torch.no_grad():
        out = tm(torch.from_numpy(audio), "BIWI", None, torch.from_numpy(mask)).numpy()
        plain = tm(torch.from_numpy(audio), "BIWI").numpy()
    _close(out, ref)
    assert not np.allclose(out, plain)


def test_processor_normalize_and_interpolation_match_jax():
    rng = np.random.default_rng(4)
    for n in (400, 12345):
        x = (rng.standard_normal(n) * 0.3 + 0.05).astype(np.float32)
        np.testing.assert_array_equal(TW.processor_normalize(x), JW.processor_normalize(x))
    x = rng.standard_normal((2, 50, 8)).astype(np.float32)
    for fps_out, n in ((30, None), (1, 17), (1, 50), (1, 121)):
        ref = np.asarray(JW.linear_interpolation(x, 50, fps_out, output_len=n))
        out = TW.linear_interpolation(torch.from_numpy(x), 50, fps_out, output_len=n).numpy()
        _close(out, ref, 1e-5)  # JAX's positions are float32, ours float64
        torch_ref = torch.nn.functional.interpolate(
            torch.from_numpy(x).transpose(1, 2), size=out.shape[1], align_corners=True,
            mode="linear").transpose(1, 2).numpy()
        _close(out, torch_ref, 1e-5)
    x2 = x[0]
    _close(TH.interpolate_to_length(torch.from_numpy(x2), 9).numpy(),
           JH.interpolate_to_length(x2, 9), 1e-5)


@pytest.mark.parametrize("shape,prob,length,min_masks", [((4, 100), 0.2, 10, 2),
                                                         ((2, 37), 0.3, 5, 0),
                                                         ((3, 240), 0.65, 10, 2)])
def test_compute_mask_indices_matches_jax(shape, prob, length, min_masks):
    ours = TW.compute_mask_indices(np.random.default_rng(5), shape, prob, length, min_masks)
    ref = JW.compute_mask_indices(np.random.default_rng(5), shape, prob, length, min_masks)
    np.testing.assert_array_equal(ours, ref)
    assert (ours.sum(axis=1) == ours.sum(axis=1)[0]).all()


@pytest.mark.parametrize("norm", ["group", "layer"])
def test_load_hf_wav2vec2_matches_transformers(norm):
    """An HF ``Wav2Vec2Model`` (random init, no download) loaded strictly:
    its ``last_hidden_state`` from our forward without alignment, with the
    positional conv's weight norm as ``parametrizations`` and as
    ``weight_g`` / ``weight_v``."""
    transformers = pytest.importorskip("transformers")
    hf_cfg = transformers.Wav2Vec2Config(
        conv_dim=(32, 32), conv_kernel=(10, 3), conv_stride=(5, 2), hidden_size=32,
        num_hidden_layers=2, num_attention_heads=2, intermediate_size=64,
        num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4, feat_extract_norm=norm,
        do_stable_layer_norm=False, conv_bias=norm == "layer")
    torch.manual_seed(0)
    hf = transformers.Wav2Vec2Model(hf_cfg).eval()
    sd = hf.state_dict()
    audio = torch.randn(2, 1600)
    with torch.no_grad():
        ref = hf(audio).last_hidden_state.numpy()
    cfg = TW.W2VConfig.from_hf(hf_cfg)
    legacy = {}
    for k, v in sd.items():
        k = k.replace("parametrizations.weight.original0", "weight_g")
        legacy[k.replace("parametrizations.weight.original1", "weight_v")] = v
    for state in (sd, legacy, {f"wav2vec2.{k}": v for k, v in sd.items()}):
        tm = TW.load_hf_wav2vec2(state, cfg).eval()
        with torch.no_grad():
            _close(tm(audio, "none").numpy(), ref)


# --- HuBERT: the cases of tests/test_hubert_import.py on the port ---


def _shared_weights(cfg, rng):
    """One weight set under HF's names, the positional conv weight-normed."""
    w = {}
    in_c = 1
    for i, (c, k) in enumerate(zip(cfg.conv_dim, cfg.conv_kernel)):
        w[f"feature_extractor.conv_layers.{i}.conv.weight"] = rng.randn(c, in_c, k) * 0.1
        in_c = c
    c0, h, f = cfg.conv_dim[0], cfg.hidden_size, cfg.intermediate_size
    w["feature_extractor.conv_layers.0.layer_norm.weight"] = 1 + 0.1 * rng.randn(c0)
    w["feature_extractor.conv_layers.0.layer_norm.bias"] = 0.1 * rng.randn(c0)
    w["feature_projection.layer_norm.weight"] = 1 + 0.1 * rng.randn(cfg.conv_dim[-1])
    w["feature_projection.layer_norm.bias"] = 0.1 * rng.randn(cfg.conv_dim[-1])
    w["feature_projection.projection.weight"] = rng.randn(h, cfg.conv_dim[-1]) * 0.1
    w["feature_projection.projection.bias"] = 0.1 * rng.randn(h)
    w["masked_spec_embed"] = rng.randn(h) * 0.1
    g = cfg.num_conv_pos_embedding_groups
    w["encoder.pos_conv_embed.conv.weight_v"] = rng.randn(h, h // g,
                                                          cfg.num_conv_pos_embeddings) * 0.1
    w["encoder.pos_conv_embed.conv.weight_g"] = 1 + 0.1 * rng.randn(
        1, 1, cfg.num_conv_pos_embeddings)
    w["encoder.pos_conv_embed.conv.bias"] = 0.1 * rng.randn(h)
    w["encoder.layer_norm.weight"] = 1 + 0.1 * rng.randn(h)
    w["encoder.layer_norm.bias"] = 0.1 * rng.randn(h)
    for i in range(cfg.num_hidden_layers):
        b = f"encoder.layers.{i}"
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            w[f"{b}.attention.{proj}.weight"] = rng.randn(h, h) * 0.1
            w[f"{b}.attention.{proj}.bias"] = 0.1 * rng.randn(h)
        for ln in ("layer_norm", "final_layer_norm"):
            w[f"{b}.{ln}.weight"] = 1 + 0.1 * rng.randn(h)
            w[f"{b}.{ln}.bias"] = 0.1 * rng.randn(h)
        w[f"{b}.feed_forward.intermediate_dense.weight"] = rng.randn(f, h) * 0.1
        w[f"{b}.feed_forward.intermediate_dense.bias"] = 0.1 * rng.randn(f)
        w[f"{b}.feed_forward.output_dense.weight"] = rng.randn(h, f) * 0.1
        w[f"{b}.feed_forward.output_dense.bias"] = 0.1 * rng.randn(h)
    return {k: np.asarray(v, np.float32) for k, v in w.items()}


def _to_fairseq_s3prl(w, cfg, rng):
    """The shared weights re-keyed into the s3prl file's layout (fairseq's
    HubertModel under ``upstream.model.``) with fairseq's pretraining heads."""
    out = {}
    for k, v in w.items():
        k = re.sub(r"^feature_extractor\.conv_layers\.(\d+)\.conv\.",
                   r"feature_extractor.conv_layers.\1.0.", k)
        k = k.replace("feature_extractor.conv_layers.0.layer_norm.",
                      "feature_extractor.conv_layers.0.2.")
        k = k.replace("feature_projection.layer_norm.", "layer_norm.")
        k = k.replace("feature_projection.projection.", "post_extract_proj.")
        if k == "masked_spec_embed":
            k = "mask_emb"
        k = k.replace("encoder.pos_conv_embed.conv.", "encoder.pos_conv.0.")
        k = re.sub(r"^(encoder\.layers\.\d+)\.attention\.", r"\1.self_attn.", k)
        k = re.sub(r"^(encoder\.layers\.\d+)\.layer_norm\.", r"\1.self_attn_layer_norm.", k)
        k = re.sub(r"^(encoder\.layers\.\d+)\.feed_forward\.intermediate_dense\.", r"\1.fc1.", k)
        k = re.sub(r"^(encoder\.layers\.\d+)\.feed_forward\.output_dense\.", r"\1.fc2.", k)
        out[f"upstream.model.{k}"] = v
    out["upstream.model.label_embs_concat"] = rng.randn(4, 8).astype(np.float32)
    out["upstream.model.final_proj.weight"] = rng.randn(8, cfg.hidden_size).astype(np.float32)
    out["upstream.model.final_proj.bias"] = np.zeros(8, np.float32)
    return out


def _hubert_cfg(mod):
    return mod.W2VConfig(conv_dim=(32, 32), conv_kernel=(10, 3), conv_stride=(5, 2),
                         hidden_size=48, num_hidden_layers=2, num_attention_heads=2,
                         intermediate_size=96, num_conv_pos_embeddings=16,
                         num_conv_pos_embedding_groups=2)


def test_hubert_import_both_layouts_identical_and_match_jax(tmp_path):
    """HF and s3prl layouts give one state_dict; it loads strictly, and its
    features match the JAX package's import of the s3prl file; a checkpoint
    file in each of the three wrappings loads the same."""
    cfg = _hubert_cfg(TH)
    rng = np.random.RandomState(0)
    hf_sd = _shared_weights(cfg, rng)
    fs_sd = _to_fairseq_s3prl(hf_sd, cfg, rng)
    a, b = TH.hubert_state_dict(hf_sd, cfg), TH.hubert_state_dict(fs_sd, cfg)
    assert set(a) == set(b)
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0, msg=k)
    tm = TH.HubertModel(cfg)
    tm.load_state_dict(b, strict=True)
    params = JH.hf_hubert_to_flax(fs_sd, _hubert_cfg(JW))
    wav = rng.randn(2, 1200).astype(np.float32)
    ref = np.asarray(JH.HubertModel(_hubert_cfg(JW)).apply(params, wav, "none"))
    with torch.no_grad():
        out = tm.eval()(torch.from_numpy(wav), "none").numpy()
    assert out.shape[-1] == cfg.hidden_size
    _close(out, ref)
    for i, payload in enumerate(({"Upstream": fs_sd}, {"state_dict": hf_sd}, fs_sd)):
        torch.save(payload, tmp_path / f"{i}.pt")
        got = TH.load_hubert_checkpoint(str(tmp_path / f"{i}.pt"), cfg)
        for k in a:
            torch.testing.assert_close(got[k], a[k], rtol=0, atol=0, msg=k)
    extract, model = TH.make_hubert_extractor(str(tmp_path / "0.pt"), cfg, device="cpu")
    _close(extract(wav[0]), ref[0])
    assert next(model.parameters()).device.type == "cpu"


def test_hubert_import_accounts_for_every_key():
    cfg = _hubert_cfg(TH)
    rng = np.random.RandomState(1)
    fs_sd = _to_fairseq_s3prl(_shared_weights(cfg, rng), cfg, rng)
    normalized, dropped = TH.normalize_hubert_keys(fs_sd)
    assert sorted(dropped) == sorted(f"upstream.model.{d}" for d in TH.HUBERT_DROP_KEYS)
    assert len(normalized) + len(dropped) == len(fs_sd)
    assert (normalized, dropped) == JH.normalize_hubert_keys(fs_sd)
    # an extraction-only file without the mask embedding: zeros, as the JAX import
    del fs_sd["upstream.model.mask_emb"]
    sd = TH.hubert_state_dict(fs_sd, cfg)
    assert torch.equal(sd["masked_spec_embed"], torch.zeros(cfg.hidden_size))


def test_hubert_import_rejects_unknown_keys():
    cfg = _hubert_cfg(TH)
    sd = _shared_weights(cfg, np.random.RandomState(2))
    sd["encoder.layers.0.attention.rotary_emb.inv_freq"] = np.zeros(4, np.float32)
    with pytest.raises(KeyError):
        TH.hubert_state_dict(sd, cfg)
    with pytest.raises(KeyError):
        JH.hf_hubert_to_flax(sd, _hubert_cfg(JW))


def test_hubert_base_config_is_wav2vec2_base():
    cfg = TH.hubert_base_config()
    assert cfg.hidden_size == 768 and cfg.num_hidden_layers == 12
    assert cfg.__dict__ == JH.hubert_base_config().__dict__
    with torch.device("meta"):
        n = sum(p.numel() for p in TH.HubertModel(cfg).parameters())
    assert 94e6 < n < 95e6  # HuBERT-base / wav2vec2-base: 94.4M
