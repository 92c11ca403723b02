"""The port's readers of the reference's files, its YAML configs, its
reference-checkpoint loader and its prefetching loader, against the JAX
package.

Fixtures are written in the reference's formats as
``tests/test_datasets_io.py`` writes them (per-clip pickles, an
``RLD_data.csv`` with integer ids, CANDOR utterance pickles), through the
port's ``data.reference_files`` plus files that the readers must drop. The
prefetch cases are ``tests/test_engine.py:84-143``'s.
"""

import math
import os
import pickle

import numpy as np
import pandas as pd
import pytest
import torch

from dyadic_interaction_modeling_tpu import config as JC
from dyadic_interaction_modeling_tpu.data import datasets as JD
from dyadic_interaction_modeling_tpu.data import loader as JL
from dyadic_interaction_modeling_tpu_torch import config as TC
from dyadic_interaction_modeling_tpu_torch.cli import common
from dyadic_interaction_modeling_tpu_torch.config import slm_defaults, vq_cfg_for
from dyadic_interaction_modeling_tpu_torch.data import datasets as TD
from dyadic_interaction_modeling_tpu_torch.data import loader as TL
from dyadic_interaction_modeling_tpu_torch.data.reference_files import write_candor, write_vico
from dyadic_interaction_modeling_tpu_torch.data.synthetic import synthetic_vico_dataset
from dyadic_interaction_modeling_tpu_torch.models.slm import SLMFT
from dyadic_interaction_modeling_tpu_torch.utils.checkpoint import (
    load_reference,
    load_torch_checkpoint,
    model_state_dict,
)


def _dump(path, obj):
    with open(path, "wb") as f:
        pickle.dump(obj, f)


@pytest.fixture(scope="module")
def vico(tmp_path_factory):
    """Six kept clips, then three the readers drop: 4 frames, 1025 frames,
    and one whose audio is a frame short."""
    root = str(tmp_path_factory.mktemp("vico"))
    lengths = [20, 31, 5, 1024, 17, 26, 4, 1025, 22]
    splits = ["train", "test", "train", "train", "test", "train", "train", "test", "train"]
    data_dir, meta = write_vico(root, lengths, splits, seed=1)
    bad = os.path.join(data_dir, "clip0008.pkl")
    with open(bad, "rb") as f:
        clip = pickle.load(f)
    clip["audio"] = clip["audio"][:-1]
    _dump(bad, clip)
    return data_dir, meta


def _assert_items_equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and np.array_equal(x, y)
        else:
            assert type(x) is type(y) and x == y, (x, y)


@pytest.mark.parametrize("mode", ["train", "test"])
def test_vico_readers_match_jax(vico, mode):
    data_dir, meta = vico
    jds, tds = JD.ViCoDataset(data_dir, meta, mode), TD.ViCoDataset(data_dir, meta, mode)
    assert tds.paths == jds.paths
    kept = {"train": ["clip0000", "clip0002", "clip0003", "clip0005"],
            "test": ["clip0001", "clip0004"]}[mode]  # 4, 1025 and misaligned dropped
    assert [os.path.basename(p)[:-4] for p in tds.paths] == kept
    for i in range(len(tds)):
        item = tds[i]
        _assert_items_equal(item, jds[i])
        assert np.all(item[0][:, :56] == 1.0)  # the speaker video replaced by ones
        assert (item[3], item[4]) == (200 + int(kept[i][4:]), 100 + int(kept[i][4:]))
        assert type(item[3]) is int
    for cls in ("ViCoListenerDataset", "ViCoSpeakerDataset"):
        j, t = getattr(JD, cls)(data_dir, meta, mode), getattr(TD, cls)(data_dir, meta, mode)
        assert len(t) == len(j) == len(kept)
        for i in range(len(t)):
            _assert_items_equal(t[i], j[i])
    # the ids reach pad_collate's int32 arrays as the JAX reader's do
    items = [tds[i] for i in range(len(tds))]
    jitems = [jds[i] for i in range(len(jds))]
    for a, b in zip(TL.pad_collate(items), JL.pad_collate(jitems)):
        if isinstance(a, tuple):
            for x, y in zip(a, b):
                assert x.dtype == y.dtype == np.int32 and np.array_equal(x, y)
        elif isinstance(a, list):
            assert a == b
        else:
            assert np.array_equal(a, b)


def test_csv_cells_typed_as_pandas_types_them(tmp_path):
    path = tmp_path / "meta.csv"
    path.write_text("sentiment,uid,f,n,lid,sid,split\n"
                    "neutral,a1,1.5,,3,7,train\n"
                    "positive,12,2,x,4,8,test\n")
    want = pd.read_csv(path).values
    got = TD.read_csv_rows(str(path))
    assert len(got) == len(want)
    for row, ref in zip(got, want):
        for x, y in zip(row, ref):
            assert type(x) is type(y)
            assert (isinstance(x, float) and math.isnan(x) and math.isnan(y)) or x == y


def test_candor_split_and_dataset_match_jax(tmp_path):
    sp, li = write_candor(str(tmp_path), n_conversations=20, utterances=2, min_len=3,
                          max_len=40, seed=2)
    # a listener clip a frame short: dropped
    with open(os.path.join(li, "conv0003_1.pkl"), "rb") as f:
        clip = pickle.load(f)
    _dump(os.path.join(li, "conv0003_1.pkl"), {"video": clip["video"][:-1]})
    (jtr, jva), (ttr, tva) = JD.candor_split(sp, li), TD.candor_split(sp, li)
    assert (ttr, tva) == (jtr, jva)
    assert len(tva) > 0 and len(ttr) > len(tva)
    names = {os.path.basename(s) for s, _ in ttr + tva}
    assert "conv0003_1.pkl" not in names
    assert all(5 <= len(pickle.load(open(s, "rb"))["video"]) <= 250 for s, _ in ttr)
    jds, tds = JD.CandorDataset(jtr), TD.CandorDataset(ttr)
    for i in (0, len(tds) - 1):
        _assert_items_equal(tds[i], jds[i])
    speakers = [s for s, _ in tva]
    for cls in ("CandorListenerDataset", "CandorSpeakerDataset"):
        _assert_items_equal(getattr(TD, cls)(speakers)[0], getattr(JD, cls)(speakers)[0])


YAML = """DATA:
  data_path: ../data/vico_processed_30fps
  batch_size: 2
NETWORK:
  arch: stage1_speaker_BIWI
  in_dim: 824
  hidden_size: 768
  face_quan_num: 8
VQuantizer:
  n_embed: 512
  zquant_dim: 128
TRAIN:
  base_lr: 0.0001
  epochs: 100
  weight_decay: 0.002
manual_seed: 131
"""


def test_yaml_config_flattened_as_jax(tmp_path):
    path = tmp_path / "config_speaker.yaml"
    path.write_text(YAML)
    got, ref = TC.load_cfg_from_cfg_file(str(path)), JC.load_cfg_from_cfg_file(str(path))
    assert dict(got) == dict(ref) and got.in_dim == 824 and got.manual_seed == 131
    with pytest.raises(ValueError, match="not a yaml file"):
        TC.load_cfg_from_cfg_file(str(tmp_path / "missing.yaml"))
    # the CLI's config: the file, then the defaults it lacks, then KEY VALUE and --epochs
    args = common.get_parser().parse_args(["--config", str(path), "--epochs", "3",
                                           "hidden_size", "96"])
    cfg = common.load_config(args, TC.vq_listener_defaults)
    assert (cfg.hidden_size, cfg.epochs, cfg.num_hidden_layers, cfg.batch_size) == (96, 3, 6, 2)
    assert args.device == "cuda" and args.prefetch == 0


def _reference_layout(sd):
    """A state_dict as a reference file may hold it: under ``state_dict``,
    with nn.DataParallel's ``module.`` prefix and every LayerNorm spelled
    gamma/beta."""
    out = {}
    for k, v in sd.items():
        k = "module." + k
        if k.endswith(".weight") and v.dim() == 1 and "norm" in k:
            k = k[: -len("weight")] + "gamma"
        elif k.endswith(".bias") and "norm" in k:
            k = k[: -len("bias")] + "beta"
        out[k] = v
    return {"state_dict": out, "epoch": 3}


def test_reference_checkpoint_loads_strictly(tmp_path):
    cfg = TC.merge_cfg_from_list(slm_defaults(), ["dim", "32", "enc_depth", "1",
                                                  "dec_depth", "1", "enc_heads", "2",
                                                  "dec_heads", "2"])
    vq_cfg = vq_cfg_for(cfg, True)
    torch.manual_seed(1)
    src = SLMFT(cfg, vq_cfg)
    ref = _reference_layout(src.state_dict())
    assert any(k.endswith(".gamma") and "norm_s" in k for k in ref["state_dict"])
    assert all(k.startswith("module.") for k in ref["state_dict"])
    torch.save(ref, tmp_path / "ref.pth.tar")
    # the x-transformers norms spelled weight/bias too, unwrapped
    plain = {k.replace(".gamma", ".weight").replace(".beta", ".bias"): v
             for k, v in ref["state_dict"].items()}
    torch.save(plain, tmp_path / "plain.pt")
    for name in ("ref.pth.tar", "plain.pt"):
        torch.manual_seed(2)
        dst = SLMFT(cfg, vq_cfg)
        load_reference(dst, str(tmp_path / name))
        assert all(torch.equal(a, b) for a, b in zip(src.state_dict().values(),
                                                     dst.state_dict().values()))
    sd = model_state_dict(load_torch_checkpoint(str(tmp_path / "ref.pth.tar")), src)
    assert list(sd) == list(src.state_dict())
    # a speaker VQ's checkpoint into SLMFT's decoder-less speaker VQ: decoder dropped
    from dyadic_interaction_modeling_tpu_torch.models.vq_vae import VQAutoEncoder

    torch.save(_reference_layout(VQAutoEncoder(vq_cfg).state_dict()), tmp_path / "vq.pt")
    load_reference(dst.speaker_vq, str(tmp_path / "vq.pt"), drop_prefixes=("decoder.",))
    with pytest.raises(RuntimeError, match="Unexpected key"):
        load_reference(dst.speaker_vq, str(tmp_path / "vq.pt"))


def test_prefetch_loader_matches_sequential():
    ds = synthetic_vico_dataset(n_clips=10, min_len=10, max_len=40, seed=0)
    loader = TL.PaddedBatchLoader(ds, batch_size=4, shuffle=True, seed=1)
    direct = list(loader)
    pre = TL.PrefetchLoader(loader, depth=2)
    assert len(pre) == len(loader)
    fetched = list(pre)
    assert len(fetched) == len(direct)
    for a, b in zip(direct, fetched):
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[3], b[3])
        assert a[5] == b[5]
    # transform hook + set_epoch passthrough + reiterability
    pre_t = TL.PrefetchLoader(loader, depth=3, transform=TL.slm_batch_from_collated)
    pre_t.set_epoch(2)
    loader.set_epoch(2)
    direct2 = [TL.slm_batch_from_collated(c) for c in loader]
    for a, b in zip(direct2, list(pre_t)):
        np.testing.assert_array_equal(a[0], b[0])
    # early break must not wedge subsequent iterations
    it = iter(pre)
    next(it)
    del it
    assert len(list(pre)) == len(direct)


def test_prefetch_loader_copies_to_the_device():
    """The JAX package's ``device_put=True``: every array of a batch arrives
    as a tensor on the caller's device."""
    ds = synthetic_vico_dataset(n_clips=4, min_len=10, max_len=20, seed=0)
    loader = TL.PaddedBatchLoader(ds, batch_size=2, shuffle=False)
    pre = TL.PrefetchLoader(loader, depth=1, transform=TL.slm_batch_from_collated,
                            device=torch.device("cpu"))
    batches = list(pre)
    assert batches and all(isinstance(x, torch.Tensor) for b in batches for x in b)
    ref = [TL.slm_batch_from_collated(c) for c in loader]
    np.testing.assert_array_equal(batches[0][0].numpy(), ref[0][0])


def test_prefetch_loader_propagates_worker_errors():
    class Boom:
        def __len__(self):
            return 6

        def __getitem__(self, i):
            if i == 4:
                raise RuntimeError("corrupt sample")
            return (np.zeros((8, 824), np.float32), np.zeros((8, 56), np.float32),
                    f"c{i}", 0, 0, 0)

    loader = TL.PaddedBatchLoader(Boom(), batch_size=2, shuffle=False)
    pre = TL.PrefetchLoader(loader, depth=1)
    with pytest.raises(RuntimeError, match="corrupt sample"):
        list(pre)
