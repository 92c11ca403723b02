"""The port's ``train_s2s_pretrain`` twin runs on the CPU at a tiny size:
one epoch on synthetic CANDOR clips, the validation loss reported, the
best state_dict written in SLM's layout and the run record beside it."""

import torch

from dyadic_interaction_modeling_tpu_torch.cli import train_s2s_pretrain
from dyadic_interaction_modeling_tpu_torch.config import (
    merge_cfg_from_list,
    slm_defaults,
    vq_cfg_for,
)
from dyadic_interaction_modeling_tpu_torch.models.slm import SLM
from tests.test_torch_observability import assert_run_record, no_tensorboard  # noqa: F401

TINY = ["dim", "32", "enc_depth", "1", "dec_depth", "1", "enc_heads", "2",
        "dec_heads", "2"]


def test_train_cli_twin_synthetic_on_cpu(tmp_path, capsys, no_tensorboard):
    rc = train_s2s_pretrain.main(["--synthetic", "--device", "cpu", "--batch-size", "16",
                                  "--save-path", str(tmp_path / "run"), *TINY,
                                  "epochs", "1"])
    assert rc == 0 and "val loss" in capsys.readouterr().out
    cfg = merge_cfg_from_list(slm_defaults(), TINY)
    SLM(cfg, vq_cfg_for(cfg, True)).load_state_dict(
        torch.load(tmp_path / "run" / "best_model.pt", weights_only=True), strict=True)
    assert_run_record(tmp_path / "run", "train_s2s_pretrain")
