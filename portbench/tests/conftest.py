"""Shared pieces of the benchmark's CPU tests: tiny widths of each cell
(the program in fp32 there, so that a sound run reads rounding alone),
the cells of ``BENCHMARK.json`` together with those of
``portbench/pending.json``, and the repository root on ``sys.path``."""

from __future__ import annotations

import copy
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY_SLM = dict(dim=32, enc_depth=1, dec_depth=1, enc_heads=2, dec_heads=2)
TINY_VQ = dict(hidden_size=32, num_hidden_layers=1, num_attention_heads=2,
               intermediate_size=64, zquant_dim=32)
TINY_TRAFFIC = {
    "slm_vico.gen_bo10_c256": dict(clips=3, frames=24, samples=2, check_rows=4, trace_units=2),
    "slm_vico.pretrain_b32": dict(clips=4, frames=24, trace_units=2),
    "vq_speaker_av.train_l1024": dict(frames=48, trace_units=2),
}
CELLS = sorted(TINY_TRAFFIC)


def tiny_cell(name: str, fp32: bool = True):
    """The cell at tiny widths and shapes; with ``fp32`` the program runs
    in fp32 (no bf16 model, no autocast)."""
    from portbench.harness.cell import resolve, with_pending

    cell = resolve(name, with_pending())
    cell.config = copy.deepcopy(cell.config)
    if "slm" in cell.config:
        cell.config["slm"].update(TINY_SLM)
    cell.config["vq"].update(TINY_VQ)
    if fp32:
        prec = cell.config["precision"]
        if "serve_dtype" in prec:
            prec["serve_dtype"] = "float32"
        prec["train_autocast"] = None
    cell.traffic = dict(cell.traffic, **TINY_TRAFFIC[name])
    return cell


@pytest.fixture(autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
