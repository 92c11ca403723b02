"""Tiny shapes of the cells that came after the first three, for the
benchmark's CPU tests.

``tests/conftest.py`` holds the first cells' tiny traffic (``TINY_TRAFFIC``,
``CELLS``) and ``tiny_cell``. As pytest registers that module, this adds the
later cells to both tables and widens ``tiny_cell`` to a configuration
without the SLM, so every test parametrised over ``CELLS`` (resolving,
rehearsing, the control) takes them too.
"""

from __future__ import annotations

import copy
from pathlib import Path

SHARED = Path(__file__).resolve().parent / "tests" / "conftest.py"

TINY_DSV2 = dict(vocab_size=128, hidden_size=64, intermediate_size=96, moe_intermediate_size=32,
                 num_hidden_layers=3, num_attention_heads=4, n_routed_experts=8,
                 num_experts_per_tok=2, kv_lora_rank=32, qk_nope_head_dim=16,
                 qk_rope_head_dim=8, v_head_dim=16,
                 # logits of the order the published widths give at 0.006, so
                 # that the fp8 control reads over the cell's limits here too
                 initializer_range=0.1)
LATER_TRAFFIC = {
    "dsv2_lite.gen_b512_p512_g256": dict(sequences=3, prompt=6, tokens=7, check_rows=2,
                                         trace_units=2, prefill_tokens=12),
}


def _widened(tiny_cell, tiny_traffic):
    def widened(name: str, fp32: bool = True):
        """``tiny_cell``, and for a DeepSeek-V2 cell its decoder at
        ``TINY_DSV2`` (in fp32 with ``fp32``)."""
        from portbench.harness.cell import resolve, with_pending

        cell = resolve(name, with_pending())
        if "slm" in cell.config:
            return tiny_cell(name, fp32)
        cell.config = copy.deepcopy(cell.config)
        cell.config.update(TINY_DSV2)
        if fp32:
            cell.config["precision"]["serve_dtype"] = "float32"
        cell.traffic = dict(cell.traffic, **tiny_traffic[name])
        return cell

    return widened


def pytest_plugin_registered(plugin, manager):
    if Path(getattr(plugin, "__file__", None) or "/").resolve() != SHARED:
        return
    plugin.TINY_TRAFFIC.update(LATER_TRAFFIC)
    plugin.CELLS[:] = sorted(plugin.TINY_TRAFFIC)
    plugin.tiny_cell = _widened(plugin.tiny_cell, plugin.TINY_TRAFFIC)
