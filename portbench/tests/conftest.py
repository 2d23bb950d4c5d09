"""Shared set-up of the benchmark's own tests (run on the CPU with
``python -m pytest portbench/tests``; the tests marked ``cuda`` need a
card and skip without one)."""
import dataclasses
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

SMALL = {"frames": 16, "height": 96, "width": 80, "grid_points": 2000}
# DeepSeek-V2's structure (MLA, a dense first layer, routed and shared
# experts) at widths the CPU runs in a second, and a mix to fit it
TINY_LM = {"hidden_size": 64, "num_attention_heads": 4,
           "num_key_value_heads": 4, "qk_nope_head_dim": 16,
           "qk_rope_head_dim": 8, "v_head_dim": 16, "kv_lora_rank": 32,
           "n_routed_experts": 8, "num_experts_per_tok": 2,
           "moe_intermediate_size": 32, "intermediate_size": 128,
           "vocab_size": 512, "num_hidden_layers": 3}
TINY_MIX = {"clients": 4, "requests_per_client": 4, "batch_slots": 4,
            "capacity": 96, "prompt_tokens": [8, 32],
            "answer_tokens": [8, 48], "judged": 3}


@pytest.fixture
def small_cell():
    """A cell of ``BENCHMARK.json`` with its configuration (and for a
    served model its mix) cut to a size the CPU runs in a second."""
    from portbench import harness

    def make(name, **traffic):
        """``traffic`` replaces entries of the cell's mix (``loop`` too)."""
        cell = harness.find_cell(name)
        small = {**SMALL, **TINY_LM}
        config = {**cell.config, **{k: v for k, v in small.items()
                                    if k in cell.config}}
        if "num_hidden_layers" in config:
            traffic = {**TINY_MIX, **traffic}
        return dataclasses.replace(cell, config=config,
                                   traffic={**cell.traffic, **traffic})
    return make
