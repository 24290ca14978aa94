"""Tiny copies of the model cells that ``tiny.py`` does not size: a
tiny root (``tiny.tiny_root``) whose Moonlight configuration and whose
prefill and train-8k traffic are cut to what the CPU runs in seconds,
the kinds of layer kept (a dense first layer, then MoE layers with
latent attention)."""
from __future__ import annotations

import json
from pathlib import Path

from portbench.harness import HERE
from portbench.tests.tiny import tiny_root

TINY = {
    "moonlight-16b-a3b": {"num_hidden_layers": 3, "hidden_size": 128,
                          "num_attention_heads": 4, "kv_lora_rank": 32,
                          "qk_nope_head_dim": 16, "qk_rope_head_dim": 8,
                          "v_head_dim": 16, "intermediate_size": 160,
                          "moe_intermediate_size": 64,
                          "n_routed_experts": 8, "num_experts_per_tok": 2,
                          "n_shared_experts": 1, "vocab_size": 2048},
}
# Limits read at this size on the CPU (the cells' are read on the card):
# sound runs of seeds 6 and 7 read under them, each control and planted
# fault over one of them.
TINY_TRAFFIC = {
    "prefill-4x1k": {"batch": 2, "seq": 64, "t_max": 64,
                     "logit_gap_limit": 0.04, "decode_gap_limit": 0.03},
    "train-8k": {"seq": 128, "batch": 2, "grad_median_gap_limit": 3e-3,
                 "change_norm_gap_limit": 5.5e-3},
}


def tiny_model_root(tmp: Path) -> Path:
    """``tiny_root`` with the model cells' configurations and traffic
    cut as :data:`TINY` and :data:`TINY_TRAFFIC` say; returns it."""
    root = tiny_root(tmp)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    for c in bench["configs"]:
        if c["name"] in TINY:
            path = root / c["file"]
            path.write_text(json.dumps(
                {**json.loads(path.read_text()), **TINY[c["name"]]}))
    for name, over in TINY_TRAFFIC.items():
        path = root / HERE.name / "traffic" / f"{name}.json"
        path.write_text(json.dumps({**json.loads(path.read_text()), **over}))
    return root
