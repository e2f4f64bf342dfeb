"""Reduced cells for the CPU tests: the harness's run on the CPU at toy
sizes, with the kernels' plain versions."""
from __future__ import annotations

import copy
import json
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parents[2]

SMALL = {"num_hidden_layers": 2, "hidden_size": 256, "num_attention_heads": 4,
         "head_dim": 64, "vocab_size": 512}
CONFIGS = {
    "h2o-danube-3-4b": dict(SMALL, num_key_value_heads=2,
                            intermediate_size=512, sliding_window=96),
    "deepseek-moe-16b": dict(SMALL, num_key_value_heads=4,
                             moe_intermediate_size=128, n_routed_experts=4,
                             num_experts_per_tok=2, n_shared_experts=1),
}
TRAFFIC = {"kind": "waves", "size_seed": 7,
           "shared_prefixes": {"count": 2, "length": 24, "weights": [0.7, 0.3]},
           "user_turn": {"median": 20, "sigma": 0.6, "min": 4, "max": 56},
           "max_new_tokens": {"median": 5, "sigma": 0.5, "min": 2, "max": 9},
           "warmup": {"requests": 3, "max_new_tokens": 2}}
SERVE = {"buckets": [32, 48, 64, 80], "num_slots": 4, "l_slots": 2,
         "page_size": 16, "decode_block": 2, "prefix_sharing": True,
         "prefix_entries": 2, "chunk_prefill": True, "chunk_size": 16,
         "chunk_width": 2, "kv_dtype": "bf16"}
LIMITS = {"gap_mean": 1e-4, "conf_med": 1e-4, "flips": 0}


def cell(config: str, waves: int = 6) -> SimpleNamespace:
    """A cell of ``config`` cut to toy size, with BENCHMARK.json's metrics
    and the real per-layer metric files."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((ROOT / "hibench" / "configs" / f"{config}.json")
                     .read_text())
    return SimpleNamespace(
        name=f"tiny.{config}", chips=1, config=dict(cfg, **CONFIGS[config]),
        traffic=copy.deepcopy(TRAFFIC),
        settings={"offload_share": 0.5, "calibration_waves": 1,
                  "wave_requests": waves,
                  "max_new_tokens": 9, "serve": dict(SERVE),
                  "check": {"min_served_tokens": 40, "min_local": 1,
                            "min_escalated": 1, "flip_margin": 1e-4,
                            "limits": dict(LIMITS)}},
        end_to_end=bench["end_to_end"], per_layer=bench["per_layer"],
        metrics_dir=ROOT / "hibench" / "metrics")


def dump(result: dict) -> str:
    return json.dumps(result, default=str)
