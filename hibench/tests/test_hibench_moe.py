"""The MoE cell's additions on hand-made inputs: the grouped kernel's least
time worked out by hand at the deepseek-moe.chat cell's shapes, and the
``moe_experts_share`` reader, which reads nothing where the trace holds no
grouped kernel (a dense cell, the CPU, a program without the kernel)."""
import json
from pathlib import Path
from types import SimpleNamespace

import pytest

from hibench import grouped_bound, peaks, run

BENCH = Path(__file__).resolve().parents[1]


def test_decode_step_is_bound_by_the_experts_it_reads():
    # 8 tokens x top 6 over 35 of 64 experts of 1,408 at d 2,048
    b = grouped_bound.call_bound(48, 8, 35, 2048, 1408)
    nbytes = 4 * (35 * 3 * 2048 * 1408 + 8 * 2048 + 48 * 2048)
    assert b == pytest.approx(nbytes / peaks.HBM_BYTES_PER_S)
    assert 3.5e-4 < b < 3.7e-4


def test_chunk_pass_is_bound_by_its_float32_products():
    # 8 x 256 tokens x top 6: 12,288 pairs over all 64 experts
    b = grouped_bound.call_bound(12288, 2048, 64, 2048, 1408)
    assert b == pytest.approx(6 * 2048 * 1408 * 12288 / peaks.F32_FLOP_PER_S)
    assert 3.1e-3 < b < 3.2e-3


def _read(ctx):
    return run.read_metric(BENCH / "metrics" / "moe_experts_share.py", ctx)


def test_experts_share_reads_the_two_kernels():
    ctx = SimpleNamespace(trace={"busy_s": 4.0, "window_s": 10.0, "op_s": {
        "moe_gate_up_kernel": 1.5, "moe_down_kernel": 0.5,
        "paged_attention_split_kernel": 1.0, "void_cutlass_sgemm": 1.0}})
    assert _read(ctx) == pytest.approx(50.0)
    for trace in (None, {"busy_s": 0.0, "window_s": 1.0, "op_s": {}},
                  {"busy_s": 2.0, "window_s": 3.0,
                   "op_s": {"void_cutlass_sgemm": 2.0}}):
        assert _read(SimpleNamespace(trace=trace)) is None


def test_the_cell_reports_the_share():
    bench = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    entry = next(m for m in bench["per_layer"]
                 if m["name"] == "moe_experts_share")
    assert entry["workloads"] == ["deepseek-moe.chat"]
    cell = run.load_cell("deepseek-moe.chat", BENCH.parent)
    assert "moe_experts_share" in [m["name"] for m in cell.per_layer]
    assert cell.config["name"] == "deepseek-moe-16b"
