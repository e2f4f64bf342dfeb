"""The benchmark's arithmetic on hand-made inputs: the busy union and idle
gaps, the 95th percentile over every request, FLOPs a token of each
configuration worked out by hand, the roofline bound, and the per-layer
metric readers."""
import json
from pathlib import Path
from types import SimpleNamespace

import pytest

from hibench import flops, peaks
from hibench import run
from hibench import trace as tr
from hibench.reference import dims

BENCH = Path(__file__).resolve().parents[1]


def _dims(name):
    return dims.from_config(json.loads(
        (BENCH / "configs" / f"{name}.json").read_text()))


def test_union_counts_overlap_once():
    spans = [(0, 10), (5, 15), (20, 25), (24, 30), (40, 41)]
    u = tr.union(spans)
    assert u == [(0, 15), (20, 30), (40, 41)]
    assert sum(b - a for a, b in tr.clip(u, 2, 45)) == 13 + 10 + 1
    assert tr.gaps(u, -5, 50) == [(-5, 0), (15, 20), (30, 40), (41, 50)]


def test_idle_gaps_go_to_the_host_phase():
    segs = [("dispatch", 0, 10), ("host_fetch", 10, 12), ("postprocess", 12, 20)]
    got = tr.attribute([(5, 11), (18, 25)], segs)
    assert got == {"dispatch": 5, "host_fetch": 1, "postprocess": 2,
                   "outside_ticks": 5}
    assert tr.top({"a": 1, "b": 3, "c": 2}, 2) == [["b", 3], ["c", 2]]


def test_p95_over_every_request():
    rows = [{"ttft": t / 1e3, "tokens": [0] * 3} for t in range(1, 101)]
    e2e = run.end_to_end(rows, 2.0, 3 * 2 ** 30, 7.5)
    assert e2e["ttft_p95_ms"] == pytest.approx(95.05)
    assert e2e["tokens_per_s"] == 150.0
    assert e2e["peak_mem_gib"] == 3.0 and e2e["setup_s"] == 7.5


def test_danube_flops_by_hand():
    l = _dims("h2o-danube-3-4b")
    layer = 3840 * 120 * (2 * 32 + 2 * 8) + 3 * 3840 * 10240
    assert layer == 154_828_800
    assert dims.param_count(l) == {
        "matmul": 24 * layer + 3840 * 32000,
        "total": 24 * layer + 2 * 3840 * 32000 + 49 * 3840}
    assert dims.param_count(l)["total"] == 3_961_839_360
    # 2 FLOPs a parameter, and QK + PV over the real context
    assert flops.request_flops(l, 1, 1) == 2 * 3_838_771_200 + 4 * 24 * 32 * 120
    s = dims.s_tier(l, 4)
    assert (s.layers, s.d, s.heads, s.kv_heads, s.head_dim, s.ff) == \
        (6, 960, 8, 8, 120, 2560)


def test_deepseek_flops_by_hand():
    l = _dims("deepseek-moe-16b")
    expert = 3 * 2048 * 1408
    layer = 2048 * 128 * 64 + (6 + 2) * expert + 2048 * 64
    assert dims.param_count(l)["matmul"] == 28 * layer + 2048 * 102400
    assert dims.param_count(l)["matmul"] == 2_620_915_712
    assert dims.param_count(l)["total"] == 16_879_568_896
    s = dims.s_tier(l, 4)
    assert (s.layers, s.d, s.heads, s.experts, s.ff_expert, s.shared,
            s.top_k) == (7, 512, 4, 16, 352, 2, 6)


def test_request_flops_sum_the_context():
    l = _dims("h2o-danube-3-4b")
    per_param = 2 * dims.param_count(l)["matmul"]
    att = 4 * 24 * 32 * 120
    # 3 prompt tokens and 3 served: 5 tokens run, contexts 1..5
    assert flops.request_flops(l, 3, 3) == 5 * per_param + att * 15


def test_paged_call_bound():
    # bytes: q and out 2 x 4 x (2*1*8*128) + 100 rows x 2 heads x 128 x 2 B x 2
    b = flops.paged_call_bound(800, 100, (2, 1, 8, 128), (9, 16, 2, 128), 2)
    assert b == pytest.approx((2 * 4 * 2048 + 2 * 100 * 2 * 128 * 2)
                              / peaks.HBM_BYTES_PER_S)
    # a compute-bound call: many pairs, few bytes
    c = flops.paged_call_bound(10 ** 9, 1, (1, 1, 1, 128), (1, 16, 1, 128), 2)
    assert c == pytest.approx(4 * 128 * 1e9 / peaks.BF16_FLOP_PER_S)


def _read(name, ctx):
    return run.read_metric(BENCH / "metrics" / f"{name}.py", ctx)


def test_metric_readers():
    rows = [{"offloaded": i < 3} for i in range(8)]
    ctx = SimpleNamespace(
        window_s=10.0, ticks=40, requests=rows, phase_time={
            "dispatch": 6.0, "host_fetch": 3.0, "postprocess": 1.0},
        prefix_saved=25, prompt_admitted=1000, model_flops=989e12 * 0.1,
        trace={"busy_s": 2.5, "window_s": 10.0},
        kernel_bounds={"decode_attention_paged": {"bound_s": 1.0,
                                                  "device_s": 4.0}})
    assert _read("tick_ms", ctx) == 250.0
    assert _read("dispatch_share", ctx) == 60.0
    assert _read("offload_share", ctx) == 37.5
    assert _read("prefill_saved_share", ctx) == 2.5
    assert _read("mfu", ctx) == pytest.approx(1.0)
    assert _read("device_idle_share", ctx) == 75.0
    assert _read("paged_decode_roofline", ctx) == 25.0
    # nothing to read: no value, never a 0 share
    assert _read("chunk_attn_roofline", ctx) is None
    empty = SimpleNamespace(window_s=1.0, ticks=0, requests=[],
                            phase_time=None, prefix_saved=0,
                            prompt_admitted=0, model_flops=0.0, trace=None,
                            kernel_bounds={})
    for name in ("tick_ms", "dispatch_share", "offload_share",
                 "prefill_saved_share", "mfu", "device_idle_share",
                 "paged_decode_roofline", "chunk_attn_roofline"):
        assert _read(name, empty) is None, name


def test_check_sample_covers_both_tiers():
    from hibench import check
    rows = [{"tokens": [0] * (5 + i), "s_tokens": [0] * (5 + i),
             "offloaded": i % 3 == 0} for i in range(12)]
    got = check.sample(rows, 77, {"min_served_tokens": 30, "min_local": 2,
                                  "min_escalated": 2})
    assert got[0] is rows[11]                    # the longest
    assert sum(r["offloaded"] for r in got) >= 2
    assert sum(not r["offloaded"] for r in got) >= 2
    assert got == check.sample(rows, 77, {"min_served_tokens": 30,
                                          "min_local": 2, "min_escalated": 2})
    assert check.judge({"a": 1.0, "b": 0}, {"a": 1.0, "b": 0})
    assert not check.judge({"a": float("nan")}, {"a": 1.0})
    assert not check.judge({}, {"a": 1.0})
