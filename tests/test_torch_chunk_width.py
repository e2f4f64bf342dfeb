"""The chunk lane at its live rows' width (``serving/scheduler.py``,
``chunk_lane_width``), on reduced configs on the CPU:

* the width rule: the smallest power of two below W that holds the live
  rows, else W;
* a lane run at that width gives the tokens, confidences and records of
  the same lane run at W (the width function monkeypatched to W), for the
  dense, SSM and hybrid families with and without prefix sharing, with
  1–3 live rows of a W = 4 lane: every field equal but the confidence,
  held within ``CONF_TOL`` = 1e-6 (``test_torch_stream.py``'s default):
  the CPU's float32 GEMMs block their rows by the row count, so a row's
  sums may round otherwise at another width (1.3e-8 at most measured, on
  the SSM and hybrid lanes);
* the MoE family's dropless dispatch runs the rule's widths; experts
  split over a ``model`` axis (capacity from the pass's token count) keep
  W;
* the counters: ``chunk_width_ticks`` sums to ``lane_ticks["chunk"]``,
  ``chunk_positions`` is the sum of width x C, one ``_host_fetch`` a tick
  whose chunk outputs keep their (W,) shapes;
* a ``data`` = 2 gloo mesh whose S replicas run their lanes at different
  widths in one tick gathers and serves as at W.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs.base import HIConfig
from repro_torch.configs.registry import ARCHS
from repro_torch.models import model_zoo
from repro_torch.serving import engine as engine_mod
from repro_torch.serving import scheduler as sched_mod
from repro_torch.serving.batcher import Request
from repro_torch.serving.engine import build_engine
from test_torch_sharding import run_ranks

STEPS = 3
W = 4
C = 8
# prompts of 16-32 tokens take the chunk lane (C = 8); the 8-token ones
# the admit lane, so that 1-3 of the 4 slots chunk at a time
LENS = (32, 8, 16, 24, 8, 32, 16, 8, 24)
KW = dict(buckets=(8, 16, 24, 32), num_slots=W, l_slots=W, page_size=8,
          chunk_prefill=True, chunk_size=C, chunk_width=W, validate=True)
FAMILIES = ("qwen2-1.5b", "mamba2-370m", "zamba2-2.7b")
CONF_TOL = 1e-6
MOE_ARCH = "deepseek-moe-16b"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op torch thread: the reduced models' small ops run about
    as fast on it, and the suite's other workers keep their cores (the
    thread count is restored afterwards)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _requests(arch, lens=LENS, seed=5):
    vocab = ARCHS[arch].reduced().vocab_size
    rng = np.random.default_rng(seed)
    return [Request(i, rng.integers(0, vocab, n).astype(np.int32),
                    max_new_tokens=STEPS) for i, n in enumerate(lens)]


def _serve(arch, sharing=False, reqs=None):
    """One stream with every request escalated (theta above any max-prob
    confidence), so that both tiers' chunk lanes run; returns (records,
    scheduler)."""
    eng = build_engine(ARCHS[arch].reduced(),
                       HIConfig(theta=1.1, capacity_factor=1.0),
                       max_new_tokens=STEPS, cache_len=48, device="cpu")
    if reqs is None:
        reqs = _requests(arch)
        if sharing:
            reqs += _requests(arch)[:4]       # repeats restore a prefix
    out = eng.serve_stream(reqs, prefix_sharing=sharing, **KW)
    return out, eng._stream[1]


def _full_width(monkeypatch):
    monkeypatch.setattr(sched_mod, "chunk_lane_width", lambda live, w: w)


def _assert_records_equal(a, b):
    assert a.keys() == b.keys()
    for rid in a:
        assert a[rid].keys() == b[rid].keys()
        for key in a[rid]:
            if key == "ttft":                 # a wall-clock reading
                continue
            if key == "confidence":
                assert abs(a[rid][key] - b[rid][key]) <= CONF_TOL, rid
                continue
            np.testing.assert_array_equal(a[rid][key], b[rid][key],
                                          err_msg=f"{rid} {key}")


@pytest.mark.parametrize("w,want", [(8, (1, 2, 4, 4, 8, 8, 8, 8)),
                                    (6, (1, 2, 4, 4, 6, 6)),
                                    (4, (1, 2, 4, 4)), (1, (1,))])
def test_width_rule(w, want):
    assert tuple(sched_mod.chunk_lane_width(n, w)
                 for n in range(1, w + 1)) == want


@pytest.mark.parametrize("arch", FAMILIES)
@pytest.mark.parametrize("sharing", [False, True])
def test_width_lane_equals_the_full_lane(arch, sharing, monkeypatch):
    assert model_zoo.independent_rows(ARCHS[arch].reduced())
    got, sched = _serve(arch, sharing)
    widths = {w for rt in (sched.srt, sched.lrt)
              for w in rt.chunk_width_ticks}
    assert {1, 2} <= widths, widths
    _full_width(monkeypatch)
    ref, ref_sched = _serve(arch, sharing)
    assert set(ref_sched.lrt.chunk_width_ticks) == {W}
    _assert_records_equal(got, ref)
    for rt, ref_rt in ((sched.srt, ref_sched.srt),
                       (sched.lrt, ref_sched.lrt)):
        assert rt.lane_ticks == ref_rt.lane_ticks
        assert rt.chunk_tokens == ref_rt.chunk_tokens
        assert rt.chunk_positions < ref_rt.chunk_positions \
            == W * C * ref_rt.lane_ticks["chunk"]
    if sharing:
        assert sched.prefix_stats == ref_sched.prefix_stats
        assert sched.prefix_stats["full_hits"] > 0


def test_moe_lane_keeps_its_width():
    """Only experts split over a ``model`` axis wider than 1 (the capacity
    dispatch, whose capacity comes from the pass's token count) keep the
    lane at W; the dropless dispatch of one rank runs the rule's widths."""
    cfg = ARCHS[MOE_ARCH].reduced()
    assert not model_zoo.independent_rows(cfg, model_ranks=2)
    assert model_zoo.independent_rows(cfg)
    _, sched = _serve(MOE_ARCH)
    for rt in (sched.srt, sched.lrt):
        assert rt.lane_ticks["chunk"] > 0
        assert sum(rt.chunk_width_ticks.values()) == rt.lane_ticks["chunk"]
        assert min(rt.chunk_width_ticks) < W
        assert rt.chunk_positions < W * C * rt.lane_ticks["chunk"]


@pytest.mark.parametrize("arch", (*FAMILIES, MOE_ARCH))
def test_counters_follow_the_widths(arch, monkeypatch):
    """Per tick the lane's width is the rule's for its scheduled rows; the
    counters sum it; one fetch a tick, its chunk outputs (W,)."""
    log, shapes = [], []
    real = sched_mod._TierRuntime.tick_inputs

    def logged(self, s_max):
        arrays, flags = real(self, s_max)
        log.append((self, flags["chunk_width"], len(self.chunk_sched)))
        return arrays, flags
    fetch = engine_mod._host_fetch

    def fetched(tree):
        shapes.append({k: tuple(v.shape) for k, v in tree.items()
                       if k.endswith(("chunk_tok", "chunk_conf"))})
        return fetch(tree)
    monkeypatch.setattr(sched_mod._TierRuntime, "tick_inputs", logged)
    monkeypatch.setattr(engine_mod, "_host_fetch", fetched)
    _, sched = _serve(arch)
    rows = model_zoo.independent_rows(ARCHS[arch].reduced())
    for rt in (sched.srt, sched.lrt):
        ticks = [(w, n) for r, w, n in log if r is rt and n]
        assert ticks and len(ticks) == rt.lane_ticks["chunk"]
        for w, n in ticks:
            assert w == (sched_mod.chunk_lane_width(n, W) if rows else W)
        assert sum(rt.chunk_width_ticks.values()) == rt.lane_ticks["chunk"]
        assert rt.chunk_width_ticks == {
            w: sum(x == w for x, _ in ticks) for w, _ in ticks}
        assert rt.chunk_positions == C * sum(w for w, _ in ticks)
    assert len(shapes) == sched.counters.ticks
    assert all(s == {f"{t}.chunk_{k}": (W,) for t in "sl"
                     for k in ("tok", "conf")} for s in shapes)


_MESH_SCRIPT = """
import numpy as np
from repro_torch.configs.base import HIConfig
from repro_torch.configs.registry import ARCHS
from repro_torch.launch.mesh import make_serving_mesh
from repro_torch.serving import scheduler
from repro_torch.serving.batcher import Request
from repro_torch.serving.engine import build_engine

mesh = make_serving_mesh(2, 1, device="cpu")
cfg = ARCHS["qwen2-1.5b"].reduced()
rng = np.random.default_rng(2)
reqs = [Request(i, rng.integers(0, cfg.vocab_size, n).astype(np.int32),
                max_new_tokens=3) for i, n in enumerate(ARGS["lens"])]
real = scheduler._TierRuntime.tick_inputs
rule = scheduler.chunk_lane_width
out = {}
for name, width_fn in (("width", rule), ("full", lambda live, w: w)):
    scheduler.chunk_lane_width = width_fn
    log = []

    def logged(self, s_max):
        arrays, flags = real(self, s_max)
        log.append((self.name, flags["chunk_width"], len(self.chunk_sched)))
        return arrays, flags
    scheduler._TierRuntime.tick_inputs = logged
    e = build_engine(cfg, HIConfig(theta=1.1, capacity_factor=1.0),
                     max_new_tokens=3, cache_len=48, device="cpu")
    recs = e.serve_stream(reqs, mesh=mesh, **ARGS["kw"])
    sched = e._stream[1]
    for rt in (*sched.srts, sched.lrt):
        rt.pool.check_invariants()
    out[name] = {"recs": {k: {f: v for f, v in r.items() if f != "ttft"}
                          for k, r in recs.items()},
                 "log": log, "ticks": e.stats["stream_ticks"],
                 "widths": {rt.name: dict(rt.chunk_width_ticks)
                            for rt in (*sched.srts, sched.lrt)}}
save(out)
"""


def test_data_mesh_replicas_at_different_widths(tmp_path):
    lens = (32, 24, 32, 8, 16, 8, 32, 16, 24, 8, 32, 8)
    ranks = run_ranks(_MESH_SCRIPT, 2, tmp_path,
                      args={"lens": lens, "kw": KW})
    for got in ranks:
        _assert_records_equal(got["width"]["recs"], got["full"]["recs"])
        assert got["width"]["ticks"] == got["full"]["ticks"]
        assert all(set(w) == {W} for w in got["full"]["widths"].values())
    # both ranks absorbed the same gathered outputs, to the bit
    a, b = ranks[0]["width"], ranks[1]["width"]
    for rid, rec in a["recs"].items():
        for key in rec:
            np.testing.assert_array_equal(rec[key], b["recs"][rid][key])
    assert (a["log"], a["widths"]) == (b["log"], b["widths"])
    # the S replicas' rows of each tick: some tick runs both lanes at
    # different widths
    log = ranks[0]["width"]["log"]
    names = sorted({n for n, _, _ in log})
    assert names == ["L", "S0", "S1"]
    per_tick = [log[i:i + 3] for i in range(0, len(log), 3)]
    assert any(a[2] and b[2] and a[1] != b[1]
               for a, b, _ in per_tick), per_tick
