"""The decode lanes as CUDA graphs (``serving/lane_graphs.py``), their host
side on the CPU: a stand-in for ``torch.cuda.CUDAGraph`` records the aten
operations of a capture (a ``TorchDispatchMode``) and a replay runs them
again on the captured tensors, writing each result into the tensor the
capture made, as a CUDA graph replays its kernels over its memory.  It
refuses a host read (``.item()``, ``nonzero``) inside a capture, as the
card does.  ``lane_graphs.engages`` is monkeypatched to engage on the CPU.

* where the graphs engage: CUDA only, not on a mesh, not speculative; the
  CPU scheduler builds none and counts nothing;
* graph == eager, record for record, for the dense, SSM and hybrid families
  with sharing and chunking on and off, bf16 and int8 pools, greedy and
  sampled (the MoE family's plain routing reads its run lengths on the
  host, so its capture is held on the card only);
* one capture per key (tier, sampled, write block, pool dtype), replays on
  every other decode-lane tick, the launch counters' deltas added per
  replay;
* an ``ops`` entry point replaced after the capture: those ticks run
  eagerly, counted, and call the replacement;
* stream == drain, sharing on == off, chunking on == off and one
  ``_host_fetch`` a tick, with the graphs engaged;
* the lane spans' ``graph`` flag, the per-tier Prometheus families and the
  upload's contiguous lane words.
"""
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs.base import HIConfig
from repro_torch.configs.registry import ARCHS
from repro_torch.kernels import hi_gate as hg
from repro_torch.kernels import ops
from repro_torch.serving import engine as engine_mod
from repro_torch.serving import lane_graphs
from repro_torch.serving import scheduler as sched_mod
from repro_torch.serving.batcher import Request
from repro_torch.serving.engine import build_engine
from repro_torch.serving.telemetry import Telemetry

STEPS = 4
FAMILIES = ("qwen2-1.5b", "mamba2-370m", "zamba2-2.7b")
KW = dict(buckets=(8, 16, 24), num_slots=3, l_slots=2, page_size=8,
          validate=True)
LENS = (8, 16, 24, 8, 16, 8, 24)
_HOST_READS = ("_local_scalar_dense", "nonzero")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Recorder(TorchDispatchMode):
    def __init__(self, ops_list):
        super().__init__()
        self.ops = ops_list

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(name in str(func) for name in _HOST_READS):
            raise RuntimeError(f"host read {func} inside a captured lane")
        out = func(*args, **kwargs)
        self.ops.append((func, args, kwargs, out))
        return out


class FakeGraph:
    """``torch.cuda.CUDAGraph``'s capture and replay on CPU tensors."""
    made = []

    def __init__(self):
        self.ops, self.replays, self.mode = [], 0, None
        FakeGraph.made.append(self)

    def capture_begin(self, pool=None, capture_error_mode="global"):
        self.mode = _Recorder(self.ops)
        self.mode.__enter__()

    def capture_end(self):
        self.mode.__exit__(None, None, None)

    def replay(self):
        self.replays += 1
        for func, args, kwargs, out in self.ops:
            res = func(*args, **kwargs)
            for r, o in zip(pytree.tree_leaves(res), pytree.tree_leaves(out)):
                if (isinstance(o, torch.Tensor) and o.numel()
                        and r.untyped_storage().data_ptr()
                        != o.untyped_storage().data_ptr()):
                    o.copy_(r)


def _engage(monkeypatch):
    """From here on, the decode lanes as (stand-in) graphs on the CPU."""
    FakeGraph.made = []
    monkeypatch.setattr(lane_graphs, "engages",
                        lambda device, mesh, role: role == "plain")
    monkeypatch.setattr(torch.cuda, "CUDAGraph", FakeGraph)


@pytest.fixture
def graphs(monkeypatch):
    _engage(monkeypatch)
    return FakeGraph


def _requests(arch, lens=LENS, seed=3, temp=0.0, repeat=0):
    vocab = ARCHS[arch].reduced().vocab_size
    rng = np.random.default_rng(seed)
    reqs = [Request(i, rng.integers(0, vocab, n).astype(np.int32),
                    max_new_tokens=STEPS, temperature=temp)
            for i, n in enumerate(lens)]
    # repeats of the last prompts: full restores and COW with sharing on
    return reqs + [Request(100 + i, reqs[-1 - i].prompt,
                           max_new_tokens=STEPS, temperature=temp)
                   for i in range(repeat)]


def _engine(arch, theta=0.5):
    return build_engine(ARCHS[arch].reduced(),
                        HIConfig(theta=theta, capacity_factor=1.0),
                        max_new_tokens=STEPS, cache_len=48, device="cpu")


def _serve(arch, reqs, theta=0.5, **kw):
    eng = _engine(arch, theta)
    out = eng.serve_stream(reqs, **dict(KW, **kw))
    return out, eng._stream[1]


def _assert_equal(a, b):
    assert a.keys() == b.keys()
    for rid in a:
        for key in a[rid]:
            if key == "ttft":                 # a wall-clock reading
                continue
            np.testing.assert_array_equal(a[rid][key], b[rid][key],
                                          err_msg=f"{rid} {key}")


def _live_ticks(sched):
    return {rt.name: rt.lane_ticks["live"] for rt in (sched.srt, sched.lrt)}


@pytest.mark.parametrize("device,mesh,role,want", [
    ("cuda", None, "plain", True), ("cpu", None, "plain", False),
    ("meta", None, "plain", False), ("cuda", object(), "plain", False),
    ("cuda", None, "spec_s", False), ("cuda", None, "spec_l", False)])
def test_engages_on_cuda_off_mesh_plain_only(device, mesh, role, want):
    assert lane_graphs.engages(torch.device(device), mesh, role) is want


def test_cpu_scheduler_builds_no_graphs():
    out, sched = _serve("qwen2-1.5b", _requests("qwen2-1.5b"),
                        chunk_prefill=True)
    assert sched._graphs is None and len(out) == len(LENS)
    for name in ("graph_captures", "graph_replays", "graph_eager_ticks"):
        assert sched.stats[name] == {}


def test_speculative_scheduler_builds_no_graphs(graphs):
    eng = _engine("qwen2-1.5b", theta=0.0)
    eng.serve_stream(_requests("qwen2-1.5b")[:3], speculative=True,
                     **dict(KW, l_slots=None))
    sched = eng._stream[1]
    assert sched._graphs is None and graphs.made == []


@pytest.mark.parametrize("arch", FAMILIES)
@pytest.mark.parametrize("sharing,chunk", [(False, False), (True, False),
                                           (False, True), (True, True)])
def test_graph_lane_equals_eager(arch, sharing, chunk, monkeypatch):
    reqs = _requests(arch, repeat=3 if sharing else 0)
    kw = dict(prefix_sharing=sharing, chunk_prefill=chunk, chunk_size=8)
    eager, _ = _serve(arch, reqs, **kw)
    _engage(monkeypatch)
    got, sched = _serve(arch, reqs, **kw)
    _assert_equal(got, eager)
    live = _live_ticks(sched)
    st = sched.stats
    assert st["graph_captures"] == {"S": 1, "L": 1}
    assert {t: st["graph_captures"][t] + st["graph_replays"].get(t, 0)
            for t in live} == live
    assert st["graph_replays"]["S"] > 0 and st["graph_eager_ticks"] == {}
    assert sum(g.replays for g in FakeGraph.made) == \
        sum(st["graph_replays"].values())


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "zamba2-2.7b"])
def test_graph_lane_equals_eager_over_int8_pools(arch, monkeypatch):
    reqs = _requests(arch, repeat=2)
    kw = dict(kv_dtype="int8", prefix_sharing=True, chunk_prefill=True,
              chunk_size=8)
    eager, _ = _serve(arch, reqs, **kw)
    _engage(monkeypatch)
    got, sched = _serve(arch, reqs, **kw)
    _assert_equal(got, eager)
    keys = set(sched._graphs._graphs)
    assert keys == {("S", False, "draft_wblock", "int8"),
                    ("L", False, "draft_wblock", "int8")}


@pytest.mark.parametrize("arch", FAMILIES)
def test_sampled_graph_lane_equals_eager(arch, monkeypatch):
    reqs = _requests(arch, temp=0.8)
    eager, _ = _serve(arch, reqs, chunk_prefill=True, chunk_size=8)
    _engage(monkeypatch)
    got, sched = _serve(arch, reqs, chunk_prefill=True, chunk_size=8)
    _assert_equal(got, eager)
    assert {k[1] for k in sched._graphs._graphs} == {True}


def test_one_capture_per_key(graphs):
    """Greedy, then sampled, then greedy again on one scheduler: a capture
    per (tier, sampled), and the second greedy stream only replays."""
    eng = _engine("qwen2-1.5b")
    greedy = _requests("qwen2-1.5b")
    kw = dict(KW, prefix_sharing=True)
    first = eng.serve_stream(greedy, **kw)
    eng.serve_stream(_requests("qwen2-1.5b", seed=4, temp=0.7), **kw)
    sched = eng._stream[1]
    captures = dict(sched.stats["graph_captures"])
    replays = dict(sched.stats["graph_replays"])
    again = eng.serve_stream(greedy, **kw)
    assert set(sched._graphs._graphs) == {
        (t, s, "wblock", "bfloat16") for t in "SL" for s in (False, True)}
    assert captures == {"S": 2, "L": 2}
    assert sched.stats["graph_captures"] == captures
    assert all(sched.stats["graph_replays"][t] > replays[t] for t in "SL")
    for rid in first:
        np.testing.assert_array_equal(again[rid]["tokens"],
                                      first[rid]["tokens"])
    assert len(graphs.made) == 4


def test_replaced_entry_point_runs_the_lane_eagerly(graphs, monkeypatch):
    """After the captures, ``ops.hi_gate`` wrapped: the decode lanes run
    eagerly and call the wrapper, counted as eager ticks, and the records
    equal the graphs' own."""
    eng = _engine("qwen2-1.5b")
    reqs = _requests("qwen2-1.5b")
    ref = eng.serve_stream(reqs, **KW)
    sched = eng._stream[1]
    replays = dict(sched.stats["graph_replays"])
    live0 = _live_ticks(sched)
    calls = []
    real = ops.hi_gate
    monkeypatch.setattr(ops, "hi_gate",
                        lambda *a, **k: (calls.append(1), real(*a, **k))[1])
    assert ops.replaced()
    got = eng.serve_stream(reqs, **KW)
    _assert_equal(got, ref)
    live = {t: n - live0[t] for t, n in _live_ticks(sched).items()}
    assert sched.stats["graph_eager_ticks"] == live
    assert sched.stats["graph_replays"] == replays
    assert len(calls) >= STEPS * sum(live.values())
    monkeypatch.setattr(ops, "hi_gate", real)
    assert not ops.replaced()


def test_replays_add_the_captured_launches(monkeypatch):
    """The plain gate made to count as its kernel does: the counters read
    the same with the graphs as with the eager lane, the replays adding
    what each capture's warm run launched."""
    real = hg.hi_gate_plain

    def counted(*a, **k):
        hg.hi_gate_cuda.launches += 1
        return real(*a, **k)

    monkeypatch.setattr(hg, "hi_gate_plain", counted)
    reqs = _requests("qwen2-1.5b")
    ops.reset_launch_counts()
    eager, _ = _serve("qwen2-1.5b", reqs, chunk_prefill=True, chunk_size=8)
    want = ops.launch_counts()
    assert want["hi_gate"] > 0
    _engage(monkeypatch)
    ops.reset_launch_counts()
    got, sched = _serve("qwen2-1.5b", reqs, chunk_prefill=True,
                        chunk_size=8)
    assert ops.launch_counts() == want
    assert sum(sched.stats["graph_replays"].values()) > 0
    ent = sched._graphs._graphs[("L", False, "draft_wblock", "bfloat16")]
    assert ent.launches["hi_gate"] == STEPS
    ops.reset_launch_counts()


def test_stream_equals_drain_with_graphs(graphs):
    from test_torch_stream import _drain_by_bucket
    reqs = _requests("qwen2-1.5b", lens=(8, 16, 8, 16, 8))
    drain = _drain_by_bucket(_engine("qwen2-1.5b"), reqs)
    eng = _engine("qwen2-1.5b")
    stream = eng.serve_stream(reqs, buckets=(8, 16), num_slots=3,
                              page_size=8)
    for rid, rec in stream.items():
        np.testing.assert_array_equal(rec["tokens"], drain[rid]["tokens"])
        np.testing.assert_array_equal(rec["s_tokens"],
                                      drain[rid]["s_tokens"])
        assert rec["offloaded"] == bool(drain[rid]["offloaded"])
    assert sum(eng._stream[1].stats["graph_replays"].values()) > 0
    assert eng.stats["stream_compiles"] == 1


def test_sharing_changes_nothing_with_graphs(graphs):
    """``test_torch_stream.test_sharing_equivalence`` with the graphs
    engaged: full restores, partial hits and COW."""
    from test_torch_stream import (_assert_stream_equal, _engine,
                                   _repeated_prefix_traffic)
    reqs = _repeated_prefix_traffic()
    kw = dict(buckets=(12, 16), num_slots=2, page_size=8, validate=True)
    eng = _engine()
    on = eng.serve_stream(reqs, prefix_sharing=True, **kw)
    off = _engine().serve_stream(reqs, prefix_sharing=False, **kw)
    _assert_stream_equal(on, off)
    stats = eng._stream[1].prefix_stats
    assert stats["full_hits"] > 0 and stats["cow_copies"] > 0
    assert sum(eng._stream[1].stats["graph_replays"].values()) > 0


@pytest.mark.parametrize("sharing", [False, True])
def test_chunking_changes_nothing_with_graphs(graphs, sharing):
    """``test_torch_stream.test_chunked_prefill_admission_token_identical``
    with the graphs engaged."""
    from test_torch_stream import CONF_TOL, _assert_stream_equal, _engine
    cfg = ARCHS["qwen2-1.5b"].reduced()
    rng = np.random.default_rng(3)
    reqs = [Request(i, rng.integers(0, cfg.vocab_size, n).astype(np.int32),
                    max_new_tokens=4) for i, n in enumerate([8, 24, 16, 24])]
    kw = dict(buckets=(8, 16, 24), num_slots=3, page_size=8,
              prefix_sharing=sharing, validate=True)
    base = _engine(max_new=4, cache_len=48).serve_stream(reqs, **kw)
    eng = _engine(max_new=4, cache_len=48)
    chunked = eng.serve_stream(reqs, **kw, chunk_prefill=True, chunk_size=8)
    _assert_stream_equal(chunked, base, conf_tol=CONF_TOL)
    sched = eng._stream[1]
    assert sched.srt.lane_ticks["chunk"] > 0
    assert sum(sched.stats["graph_replays"].values()) > 0


@pytest.mark.parametrize("sharing,chunk", [(False, False), (True, True)])
def test_one_fetch_a_tick_with_graphs(graphs, monkeypatch, sharing, chunk):
    calls = []
    real = engine_mod._host_fetch
    monkeypatch.setattr(engine_mod, "_host_fetch",
                        lambda tree: (calls.append(1), real(tree))[1])
    out, sched = _serve("qwen2-1.5b", _requests("qwen2-1.5b"),
                        prefix_sharing=sharing, chunk_prefill=chunk)
    assert len(calls) == sched.stats["ticks"] > 0
    assert sum(sched.stats["graph_replays"].values()) > 0


def test_lane_spans_mark_the_replays(graphs):
    tel = Telemetry()
    eng = _engine("qwen2-1.5b")
    eng.serve_stream(_requests("qwen2-1.5b"), telemetry=tel, **KW)
    sched = eng._stream[1]
    live = [sp for t in tel.ticks for sp in t.lanes if sp.lane == "live"]
    assert {t: sum(sp.graph for sp in live if sp.tier == t)
            for t in "SL"} == sched.stats["graph_replays"]
    assert not any(sp.graph for t in tel.ticks for sp in t.lanes
                   if sp.lane != "live")
    txt = tel.prometheus_text()
    for name in ("graph_captures", "graph_replays"):
        assert f"# TYPE hi_{name}_total counter" in txt
        for t, n in sched.stats[name].items():
            assert f'hi_{name}_total{{tier="{t}"}} {n}' in txt
    assert "hi_graph_eager_ticks_total" not in txt


@pytest.mark.parametrize("chunk,sharing", [(0, False), (0, True), (8, False),
                                           (8, True)])
def test_lane_words_are_one_slice_of_the_upload(chunk, sharing):
    keys = sched_mod.decode_lane_keys(chunk, sharing)
    rng = np.random.default_rng(0)
    arrays = {"last_tok": rng.integers(0, 9, 3).astype(np.int32),
              "admit_tokens": rng.integers(0, 9, (2, 8)).astype(np.int32)}
    for k in keys:
        arrays[k] = (rng.random(3) > 0.5 if k == "decode_live" else
                     rng.random(3).astype(np.float32) if k == "temps" else
                     rng.integers(0, 9, (3, 4) if "block" in k else 3
                                  ).astype(np.int32))
    host = {f"l.{k}": arrays[k] for k in keys}
    host.update({f"l.{k}": v for k, v in arrays.items()})
    views, buf, metas = sched_mod._upload(host, torch.device("cpu"))
    words, rel = sched_mod._lane_words(buf, metas, "l.", keys)
    assert words.numel() == sum(a.size for k, a in arrays.items()
                                if k in keys)
    lane = sched_mod._views(words.clone(), rel)
    assert list(lane) == list(keys)
    for k in keys:
        assert torch.equal(lane[k], views["l." + k]), k
        assert lane[k].dtype == views["l." + k].dtype
