"""Chunked admissions share the prefix pages they have written.

With prefix sharing and the chunk lane on, a prompt longer than one chunk
is fed through the chunk lane from its cached prefix on, however short the
rest, and each tick's written full prompt pages enter the tier's page
index for the next tick's admissions (``KVPool.register_written``).  On
reduced qwen2-1.5b (and deepseek-moe-16b where cheap), every bucket above
the chunk, prompts behind a shared page-aligned prefix:

* later prompts hit on both tiers, their first chunk row starts at the
  prefix they saved, and the admit lane never runs, also for a remainder
  of one chunk or less;
* records equal sharing off and chunking off (``tests/test_torch_stream.py``'s
  rule), with ``check_invariants`` after every tick;
* a prompt admitted in the tick that writes its prefix misses;
* a slot released mid-prompt leaves only the pages its rows wrote indexed;
* sharing off, the paired speculative admission and a recurrent family
  index nothing;
* the pool's LRU heap evicts in the order of the sorted scan it replaced,
  skipping pending and slot-held entries;
* with the decode-lane graphs engaged (the stand-in of
  ``tests/test_torch_lane_graphs.py`` on the CPU, the card's own graphs
  under the ``cuda`` marker), graph == eager with hits on the chunk lane.

Tolerances: ``CONF_TOL`` of ``tests/test_torch_stream.py`` (5e-4) chunk
lane against admit lane, 1e-6 otherwise.
"""
import copy

import numpy as np
import pytest
import torch

from repro_torch.configs.base import HIConfig
from repro_torch.configs.registry import ARCHS
from repro_torch.serving import scheduler as sched_mod
from repro_torch.serving.batcher import AdmissionQueue, Request, prompt_hashes
from repro_torch.serving.engine import build_engine
from repro_torch.serving.kv_pool import KVPool

STEPS = 3
PAGE = 8
C = 8
PREFIX = 16                     # two pages, two chunks
# every bucket exceeds the chunk: a hit leaves 8 or 16 tokens to feed
KW = dict(buckets=(24, 32), num_slots=2, l_slots=2, page_size=PAGE,
          prefix_sharing=True, chunk_prefill=True, chunk_size=C,
          chunk_width=2, validate=True)
CONF_TOL = 5e-4
DENSE, MOE = "qwen2-1.5b", "deepseek-moe-16b"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _requests(arch, turns=(3, 8, 12, 5, 16, 7), seed=4, repeat=True):
    """Prompts behind one shared prefix, one without it, and (``repeat``)
    a repeat of the 28-token one, whose remainder after its hit is its
    last page of the 32 bucket."""
    vocab = ARCHS[arch].reduced().vocab_size
    rng = np.random.default_rng(seed)
    prefix = rng.integers(1, vocab, PREFIX).astype(np.int32)
    prompts = [np.concatenate([prefix, rng.integers(1, vocab, n)
                               .astype(np.int32)]) for n in turns]
    prompts.insert(2, rng.integers(1, vocab, 20).astype(np.int32))
    if repeat:
        prompts.append(prompts[3])
    return [Request(i, p, max_new_tokens=STEPS)
            for i, p in enumerate(prompts)]


def _engine(arch, theta=1.1):
    return build_engine(ARCHS[arch].reduced(),
                        HIConfig(theta=theta, capacity_factor=1.0),
                        max_new_tokens=STEPS, cache_len=48, device="cpu")


def _serve(arch, reqs, theta=1.1, **kw):
    eng = _engine(arch, theta)
    out = eng.serve_stream(reqs, **dict(KW, **kw))
    return out, eng._stream[1]


def _first_rows(monkeypatch):
    """Each tier's chunk rows, logged from ``tick_inputs``: (tier, request
    id) -> the position of the request's first row."""
    first = {}
    real = sched_mod._TierRuntime.tick_inputs

    def logged(self, s_max):
        arrays, flags = real(self, s_max)
        for row, (slot, _, _) in enumerate(self.chunk_sched):
            rid = self.slot_req[slot].adm.request.request_id
            first.setdefault((self.name, rid), int(arrays["chunk_pos"][row]))
        return arrays, flags
    monkeypatch.setattr(sched_mod._TierRuntime, "tick_inputs", logged)
    return first


def _assert_records(a, b, conf_tol=1e-6):
    assert a.keys() == b.keys()
    for rid in b:
        for key in ("tokens", "s_tokens", "offloaded", "served_remote",
                    "status"):
            np.testing.assert_array_equal(a[rid][key], b[rid][key],
                                          err_msg=f"{rid} {key}")
        assert abs(a[rid]["confidence"] - b[rid]["confidence"]) <= conf_tol


@pytest.mark.parametrize("arch", [DENSE, MOE])
def test_hits_start_on_the_chunk_lane(arch, monkeypatch):
    first = _first_rows(monkeypatch)
    out, sched = _serve(arch, _requests(arch))
    assert all(r["status"] == "ok" for r in out.values())
    for rt in (sched.srt, sched.lrt):
        st = rt.pool.stats
        rows = {rid: pos for (tier, rid), pos in first.items()
                if tier == rt.name}
        # every request started on the chunk lane, at the prefix it saved
        assert sorted(rows) == sorted(out)
        assert sum(rows.values()) == st["tokens_saved"] > 0
        assert st["hits"] == sum(pos > 0 for pos in rows.values())
        assert all(pos % PAGE == 0 for pos in rows.values())
        assert rows[2] == 0                           # no shared prefix
        # the repeat saves all but its last page: one page left, <= C
        assert rows[len(out) - 1] == 24
        assert rt.lane_ticks["admit"] == rt.lane_ticks["prefill"] == 0
        assert st["chunk_registered"] > 0 and st["full_hits"] == 0
        rt.pool.check_invariants()


@pytest.mark.parametrize("arch", [DENSE, MOE])
def test_records_equal_sharing_off_and_chunking_off(arch):
    reqs = _requests(arch)
    on, sched = _serve(arch, reqs)
    assert sched.prefix_stats["tokens_saved"] > 0
    off, off_sched = _serve(arch, reqs, prefix_sharing=False)
    assert off_sched.prefix_stats["tokens_saved"] == 0
    _assert_records(on, off)
    unchunked, _ = _serve(arch, reqs, chunk_prefill=False)
    _assert_records(on, unchunked, conf_tol=CONF_TOL)


def test_same_tick_duplicate_prefix_misses():
    """Three prompts behind one prefix admitted in tick 0 all miss (their
    pages are written in that tick); a fourth, admitted once a slot frees,
    hits the prefix alone."""
    reqs = _requests(DENSE, turns=(3, 9, 14, 6), repeat=False)
    reqs = [r for r in reqs if r.request_id != 2]
    out, sched = _serve(DENSE, reqs, theta=0.0, num_slots=3)
    assert not any(r["offloaded"] for r in out.values())
    st = sched.srt.pool.stats
    assert st["hits"] == 1 and st["tokens_saved"] == PREFIX


def test_release_mid_prompt_leaves_only_written_pages():
    """Two ticks of a 32-token prompt write its first 16 positions; the
    slot is then released: its two written pages stay indexed (and a
    later prompt aliases them), its two unwritten ones do not."""
    eng = _engine(DENSE)
    sched = sched_mod.ContinuousScheduler(
        eng.s, eng.l, eng.hi, max_prompt_len=32, max_new_tokens=STEPS,
        num_slots=2, l_slots=2, page_size=PAGE, decode_block=2,
        prefix_sharing=True, chunk_prefill=True, chunk_size=C, chunk_width=2)
    sched.set_faults(validate=True)
    rt = sched.srt
    queue = AdmissionQueue(buckets=(24, 32), page_size=PAGE)
    prompt = _requests(DENSE, turns=(16,), repeat=False)[0].prompt
    queue.submit(Request(0, prompt, max_new_tokens=STEPS))
    hashes, _ = prompt_hashes(prompt, PAGE)
    theta = sched._theta(1.1)
    sched._try_admit(rt, queue)
    (slot,) = [s for s in range(rt.num_slots) if rt.slot_req[s] is not None]
    for tick in range(2):
        host = sched._dispatch(theta)
        sched._absorb(rt, host["s"][0], lambda rec: None)
        sched._check_pools(tick)
        assert int(rt.chunk_fed[slot]) == C * (tick + 1)
        assert set(rt.pool._page_index) == set(hashes[:tick + 1])
    rt.release(slot)
    rt.pool.check_invariants()
    assert set(rt.pool._page_index) == set(hashes[:2])
    assert rt.pool.stats["chunk_registered"] == 2
    plan = rt.pool.admit_prefix(1, 40, 32, hashes, b"other",
                                sched.counters.ticks, register=False)
    assert plan.start == PREFIX and not plan.is_restore
    rt.pool.check_invariants()


@pytest.mark.parametrize("case", ["sharing_off", "speculative", "recurrent"])
def test_nothing_registered(case):
    arch = "mamba2-370m" if case == "recurrent" else DENSE
    kw = {"sharing_off": dict(prefix_sharing=False),
          "speculative": dict(speculative=True, decode_block=2),
          "recurrent": {}}[case]
    out, sched = _serve(arch, _requests(arch), theta=0.5, **kw)
    assert all(r["status"] == "ok" for r in out.values())
    for rt in (sched.srt, sched.lrt):
        assert rt.lane_ticks["chunk"] > 0
        assert rt.pool.stats["chunk_registered"] == 0
        assert rt.pool.stats["tokens_saved"] == 0
        if case != "recurrent":
            assert not rt.pool._page_index


# -- the LRU heap -------------------------------------------------------------

def _scan_evict(pool, need, tick, log):
    """The sorted scan the heap replaced (one candidate list of both
    indexes, sorted by (used, kind, hash)), logging what it drops."""
    if len(pool._free) >= need:
        return True
    cand = [(e.used, 0, h) for h, e in pool._page_index.items()
            if tick is None or e.ready <= tick]
    cand += [(e.used, 1, h) for h, e in pool._full_index.items()
             if tick is None or e.ready <= tick]
    for _, kind, h in sorted(cand):
        if len(pool._free) >= need:
            break
        if kind == 0:
            if pool._slot_refs[pool._page_index[h].page] > 0:
                continue
            pool._drop_page_entry(h)
        else:
            if all(pool._slot_refs[p] > 0 for p in pool._full_index[h].pages):
                continue
            pool._drop_full_entry(h)
        log.append((kind, h))
    return len(pool._free) >= need


def _logged_drops(pool):
    log = []
    for kind, name in ((0, "_drop_page_entry"), (1, "_drop_full_entry")):
        real = getattr(pool, name)
        setattr(pool, name, lambda h, real=real, kind=kind:
                (log.append((kind, h)), real(h))[1])
    return log


def test_lru_heap_evicts_in_the_sorted_scan_order():
    """A seeded run of admissions (admit-lane ones registering pages and
    full entries, chunked ones registering pages as they are written),
    lookups and frees; at every tick, copies of the pool evict with the
    heap and with the sorted scan for several targets: the same entries
    in the same order, pending and slot-held entries skipped."""
    cfg = ARCHS[DENSE].reduced()
    pool = KVPool(cfg, num_slots=4, max_context=48, page_size=PAGE,
                  num_pages=30, prefix_entries=3, device="cpu")
    rng = np.random.default_rng(0)
    prefixes = [rng.integers(1, 100, 16).astype(np.int32) for _ in range(2)]
    compared = skipped_pending = skipped_held = 0
    for tick in range(60):
        slot = next((s for s in range(4) if s not in pool._slot_pages), None)
        if slot is not None and rng.random() < 0.7:
            n = int(rng.integers(1, 24))
            toks = np.concatenate([prefixes[int(rng.integers(2))],
                                   rng.integers(1, 100, n).astype(np.int32)])
            bucket = 24 if len(toks) <= 24 else 40
            toks = np.pad(toks, (0, bucket - len(toks)))
            hashes, full = prompt_hashes(toks, PAGE)
            chunked = bool(rng.integers(2))
            plan = pool.admit_prefix(slot, bucket + 4, bucket, hashes, full,
                                     tick, register=not chunked)
            if plan is not None and chunked:
                pool.register_written(slot, hashes, bucket, plan.start,
                                      bucket, tick + 1)
        if pool._slot_pages and rng.random() < 0.5:
            pool.free(int(rng.choice(sorted(pool._slot_pages))))
        pool.check_invariants()
        for extra in (1, 3, 8, 40):
            need = len(pool._free) + extra
            heap_pool, scan_pool = copy.deepcopy(pool), copy.deepcopy(pool)
            got = _logged_drops(heap_pool)
            want = []
            ok = heap_pool._evict_pages(need, tick=tick)
            assert ok == _scan_evict(scan_pool, need, tick, want)
            assert got == want, (tick, extra)
            heap_pool.check_invariants()
            compared += len(want)
            kept = {h for k, h in want}
            for h, e in pool._page_index.items():
                if h in kept:
                    continue
                skipped_pending += e.ready > tick
                skipped_held += pool._slot_refs[e.page] > 0
            if ok:
                # the heap still orders what it kept: a second eviction
                # agrees with the scan as well
                again, want2 = _logged_drops(heap_pool), []
                heap_pool._evict_pages(need + 2, tick=tick)
                _scan_evict(scan_pool, need + 2, tick, want2)
                assert again == want2
    assert compared > 50 and skipped_pending > 0 and skipped_held > 0
    assert pool.stats["evictions"] > 0 and pool.stats["chunk_registered"] > 0
    # stale items are compacted away: the heap stays near the index's size
    assert len(pool._lru) <= 2 * (len(pool._page_index)
                                  + len(pool._full_index)) + 64


# -- the decode-lane graphs ---------------------------------------------------

def test_graph_lane_equals_eager_with_chunk_hits(monkeypatch):
    """The stand-in graphs of ``tests/test_torch_lane_graphs.py`` on the
    CPU: the same records with hits on the chunk lane, one capture a tier
    and no eager tick."""
    from test_torch_lane_graphs import _engage
    reqs = _requests(DENSE)
    eager, _ = _serve(DENSE, reqs)
    _engage(monkeypatch)
    got, sched = _serve(DENSE, reqs)
    _assert_records(got, eager, conf_tol=0.0)
    assert sched.prefix_stats["tokens_saved"] > 0
    st = sched.stats
    assert st["graph_captures"] == {"S": 1, "L": 1}
    assert st["graph_eager_ticks"] == {}
    assert sum(st["graph_replays"].values()) > 0


@pytest.mark.cuda
def test_graph_lane_equals_eager_with_chunk_hits_on_card(monkeypatch):
    """The same trace on the card, danube-shaped tiers at their published
    widths and 2 layers: the graphs' records equal the eager lane's bit for
    bit with hits on the chunk lane, no eager tick, and the admit lane never
    runs."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (run on the chip)")
    import dataclasses

    from repro_torch.models import model_zoo
    from repro_torch.serving import lane_graphs
    from repro_torch.serving.engine import HIEngine, TierModel
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(ARCHS["h2o-danube-3-4b"], num_layers=2,
                              vocab_size=32_000)
    g = torch.Generator(device="cuda").manual_seed(0)
    tiers = [TierModel(c, model_zoo.init_params(g, c))
             for c in (cfg.s_variant(4), cfg)]
    vocab = cfg.vocab_size
    rng = np.random.default_rng(4)
    prefix = rng.integers(1, vocab, 64).astype(np.int32)
    reqs = [Request(i, np.concatenate([prefix, rng.integers(1, vocab, n)
                                       .astype(np.int32)]),
                    max_new_tokens=6) for i, n in enumerate(
                        (10, 40, 25, 64, 7, 33, 50, 12))]
    kw = dict(buckets=(96, 128), num_slots=4, l_slots=2, page_size=16,
              decode_block=4, prefix_sharing=True, chunk_prefill=True,
              chunk_size=32, chunk_width=2, validate=True)
    runs, engages = {}, lane_graphs.engages
    for graphs in (False, True):
        monkeypatch.setattr(lane_graphs, "engages",
                            engages if graphs else lambda *a: False)
        eng = HIEngine(*tiers, HIConfig(theta=1.1, capacity_factor=1.0),
                       max_new_tokens=6)
        with torch.inference_mode():
            out = eng.serve_stream(reqs, **kw)
        torch.cuda.synchronize()
        runs[graphs] = (out, eng._stream[1])
    (ref, ref_sched), (got, sched) = runs[False], runs[True]
    assert ref_sched._graphs is None
    for rid in ref:
        for key in ("tokens", "s_tokens", "offloaded", "served_remote",
                    "status"):
            np.testing.assert_array_equal(got[rid][key], ref[rid][key],
                                          err_msg=f"{rid} {key}")
        assert np.float32(got[rid]["confidence"]).view(np.int32) == \
            np.float32(ref[rid]["confidence"]).view(np.int32), rid
    for rt, ref_rt in ((sched.srt, ref_sched.srt), (sched.lrt, ref_sched.lrt)):
        assert rt.lane_ticks == ref_rt.lane_ticks
        assert rt.lane_ticks["admit"] == 0
        assert rt.pool.stats == ref_rt.pool.stats
        assert rt.pool.stats["tokens_saved"] > 0
    st = sched.stats
    assert st["graph_captures"] == {"S": 1, "L": 1}
    assert st["graph_eager_ticks"] == {}
    print(f"card chunk hits: saved {sched.prefix_stats['tokens_saved']}, "
          f"registered {sched.prefix_stats['chunk_registered']}, replays "
          f"{st['graph_replays']}")
