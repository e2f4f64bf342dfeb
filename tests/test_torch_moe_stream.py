"""Continuous serving of the port's MoE family on the CPU, reduced
deepseek-moe-16b (2 layers, d_model 256, 4 experts, top-2, 1 shared).

* ``serve_stream`` against the reference's on the ``mixed_poisson`` and
  ``repeated_prefix`` traces of ``benchmarks/bench_serving.py``, by the
  teacher-forced margin rule of ``tests/test_torch_stream.py`` (whose test
  runs here on a MoE fixture).
* The reference's invariants, which hold at this size because the serving
  capacity 2.0 gives every expert a slot for every token (4 experts, top
  2: cap = T), so no pair drops: stream == drain
  (``tests/test_scheduler.py:36``), sharing on == off with partial prefix
  hits and copy-on-write (``tests/test_prefix_cache.py:51``), chunk on ==
  off (``tests/test_chunk_lane.py:139``), each with one ``_host_fetch`` per
  tick and the pools' invariants after every tick, bf16 and int8 pools
  (int8: sharing and chunking by the int8 tolerance, as
  ``tests/test_kv_quant.py:93``).
* The speculative lane equals the port's host oracle
  ``TokenCascade.generate_speculative`` (``tests/test_speculative.py:29``).

At full width none of these equalities holds, in either package: the L
tier's 4-slot decode gets one slot per expert, and the co-admitted rows'
padded tails take capacity ahead of later rows' tokens (ROADMAP Queue C).

Tolerances: ``LOGIT_TOL`` of ``tests/test_torch_stream.py`` (3e-2) against
the reference; mean confidences between the port's own paths: 1e-5 stream
against drain and 1e-6 sharing on against off (bf16), ``CONF_TOL`` of
``tests/test_torch_stream.py`` (5e-4) chunk lane against admit lane (bf16
K/V rounded after float32 sums in another order; 5.1e-5 measured), and
``INT8_CONF_TOL`` = 2e-3 over int8 pools (a chunk commits a page at its
final scale where steps requantise).
"""
import jax
import numpy as np
import pytest
import torch

import test_torch_stream as dense_stream
from repro.configs.base import HIConfig as JHIConfig
from repro.configs.registry import ARCHS as JAX_ARCHS
from repro.serving.engine import build_engine as jax_build_engine
from repro_torch.bridge import params_from_numpy
from repro_torch.configs.base import HIConfig
from repro_torch.configs.registry import ARCHS
from repro_torch.serving import engine as engine_mod
from repro_torch.serving.batcher import Request
from repro_torch.serving.engine import HIEngine, TierModel, build_engine
from repro_torch.serving.token_cascade import TokenCascade
from test_torch_stream import CONF_TOL, TRACES, _assert_stream_equal

ARCH = "deepseek-moe-16b"
STEPS = 3
INT8_CONF_TOL = 2e-3


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op torch thread: the reduced models' small ops run about
    as fast on it, and the suite's other workers keep their cores (the
    thread count is restored afterwards)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=sorted(TRACES))
def trace_engines(request):
    """``test_serve_stream_matches_reference``'s engines on reduced
    deepseek-moe-16b: both packages on the reference's params."""
    name = request.param
    make, kw, max_new = TRACES[name]
    jcfg, tcfg = JAX_ARCHS[ARCH].reduced(), ARCHS[ARCH].reduced()
    hi = dict(theta=0.6, capacity_factor=1.0)
    jeng = jax_build_engine(jcfg, JHIConfig(**hi), max_new_tokens=max_new,
                            cache_len=64)
    tiers = [TierModel(c, params_from_numpy(jax.tree.map(np.asarray,
                                                         t.params),
                                            device="cpu"))
             for c, t in ((tcfg.s_variant(4), jeng.s), (tcfg, jeng.l))]
    teng = HIEngine(*tiers, HIConfig(**hi), max_new_tokens=max_new)
    return name, make(jcfg), kw, jeng, teng


test_serve_stream_matches_reference = \
    dense_stream.test_serve_stream_matches_reference


# ---------------------------------------------------------------------------
# the reference's invariants on the port's MoE
# ---------------------------------------------------------------------------

def _engine(theta=0.6, cache_len=48):
    return build_engine(ARCHS[ARCH].reduced(),
                        HIConfig(theta=theta, capacity_factor=1.0),
                        max_new_tokens=STEPS, cache_len=cache_len,
                        device="cpu")


def _requests(lens, seed):
    vocab = ARCHS[ARCH].reduced().vocab_size
    rng = np.random.default_rng(seed)
    return [Request(i, rng.integers(0, vocab, n).astype(np.int32),
                    max_new_tokens=STEPS) for i, n in enumerate(lens)]


def _counted(monkeypatch):
    calls = []
    real = engine_mod._host_fetch
    monkeypatch.setattr(engine_mod, "_host_fetch",
                        lambda tree: (calls.append(1), real(tree))[1])
    return calls


def test_stream_matches_drain(monkeypatch):
    """tests/test_scheduler.py:36, one fetch per tick."""
    reqs = _requests([8, 16, 8, 16, 8], seed=7)
    drain = dense_stream._drain_by_bucket(_engine(), reqs)
    calls = _counted(monkeypatch)
    eng = _engine()
    stream = eng.serve_stream(reqs, buckets=(8, 16), num_slots=3,
                              page_size=8, validate=True)
    assert len(calls) == eng.stats["stream_ticks"] > 0
    assert set(stream) == {r.request_id for r in reqs}
    for rid, rec in stream.items():
        np.testing.assert_array_equal(rec["tokens"], drain[rid]["tokens"])
        np.testing.assert_array_equal(rec["s_tokens"], drain[rid]["s_tokens"])
        assert rec["offloaded"] == bool(drain[rid]["offloaded"])
        np.testing.assert_allclose(rec["confidence"],
                                   drain[rid]["confidence"], atol=1e-5)


def _repeated_prompts(seed=3):
    """Prompts on a shared 8-token base: partial prefix hits (the page of 8
    is shared, the suffix prefilled) and whole-prompt restores."""
    vocab = ARCHS[ARCH].reduced().vocab_size
    rng = np.random.default_rng(seed)
    base = rng.integers(0, vocab, 8).astype(np.int32)

    def mk(n):
        return np.concatenate([base, rng.integers(0, vocab, n)
                               .astype(np.int32)])

    p1, p2, p3 = mk(4), mk(8), mk(8)
    return [Request(i, p, max_new_tokens=STEPS)
            for i, p in enumerate([p1, p2, p3, p1, p2, p3, p1, p2])]


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_sharing_equivalence(monkeypatch, kv_dtype):
    """tests/test_prefix_cache.py:51 — sharing on == off: partial hits
    splice the cached prefix under the same routed batch, full hits
    restore, a restore of the 12 bucket's partial tail page copies it."""
    reqs = _repeated_prompts()
    kw = dict(buckets=(12, 16), num_slots=2, page_size=8, validate=True,
              kv_dtype=kv_dtype)
    calls = _counted(monkeypatch)
    eng_on = _engine()
    on = eng_on.serve_stream(reqs, prefix_sharing=True, **kw)
    assert len(calls) == eng_on.stats["stream_ticks"]
    off = _engine().serve_stream(reqs, prefix_sharing=False, **kw)
    _assert_stream_equal(on, off,
                         conf_tol=INT8_CONF_TOL if kv_dtype == "int8"
                         else 1e-6)
    sched = eng_on._stream[1]
    stats = sched.prefix_stats
    assert stats["hits"] > stats["full_hits"] > 0 and stats["cow_copies"] > 0
    assert eng_on.stats["prefill_tokens_saved"] == stats["tokens_saved"] > 0
    assert sched.srt.pool.held_slots == sched.lrt.pool.held_slots == []


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_chunked_prefill_admission_token_identical(monkeypatch, kv_dtype):
    """tests/test_chunk_lane.py:139 — chunk_prefill on == off, with
    sharing on."""
    reqs = _requests([8, 24, 16, 24], seed=3)
    kw = dict(buckets=(8, 16, 24), num_slots=3, page_size=8,
              validate=True, kv_dtype=kv_dtype)
    base = _engine().serve_stream(reqs, **kw)
    calls = _counted(monkeypatch)
    eng = _engine()
    chunked = eng.serve_stream(reqs, **kw, chunk_prefill=True, chunk_size=8)
    assert len(calls) == eng.stats["stream_ticks"]
    _assert_stream_equal(chunked, base,
                         conf_tol=INT8_CONF_TOL if kv_dtype == "int8"
                         else CONF_TOL)
    assert eng._stream[1].srt.lane_ticks["chunk"] > 0


def test_speculative_lane_matches_host_oracle():
    """tests/test_speculative.py:29 — the fused draft-verify lane equals
    ``TokenCascade.generate_speculative`` block for block."""
    cfg = ARCHS[ARCH].reduced()
    hi = HIConfig(theta=0.5, capacity_factor=1.0)
    eng = build_engine(cfg, hi, max_new_tokens=6, cache_len=48, device="cpu")
    tc = TokenCascade(s_cfg=eng.s.cfg, l_cfg=eng.l.cfg,
                      s_params=eng.s.params, l_params=eng.l.params, hi=hi,
                      block=3, cache_len=48)
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, cfg.vocab_size, 8).astype(np.int32)
               for _ in range(3)]
    out = eng.serve_stream([Request(i, p, max_new_tokens=6)
                            for i, p in enumerate(prompts)],
                           buckets=(8,), num_slots=2, page_size=8,
                           decode_block=3, speculative=True, validate=True)
    escalated = 0
    for i, p in enumerate(prompts):
        ref = tc.generate_speculative(p[None, :], 6)
        np.testing.assert_array_equal(out[i]["tokens"], ref["tokens"][0])
        assert out[i]["rounds"] == ref["rounds"]
        assert out[i]["escalated_blocks"] == ref["escalated"]
        escalated += ref["escalated"]
    assert escalated > 0
    assert eng.stats["stream_compiles"] == 1
