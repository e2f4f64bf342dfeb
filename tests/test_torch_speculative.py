"""The speculative draft-verify lane on the port's ``serve_stream`` and the
port's host oracle ``serving/token_cascade.py``, held against the
reference's.

Re-states ``tests/test_speculative.py`` and ``tests/test_token_cascade.py``:

* the fused cascade equals the port's ``TokenCascade.generate_speculative``
  block for block (qwen2, mamba2): tokens, rounds, escalated blocks;
* on bridged params it matches the reference's speculative
  ``serve_stream`` under the margin rule of ``tests/test_torch_stream.py``
  (each emitted token teacher-forced through the tier that produced it,
  both tiers where L agreed with S's draft; tokens equal up to the first
  position that is not decisive), with equal ``drafted`` / ``accepted``
  where every position is decisive; over int8 pools the tokens, rounds
  and counts equal the reference's int8 stream;
* one ``_host_fetch`` per tick; never escalating equals the plain greedy
  stream; speculative with chunked prefill equals plain speculative;
* the port's ``TokenCascade`` against the reference's on reduced
  gemma3-1b: never escalating is pure S, always is pure L, and the counts
  at an intermediate theta;
* the gate audit's bins on a speculative run equal the ``p_histogram``
  oracle over its recorded ground truth;
* speculative serving is greedy-only.

Tolerance: ``LOGIT_TOL`` of ``tests/test_torch_stream.py``.
"""
import jax
import numpy as np
import pytest

from repro.configs.base import HIConfig as JHIConfig
from repro.configs.registry import ARCHS as JAX_ARCHS
from repro.core.calibrate import p_histogram
from repro.serving.batcher import Request as JRequest
from repro.serving.engine import build_engine as jax_build_engine
from repro.serving.token_cascade import \
    build_token_cascade as jax_build_token_cascade
from repro_torch.bridge import params_from_numpy
from repro_torch.configs.base import HIConfig
from repro_torch.configs.registry import ARCHS
from repro_torch.parity import decisive
from repro_torch.serving import engine as engine_mod
from repro_torch.serving.audit import GateAudit
from repro_torch.serving.batcher import Request
from repro_torch.serving.engine import HIEngine, TierModel, build_engine
from repro_torch.serving.token_cascade import (TokenCascade, _draft,
                                               build_token_cascade)
from test_torch_stream import LOGIT_TOL, _teacher_forced

import torch

MAX_NEW = 6
K = 3


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op torch thread: the reduced models' small ops run about
    as fast on it, and the suite's other workers keep their cores (the
    thread count is restored afterwards)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _engine_and_oracle(arch, theta, block=K, max_new=MAX_NEW):
    cfg = ARCHS[arch].reduced()
    hi = HIConfig(theta=theta, capacity_factor=1.0)
    eng = build_engine(cfg, hi, max_new_tokens=max_new, cache_len=48,
                       device="cpu")
    tc = TokenCascade(s_cfg=eng.s.cfg, l_cfg=eng.l.cfg,
                      s_params=eng.s.params, l_params=eng.l.params,
                      hi=hi, block=block, cache_len=48)
    return cfg, eng, tc


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "mamba2-370m"])
def test_fused_cascade_matches_host_oracle(arch):
    """tests/test_speculative.py:29 — the same traffic through the fused
    in-tick cascade and the host-driven loop: the same block decisions and
    tokens per request, one scheduler build."""
    cfg, eng, tc = _engine_and_oracle(arch, theta=0.5)
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, cfg.vocab_size, 8).astype(np.int32)
               for _ in range(3)]
    out = eng.serve_stream(
        [Request(i, p, max_new_tokens=MAX_NEW)
         for i, p in enumerate(prompts)],
        buckets=(8,), num_slots=2, page_size=8, decode_block=K,
        speculative=True, validate=True)
    for i, p in enumerate(prompts):
        ref = tc.generate_speculative(p[None, :], MAX_NEW)
        np.testing.assert_array_equal(out[i]["tokens"], ref["tokens"][0])
        assert out[i]["rounds"] == ref["rounds"]
        assert out[i]["escalated_blocks"] == ref["escalated"]
    assert eng.stats["stream_compiles"] == 1
    sched = eng._stream[1]
    assert sched.srt.pool.held_slots == sched.lrt.pool.held_slots == []


def test_fused_cascade_with_agreeing_tiers_keeps_whole_blocks():
    """S = L (the same params in both tiers) at theta 1.1: every block
    escalates and L agrees with every draft, so each block keeps all K
    inputs; the fused cascade still equals the oracle, and the counters
    read every draft accepted."""
    cfg = ARCHS["mamba2-370m"].reduced()
    hi = HIConfig(theta=1.1, capacity_factor=1.0)
    eng = build_engine(cfg, hi, max_new_tokens=MAX_NEW, cache_len=48,
                       device="cpu")
    same = HIEngine(eng.l, eng.l, hi, max_new_tokens=MAX_NEW)
    tc = TokenCascade(s_cfg=eng.l.cfg, l_cfg=eng.l.cfg,
                      s_params=eng.l.params, l_params=eng.l.params, hi=hi,
                      block=K, cache_len=48)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab_size, 8).astype(np.int32)
               for _ in range(2)]
    out = same.serve_stream([Request(i, p, max_new_tokens=MAX_NEW)
                             for i, p in enumerate(prompts)],
                            buckets=(8,), num_slots=2, page_size=8,
                            decode_block=K, speculative=True, validate=True)
    for i, p in enumerate(prompts):
        ref = tc.generate_speculative(p[None, :], MAX_NEW)
        np.testing.assert_array_equal(out[i]["tokens"], ref["tokens"][0])
        assert out[i]["rounds"] == ref["rounds"]
        assert all(esc for esc, _ in out[i]["rounds"])
    stats = same._stream[1].stats
    assert stats["escalated_blocks"] == stats["blocks"] > 0
    assert stats["accepted"] > 0


def _bridged_pair(theta, arch="qwen2-1.5b", cache_len=48):
    jcfg = JAX_ARCHS[arch].reduced()
    tcfg = ARCHS[arch].reduced()
    hi = dict(theta=theta, capacity_factor=1.0)
    jeng = jax_build_engine(jcfg, JHIConfig(**hi), max_new_tokens=MAX_NEW,
                            cache_len=cache_len)
    thi = HIConfig(**hi)
    tiers = [TierModel(c, params_from_numpy(jax.tree.map(np.asarray,
                                                         t.params),
                                            device="cpu"))
             for c, t in ((tcfg.s_variant(thi.s_scale), jeng.s),
                          (tcfg, jeng.l))]
    return jeng, HIEngine(*tiers, thi, max_new_tokens=MAX_NEW)


def _producers(ref_rec):
    """Per emitted position, the tiers whose argmax decides it: "S" for
    the admission token and the drafts of an accepted block, "SL" in an
    escalated block (an agreed draft needs both; a bonus token is L's, and
    S's draft there decided that it was needed)."""
    who = ["S"]
    for esc, n in ref_rec["rounds"]:
        who += ["SL" if esc else "S"] * n
    return who[:len(ref_rec["tokens"])]


def test_fused_cascade_matches_reference_stream():
    """The port's speculative stream against the reference's on bridged
    params, teacher-forced per producing tier."""
    jeng, teng = _bridged_pair(0.5)
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, 500, 8).astype(np.int32) for _ in range(4)]
    kw = dict(buckets=(8,), num_slots=2, page_size=8, decode_block=K,
              speculative=True)
    jout = jeng.serve_stream([JRequest(i, p, max_new_tokens=MAX_NEW)
                              for i, p in enumerate(prompts)], **kw)
    tout = teng.serve_stream([Request(i, p, max_new_tokens=MAX_NEW)
                              for i, p in enumerate(prompts)],
                             validate=True, **kw)
    all_decided, compared = True, 0
    for i, p in enumerate(prompts):
        j, t = jout[i], tout[i]
        toks = j["tokens"]
        mask = np.ones(len(toks), bool)
        for tier, letter in ((jeng.s, "S"), (jeng.l, "L")):
            ttier = teng.s if letter == "S" else teng.l
            js, ts = _teacher_forced(tier.cfg, tier.params, ttier.cfg,
                                     ttier.params, p, toks, 48)
            np.testing.assert_allclose(ts, js, rtol=LOGIT_TOL,
                                       atol=LOGIT_TOL)
            dec = decisive(js, 2 * LOGIT_TOL)
            for pos, who in enumerate(_producers(j)):
                if letter in who:
                    mask[pos] &= dec[pos]
                    if who == letter:    # this tier's argmax is the token
                        assert js[pos].argmax() == toks[pos]
        first = int(np.argmin(mask)) if not mask.all() else len(mask)
        np.testing.assert_array_equal(t["tokens"][:first], toks[:first])
        compared += first
        if first == len(mask):
            assert t["rounds"] == j["rounds"]
        else:
            all_decided = False
    assert compared > 0
    if all_decided:
        for key in ("drafted", "accepted", "blocks", "escalated_blocks"):
            assert teng._stream[1].stats[key] == jeng._stream[1].stats[key]


def test_fused_cascade_int8_matches_reference():
    """int8 pools: the speculative stream's tokens, rounds and counts
    equal the reference's int8 stream on bridged params."""
    jeng, teng = _bridged_pair(0.5)
    rng = np.random.default_rng(12)
    prompts = [rng.integers(0, 500, n).astype(np.int32) for n in (8, 16, 8)]
    kw = dict(buckets=(8, 16), num_slots=2, page_size=8, decode_block=K,
              speculative=True, kv_dtype="int8")
    jout = jeng.serve_stream([JRequest(i, p, max_new_tokens=MAX_NEW)
                              for i, p in enumerate(prompts)], **kw)
    tout = teng.serve_stream([Request(i, p, max_new_tokens=MAX_NEW)
                              for i, p in enumerate(prompts)],
                             validate=True, **kw)
    for rid in jout:
        np.testing.assert_array_equal(tout[rid]["tokens"],
                                      jout[rid]["tokens"])
        assert tout[rid]["rounds"] == jout[rid]["rounds"]
    for key in ("drafted", "accepted", "blocks", "escalated_blocks"):
        assert teng._stream[1].stats[key] == jeng._stream[1].stats[key]


def test_fused_cascade_single_fetch_per_tick(monkeypatch):
    """tests/test_speculative.py:53 — draft, verify and rollback ride one
    host fetch per tick."""
    calls = []
    real = engine_mod._host_fetch
    monkeypatch.setattr(engine_mod, "_host_fetch",
                        lambda tree: (calls.append(1), real(tree))[1])
    cfg, eng, _ = _engine_and_oracle("qwen2-1.5b", theta=0.5)
    rng = np.random.default_rng(0)
    eng.serve_stream([Request(0, rng.integers(0, cfg.vocab_size, 8)
                              .astype(np.int32), max_new_tokens=MAX_NEW)],
                     buckets=(8,), num_slots=1, page_size=8, decode_block=K,
                     speculative=True)
    sched = eng._stream[1]
    assert len(calls) == sched.stats["ticks"] > 0
    sched.srt.pool.check_invariants()
    sched.lrt.pool.check_invariants()


def test_speculative_never_escalates_equals_greedy_stream():
    """tests/test_speculative.py:72 — theta 0: every draft block is
    accepted, and the tokens are the plain stream's S tokens."""
    cfg = ARCHS["qwen2-1.5b"].reduced()
    hi = HIConfig(theta=0.0, capacity_factor=1.0)
    rng = np.random.default_rng(5)
    reqs = [Request(i, rng.integers(0, cfg.vocab_size, n).astype(np.int32),
                    max_new_tokens=MAX_NEW)
            for i, n in enumerate([8, 16, 8])]
    plain = build_engine(cfg, hi, max_new_tokens=MAX_NEW, cache_len=48,
                         device="cpu").serve_stream(
        reqs, buckets=(8, 16), num_slots=2, page_size=8)
    eng_s = build_engine(cfg, hi, max_new_tokens=MAX_NEW, cache_len=48,
                         device="cpu")
    spec = eng_s.serve_stream(reqs, buckets=(8, 16), num_slots=2,
                              page_size=8, decode_block=K, speculative=True)
    for rid in plain:
        np.testing.assert_array_equal(plain[rid]["s_tokens"],
                                      spec[rid]["tokens"])
        assert spec[rid]["escalated_blocks"] == 0
        assert not spec[rid]["offloaded"]
    sched = eng_s._stream[1]
    assert sched.stats["accepted"] == sched.stats["drafted"] > 0


def test_speculative_with_chunked_prefill_matches_plain_speculative():
    """tests/test_speculative.py:97 — chunked prompt ingestion does not
    change a speculative token."""
    cfg, eng_a, _ = _engine_and_oracle("qwen2-1.5b", theta=0.5)
    rng = np.random.default_rng(2)
    reqs = [Request(i, rng.integers(0, cfg.vocab_size, n).astype(np.int32),
                    max_new_tokens=MAX_NEW)
            for i, n in enumerate([24, 8, 16])]
    kw = dict(buckets=(8, 16, 24), num_slots=2, page_size=8, decode_block=K,
              speculative=True, validate=True)
    base = eng_a.serve_stream(reqs, **kw)
    _, eng_b, _ = _engine_and_oracle("qwen2-1.5b", theta=0.5)
    both = eng_b.serve_stream(reqs, chunk_prefill=True, chunk_size=8, **kw)
    for rid in base:
        np.testing.assert_array_equal(base[rid]["tokens"],
                                      both[rid]["tokens"])
        assert base[rid]["rounds"] == both[rid]["rounds"]
    assert eng_b._stream[1].srt.lane_ticks["chunk"] > 0
    assert eng_b.stats["stream_compiles"] == 1


def test_speculative_temperature_raises():
    """tests/test_speculative.py:118 — greedy-only; greedy requests still
    serve."""
    cfg = ARCHS["qwen2-1.5b"].reduced()
    eng = build_engine(cfg, HIConfig(theta=0.5, capacity_factor=1.0),
                       max_new_tokens=4, cache_len=48, device="cpu")
    prompt = np.random.default_rng(1).integers(0, cfg.vocab_size,
                                               8).astype(np.int32)
    with pytest.raises(NotImplementedError, match="greedy-only"):
        eng.serve_stream([Request(0, prompt, temperature=0.7)],
                         buckets=(8,), speculative=True)
    out = eng.serve_stream([Request(0, prompt, max_new_tokens=4)],
                           buckets=(8,), num_slots=1, page_size=8,
                           decode_block=2, speculative=True)
    assert len(out[0]["tokens"]) == 4


def test_spec_run_bins_match_oracle_on_recorded_stream():
    """tests/test_audit.py:86 — the verify lane's ground-truthed records,
    replayed through the oracle, give the audit's streaming bins."""
    cfg = ARCHS["qwen2-1.5b"].reduced()
    eng = build_engine(cfg, HIConfig(theta=0.9, capacity_factor=1.0),
                       max_new_tokens=6, cache_len=48, device="cpu")
    aud = GateAudit(bins=20)
    rng = np.random.default_rng(1)
    reqs = [Request(i, rng.integers(0, cfg.vocab_size, 8).astype(np.int32),
                    max_new_tokens=6) for i in range(4)]
    eng.serve_stream(reqs, buckets=(8,), num_slots=2, page_size=8,
                     decode_block=4, speculative=True, audit=aud)
    truthed = [r for r in aud.records if r.ok is not None]
    assert truthed and {r.kind for r in truthed} == {"draft"}
    conf = np.array([r.conf for r in truthed])
    ok = np.array([r.ok for r in truthed], np.float32)
    oracle = p_histogram(conf, ok, bins=20)
    np.testing.assert_array_equal(aud.overall.correct, oracle["correct"])
    np.testing.assert_array_equal(aud.overall.incorrect, oracle["incorrect"])
    assert aud.outcomes == len(truthed)
    wasted = sum(1 for r in truthed if r.offload and r.ok)
    missed = sum(1 for r in truthed if not r.offload and not r.ok)
    assert aud.wasted_offload == wasted and aud.missed_local == missed
    assert aud.regret_cost == pytest.approx(
        wasted * aud.beta + missed * (1 - aud.beta))
    blocks = [r for r in aud.records if r.kind == "block"]
    assert len(blocks) == eng._stream[1].stats["blocks"]


# ---------------------------------------------------------------------------
# TokenCascade against the reference's (tests/test_token_cascade.py)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def gemma():
    """The reference's token cascade on reduced gemma3-1b and the port's
    on its params (bridged), with the reference's (2, 6) prompt."""
    cfg = ARCHS["gemma3-1b"].reduced()
    jcfg = JAX_ARCHS["gemma3-1b"].reduced()
    prompt = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 6)).astype(np.int32)
    jtc = jax_build_token_cascade(jcfg, JHIConfig(theta=0.5), block=3,
                                  cache_len=32)
    s_params = params_from_numpy(jax.tree.map(np.asarray, jtc.s_params),
                                 device="cpu")
    l_params = params_from_numpy(jax.tree.map(np.asarray, jtc.l_params),
                                 device="cpu")
    return cfg, jtc, s_params, l_params, prompt


def _port_tc(gemma, theta):
    cfg, jtc, s_params, l_params, _ = gemma
    return TokenCascade(s_cfg=cfg.s_variant(4), l_cfg=cfg, s_params=s_params,
                        l_params=l_params, hi=HIConfig(theta=theta), block=3,
                        cache_len=32)


def _jax_tc(gemma, theta):
    from repro.serving.token_cascade import TokenCascade as JTC
    _, jtc, _, _, _ = gemma
    return JTC(s_cfg=jtc.s_cfg, l_cfg=jtc.l_cfg, s_params=jtc.s_params,
               l_params=jtc.l_params, hi=JHIConfig(theta=theta), block=3,
               cache_len=32)


def _pure_greedy(tc, params, cfg, prompt, steps):
    cache, logits = tc._prefill(params, cfg, prompt)
    toks = _draft(params, cfg, cache, logits, steps, "max_prob", tc.theta)[0]
    return toks.numpy()


def _tokens_match_reference(gemma, tier, got, ref):
    """The port's tokens equal the reference's up to the first position
    whose margin (through ``tier``'s weights, teacher-forced) is not
    decisive."""
    cfg, jtc, s_params, l_params, prompt = gemma
    jcfg, jparams = (jtc.s_cfg, jtc.s_params) if tier == "S" \
        else (jtc.l_cfg, jtc.l_params)
    tcfg, tparams = (cfg.s_variant(4), s_params) if tier == "S" \
        else (cfg, l_params)
    compared = 0
    for b in range(prompt.shape[0]):
        js, _ = _teacher_forced(jcfg, jparams, tcfg, tparams, prompt[b],
                                ref[b], 32)
        dec = decisive(js, 2 * LOGIT_TOL)
        first = int(np.argmin(dec)) if not dec.all() else len(dec)
        np.testing.assert_array_equal(got[b][:first], ref[b][:first])
        compared += first
    return compared


def test_never_escalate_equals_pure_s(gemma):
    cfg, _, s_params, _, prompt = gemma
    tc = _port_tc(gemma, 0.0)
    out = tc.generate(prompt, num_blocks=2)
    assert out["escalated"] == 0
    np.testing.assert_array_equal(
        out["tokens"], _pure_greedy(tc, s_params, cfg.s_variant(4), prompt,
                                    6))
    ref = _jax_tc(gemma, 0.0).generate(prompt, num_blocks=2)
    assert ref["escalated"] == 0
    assert _tokens_match_reference(gemma, "S", out["tokens"],
                                   ref["tokens"]) > 0


def test_always_escalate_equals_pure_l(gemma):
    cfg, _, _, l_params, prompt = gemma
    tc = _port_tc(gemma, 1.1)
    out = tc.generate(prompt, num_blocks=2)
    assert out["escalated"] == 2 and out["escalation_frac"] == 1.0
    np.testing.assert_array_equal(
        out["tokens"], _pure_greedy(tc, l_params, cfg, prompt, 6))
    ref = _jax_tc(gemma, 1.1).generate(prompt, num_blocks=2)
    assert _tokens_match_reference(gemma, "L", out["tokens"],
                                   ref["tokens"]) > 0


def test_intermediate_theta_counts(gemma):
    _, _, _, _, prompt = gemma
    out = _port_tc(gemma, 0.5).generate(prompt, num_blocks=3)
    ref = _jax_tc(gemma, 0.5).generate(prompt, num_blocks=3)
    assert out["tokens"].shape == ref["tokens"].shape == (2, 9)
    assert out["escalated"] == ref["escalated"]
    assert 0 <= out["escalated"] <= 3


def test_build_token_cascade_on_the_cpu():
    """``build_token_cascade`` makes seeded params on the asked device; the
    card is the default and the CPU is used only when asked for."""
    cfg = ARCHS["qwen2-1.5b"].reduced()
    a = build_token_cascade(cfg, HIConfig(theta=0.5), seed=3, block=2,
                            cache_len=32, device="cpu")
    b = build_token_cascade(cfg, HIConfig(theta=0.5), seed=3, block=2,
                            cache_len=32, device="cpu")
    assert a.device == torch.device("cpu")
    prompt = np.random.default_rng(0).integers(0, cfg.vocab_size,
                                               (1, 8)).astype(np.int32)
    ra = a.generate_speculative(prompt, 5)
    rb = b.generate_speculative(prompt, 5)
    np.testing.assert_array_equal(ra["tokens"], rb["tokens"])
    assert ra["rounds"] == rb["rounds"] and ra["tokens"].shape == (1, 5)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build_token_cascade(cfg, HIConfig(theta=0.5))
