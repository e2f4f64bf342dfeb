"""The port's drained-batch HI cascade (``HIEngine.serve``) against the JAX
engine with ``use_kernel=True`` (Pallas in interpret mode) on bridged
params, plus the reference's engine tests re-stated against the port.

Random-init logits often have their top two entries within numerical noise,
so a greedy token is compared only where the reference's top1 - top2 margin
exceeds the tolerance (teacher-forced), and a request's confidence and
offload decision only where its whole S-tier trajectory was decided by more
than that.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import HIConfig as JHIConfig
from repro.configs.registry import ARCHS as JAX_ARCHS
from repro.models import model_zoo as jzoo
from repro.serving.engine import build_engine as jax_build_engine
from repro_torch.bridge import params_from_numpy
from repro_torch.configs.base import HIConfig
from repro_torch.configs.registry import ARCHS
from repro_torch.models import model_zoo as tzoo
from repro_torch.parity import decisive, greedy_agreement
from repro_torch.serving import engine as engine_mod
from repro_torch.serving import sampler
from repro_torch.serving.batcher import Batcher, Request
from repro_torch.serving.engine import HIEngine, TierModel, build_engine

T, CACHE = 4, 32
# logits differ by <= 5e-3 (bf16 rounding flips, see test_torch_model.py)
LOGIT_TOL = 5e-3
# mean max-prob confidences over decisive trajectories
CONF_TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op torch thread: the reduced models' small ops run about
    as fast on it, and the suite's other workers keep their cores (the
    thread count is restored afterwards)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(vocab, n_req=6, batch=8, seed=0):
    """6 requests in a batch of 8: the two padded rows carry identical
    prompts, hence identical confidences, and tie in the router."""
    rng = np.random.default_rng(seed)
    b = Batcher(batch_size=batch, buckets=(8, 16))
    for i in range(n_req):
        b.submit(Request(i, rng.integers(1, vocab, int(rng.integers(4, 16)))
                         .astype(np.int32)))
    return b.next_batch().tokens


def _teacher_forced(jcfg, jparams, tcfg, tparams, prompts, gen):
    """Logits of both packages along the reference's generated tokens:
    (T, B, V) each; step i's logits decide gen[:, i]."""
    b = prompts.shape[0]
    jl, jc = jax.jit(lambda p, t, c: jzoo.prefill(p, jcfg, t, c))(
        jparams, jnp.asarray(prompts), jzoo.init_cache(jcfg, b, CACHE))
    tl, tc = tzoo.prefill(tparams, tcfg, torch.as_tensor(prompts, dtype=torch.int64),
                          tzoo.init_cache(tcfg, b, CACHE, device="cpu"))
    step = jax.jit(lambda p, t, c: jzoo.decode_step(p, jcfg, t, c,
                                                    use_kernel=True))
    js, ts = [], []
    for i in range(gen.shape[1]):
        js.append(np.asarray(jl))
        ts.append(tl.numpy())
        tok = np.array(gen[:, i:i + 1])
        jl, jc = step(jparams, jnp.asarray(tok, jnp.int32), jc)
        tl, tc = tzoo.decode_step(tparams, tcfg,
                                  torch.as_tensor(tok, dtype=torch.int64), tc)
    return np.stack(js), np.stack(ts)


@pytest.fixture(scope="module", params=["qwen2-1.5b", "gemma3-1b"])
def engines(request):
    arch = request.param
    jcfg, tcfg = JAX_ARCHS[arch].reduced(), ARCHS[arch].reduced()
    jeng = jax_build_engine(jcfg, JHIConfig(theta=0.6, capacity_factor=0.5),
                            max_new_tokens=T, cache_len=CACHE,
                            use_kernel=True)
    tiers = [TierModel(c, params_from_numpy(jax.tree.map(np.asarray, t.params),
                                            device="cpu"))
             for c, t in ((tcfg.s_variant(4), jeng.s), (tcfg, jeng.l))]
    teng = HIEngine(*tiers, HIConfig(theta=0.6, capacity_factor=0.5),
                    cache_len=CACHE, max_new_tokens=T)
    return jeng, teng


def test_serve_matches_jax_engine(engines):
    jeng, teng = engines
    jcfg_s, tcfg_s = jeng.s.cfg, teng.s.cfg
    toks = _batch(jcfg_s.vocab_size)
    jout = jeng.serve(toks)
    # theta at the median S confidence: half the batch escalates
    theta = float(np.median(jout["confidence"]))
    for th in (0.6, theta):
        jeng.hi = dataclasses.replace(jeng.hi, theta=th)
        teng.hi = dataclasses.replace(teng.hi, theta=th)
        jout, tout = jeng.serve(toks), teng.serve(toks)
        assert set(tout) == {"tokens", "s_tokens", "confidence", "offloaded",
                             "served_remote"}
        assert tout["tokens"].dtype == tout["s_tokens"].dtype == np.int32

        # S tier: teacher-forced along the reference's tokens
        js, ts = _teacher_forced(jcfg_s, jeng.s.params, tcfg_s,
                                 teng.s.params, toks, jout["s_tokens"])
        np.testing.assert_array_equal(js.argmax(-1).T, jout["s_tokens"])
        np.testing.assert_allclose(ts, js, rtol=LOGIT_TOL, atol=LOGIT_TOL)
        n, agree = greedy_agreement(js, ts, LOGIT_TOL)
        assert n > 0 and agree == n
        row_ok = decisive(js, LOGIT_TOL).all(axis=0)       # (B,)
        assert row_ok.sum() >= len(row_ok) // 2
        np.testing.assert_array_equal(tout["s_tokens"][row_ok],
                                      jout["s_tokens"][row_ok])
        np.testing.assert_allclose(tout["confidence"][row_ok],
                                   jout["confidence"][row_ok],
                                   rtol=CONF_TOL, atol=CONF_TOL)
        far = row_ok & (np.abs(jout["confidence"] - th) > CONF_TOL)
        np.testing.assert_array_equal(tout["offloaded"][far],
                                      jout["offloaded"][far])
        if row_ok.all():
            # identical decisions, router ties on the padded rows included
            np.testing.assert_array_equal(tout["served_remote"],
                                          jout["served_remote"])

        # L tier: teacher-forced on the requests it served
        served = np.flatnonzero(jout["served_remote"])
        if len(served):
            jl, tl = _teacher_forced(jeng.l.cfg, jeng.l.params, teng.l.cfg,
                                     teng.l.params, toks[served],
                                     jout["tokens"][served])
            np.testing.assert_allclose(tl, jl, rtol=LOGIT_TOL, atol=LOGIT_TOL)
            n, agree = greedy_agreement(jl, tl, LOGIT_TOL)
            assert agree == n
        # local rows keep their S answer
        local = ~tout["served_remote"]
        np.testing.assert_array_equal(tout["tokens"][local],
                                      tout["s_tokens"][local])


def test_one_host_fetch_per_serve(monkeypatch):
    cfg = ARCHS["qwen2-1.5b"].reduced()
    eng = build_engine(cfg, HIConfig(theta=0.6), max_new_tokens=3,
                       cache_len=32, device="cpu")
    calls = []
    real = engine_mod._host_fetch

    def counting(tree):
        calls.append(sorted(tree))
        return real(tree)

    monkeypatch.setattr(engine_mod, "_host_fetch", counting)
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (4, 8))
    for i in range(3):
        eng.serve(toks.astype(np.int32))
        assert len(calls) == i + 1
    assert eng.stats["cache_allocs"] == 1          # one (batch, bucket)
    eng.serve(np.zeros((4, 16), np.int32))
    assert eng.stats["cache_allocs"] == 2 and len(calls) == 4


def test_host_fetch_round_trips_dtypes():
    tree = {"f": torch.tensor([[1.5, -2.25]]), "b": torch.tensor([True, False]),
            "i": torch.tensor([3, 151935], dtype=torch.int64),
            "d": torch.tensor(7, dtype=torch.int32)}
    host = engine_mod._host_fetch(tree)
    assert host["f"].dtype == np.float32 and host["f"].tolist() == [[1.5, -2.25]]
    assert host["b"].dtype == bool and host["b"].tolist() == [True, False]
    assert host["i"].dtype == np.int32 and host["i"].tolist() == [3, 151935]
    assert host["d"].shape == () and int(host["d"]) == 7


def test_cuda_device_without_a_card_raises():
    """No silent CPU execution when the card was asked for."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_engine(ARCHS["qwen2-1.5b"].reduced(), HIConfig())


def test_engine_takes_temperature():
    """The engine takes ``temperature`` (default 0, greedy); the sampler is
    exactly greedy at temperature 0 and draws under per-request keys above
    it, reproducibly."""
    logits = torch.randn(2, 16, generator=torch.Generator().manual_seed(0))
    keys = sampler.request_keys(torch.tensor([3, 4]), 0)
    assert torch.equal(sampler.sample(keys, logits, 0.0), logits.argmax(-1))
    hot = sampler.sample(keys, logits * 0, 0.7)
    assert torch.equal(hot, sampler.sample(keys, logits * 0, 0.7))
    assert build_engine(ARCHS["qwen2-1.5b"].reduced(), HIConfig(),
                        device="cpu").temperature == 0.0
    eng = build_engine(ARCHS["qwen2-1.5b"].reduced(), HIConfig(),
                       temperature=0.7, max_new_tokens=3, cache_len=16,
                       device="cpu")
    assert eng.temperature == 0.7
    toks = np.ones((2, 8), np.int32)
    a = eng.serve(toks, seeds=np.array([5, 6], np.int32))
    b = eng.serve(toks, seeds=np.array([5, 6], np.int32))
    np.testing.assert_array_equal(a["tokens"], b["tokens"])


def test_bucket_overflowing_cache_raises():
    eng = build_engine(ARCHS["qwen2-1.5b"].reduced(), HIConfig(),
                       max_new_tokens=8, cache_len=16, device="cpu")
    with pytest.raises(ValueError, match="cache_len"):
        eng.serve(np.ones((2, 16), np.int32))


# ---------------------------------------------------------------------------
# tests/test_serving.py's batcher and engine tests, re-stated against the port
# ---------------------------------------------------------------------------

def test_batcher_padding_and_buckets():
    b = Batcher(batch_size=4, buckets=(8, 16), pad_id=0)
    for i, n in enumerate([3, 9, 5]):
        b.submit(Request(i, np.arange(1, n + 1, dtype=np.int32)))
    batch = b.next_batch()
    assert batch.tokens.shape == (4, 16) and batch.bucket == 16
    assert (batch.request_ids >= 0).sum() == 3    # one padding slot
    assert batch.lengths[0] == 3
    assert (batch.tokens[0, 3:] == 0).all()


def test_pad_to_bucket_overflow_raises():
    from repro_torch.serving.batcher import pad_to_bucket
    assert pad_to_bucket(8, (8, 16)) == 8
    assert pad_to_bucket(9, (8, 16)) == 16
    with pytest.raises(ValueError, match="exceeds the largest bucket"):
        pad_to_bucket(17, (8, 16))
    with pytest.raises(ValueError, match="exceeds the largest bucket"):
        Batcher(batch_size=2, buckets=(8, 16)).submit(
            Request(0, np.ones(17, np.int32)))


def test_batcher_queue_drain():
    b = Batcher(batch_size=2, buckets=(8,))
    for i in range(5):
        b.submit(Request(i, np.ones(4, np.int32)))
    seen = []
    while b.queue:
        rids = b.next_batch().request_ids
        seen += rids[rids >= 0].tolist()
    assert seen == [0, 1, 2, 3, 4]             # FIFO
    assert b.next_batch() is None


@pytest.mark.parametrize("theta,expect", [(0.0, "none"), (1.1, "all")])
def test_engine_offload_extremes(theta, expect):
    cfg = ARCHS["gemma3-1b"].reduced()
    hi = HIConfig(theta=theta, capacity_factor=1.0)
    eng = build_engine(cfg, hi, max_new_tokens=4, cache_len=32, device="cpu")
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size,
                                             (4, 8)).astype(np.int32)
    out = eng.serve(toks)
    if expect == "none":
        assert out["offloaded"].sum() == 0
        np.testing.assert_array_equal(out["tokens"], out["s_tokens"])
    else:
        assert out["offloaded"].sum() == 4
        assert out["served_remote"].sum() == 4


def test_engine_capacity_drops_counted():
    cfg = ARCHS["gemma3-1b"].reduced()
    hi = HIConfig(theta=1.1, capacity_factor=0.5)   # all want offload, half fit
    eng = build_engine(cfg, hi, max_new_tokens=2, cache_len=32, device="cpu")
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size,
                                             (4, 8)).astype(np.int32)
    out = eng.serve(toks)
    assert out["served_remote"].sum() == 2
    s = eng.summary()
    assert s["dropped"] == 2 and s["offload_frac"] == 1.0
    assert s["drop_frac"] == 0.5


def test_engine_output_shapes_and_stats():
    cfg = ARCHS["qwen2-1.5b"].reduced()
    hi = HIConfig(theta=0.6, capacity_factor=0.5)
    eng = build_engine(cfg, hi, max_new_tokens=3, cache_len=32, device="cpu")
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size,
                                             (4, 8)).astype(np.int32)
    out = eng.serve(toks)
    assert out["tokens"].shape == (4, 3)
    assert out["confidence"].shape == (4,)
    s = eng.summary()
    assert 0 <= s["offload_frac"] <= 1
    assert s["requests"] == 4 and s["serve_time"] > 0
    assert set(s) == {"requests", "offloaded", "dropped", "serve_time",
                      "cache_allocs", "offload_frac", "drop_frac",
                      # serve_stream's counters (0 on the drain path)
                      "stream_compiles", "stream_ticks",
                      "prefill_tokens_saved", "degraded_local", "rejected",
                      # and the fault path's, as the reference's engine
                      "breaker_open_ticks", "breaker_opens", "esc_retries",
                      "esc_lost"}
    assert s["stream_ticks"] == s["stream_compiles"] == 0


def test_engine_online_policy_adapts():
    """Paper ref [27]: online theta tuning from L-tier feedback.  A
    random-init S tier rarely agrees with L, so the policy observes
    disagreement feedback and moves."""
    from repro_torch.core.policy import OnlineThresholdPolicy
    cfg = ARCHS["gemma3-1b"].reduced()
    pol = OnlineThresholdPolicy(beta=0.1, grid=32, eta_lr=0.5)
    hi = HIConfig(theta=0.5, capacity_factor=1.0)
    eng = build_engine(cfg, hi, max_new_tokens=2, cache_len=32, device="cpu")
    eng.online_policy = pol
    rng = np.random.default_rng(3)
    thetas = [pol.theta]
    for _ in range(3):
        toks = rng.integers(0, cfg.vocab_size, (4, 8)).astype(np.int32)
        eng.serve(toks)
        thetas.append(pol.theta)
    assert thetas[-1] != thetas[0] or len(pol.history) > 0
