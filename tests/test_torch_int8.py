"""The port's int8 paged KV pools against the JAX reference, at reduced size.

Re-states the cases of ``tests/test_kv_quant.py`` on the port, each held
against the reference on bridged params (or on the same seeded numpy
inputs):

* the write side: ``quant_append_page`` on one chunk that writes a page
  twice and crosses a page boundary, ``dequant_gather``;
* the int8 plain kernels against ``decode_attention_{paged,chunk_paged}_
  pallas(..., scale_k, scale_v, interpret=True)`` and against the
  reference's ``dequant_gather`` + ``_sdpa`` path, with garbage (NaN
  scales, arbitrary bytes) planted where no query may look;
* per-family int8-vs-bf16 fidelity (qwen2, gemma3, zamba2; mamba2, which
  has no pages, bit-identical), with the port's int8 logits and pools held
  against the reference's;
* sharing and chunking equivalence by tolerance, ``copy_pages`` and
  ``cow_pages`` over int8 pools with their scale rows, the pool gauges, one
  host fetch per tick in both dtypes, int8 prefix sharing with COW moving
  scale rows, and the reference's teacher-forced gate on reduced zamba2.

Tolerances.
* ``ATT_TOL`` = 3e-5: plain version against the Pallas kernel, both
  float32 with the same dequantisation; only the order of the sums differs.
* ``INT8_LOGIT_TOL``: port against reference on an int8 pool, per family,
  absolute (rtol 0), each between the port-against-reference error and the
  int8-against-bf16 gap that the check must resolve (both read on the
  prefill and two decode steps of the per-family test): qwen2 1.5e-2
  (error 6.2e-3, gap 6.4e-2), gemma3 1e-4 (error 4.3e-6, gap 6.5e-2),
  zamba2 4e-3 (error 5.5e-4, gap 1.03e-2).  A port that attended over
  unquantised K/V would miss each limit.  The error comes from rounding
  ties: a float32 value that lies within rounding noise of a half level
  quantises to the neighbouring level in the other package (one such tie
  in layer 0's V of reduced qwen2 moves later layers' inputs by about
  1e-3).  ``SAME_LEVELS_TOL`` = 1e-4: both packages' chunk pass over one
  bridged int8 pool, which read the same levels (measured 3.9e-6).
* Pools, port against reference: every level within 1 of the reference's,
  and at most ``LEVEL_FLIPS`` = 1 in 200 levels off by 1 (the rounding
  ties above; measured 56 of 24,576 = 0.23% on reduced qwen2 after a
  prefill and four decode steps, 2 of 24,576 on zamba2, none on gemma3);
  scales within rtol ``SCALE_RTOL`` = 5e-3 (measured 3.4e-4).  Where both
  packages write from the same float32 inputs (``quant_append_page``,
  ``copy_pages``), levels and scales are equal, with no tie allowed.
* Chunk against steps on the port's own pool (the reference's own
  tolerance): logits 2e-2, scales rtol 5e-3, levels within 2.  A prefill
  that splices a shared int8 prefix against a from-scratch prefill of the
  same prompt: ``SHARE_TOL`` = 1e-3 (measured 1.2e-4; bitwise under bf16).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import HIConfig as JHIConfig
from repro.configs.registry import ARCHS as JAX_ARCHS
from repro.kernels import decode_attention as jda
from repro.kernels import ops as jops
from repro.models import layers as JL
from repro.models import model_zoo as jzoo
from repro.serving.engine import build_engine as jax_build_engine
from repro_torch.bridge import params_from_numpy
from repro_torch.configs.base import HIConfig
from repro_torch.configs.registry import ARCHS
from repro_torch.kernels import copy_pages as cp
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models import model_zoo as tzoo
from repro_torch.parity import (TRACE_LOGIT_TOL, greedy_agreement,
                                int8_agreement, paged_trace, traces_close)
from repro_torch.serving import engine as engine_mod
from repro_torch.serving.batcher import Request
from repro_torch.serving.engine import build_engine
from repro_torch.serving.kv_pool import KVPool

ATT_TOL = 3e-5
INT8_LOGIT_TOL = {"qwen2-1.5b": 1.5e-2, "gemma3-1b": 1e-4,
                  "zamba2-2.7b": 4e-3}
SAME_LEVELS_TOL = 1e-4
LEVEL_FLIPS = 1 / 200
SCALE_RTOL = 5e-3
SHARE_TOL = 1e-3
PAGE = 8
FAMS = ["qwen2-1.5b", "gemma3-1b", "mamba2-370m", "zamba2-2.7b"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op torch thread: the reduced models' small ops run about
    as fast on it, and the suite's other workers keep their cores (the
    thread count is restored afterwards)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _levels_close(got: torch.Tensor, ref, what: str) -> int:
    """Levels within 1 and at most LEVEL_FLIPS of them off by 1; returns
    the count off by 1."""
    d = np.abs(got.numpy().astype(np.int32) - np.asarray(ref, np.int32))
    flips = int((d == 1).sum())
    assert d.max() <= 1, f"{what}: a level {d.max()} steps off"
    assert flips <= LEVEL_FLIPS * d.size, f"{what}: {flips}/{d.size} flips"
    return flips


def _pools_close(jcache, tcache):
    """Every page but the null page 0, which takes redirected and padded
    rows' writes in an order neither package fixes."""
    for key in ("kp", "vp"):
        _levels_close(tcache[key][:, 1:], jcache[key][:, 1:], key)
    for key in ("ks", "vs"):
        np.testing.assert_allclose(tcache[key][:, 1:].numpy(),
                                   _np(jcache[key])[:, 1:], rtol=SCALE_RTOL,
                                   atol=1e-6)


_BRIDGED = {}


def _bridged(arch):
    """(reference cfg, reference params, port cfg, bridged params)."""
    if arch not in _BRIDGED:
        jcfg, tcfg = JAX_ARCHS[arch].reduced(), ARCHS[arch].reduced()
        jparams = jzoo.init_params(jax.random.PRNGKey(0), jcfg)
        tparams = params_from_numpy(jax.tree.map(np.asarray, jparams),
                                    device="cpu")
        _BRIDGED[arch] = (jcfg, jparams, tcfg, tparams)
    return _BRIDGED[arch]


def _to_port(jcache):
    """An int8 cache of the reference's, bridged as numpy arrays."""
    return params_from_numpy(jax.tree.map(np.asarray, jcache), device="cpu")


# ---------------------------------------------------------------------------
# the write side and the gather (plain torch in both packages)
# ---------------------------------------------------------------------------

def test_quant_append_page_matches_reference():
    """One chunk of six tokens from offset 2 of page 3: page 3 takes two
    (offsets 2, 3) and page 5 four (offsets 0..3, a stale page whose scale
    must reset).  A second row writes the null page.  The port's in-place
    update equals the reference's functional one, levels and scales."""
    rng = np.random.default_rng(0)
    p, page, kh, d = 7, 4, 2, 8
    pool = rng.integers(-127, 128, (p, page, kh, d)).astype(np.int8)
    scale = (rng.random((p, kh)) * 0.05).astype(np.float32)
    scale[5] = 9.0                                    # stale, huge
    pg = np.array([[3, 3, 5, 5, 5, 5], [0, 0, 0, 0, 0, 0]], np.int32)
    off = np.array([[2, 3, 0, 1, 2, 3], [1, 2, 3, 1, 2, 3]], np.int32)
    val = (rng.normal(size=(2, 6, kh, d)) * 3).astype(np.float32)
    val[0, 1] *= 4                                    # the page-3 scale grows
    jp, js = JL.quant_append_page(jnp.asarray(pool), jnp.asarray(scale),
                                  jnp.asarray(pg), jnp.asarray(off),
                                  jnp.asarray(val))
    tp, ts = torch.from_numpy(pool.copy()), torch.from_numpy(scale.copy())
    L.quant_append_page(tp, ts, torch.from_numpy(pg).long(),
                        torch.from_numpy(off).long(), torch.from_numpy(val))
    np.testing.assert_array_equal(tp.numpy()[1:], np.asarray(jp)[1:])
    np.testing.assert_array_equal(ts.numpy()[1:], np.asarray(js)[1:])
    assert ts[5].max() < 1.0                          # the stale scale reset
    assert not torch.equal(tp[3], torch.from_numpy(pool[3]))  # requantised


def test_dequant_gather_matches_reference():
    rng = np.random.default_rng(1)
    pool = rng.integers(-127, 128, (9, 4, 2, 8)).astype(np.int8)
    scale = rng.random((9, 2)).astype(np.float32)
    block = rng.permutation(np.arange(1, 9))[:6].reshape(2, 3) \
        .astype(np.int32)
    ref = JL.dequant_gather(jnp.asarray(pool), jnp.asarray(scale),
                            jnp.asarray(block), 2, 8)
    got = da.dequant_gather(torch.from_numpy(pool), torch.from_numpy(scale),
                            torch.from_numpy(block))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


# ---------------------------------------------------------------------------
# the int8 plain kernels against the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------

def _int8_case(seed, b=3, h=4, kh=2, d=16, page=4, npg=5, c=1):
    """Shuffled physical pages; slot 1 holds fewer pages than its row (the
    rest is the null page 0); slot 2 sees no key.  Returns the clean inputs
    and a copy with NaN / inf scales and arbitrary bytes wherever no query
    of the slot may look (page 0, unallocated pages, stale tails)."""
    rng = np.random.default_rng(seed)
    p = b * npg + 2
    pool_k = rng.integers(-127, 128, (p, page, kh, d)).astype(np.int8)
    pool_v = rng.integers(-127, 128, (p, page, kh, d)).astype(np.int8)
    sk = (rng.random((p, kh)) * 0.1).astype(np.float32)
    sv = (rng.random((p, kh)) * 0.1).astype(np.float32)
    perm = rng.permutation(np.arange(1, p)).astype(np.int32)
    block = perm[: b * npg].reshape(b, npg)
    block[1, 4:] = 0
    q = rng.normal(size=(b, c, h, d)).astype(np.float32)
    pos = np.array([page * npg - c, 2 * page + 1, 0], np.int32)[:b]
    qpos = pos[:, None] + np.arange(c)[None, :]
    valid = np.arange(npg * page)[None, None, :] <= qpos[:, :, None]
    valid[2] = False
    clean = (q, pool_k, pool_v, sk, sv, block, valid)
    dk, dv, dsk, dsv = pool_k.copy(), pool_v.copy(), sk.copy(), sv.copy()
    seen = valid.any(axis=1)
    dsk[0], dsv[0] = np.nan, np.inf
    dk[0] = rng.integers(-128, 128, dk[0].shape)
    used = set()
    for bi in range(b):
        for s in np.flatnonzero(~seen[bi]):
            pg = block[bi, s // page]
            dk[pg, s % page] = rng.integers(-128, 128, dk[pg, s % page].shape)
            dv[pg, s % page] = -128
            used.add(int(pg))
    for pg in set(range(1, p)) - set(block.ravel().tolist()):
        dsk[pg], dsv[pg] = np.nan, -np.inf            # unallocated pages
    return clean, (q, dk, dv, dsk, dsv, block, valid)


def _t(*xs):
    return tuple(torch.from_numpy(x) for x in xs)


@pytest.mark.parametrize("c", [1, 4])
@pytest.mark.parametrize("d", [16, 120])
def test_int8_plain_kernels_match_pallas(c, d):
    clean, dirty = _int8_case(10 + c, c=c, d=d)
    q, pk, pv, sk, sv, block, valid = clean
    if c == 1:
        ref = jda.decode_attention_paged_pallas(
            jnp.asarray(q), jnp.asarray(pk), jnp.asarray(pv),
            jnp.asarray(block), jnp.asarray(valid[:, 0]),
            scale_k=jnp.asarray(sk), scale_v=jnp.asarray(sv), interpret=True)
    else:
        ref = jda.decode_attention_chunk_paged_pallas(
            jnp.asarray(q), jnp.asarray(pk), jnp.asarray(pv),
            jnp.asarray(block), jnp.asarray(valid),
            scale_k=jnp.asarray(sk), scale_v=jnp.asarray(sv), interpret=True)

    def run(case):
        q, pk, pv, sk, sv, block, valid = _t(*case)
        if c == 1:
            return ops.decode_attention_paged(q, pk, pv, block, valid[:, 0],
                                              sk, sv)
        return ops.decode_attention_chunk_paged(q, pk, pv, block, valid,
                                                sk, sv)

    got = run(clean)
    np.testing.assert_allclose(got.numpy(), _np(ref), rtol=ATT_TOL,
                               atol=ATT_TOL)
    assert (got[2] == 0).all()                        # no key: returns 0
    # the reference's jnp path: dequant_gather, then _sdpa (q float32)
    kk = JL.dequant_gather(jnp.asarray(pk), jnp.asarray(sk),
                           jnp.asarray(block), pk.shape[2], pk.shape[3])
    vv = JL.dequant_gather(jnp.asarray(pv), jnp.asarray(sv),
                           jnp.asarray(block), pk.shape[2], pk.shape[3])
    jref = JL._sdpa(jnp.asarray(q), kk, vv, jnp.asarray(valid))
    np.testing.assert_allclose(got.numpy()[:2], _np(jref)[:2], rtol=ATT_TOL,
                               atol=ATT_TOL)
    planted = run(dirty)
    assert torch.isfinite(planted).all()
    torch.testing.assert_close(planted, got, rtol=0, atol=0)


def test_int8_pool_without_scales_is_refused():
    """An int8 pool without its scales, or scales beside a bf16 pool, is
    refused by the op (CPU: the plain version) and by the CUDA wrapper
    before anything else, never read as bf16 bytes."""
    (q, pk, pv, sk, sv, block, valid), _ = _int8_case(3)
    q, pk, pv, sk, sv, block, valid = _t(q, pk, pv, sk, sv, block, valid)
    with pytest.raises(ValueError, match="needs scale_k and scale_v"):
        ops.decode_attention_paged(q, pk, pv, block, valid[:, 0])
    with pytest.raises(ValueError, match="needs scale_k and scale_v"):
        ops.decode_attention_chunk_paged(q, pk, pv, block, valid, sk, None)
    with pytest.raises(ValueError, match="needs scale_k and scale_v"):
        da.decode_attention_paged_cuda(q, pk, pv, block, valid[:, 0])
    with pytest.raises(ValueError, match="needs scale_k and scale_v"):
        da.decode_attention_chunk_paged_cuda(q, pk.to(torch.bfloat16),
                                             pv.to(torch.bfloat16), block,
                                             valid, sk, sv)
    with pytest.raises(ValueError, match="float32"):
        ops.decode_attention_paged(q, pk, pv, block, valid[:, 0],
                                   sk.double(), sv)
    with pytest.raises(TypeError, match="int8"):
        ops.decode_attention_paged(q, pk.to(torch.int16), pv.to(torch.int16),
                                   block, valid[:, 0])


# ---------------------------------------------------------------------------
# the paged model API: int8 against bf16, and against the reference
# ---------------------------------------------------------------------------

SLOTS, NPG, PROMPT = 2, 6, 16


def _prefill(tcfg, tparams, dtype, toks, block):
    cache = tzoo.init_paged_cache(tcfg, SLOTS, SLOTS * NPG + 1, PAGE, dtype,
                                  device="cpu")
    return tzoo.prefill_paged(tparams, tcfg, torch.from_numpy(toks),
                              torch.full((SLOTS,), PROMPT),
                              torch.arange(SLOTS), torch.from_numpy(block),
                              cache)


def _inputs(cfg, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (SLOTS, PROMPT)).astype(np.int32)
    block = np.arange(1, SLOTS * NPG + 1, dtype=np.int32).reshape(SLOTS, NPG)
    return rng, toks, block


@pytest.mark.parametrize("arch", FAMS)
def test_int8_decode_fidelity_per_family(arch):
    """tests/test_kv_quant.py:48 on the port: int8 pools track bf16 within
    the reference's bounds, teacher-forced on the bf16 argmax (mamba2,
    with no pages to quantise, stays exact).  Then the port's int8 prefill
    and two decode steps against the reference's: logits within the
    family's ``INT8_LOGIT_TOL``, decisive greedy tokens equal, pools
    close."""
    jcfg, jparams, tcfg, tparams = _bridged(arch)
    rng, toks, block = _inputs(tcfg)
    lg_b, cache_b = _prefill(tcfg, tparams, torch.bfloat16, toks, block)
    lg_q, cache_q = _prefill(tcfg, tparams, torch.int8, toks, block)
    assert ("ks" in cache_q) == (arch != "mamba2-370m")
    pos = torch.full((SLOTS,), PROMPT)
    bt = torch.from_numpy(block)
    max_err = float((lg_b - lg_q).abs().max())
    match, total = int((lg_b.argmax(-1) == lg_q.argmax(-1)).sum()), SLOTS
    for i in range(8):
        tok = lg_b.argmax(-1)[:, None]
        lg_b, _ = tzoo.decode_step_paged(tparams, tcfg, tok, pos + i, bt,
                                         cache_b)
        lg_q, _ = tzoo.decode_step_paged(tparams, tcfg, tok, pos + i, bt,
                                         cache_q)
        max_err = max(max_err, float((lg_b - lg_q).abs().max()))
        match += int((lg_b.argmax(-1) == lg_q.argmax(-1)).sum())
        total += SLOTS
    if arch == "mamba2-370m":
        assert match == total and max_err == 0.0
        return
    assert match / total >= 0.8, f"{arch}: agreement {match}/{total}"
    assert max_err <= 0.3, f"{arch}: logit error {max_err}"

    jcache = jzoo.init_paged_cache(jcfg, SLOTS, SLOTS * NPG + 1, PAGE,
                                   jnp.int8)
    jl, jcache = jzoo.prefill_paged(
        jparams, jcfg, jnp.asarray(toks), jnp.full((SLOTS,), PROMPT),
        jnp.arange(SLOTS, dtype=jnp.int32), jnp.asarray(block), jcache)
    tl, tcache = _prefill(tcfg, tparams, torch.int8, toks, block)
    js, ts = [_np(jl)], [tl.numpy()]
    for i in range(2):
        tok = rng.integers(0, jcfg.vocab_size, (SLOTS, 1)).astype(np.int32)
        jl, jcache = jzoo.decode_step_paged(
            jparams, jcfg, jnp.asarray(tok), jnp.full((SLOTS,), PROMPT + i),
            jnp.asarray(block), jcache)
        tl, tcache = tzoo.decode_step_paged(
            tparams, tcfg, torch.from_numpy(tok), pos + i, bt, tcache)
        js.append(_np(jl))
        ts.append(tl.numpy())
    js, ts = np.stack(js), np.stack(ts)
    tol = INT8_LOGIT_TOL[arch]
    np.testing.assert_allclose(ts, js, rtol=0, atol=tol)
    n, agree = greedy_agreement(js, ts, 2 * tol)
    assert n > 0 and agree == n
    _pools_close(jcache, tcache)


def test_int8_chunk_pass_matches_reference_on_one_pool():
    """The reference's int8 pool, bridged: the port's chunk pass (the
    chunk-paged int8 body's plain version) and the reference's Pallas chunk
    pass read the same levels and scales and write the same chunk."""
    jcfg, jparams, tcfg, tparams = _bridged("qwen2-1.5b")
    rng, toks, block = _inputs(tcfg, seed=1)
    jcache = jzoo.init_paged_cache(jcfg, SLOTS, SLOTS * NPG + 1, PAGE,
                                   jnp.int8)
    _, jcache = jzoo.prefill_paged(
        jparams, jcfg, jnp.asarray(toks), jnp.full((SLOTS,), PROMPT),
        jnp.arange(SLOTS, dtype=jnp.int32), jnp.asarray(block), jcache)
    tcache = _to_port(jcache)
    assert tcache["kp"].dtype == torch.int8
    chunk = rng.integers(0, jcfg.vocab_size, (SLOTS, 4)).astype(np.int32)
    jl, jcache, _ = jzoo.forward_chunk_paged(
        jparams, jcfg, jnp.asarray(chunk), jnp.full((SLOTS,), PROMPT),
        jnp.asarray(block), jcache, use_kernel=True)
    tl, tcache, _ = tzoo.forward_chunk_paged(
        tparams, tcfg, torch.from_numpy(chunk), torch.full((SLOTS,), PROMPT),
        torch.from_numpy(block), tcache)
    np.testing.assert_allclose(tl.numpy(), _np(jl), rtol=0,
                               atol=SAME_LEVELS_TOL)
    _pools_close(jcache, tcache)


def test_int8_sharing_and_chunking_equivalence_tolerance():
    """tests/test_kv_quant.py:93 on the port: one chunk pass tracks the
    same tokens fed as decode steps on the same int8 pool (the chunk
    commits each page at its final scale, the steps may requantise).  And
    prefix sharing: a second admission that splices slot 0's first two
    pages (start 16) gives the logits of a from-scratch int8 prefill, and
    the reference's."""
    jcfg, jparams, tcfg, tparams = _bridged("qwen2-1.5b")
    rng, toks, block = _inputs(tcfg, seed=2)
    _, cache = _prefill(tcfg, tparams, torch.int8, toks, block)
    pos = torch.full((SLOTS,), PROMPT)
    bt = torch.from_numpy(block)
    chunk = torch.from_numpy(
        rng.integers(0, tcfg.vocab_size, (SLOTS, 3)).astype(np.int32))
    steps_cache = {k: v.clone() for k, v in cache.items()}
    ref = torch.stack([tzoo.decode_step_paged(
        tparams, tcfg, chunk[:, i:i + 1], pos + i, bt, steps_cache)[0]
        for i in range(3)], dim=1)
    out, cache, _ = tzoo.forward_chunk_paged(tparams, tcfg, chunk, pos, bt,
                                             cache)
    torch.testing.assert_close(out, ref, rtol=2e-2, atol=2e-2)
    for k in ("ks", "vs"):
        torch.testing.assert_close(cache[k], steps_cache[k], rtol=5e-3,
                                   atol=5e-5)
    for k in ("kp", "vp"):
        d = (cache[k].int() - steps_cache[k].int()).abs()
        assert d.max() <= 2, f"{k}: quantized bytes diverge by {d.max()}"

    # sharing: row [slot 0's pages 0-1 | three fresh pages], start 16
    jcache = jzoo.init_paged_cache(jcfg, SLOTS, SLOTS * NPG + 4, PAGE,
                                   jnp.int8)
    _, jcache = jzoo.prefill_paged(
        jparams, jcfg, jnp.asarray(toks), jnp.full((SLOTS,), PROMPT),
        jnp.arange(SLOTS, dtype=jnp.int32), jnp.asarray(block), jcache)
    tcache = _to_port(jcache)
    row = np.zeros((1, NPG), np.int32)
    row[0, :2] = block[0, :2]
    row[0, 2:5] = np.arange(SLOTS * NPG + 1, SLOTS * NPG + 4)
    t2 = np.concatenate([toks[0], rng.integers(0, tcfg.vocab_size, 8)
                         .astype(np.int32)])[None, :]
    lens, start = np.array([24], np.int32), np.array([16], np.int32)
    before = {k: tcache[k][:, block[0, :2]].clone() for k in ("kp", "ks")}
    jl, jcache = jzoo.prefill_paged(
        jparams, jcfg, jnp.asarray(t2), jnp.asarray(lens),
        jnp.zeros((1,), jnp.int32), jnp.asarray(row), jcache,
        start=jnp.asarray(start))
    tl, tcache = tzoo.prefill_paged(
        tparams, tcfg, torch.from_numpy(t2), torch.from_numpy(lens),
        torch.zeros(1), torch.from_numpy(row), tcache,
        start=torch.from_numpy(start))
    np.testing.assert_allclose(tl.numpy(), _np(jl), rtol=0,
                               atol=INT8_LOGIT_TOL["qwen2-1.5b"])
    _pools_close(jcache, tcache)
    for k in ("kp", "ks"):                            # read-only prefix
        assert torch.equal(tcache[k][:, block[0, :2]], before[k])
    scratch = {k: v.clone() for k, v in tcache.items()}
    fl, _ = tzoo.prefill_paged(tparams, tcfg, torch.from_numpy(t2),
                               torch.from_numpy(lens), torch.zeros(1),
                               torch.from_numpy(row), scratch)
    # the spliced prefix was quantised from slot 0's own prefill (another
    # batch shape: K/V equal to float32 rounding), whose page scales can
    # differ from a fresh pass's in the last bits: SHARE_TOL
    torch.testing.assert_close(tl, fl, rtol=SHARE_TOL, atol=SHARE_TOL)


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "zamba2-2.7b"])
def test_paged_trace_rule_tells_int8_from_bf16(arch):
    """The rule that holds the card's int8 pools against the CPU's
    (``parity.paged_trace`` under ``parity.traces_close``) resolves
    quantisation: two CPU runs pass exactly, and the same trace over a bf16
    pool, a level moved by 2, or a scale row moved by 1% fails it."""
    cfg = ARCHS[arch].reduced()
    params = tzoo.init_params(torch.Generator().manual_seed(2), cfg)
    ref = paged_trace(params, cfg, torch.int8)
    tol = TRACE_LOGIT_TOL[arch]
    assert traces_close(paged_trace(params, cfg, torch.int8), ref, tol) \
        == (0.0, 0, 0.0)
    bf16 = paged_trace(params, cfg, torch.bfloat16)
    with pytest.raises(AssertionError, match="logits differ"):
        traces_close((bf16[0], ref[1]), ref, tol)
    pool = dict(ref[1], kp=ref[1]["kp"].copy(), vs=ref[1]["vs"].copy())
    pool["kp"][0, 13, 3, 0, 0] += 2 if pool["kp"][0, 13, 3, 0, 0] < 0 else -2
    with pytest.raises(AssertionError, match="kp: a level 2 steps off"):
        traces_close((ref[0], pool), ref, tol)
    pool["kp"] = ref[1]["kp"]
    pool["vs"][0, 13] *= 1.01
    with pytest.raises(AssertionError, match="scale rows differ"):
        traces_close((ref[0], pool), ref, tol)


# ---------------------------------------------------------------------------
# scale rows move with their pages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kh", [1, 2, 4])
def test_copy_pages_int8_pool_with_scales(kh):
    """tests/test_kv_quant.py:130: the int8 pools and their (L, P, K) scale
    rows (4, 8 and 16 bytes a row) in one call, equal to the reference's
    ``copy_pages`` over each tensor."""
    rng = np.random.default_rng(kh)
    pool = rng.integers(-127, 128, (2, 6, 4, kh, 16)).astype(np.int8)
    scale = rng.random((2, 6, kh)).astype(np.float32)
    src = np.array([4, 2, 0], np.int32)
    dst = np.array([1, 3, 0], np.int32)
    want = [np.asarray(jops.copy_pages(jnp.asarray(x), jnp.asarray(src),
                                       jnp.asarray(dst)))
            for x in (pool, pool[::-1], scale, scale[::-1])]
    np.testing.assert_array_equal(
        want[2], np.asarray(JL.cow_copy_scales(jnp.asarray(scale),
                                               jnp.asarray(src),
                                               jnp.asarray(dst))))
    got = [torch.from_numpy(np.ascontiguousarray(x))
           for x in (pool, pool[::-1], scale, scale[::-1])]
    ops.copy_pages(got, src, dst)
    for g, w in zip(got, want):
        assert g.numpy().dtype == w.dtype
        np.testing.assert_array_equal(g.numpy(), w)
    np.testing.assert_array_equal(got[2].numpy()[:, 1], scale[:, 4])
    with pytest.raises(ValueError, match="CUDA"):
        cp.copy_pages_cuda(got, src, dst)


def test_cow_pages_moves_scale_rows_as_the_reference():
    jcfg, _, tcfg, _ = _bridged("zamba2-2.7b")
    rng = np.random.default_rng(5)
    jcache = jzoo.init_paged_cache(jcfg, 2, 9, PAGE, jnp.int8)
    jcache = dict(jcache, **{k: jnp.asarray(rng.integers(
        -127, 128, jcache[k].shape), jnp.int8) for k in ("kp", "vp")},
        **{k: jnp.asarray(rng.random(jcache[k].shape), jnp.float32)
           for k in ("ks", "vs")})
    tcache = _to_port(jcache)
    src, dst = np.array([3, 5, 0], np.int32), np.array([7, 2, 0], np.int32)
    jcache = jzoo.cow_pages(jcfg, jcache, jnp.asarray(src), jnp.asarray(dst),
                            use_kernel=True)
    tzoo.cow_pages(tcfg, tcache, src, dst)
    for k in ("kp", "vp", "ks", "vs", "state", "conv"):
        np.testing.assert_array_equal(
            tcache[k].float().numpy(), _np(jcache[k]))


# ---------------------------------------------------------------------------
# the pool and the serving stack
# ---------------------------------------------------------------------------

def test_pool_gauges_report_quant_footprint():
    """tests/test_kv_quant.py:158 on the port: kv_bits 8 for int8 and 16
    for bf16 (the port's float32 pool reports 32), and the int8 pool (pages
    + scale rows) in <= 0.55x the bf16 bytes; ``check_invariants`` checks
    the scale rows."""
    cfg = ARCHS["qwen2-1.5b"].reduced()
    kw = dict(num_slots=4, max_context=32, page_size=8, device="cpu")
    g16 = KVPool(cfg, dtype=torch.bfloat16, **kw).gauges()
    pool8 = KVPool(cfg, dtype=torch.int8, **kw)
    g8 = pool8.gauges()
    g32 = KVPool(cfg, dtype=torch.float32, **kw).gauges()
    assert (g16["kv_bits"], g8["kv_bits"], g32["kv_bits"]) == (16, 8, 32)
    assert g16["kv_bytes_total"] == g16["bytes_per_slot"] * 4
    assert g8["kv_bytes_total"] <= 0.55 * g16["kv_bytes_total"]
    for g in (g16, g8):
        assert all(isinstance(v, int) for v in g.values())
    jg8 = __import__("repro.serving.kv_pool", fromlist=["KVPool"]).KVPool(
        JAX_ARCHS["qwen2-1.5b"].reduced(), num_slots=4, max_context=32,
        page_size=8, dtype=jnp.int8).gauges()
    assert {k: g8[k] for k in jg8} == jg8
    pool8.check_invariants()
    pool8.buffers["vs"] = pool8.buffers["vs"].double()
    with pytest.raises(AssertionError, match="float32"):
        pool8.check_invariants()


def _qwen_engine(max_new=3):
    return build_engine(ARCHS["qwen2-1.5b"].reduced(),
                        HIConfig(theta=0.6, capacity_factor=1.0),
                        max_new_tokens=max_new, cache_len=32, device="cpu")


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_stream_one_compile_one_sync_both_dtypes(monkeypatch, kv_dtype):
    """tests/test_kv_quant.py:187 on the port: one scheduler build and one
    device->host fetch per tick in either dtype, invariants (scale rows
    included) after every tick."""
    calls = []
    real = engine_mod._host_fetch
    monkeypatch.setattr(engine_mod, "_host_fetch",
                        lambda tree: (calls.append(1), real(tree))[1])
    cfg = ARCHS["qwen2-1.5b"].reduced()
    eng = _qwen_engine()
    rng = np.random.default_rng(0)
    reqs = [Request(i, rng.integers(0, cfg.vocab_size, n).astype(np.int32),
                    max_new_tokens=3) for i, n in enumerate([8, 16, 8])]
    eng.serve_stream(reqs, buckets=(8, 16), num_slots=2, page_size=8,
                     kv_dtype=kv_dtype, validate=True)
    assert eng.stats["stream_compiles"] == 1
    assert len(calls) == eng.stats["stream_ticks"] > 0
    pool = eng._stream[1].srt.pool
    assert pool.kv_dtype == ("int8" if kv_dtype == "int8" else "bfloat16")
    assert ("ks" in pool.buffers) == (kv_dtype == "int8")


def _repeated(cfg, seed=3):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, cfg.vocab_size, 8).astype(np.int32)

    def mk(n):
        return np.concatenate(
            [base, rng.integers(0, cfg.vocab_size, n).astype(np.int32)])

    p1, p2 = mk(4), mk(8)
    return [(i, p) for i, p in enumerate([p1, p2, p1, p2, p1])]


def test_int8_prefix_sharing_cow_moves_scale_rows():
    """tests/test_kv_quant.py:212 on the port: repeated prompts in a bucket
    that is not page-aligned force full restores and COW tail copies on an
    int8 pool; invariants hold every tick and the restored continuations
    equal the unshared engine's tokens.  On bridged params the statuses and
    tokens equal the reference's int8 stream (``use_kernel=False``)."""
    jcfg, jparams, tcfg, tparams = _bridged("qwen2-1.5b")
    trace = _repeated(tcfg)
    kw = dict(buckets=(12, 16), num_slots=2, page_size=8, kv_dtype="int8",
              validate=True)
    hi = HIConfig(theta=0.6, capacity_factor=1.0)
    eng_on = _qwen_engine()
    on = eng_on.serve_stream([Request(i, p, max_new_tokens=3)
                              for i, p in trace], prefix_sharing=True, **kw)
    off = _qwen_engine().serve_stream([Request(i, p, max_new_tokens=3)
                                       for i, p in trace],
                                      prefix_sharing=False, **kw)
    stats = eng_on._stream[1].prefix_stats
    assert stats["full_hits"] > 0 and stats["cow_copies"] > 0
    for rid in off:
        np.testing.assert_array_equal(on[rid]["tokens"], off[rid]["tokens"])
    eng_on._stream[1].srt.pool.check_invariants()
    eng_on._stream[1].lrt.pool.check_invariants()

    # the same trace through both packages on the reference's params
    from repro.serving.batcher import Request as JRequest
    from repro_torch.serving.engine import HIEngine, TierModel
    jeng = jax_build_engine(jcfg, JHIConfig(theta=0.6, capacity_factor=1.0),
                            max_new_tokens=3, cache_len=32)
    teng = HIEngine(*[TierModel(c, params_from_numpy(
        jax.tree.map(np.asarray, t.params), device="cpu"))
        for c, t in ((tcfg.s_variant(4), jeng.s), (tcfg, jeng.l))],
        hi, max_new_tokens=3)
    ref = jeng.serve_stream([JRequest(i, p, max_new_tokens=3)
                             for i, p in trace], prefix_sharing=True, **kw)
    got = teng.serve_stream([Request(i, p, max_new_tokens=3)
                             for i, p in trace], prefix_sharing=True, **kw)
    assert teng._stream[1].prefix_stats["cow_copies"] > 0
    for rid in ref:
        assert got[rid]["status"] == ref[rid]["status"]
        np.testing.assert_array_equal(got[rid]["s_tokens"],
                                      ref[rid]["s_tokens"])


def test_int8_teacher_forced_gate_on_reduced_zamba2():
    """The reference's int8 gate (benchmarks/bench_serving.py:564-606):
    reduced zamba2-2.7b, its params (seed 0, bridged), prompts from numpy
    seed 1, 8 slots, 16 steps, page 8, prompt 16: the port's bf16 and int8
    pools agree on >= 99% of the 136 teacher-forced greedy decisions."""
    _, _, tcfg, tparams = _bridged("zamba2-2.7b")
    match, total, err = int8_agreement(tparams, tcfg)
    assert total == 136
    assert match / total >= 0.99, f"agreement {match}/{total}, err {err}"
