"""The port's paged KV path against the JAX reference, at reduced size.

* The plain versions of the three paged kernels (``decode_attention_paged``,
  ``decode_attention_chunk_paged``, ``copy_pages``) against the reference's
  Pallas kernels in interpret mode, on the same seeded numpy inputs.
* The paged model API (``prefill_paged`` with and without ``start``,
  ``decode_step_paged``, ``forward_chunk_paged``, ``cow_pages``) against the
  reference's on bridged params, for reduced qwen2-1.5b and gemma3-1b.
* The reference's ``KVPool`` host cases (``tests/test_kv_pool.py`` and the
  pool cases of ``tests/test_chunk_lane.py``) re-stated on the port's pool.

Tolerances.  The plain attention versions and the Pallas kernels both keep q
in float32 and accumulate in float32; they differ only in the order of the
sums (one softmax over all keys against an online softmax over pages):
``ATT_TOL`` = 3e-5 over a few dozen keys.  Model logits: ``LOGIT_TOL`` =
5e-3, because a float32 sum in another order can round a K/V value to the
neighbouring bf16 step, as the contiguous-cache tests of
``test_torch_model.py`` found; bf16 pools are compared within
``POOL_TOL`` = 2e-2, two bf16 steps at the pools' magnitude.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCHS as JAX_ARCHS
from repro.kernels import ops as jops
from repro.models import model_zoo as jzoo
from repro.serving.batcher import prompt_hashes as jax_prompt_hashes
from repro_torch.bridge import params_from_numpy
from repro_torch.configs.base import ENCDEC
from repro_torch.configs.registry import ARCHS
from repro_torch.kernels import copy_pages as cp
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import ops
from repro_torch.models import model_zoo as tzoo
from repro_torch.parity import greedy_agreement
from repro_torch.serving.batcher import prompt_hashes
from repro_torch.serving.kv_pool import KVPool

ATT_TOL = 3e-5
LOGIT_TOL = 5e-3
POOL_TOL = 2e-2
PAGE = 8


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


# ---------------------------------------------------------------------------
# the plain kernel versions against the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------

def _paged_case(seed, b=3, h=4, kh=2, d=16, page=4, npg=5, c=1, window=None,
                dtype=np.float32):
    """Shuffled physical pages; slot 1 holds fewer pages than its row (the
    rest point at the null page 0); slot 2 sees no key at all."""
    rng = np.random.default_rng(seed)
    p = b * npg + 1
    pool_k = rng.normal(size=(p, page, kh, d)).astype(np.float32)
    pool_v = rng.normal(size=(p, page, kh, d)).astype(np.float32)
    perm = rng.permutation(np.arange(1, p)).astype(np.int32)
    block = perm[: b * npg].reshape(b, npg)
    block[1, 4:] = 0                                 # null-page tail
    q = rng.normal(size=(b, c, h, d)).astype(np.float32)
    pos = np.array([page * npg - c, 2 * page + 1, 0], np.int32)[:b]
    qpos = pos[:, None] + np.arange(c)[None, :]
    kpos = np.arange(npg * page)
    valid = kpos[None, None, :] <= qpos[:, :, None]
    if window is not None:
        valid &= qpos[:, :, None] - kpos[None, None, :] < window
    valid[2] = False                                 # a fully masked slot
    if dtype != np.float32:
        pool_k = np.asarray(jnp.asarray(pool_k, dtype), np.float32)
        pool_v = np.asarray(jnp.asarray(pool_v, dtype), np.float32)
    return q, pool_k, pool_v, block, valid


def _torch_pools(pool_k, pool_v, dtype):
    return (torch.from_numpy(pool_k).to(dtype),
            torch.from_numpy(pool_v).to(dtype))


@pytest.mark.parametrize("window", [None, 6])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [16, 120])
def test_paged_decode_plain_matches_pallas(window, dtype, d):
    q, pk, pv, block, valid = _paged_case(0, d=d, window=window,
                                          dtype=jnp.bfloat16
                                          if dtype == torch.bfloat16
                                          else np.float32)
    jd = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    ref = _np(jops.decode_attention_paged(
        jnp.asarray(q), jnp.asarray(pk, jd), jnp.asarray(pv, jd),
        jnp.asarray(block), jnp.asarray(valid[:, 0])))
    tk, tv = _torch_pools(pk, pv, dtype)
    got = da.decode_attention_paged_plain(torch.from_numpy(q), tk, tv,
                                          torch.from_numpy(block),
                                          torch.from_numpy(valid[:, 0]))
    np.testing.assert_allclose(got.numpy(), ref, rtol=ATT_TOL, atol=ATT_TOL)
    assert (got[2] == 0).all()                       # no key: returns 0


@pytest.mark.parametrize("window", [None, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [16, 120])
def test_paged_chunk_plain_matches_pallas(window, dtype, d):
    q, pk, pv, block, valid = _paged_case(1, d=d, c=4, window=window,
                                          dtype=jnp.bfloat16
                                          if dtype == torch.bfloat16
                                          else np.float32)
    jd = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    ref = _np(jops.decode_attention_chunk_paged(
        jnp.asarray(q), jnp.asarray(pk, jd), jnp.asarray(pv, jd),
        jnp.asarray(block), jnp.asarray(valid)))
    tk, tv = _torch_pools(pk, pv, dtype)
    got = da.decode_attention_chunk_paged_plain(
        torch.from_numpy(q), tk, tv, torch.from_numpy(block),
        torch.from_numpy(valid))
    np.testing.assert_allclose(got.numpy(), ref, rtol=ATT_TOL, atol=ATT_TOL)


@pytest.mark.parametrize("chunk", [1, 4])
def test_paged_plain_skips_garbage_it_may_not_see(chunk):
    """Keys that no query of the slot may see (page 0, unallocated pages,
    the tail past the last query) may hold inf or NaN: the plain versions
    select them out and return what a clean pool gives."""
    q, pk, pv, block, valid = _paged_case(2, c=chunk)
    qt, vt, bt = (torch.from_numpy(q), torch.from_numpy(valid),
                  torch.from_numpy(block))
    fn = da.decode_attention_chunk_paged_plain
    clean = fn(qt, torch.from_numpy(pk), torch.from_numpy(pv), bt, vt)
    seen = valid.any(axis=1)                         # (B, S_tot)
    dirty_k, dirty_v = pk.copy(), pv.copy()
    page = pk.shape[1]
    dirty_k[0], dirty_v[0] = np.nan, np.inf          # the null page
    for b in range(block.shape[0]):
        for s in np.flatnonzero(~seen[b]):
            pg = block[b, s // page]
            dirty_k[pg, s % page] = np.nan
            dirty_v[pg, s % page] = -np.inf
    got = fn(qt, torch.from_numpy(dirty_k), torch.from_numpy(dirty_v), bt, vt)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, clean, rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16])
def test_copy_pages_plain_matches_pallas(dtype):
    rng = np.random.default_rng(3)
    pool = rng.normal(size=(3, 7, 4, 2, 8)).astype(np.float32)
    pool = np.array(jnp.asarray(pool, dtype), np.float32)
    src = np.array([4, 2, 0, 0], np.int32)           # (0, 0) pads
    dst = np.array([1, 6, 0, 0], np.int32)
    jd = jnp.float32 if dtype == np.float32 else jnp.bfloat16
    ref = _np(jops.copy_pages(jnp.asarray(pool, jd), jnp.asarray(src),
                              jnp.asarray(dst)))
    td = torch.float32 if dtype == np.float32 else torch.bfloat16
    a = torch.from_numpy(pool).to(td)
    b = torch.from_numpy(pool[::-1].copy()).to(td)
    b_ref = _np(jops.copy_pages(jnp.asarray(pool[::-1].copy(), jd),
                                jnp.asarray(src), jnp.asarray(dst)))
    cp.copy_pages_plain((a, b), src, dst)
    np.testing.assert_array_equal(a.float().numpy(), ref)
    np.testing.assert_array_equal(b.float().numpy(), b_ref)
    ops.copy_pages((a,), src, dst)                   # device dispatch: CPU
    np.testing.assert_array_equal(a.float().numpy(), ref)


@pytest.mark.parametrize("src,dst,match", [
    ([3, 2], [2, 5], "also a source"),
    ([3, 4], [5, 5], "repeat"),
    ([3], [0], "null page"),
    ([3, 0], [5], "length"),
])
def test_copy_pages_refuses_order_dependent_pairs(src, dst, match):
    pool = torch.zeros((2, 6, 4, 1, 8))
    with pytest.raises(ValueError, match=match):
        cp.copy_pages_plain((pool,), np.array(src), np.array(dst))


def test_paged_cuda_wrappers_refuse_cpu_tensors():
    q, pk, pv, block, valid = _paged_case(0)
    args = (torch.from_numpy(q), torch.from_numpy(pk), torch.from_numpy(pv),
            torch.from_numpy(block), torch.from_numpy(valid[:, 0]))
    with pytest.raises(ValueError, match="CUDA"):
        da.decode_attention_paged_cuda(*args)
    with pytest.raises(ValueError, match="CUDA"):
        da.decode_attention_chunk_paged_cuda(
            *args[:4], torch.from_numpy(valid))
    with pytest.raises(ValueError, match="CUDA"):
        cp.copy_pages_cuda((torch.zeros(2, 4, 16),), [1], [2])


# ---------------------------------------------------------------------------
# the paged model API against the reference
# ---------------------------------------------------------------------------

SLOTS, NPG, PROMPT = 2, 6, 16


@pytest.fixture(scope="module", params=["qwen2-1.5b", "gemma3-1b"])
def model(request):
    arch = request.param
    jcfg, tcfg = JAX_ARCHS[arch].reduced(), ARCHS[arch].reduced()
    jparams = jzoo.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams),
                                 device="cpu")
    return jcfg, jparams, tcfg, tparams


def _pools_close(jcache, tcache):
    """Every page but the null page 0, which takes redirected and padded
    rows' writes in an order neither package fixes."""
    for key in ("kp", "vp"):
        np.testing.assert_allclose(tcache[key][:, 1:].float().numpy(),
                                   _np(jcache[key])[:, 1:], rtol=POOL_TOL,
                                   atol=POOL_TOL)


def _setup(model, seed=0):
    """Both packages' pools with SLOTS prompts prefilled, shuffled pages."""
    jcfg, jparams, tcfg, tparams = model
    rng = np.random.default_rng(seed)
    n_pages = SLOTS * NPG + 4
    block = (rng.permutation(np.arange(1, n_pages))[: SLOTS * NPG]
             .astype(np.int32).reshape(SLOTS, NPG))
    toks = rng.integers(0, jcfg.vocab_size, (SLOTS, PROMPT)).astype(np.int32)
    lens = np.array([PROMPT, PROMPT - 5], np.int32)
    jcache = jzoo.init_paged_cache(jcfg, SLOTS, n_pages, PAGE)
    tcache = tzoo.init_paged_cache(tcfg, SLOTS, n_pages, PAGE, device="cpu")
    jl, jcache = jzoo.prefill_paged(jparams, jcfg, jnp.asarray(toks),
                                    jnp.asarray(lens),
                                    jnp.arange(SLOTS, dtype=jnp.int32),
                                    jnp.asarray(block), jcache)
    tl, tcache = tzoo.prefill_paged(tparams, tcfg, torch.from_numpy(toks),
                                    torch.from_numpy(lens),
                                    torch.arange(SLOTS),
                                    torch.from_numpy(block), tcache)
    return rng, block, toks, lens, jl, tl, jcache, tcache


def test_prefill_paged_matches_reference(model):
    _, block, _, _, jl, tl, jcache, tcache = _setup(model)
    np.testing.assert_allclose(tl.numpy(), _np(jl), rtol=LOGIT_TOL,
                               atol=LOGIT_TOL)
    _pools_close(jcache, tcache)
    # nothing but the prompts' pages was written
    used = set(block[:, : PROMPT // PAGE].ravel().tolist())
    other = [p for p in range(tcache["kp"].shape[1]) if p not in used]
    assert (tcache["kp"][:, other] == 0).all()


def test_prefill_paged_with_start_splices_the_prefix(model):
    """A second admission shares slot 0's first two pages (start = 16): the
    port splices them from the pool and writes only the suffix pages, as the
    reference does, and its logits equal a from-scratch prefill's."""
    jcfg, jparams, tcfg, tparams = model
    rng, block, toks, _, _, _, jcache, tcache = _setup(model, seed=1)
    n_pages = tcache["kp"].shape[1]
    free = sorted(set(range(1, n_pages)) - set(block.ravel().tolist()))
    row = np.zeros((1, NPG), np.int32)
    row[0, :2] = block[0, :2]                         # aliased prefix
    row[0, 2:5] = free[:3]
    t2 = np.concatenate([toks[0], rng.integers(0, jcfg.vocab_size, 8)
                         .astype(np.int32)])[None, :]
    lens, start = np.array([24], np.int32), np.array([16], np.int32)
    before = tcache["kp"][:, block[0, :2]].clone()
    jl, jcache = jzoo.prefill_paged(
        jparams, jcfg, jnp.asarray(t2), jnp.asarray(lens),
        jnp.zeros((1,), jnp.int32), jnp.asarray(row), jcache,
        start=jnp.asarray(start))
    tl, tcache = tzoo.prefill_paged(
        tparams, tcfg, torch.from_numpy(t2), torch.from_numpy(lens),
        torch.zeros(1), torch.from_numpy(row), tcache,
        start=torch.from_numpy(start))
    np.testing.assert_allclose(tl.numpy(), _np(jl), rtol=LOGIT_TOL,
                               atol=LOGIT_TOL)
    _pools_close(jcache, tcache)
    assert torch.equal(tcache["kp"][:, block[0, :2]], before)  # read-only
    # the same prompt prefilled from scratch gives the same logits
    scratch = tzoo.init_paged_cache(tcfg, 1, n_pages, PAGE, device="cpu")
    fl, _ = tzoo.prefill_paged(tparams, tcfg, torch.from_numpy(t2),
                               torch.from_numpy(lens), torch.zeros(1),
                               torch.from_numpy(row), scratch)
    np.testing.assert_allclose(tl.numpy(), fl.numpy(), rtol=1e-5, atol=1e-5)


def _decode_both(model, jcache, tcache, token, pos, block, wblock=None):
    jcfg, jparams, tcfg, tparams = model
    jl, jcache = jzoo.decode_step_paged(
        jparams, jcfg, jnp.asarray(token), jnp.asarray(pos),
        jnp.asarray(block), jcache, use_kernel=True,
        write_block=None if wblock is None else jnp.asarray(wblock))
    tl, tcache = tzoo.decode_step_paged(
        tparams, tcfg, torch.from_numpy(token), torch.from_numpy(pos),
        torch.from_numpy(block), tcache,
        write_block=None if wblock is None else torch.from_numpy(wblock))
    return _np(jl), tl.numpy(), jcache, tcache


def test_decode_step_paged_matches_reference(model):
    """Three decode steps at per-slot positions, teacher-forced: logits
    within tolerance, decisive greedy tokens equal, pools close.  The
    reference runs its Pallas kernel (q kept in float32, as the port)."""
    rng, block, toks, lens, _, _, jcache, tcache = _setup(model, seed=2)
    pos = lens.copy()
    js, ts = [], []
    for _ in range(3):
        token = rng.integers(0, model[0].vocab_size, (SLOTS, 1)) \
            .astype(np.int32)
        jl, tl, jcache, tcache = _decode_both(model, jcache, tcache, token,
                                              pos, block)
        js.append(jl)
        ts.append(tl)
        pos = pos + 1
    js, ts = np.stack(js), np.stack(ts)
    np.testing.assert_allclose(ts, js, rtol=LOGIT_TOL, atol=LOGIT_TOL)
    n, agree = greedy_agreement(js, ts, LOGIT_TOL)
    assert n > 0 and agree == n
    _pools_close(jcache, tcache)


def test_decode_step_paged_write_block_masks_shared_pages(model):
    """A write_block row masked to the null page drops the append: the
    slot's real pages keep their content."""
    rng, block, _, lens, _, _, jcache, tcache = _setup(model, seed=3)
    wblock = block.copy()
    wblock[1] = 0
    before = tcache["kp"][:, block[1]].clone()
    token = rng.integers(0, model[0].vocab_size, (SLOTS, 1)).astype(np.int32)
    jl, tl, jcache, tcache = _decode_both(model, jcache, tcache, token, lens,
                                          block, wblock)
    np.testing.assert_allclose(tl, jl, rtol=LOGIT_TOL, atol=LOGIT_TOL)
    assert torch.equal(tcache["kp"][:, block[1]], before)
    _pools_close(jcache, tcache)


def test_forward_chunk_paged_matches_reference_and_steps(model):
    """One C = 4 chunk pass: against the reference's chunk pass (Pallas),
    and against four of the port's own decode steps (the reference's
    chunk == per-token property, tests/test_chunk_lane.py:77)."""
    jcfg, jparams, tcfg, tparams = model
    rng, block, _, lens, _, _, jcache, tcache = _setup(model, seed=4)
    chunk = rng.integers(0, jcfg.vocab_size, (SLOTS, 4)).astype(np.int32)
    step_cache = {k: v.clone() for k, v in tcache.items()}
    jl, jcache, _ = jzoo.forward_chunk_paged(
        jparams, jcfg, jnp.asarray(chunk), jnp.asarray(lens),
        jnp.asarray(block), jcache, use_kernel=True)
    tl, tcache, staged = tzoo.forward_chunk_paged(
        tparams, tcfg, torch.from_numpy(chunk), torch.from_numpy(lens),
        torch.from_numpy(block), tcache)
    assert staged == {}
    np.testing.assert_allclose(tl.numpy(), _np(jl), rtol=LOGIT_TOL,
                               atol=LOGIT_TOL)
    _pools_close(jcache, tcache)
    steps = []
    for i in range(4):
        sl, step_cache = tzoo.decode_step_paged(
            tparams, tcfg, torch.from_numpy(chunk[:, i:i + 1]),
            torch.from_numpy(lens + i), torch.from_numpy(block), step_cache)
        steps.append(sl)
    steps = torch.stack(steps, dim=1)
    # one (B, C, D) matmul against C (B, 1, D) ones: identical math, the
    # low-order bits of the sums may differ (the reference's 1e-4)
    torch.testing.assert_close(tl, steps, rtol=1e-4, atol=1e-4)
    assert torch.equal(tl.argmax(-1), steps.argmax(-1))
    for key in ("kp", "vp"):
        assert torch.equal(tcache[key], step_cache[key])


def test_cow_pages_matches_reference(model):
    jcfg, _, tcfg, _ = model
    _, block, _, _, _, _, jcache, tcache = _setup(model, seed=5)
    free = sorted(set(range(1, tcache["kp"].shape[1]))
                  - set(block.ravel().tolist()))
    src = np.array([block[0, 1], block[1, 0], 0], np.int32)
    dst = np.array([free[0], free[1], 0], np.int32)
    jcache = jzoo.cow_pages(jcfg, jcache, jnp.asarray(src), jnp.asarray(dst),
                            use_kernel=True)
    tzoo.cow_pages(tcfg, tcache, src, dst)
    _pools_close(jcache, tcache)
    for key in ("kp", "vp"):
        assert torch.equal(tcache[key][:, free[0]], tcache[key][:, block[0, 1]])


def test_prefix_cache_has_a_drop_row():
    cfg = ARCHS["qwen2-1.5b"].reduced()
    prefix = tzoo.init_prefix_cache(cfg, 3, device="cpu")
    assert prefix["logits"].shape == (4, cfg.vocab_size)


def test_paged_api_refuses_encdec_and_float16_pools():
    """The enc-dec family has no paged API (the reference's ValueError);
    a pool dtype other than bf16, float32 or int8 is refused."""
    cfg = dataclasses.replace(ARCHS["qwen2-1.5b"].reduced(), family=ENCDEC)
    with pytest.raises(ValueError,
                       match="paged cache not supported for family 'encdec'"):
        tzoo.init_paged_cache(cfg, 2, 8, PAGE, dtype=torch.int8,
                              device="cpu")
    with pytest.raises(ValueError, match="int8"):
        tzoo.init_paged_cache(ARCHS["qwen2-1.5b"].reduced(), 2, 8, PAGE,
                              dtype=torch.float16, device="cpu")


# ---------------------------------------------------------------------------
# KVPool host cases (tests/test_kv_pool.py, tests/test_chunk_lane.py)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cfg():
    return ARCHS["qwen2-1.5b"].reduced()


def _pool(cfg, **kw):
    return KVPool(cfg, device="cpu", **kw)


def test_prompt_hashes_match_reference():
    toks = np.arange(21, dtype=np.int32)
    assert prompt_hashes(toks, 8) == jax_prompt_hashes(toks, 8)
    assert prompt_hashes(toks[:16], 8) == jax_prompt_hashes(toks[:16], 8)


def test_alloc_free_roundtrip(cfg):
    pool = _pool(cfg, num_slots=4, max_context=32, page_size=8)
    total = pool.free_pages
    assert total == 4 * 4
    pool.alloc(0, 20)
    assert pool.free_pages == total - 3
    assert len(pool.owned(0)) == 3
    assert (pool.block[0][3:] == 0).all()
    assert (pool.block[0][:3] > 0).all()
    pool.check_invariants()
    pool.free(0)
    assert pool.free_pages == total
    assert (pool.block[0] == 0).all()
    pool.check_invariants()


def test_owned_pages_disjoint_across_slots(cfg):
    pool = _pool(cfg, num_slots=4, max_context=32, page_size=8)
    for slot in range(4):
        pool.alloc(slot, 32)
    owned = [p for s in range(4) for p in pool.owned(s)]
    assert len(set(owned)) == len(owned)
    assert 0 not in owned
    assert pool.free_pages == 0
    pool.check_invariants()


def test_exhaustion_and_misuse_raise(cfg):
    pool = _pool(cfg, num_slots=2, max_context=16, page_size=8, num_pages=3)
    pool.alloc(0, 16)
    with pytest.raises(ValueError, match="exhausted"):
        pool.alloc(1, 8)
    with pytest.raises(ValueError, match="already holds"):
        pool.alloc(0, 8)
    pool.free(0)
    with pytest.raises(ValueError, match="holds no pages"):
        pool.free(0)
    with pytest.raises(ValueError, match="per-slot maximum"):
        pool.alloc(0, 999)


def test_free_hardening(cfg):
    pool = _pool(cfg, num_slots=3, max_context=32, page_size=8)
    pool.alloc(0, 32)
    pool.free(0)
    with pytest.raises(ValueError, match="[Dd]ouble free"):
        pool.free(0)
    with pytest.raises(ValueError, match="holds no pages"):
        pool.free(1)
    with pytest.raises(ValueError, match="out of range"):
        pool.free(7)
    with pytest.raises(ValueError, match="out of range"):
        pool.alloc(-1, 8)
    pool.alloc(2, 16)
    pool._refs[pool.owned(2)[0]] = 0
    with pytest.raises(ValueError, match="foreign free"):
        pool.free(2)


def test_refcount_conservation_invariant(cfg):
    pool = _pool(cfg, num_slots=2, max_context=32, page_size=8)
    pool.alloc(0, 24)
    pool.alloc(1, 16)
    pool.check_invariants()
    pool._refs[pool.owned(0)[0]] += 1
    with pytest.raises(AssertionError, match="refcount conservation"):
        pool.check_invariants()
    pool._refs[pool.owned(0)[0]] -= 1
    pool.check_invariants()
    pool._free.append(pool.owned(1)[0])
    with pytest.raises(AssertionError):
        pool.check_invariants()


def test_prefix_admission_aliases_and_refcounts(cfg):
    pool = _pool(cfg, num_slots=2, max_context=32, page_size=8, num_pages=24,
                 prefix_entries=2)
    rng = np.random.default_rng(0)
    t1 = rng.integers(0, cfg.vocab_size, 24).astype(np.int32)
    t2 = np.concatenate([t1[:16], rng.integers(0, cfg.vocab_size, 8)
                         .astype(np.int32)])
    h1, f1 = prompt_hashes(t1, 8)
    h2, f2 = prompt_hashes(t2, 8)
    plan1 = pool.admit_prefix(0, 28, 24, h1, f1, tick=0)
    assert plan1.start == 0 and plan1.save_row >= 0
    pool.check_invariants()
    prompt_pages = pool.owned(0)[:3]
    plan2 = pool.admit_prefix(1, 28, 24, h1, f1, tick=1)
    assert plan2.is_restore and plan2.start == 24
    assert pool.owned(1)[:3] == prompt_pages
    assert (pool._refs[prompt_pages] >= 3).all()
    pool.check_invariants()
    pool.free(1)
    assert set(pool.owned(0)) >= set(prompt_pages)
    pool.check_invariants()
    pool.free(0)
    assert not (set(prompt_pages) & set(pool._free))
    pool.check_invariants()
    plan3 = pool.admit_prefix(0, 28, 24, h2, f2, tick=2)
    assert not plan3.is_restore and plan3.start == 16
    assert pool.owned(0)[:2] == prompt_pages[:2]
    pool.check_invariants()


def test_restore_of_partial_tail_schedules_cow(cfg):
    """A full restore of a prompt whose last page is partial copies that
    page (copy-on-write) instead of appending into the retained one."""
    pool = _pool(cfg, num_slots=2, max_context=32, page_size=8,
                 prefix_entries=2)
    toks = np.arange(20, dtype=np.int32)
    h, f = prompt_hashes(toks, 8)
    pool.admit_prefix(0, 24, 20, h, f, tick=0)
    tail = pool.owned(0)[2]
    plan = pool.admit_prefix(1, 24, 20, h, f, tick=1)
    assert plan.is_restore and plan.cow is not None and plan.cow[0] == tail
    assert pool.block[1, 2] == plan.cow[1] != tail
    assert pool.stats["cow_copies"] == 1
    wb = pool.write_block()
    assert wb[1, 0] == 0 and wb[1, 2] == plan.cow[1]  # shared pages masked
    pool.check_invariants()


def test_failed_eviction_preserves_index(cfg):
    pool = _pool(cfg, num_slots=2, max_context=32, page_size=8, num_pages=5,
                 prefix_entries=2)
    rng = np.random.default_rng(2)
    t1 = rng.integers(0, cfg.vocab_size, 32).astype(np.int32)
    t2 = rng.integers(0, cfg.vocab_size, 32).astype(np.int32)
    h1, f1 = prompt_hashes(t1, 8)
    h2, f2 = prompt_hashes(t2, 8)
    pool.admit_prefix(0, 32, 32, h1, f1, tick=0)
    idx_before = len(pool._page_index)
    full_before = len(pool._full_index)
    assert pool.admit_prefix(1, 32, 32, h2, f2, tick=1) is None
    assert len(pool._page_index) == idx_before
    assert len(pool._full_index) == full_before
    pool.check_invariants()
    pool.free(0)
    assert pool.admit_prefix(1, 32, 32, h1, f1, tick=2).is_restore
    pool.check_invariants()


def test_prefix_eviction_reclaims_index_pages(cfg):
    pool = _pool(cfg, num_slots=2, max_context=64, page_size=8, num_pages=9,
                 prefix_entries=2)
    rng = np.random.default_rng(1)
    t1 = rng.integers(0, cfg.vocab_size, 32).astype(np.int32)
    t2 = rng.integers(0, cfg.vocab_size, 32).astype(np.int32)
    h1, f1 = prompt_hashes(t1, 8)
    h2, f2 = prompt_hashes(t2, 8)
    pool.admit_prefix(0, 32, 32, h1, f1, tick=0)
    pool.free(0)
    pool.check_invariants()
    assert pool.free_pages == 4
    plan = pool.admit_prefix(0, 64, 32, h2, f2, tick=1)
    assert plan is not None and plan.start == 0
    assert pool.stats["evictions"] > 0
    pool.check_invariants()
    pool.free(0)
    assert not pool.admit_prefix(1, 32, 32, h1, f1, tick=2).is_restore
    pool.check_invariants()


def test_slot_reuse_recycles_pages(cfg):
    pool = _pool(cfg, num_slots=2, max_context=32, page_size=8)
    pool.alloc(0, 32)
    first = set(pool.owned(0))
    pool.alloc(1, 32)
    pool.free(0)
    pool.alloc(0, 32)
    assert set(pool.owned(0)) == first
    assert not set(pool.owned(0)) & set(pool.owned(1))
    pool.check_invariants()


def test_truncate_guards_shared_pages(cfg):
    pool = _pool(cfg, num_slots=2, max_context=32, page_size=8,
                 prefix_entries=2)
    hashes, full = prompt_hashes(np.arange(16, dtype=np.int32), 8)
    p0 = pool.admit_prefix(0, 32, 16, hashes, full, tick=0)
    assert p0 is not None and p0.start == 0
    pool.truncate(0, 17)
    pool.check_invariants()
    p1 = pool.admit_prefix(1, 32, 16, hashes, full, tick=1)
    assert p1 is not None and p1.start > 0
    with pytest.raises(ValueError, match="shared page"):
        pool.truncate(1, 0)
    pool.truncate(1, 17)
    pool.check_invariants()
    with pytest.raises(ValueError):
        pool.truncate(1, -1)


def test_retract_undoes_rolled_back_registrations(cfg):
    pool = _pool(cfg, num_slots=2, max_context=32, page_size=8,
                 prefix_entries=2)
    hashes, full = prompt_hashes(np.arange(16, dtype=np.int32), 8)
    plan = pool.admit_prefix(0, 32, 16, hashes, full, tick=0)
    assert plan is not None and plan.save_row >= 0
    pool.retract(0, hashes, full, tick=0)
    pool.free(0)
    pool.check_invariants()
    plan2 = pool.admit_prefix(0, 32, 16, hashes, full, tick=1)
    assert plan2 is not None and plan2.start == 0 and not plan2.is_restore
    pool.retract(1, hashes, full, tick=1)
    fe_hit, pages = pool.lookup(hashes, full, 16, tick=2)
    assert fe_hit is not None or pages
    pool.check_invariants()


def test_pool_layout_and_gauges(cfg):
    pool = _pool(cfg, num_slots=2, max_context=32, page_size=8,
                 prefix_entries=3)
    assert pool.buffers["kp"].shape == (cfg.num_layers, 9, 8,
                                        cfg.num_kv_heads,
                                        cfg.resolved_head_dim)
    assert pool.buffers["kp"].dtype == torch.bfloat16
    g = pool.gauges()
    assert g["kv_bits"] == 16 and g["kv_bytes_total"] == pool.kv_bytes_total
    assert pool.prefix_buffers["logits"].shape == (4, cfg.vocab_size)
    assert pool.held_slots == []
