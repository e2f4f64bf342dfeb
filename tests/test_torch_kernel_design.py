"""The arithmetic of the kernels' designs, on the CPU.

The CUDA kernels run only on the card (tests/test_torch_cuda.py holds them
against their plain versions there).  These tests hold the algorithms they
implement, written out in torch, against the reference and the plain
versions here:

* the drain kernel (``csrc/decode_attention.cu``) splits the cache
  positions into contiguous ranges, one block each, and merges the ranges'
  partial online-softmax states (m, l, acc) in a fixed order;
* the chunk kernel (``csrc/chunk_paged_attention.cu``) runs Q.K^T and P.V
  on bf16 tensor cores with float32 accumulators, splitting each float32
  operand into bf16 terms: hi = bf16(x), mid = bf16(x - hi) and
  lo = bf16(x - hi - mid);
* the paged decode kernel (``csrc/decode_attention_paged.cu``) splits each
  slot's keys into ranges of whole logical pages, zero rows (and zero
  scales) where no query looks, and merges the ranges in split order;
* the SSD kernel (``csrc/ssd_scan.cu``) runs C.B^T, W (dt x) and
  (w_end dt x)^T B on TF32 tensor cores, each float32 operand split into
  hi (x with its low 13 mantissa bits cleared) and lo = x - hi (of which
  the tensor core reads the top 19 bits), three passes (lo.hi, hi.lo,
  hi.hi);
* the gate (``csrc/hi_gate.cu``) splits each row of logits into
  ``gate_splits`` column ranges, one block each, and merges the ranges'
  (m, z, s1, t2, arg) states in split order;
* copy_pages' wrapper (``kernels/copy_pages.py``) prepares its launch on
  the host once per tuple of pools (``_launch_args``), which must equal
  what the wrapper computed per call before, refusals included.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels.decode_attention import decode_attention_pallas
from repro.kernels.hi_gate import hi_gate_pallas
from repro.kernels.ssd_scan import ssd_chunk_pallas
from repro_torch.kernels import copy_pages as cp
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import hi_gate as hg
from repro_torch.kernels import ssd_scan

NEG = -1e30
# the kernels' tolerance against their plain versions on the card
ATT_ATOL = 1e-4


# ---------------------------------------------------------------------------
# (a) the drain kernel: splits of positions, merged in order
# ---------------------------------------------------------------------------

def split_merge(q, cache_k, cache_v, valid, split_len):
    """The drain kernel's algorithm: each range of ``split_len`` positions
    gives a partial (m, l, acc) over its keys (m = -1e30, l = 0, acc = 0 for
    a range the mask excludes), then the partials merge in split order and
    the result is acc / max(l, 1e-30).  q (B, 1, H, D) float32, cache
    (B, S, K, D), valid (S,) bool."""
    b, _, h, d = q.shape
    s, kh = cache_k.shape[1], cache_k.shape[2]
    qg = q.reshape(b, kh, h // kh, d).float()
    parts = []
    for lo in range(0, s, split_len):
        hi = min(s, lo + split_len)
        vm = valid[lo:hi]
        sc = torch.einsum("bkgd,bskd->bkgs", qg,
                          cache_k[:, lo:hi].float()) / math.sqrt(d)
        sc = torch.where(vm, sc, NEG)
        m = sc.amax(dim=-1)
        p = torch.where(vm, torch.exp(sc - m[..., None]), 0.0)
        parts.append((m, p.sum(dim=-1),
                      torch.einsum("bkgs,bskd->bkgd", p,
                                   cache_v[:, lo:hi].float())))
    m_all = torch.stack([m for m, _, _ in parts]).amax(dim=0)
    l_all = torch.zeros_like(m_all)
    acc = torch.zeros_like(parts[0][2])
    for m, l, a in parts:                          # fixed order
        f = torch.exp(m - m_all)
        l_all = l_all + f * l
        acc = acc + f[..., None] * a
    out = acc / torch.clamp(l_all, min=1e-30)[..., None]
    return out.reshape(b, 1, h, d)


def _drain_case(seed, b, s, h, k, d):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, 1, h, d)).astype(np.float32),
            rng.normal(size=(b, s, k, d)).astype(np.float32),
            rng.normal(size=(b, s, k, d)).astype(np.float32))


def _pallas(q, ck, cv, valid, block_s=64):
    return np.asarray(decode_attention_pallas(
        jnp.asarray(q), jnp.asarray(ck), jnp.asarray(cv),
        jnp.asarray(valid), block_s=block_s, interpret=True))


@pytest.mark.parametrize("name,b,s,h,k,d,split,valid", [
    # the host's own split at a reduced L tier; the mask ends mid-range, so
    # the later ranges are empty
    ("prefix", 2, 256, 6, 2, 32, None, lambda kp: kp <= 150),
    # S not a multiple of the range; the mask true only in the last range
    ("last range only", 2, 200, 4, 1, 16, 64, lambda kp: kp >= 192),
    # gemma3's 256-token sliding window over a 512-position cache
    ("window 256", 1, 512, 4, 1, 16, None,
     lambda kp: (kp <= 400) & (400 - kp < 256)),
    ("all false", 2, 128, 4, 2, 16, 32, lambda kp: kp < 0),
])
def test_split_merge_matches_the_reference(name, b, s, h, k, d, split,
                                           valid):
    q, ck, cv = _drain_case(0, b, s, h, k, d)
    vm = valid(np.arange(s))
    split = split or da.drain_split_len(b, k, s)
    assert split % da.SPLIT_UNIT == 0 or split < s
    got = split_merge(torch.from_numpy(q), torch.from_numpy(ck),
                      torch.from_numpy(cv), torch.from_numpy(vm), split)
    want = _pallas(q, ck, cv, vm)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    if not vm.any():
        assert (got == 0).all()                    # no key: exactly 0


def test_split_len_comes_from_shapes_and_fills_the_card():
    """32-position ranges at the L tier (B 4, K 2, S 1,024): 256 blocks;
    wide batches take longer ranges, never more than 256 of them."""
    assert da.drain_split_len(4, 2, 1024) == 32
    assert da.drain_split_len(8, 1, 1024) == 32
    for b, k, s in [(1, 1, 100_000), (64, 8, 4096), (3, 2, 77), (1, 1, 1)]:
        split = da.drain_split_len(b, k, s)
        n = -(-s // split)
        assert split % da.SPLIT_UNIT == 0 and 1 <= n <= da.MAX_SPLITS
        assert b * k * n <= max(b * k, da.SPLIT_TARGET_BLOCKS)


# ---------------------------------------------------------------------------
# (b) the chunk kernel: bf16 tensor-core passes with float32 operands split
# ---------------------------------------------------------------------------

def _bf16(x):
    return x.to(torch.bfloat16).float()


def _terms(x, n):
    """x as n bf16 terms, each the bf16 rounding of what the others miss."""
    out = []
    for _ in range(n):
        out.append(_bf16(x))
        x = x - out[-1]
    return out


def chunk_tensor_core(q, pool_k, pool_v, block, valid, scale_k=None,
                      scale_v=None, passes=3, tile=64):
    """The chunk kernel's arithmetic in torch: key tiles of ``tile``
    positions, an online softmax per query row, every product of bf16
    operands summed in float32 as an MMA does.  ``passes``: the number of
    bf16 terms of q and of p (3 in the kernel: hi + mid + lo), or "tf32"
    (q and p rounded to TF32's 10 mantissa bits).  The pool operand is exact:
    bf16 values or int8 levels, scaled after Q.K^T (scale_k) and folded
    into p (scale_v).  Keys no query of the slot sees are zero rows with
    scale 0, as the kernel's zero-filled shared memory."""
    b, c, h, d = q.shape
    kh = pool_k.shape[2]
    g = h // kh
    idx = block.long()
    kk = pool_k[idx].float().reshape(b, -1, kh, d)          # (B, S, K, D)
    vv = pool_v[idx].float().reshape(b, -1, kh, d)
    s_tot = kk.shape[1]
    page = pool_k.shape[1]
    seen = valid.any(dim=1)                                 # (B, S)
    kk = torch.where(seen[..., None, None], kk, 0.0)
    vv = torch.where(seen[..., None, None], vv, 0.0)
    if scale_k is not None:
        rows = idx.repeat_interleave(page, dim=1)           # (B, S)
        sk = torch.where(seen[..., None], scale_k[rows], 0.0)  # (B, S, K)
        sv = torch.where(seen[..., None], scale_v[rows], 0.0)
    else:
        sk = sv = torch.ones((b, s_tot, kh))

    def operand(x):
        if passes == "tf32":
            r = x.view(torch.int32) & ~((1 << 13) - 1)
            return (r.view(torch.float32),)
        return _terms(x, passes)

    # rows (B, K, C*G), ordered by token
    qr = q.float().reshape(b, c, kh, g, d).permute(0, 2, 1, 3, 4) \
        .reshape(b, kh, c * g, d)
    vm = valid.repeat_interleave(g, dim=1)[:, None]         # (B, 1, CG, S)
    m = torch.full((b, kh, c * g), NEG)
    l = torch.zeros((b, kh, c * g))
    acc = torch.zeros((b, kh, c * g, d))
    for s0 in range(0, s_tot, tile):
        kt = kk[:, s0:s0 + tile].transpose(1, 2)            # (B, K, T, D)
        vt = vv[:, s0:s0 + tile].transpose(1, 2)
        mt = vm[..., s0:s0 + tile]
        sc = sum(x @ kt.transpose(-1, -2) for x in operand(qr))
        sc = sc / math.sqrt(d) * sk[:, s0:s0 + tile].transpose(1, 2)[:, :, None]
        sc = torch.where(mt, sc, NEG)
        m_new = torch.maximum(m, sc.amax(dim=-1))
        corr = torch.exp(m - m_new)
        p = torch.where(mt, torch.exp(sc - m_new[..., None]), 0.0)
        l = l * corr + p.sum(dim=-1)
        pv = p * sv[:, s0:s0 + tile].transpose(1, 2)[:, :, None]
        acc = acc * corr[..., None] + sum(x @ vt for x in operand(pv))
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(b, kh, c, g, d).permute(0, 2, 1, 3, 4) \
        .reshape(b, c, h, d)


def _chunk_case(pool, seed=0, b=2, c=64, h=12, k=2, d=128, page=16,
                npg=34):
    """qwen2's widths at C 64: slot 0's chunk at positions 0..63, slot 1's
    at 448..511, over shuffled pages; NaN / inf in every pool row (and, for
    int8, every page scale) no query of the slot sees.  ``pool``: "bf16"
    (normal values), "int8" (normal values quantised as the serving pools
    hold them: per page and kv head, scale = amax / 127 and levels =
    round(x / scale)) or "int8 full range" (the card checks' stress input:
    uniform levels in -128..127, scales up to 0.05)."""
    rng = np.random.default_rng(seed)
    p = b * npg + 1
    quant = pool != "bf16"
    block = torch.from_numpy(
        rng.permutation(np.arange(1, p))[: b * npg].astype(np.int32)
        .reshape(b, npg))
    pos = torch.tensor([0, 448])
    qpos = pos[:, None] + torch.arange(c)[None, :]
    valid = torch.arange(npg * page)[None, None, :] <= qpos[:, :, None]
    q = torch.from_numpy(rng.normal(size=(b, c, h, d)).astype(np.float32))
    if pool == "int8":
        x = [rng.normal(size=(p, page, k, d)) for _ in range(2)]
        sc = [np.abs(t).max(axis=(1, 3)) / 127 for t in x]       # (P, K)
        pools = [torch.from_numpy(np.round(t / s[:, None, :, None])
                                  .astype(np.int8)) for t, s in zip(x, sc)]
        scales = [torch.from_numpy(s.astype(np.float32)) for s in sc]
    elif quant:
        pools = [torch.from_numpy(rng.integers(-128, 128, (p, page, k, d))
                                  .astype(np.int8)) for _ in range(2)]
        scales = [torch.from_numpy((rng.random((p, k)) * 0.05)
                                   .astype(np.float32)) for _ in range(2)]
    else:
        pools = [torch.from_numpy(rng.normal(size=(p, page, k, d))
                                  .astype(np.float32)).bfloat16()
                 for _ in range(2)]
        scales = [None, None]
    seen = valid.any(dim=1)
    bi, s = torch.nonzero(~seen, as_tuple=True)
    pg, off = block[bi, s // page].long(), s % page
    for pool, x in zip(pools, (float("nan"), float("inf"))):
        pool[pg, off] = -128 if quant else x
    if quant:
        hidden = torch.ones(p, dtype=torch.bool)
        hidden[block[seen.reshape(b, npg, page).any(dim=2)].long()] = False
        scales[0][hidden], scales[1][hidden] = float("nan"), float("inf")
    return q, pools, block, valid, scales


def _reference64(q, pool_k, pool_v, block, valid, scale_k, scale_v):
    """The plain version's function in float64 (dequantised, masked keys
    selected out), as (B, C, H, D)."""
    idx = block.long()

    def gather(pool, scale):
        g = pool[idx].double()                            # (B, npg, page, K, D)
        if scale is not None:
            g = g * scale.double()[idx][:, :, None, :, None]
        return g.reshape(idx.shape[0], -1, *pool.shape[2:])

    b, c, h, d = q.shape
    kh = pool_k.shape[2]
    seen = valid.any(dim=1)[:, :, None, None]
    kk = torch.where(seen, gather(pool_k, scale_k), 0.0)
    vv = torch.where(seen, gather(pool_v, scale_v), 0.0)
    sc = torch.einsum("bckgd,bskd->bkgcs",
                      q.double().reshape(b, c, kh, h // kh, d), kk)
    sc = torch.where(valid[:, None, None], sc / math.sqrt(d), -1e300)
    p = torch.where(valid[:, None, None],
                    torch.exp(sc - sc.amax(dim=-1, keepdim=True)), 0.0)
    acc = torch.einsum("bkgcs,bskd->bckgd", p, vv)
    l = p.sum(dim=-1).clamp(min=1e-300).permute(0, 3, 1, 2)[..., None]
    return (acc / l).reshape(b, c, h, d)


@pytest.mark.parametrize("pool,vs_plain", [("bf16", True), ("int8", True),
                                           ("int8 full range", False)])
def test_split_operands_meet_the_tolerance(pool, vs_plain):
    """hi + mid + lo bf16 terms of q and p, into float32 accumulators: within
    1e-5 of a float64 reference, and of the plain version where that one
    is (bf16 and serving-like int8 pools).

    Why the split: one bf16 pass over the float32 queries and softmax
    weights misses the kernels' 1e-4 tolerance.  Emulated at C 256, G 6,
    512 keys, D 128 against a float64 reference, one bf16 pass is off by
    1.1e-3 and one TF32 pass by 1.5e-4 (these inputs: 4e-3 to 5e-2 and
    1e-3 to 7e-3).  Two terms, hi + lo, came to 9e-6 on bf16 pools but 5e-5
    at full-range int8 levels, where the float32 plain version is itself
    9e-6 from float64; three terms stay within 4e-6 of float64 on all
    three.  The pool operand needs no split: a bf16 page is exact in bf16,
    and so is an int8 level in -128..127."""
    q, (pk, pv), block, valid, (sk, sv) = _chunk_case(pool)
    want64 = _reference64(q, pk, pv, block, valid, sk, sv)
    plain = da.decode_attention_chunk_paged_plain(q, pk, pv, block, valid,
                                                  sk, sv)
    got = chunk_tensor_core(q, pk, pv, block, valid, sk, sv)
    assert torch.isfinite(got).all()
    assert (got.double() - want64).abs().max().item() <= 1e-5
    if vs_plain:
        assert (got - plain).abs().max().item() <= 1e-5
    else:       # the plain version's own float32 error is 9e-6 here
        assert (got - plain).abs().max().item() <= 2e-5
    for one_pass in (1, "tf32"):
        out = chunk_tensor_core(q, pk, pv, block, valid, sk, sv, one_pass)
        assert (out.double() - want64).abs().max().item() > ATT_ATOL


def test_split_operands_give_zero_for_a_row_that_sees_nothing():
    """A query row with no visible key keeps m = -1e30; its weights are 0 by
    the select, not by exp(-1e30 - -1e30) = 1, so it returns exactly 0."""
    q, (pk, pv), block, valid, _ = _chunk_case("bf16", c=4, npg=4)
    valid[1] = False
    valid[0, 2] = False
    got = chunk_tensor_core(q, pk, pv, block, valid)
    assert (got[1] == 0).all() and (got[0, 2] == 0).all()
    want = da.decode_attention_chunk_paged_plain(q, pk, pv, block, valid)
    assert (got - want).abs().max().item() <= 1e-5


# ---------------------------------------------------------------------------
# (c) the paged decode kernel: page-aligned splits, merged in order
# ---------------------------------------------------------------------------

def paged_split_merge(q, pool_k, pool_v, block, valid, split_pages,
                      scale_k=None, scale_v=None):
    """The paged decode kernel's algorithm: each range of ``split_pages``
    logical pages gathers its rows through the block table, zero where no
    query looks (the kernel's zero-filled copies) with scale 0 on pages no
    query reaches, scores them (int8: the dot with the levels times
    scale_k), and gives a partial (m, l, acc) with the weights folded with
    scale_v; the partials merge in split order.  q (B, 1, H, D) float32;
    valid (B, n_pages * page) bool."""
    b, _, h, d = q.shape
    page, kh = pool_k.shape[1], pool_k.shape[2]
    npg = block.shape[1]
    qg = q.reshape(b, kh, h // kh, d).float() / math.sqrt(d)
    parts = []
    for p0 in range(0, npg, split_pages):
        pages = block[:, p0:p0 + split_pages].long()          # (B, np)
        vm = valid[:, p0 * page:(p0 + pages.shape[1]) * page]  # (B, S)
        rows = vm[..., None, None]
        kk = torch.where(rows, pool_k[pages].float().reshape(b, -1, kh, d),
                         0.0)
        vv = torch.where(rows, pool_v[pages].float().reshape(b, -1, kh, d),
                         0.0)
        sc = torch.einsum("bkgd,bskd->bkgs", qg, kk)
        sv = torch.ones_like(sc)
        if scale_k is not None:
            seen = vm.reshape(b, -1, page).any(dim=2)[..., None]  # (B, np, 1)

            def per_key(scale):
                s_ = torch.where(seen, scale[pages], 0.0)         # (B, np, K)
                return s_.repeat_interleave(page, dim=1) \
                    .permute(0, 2, 1)[:, :, None, :]               # (B,K,1,S)

            sc = sc * per_key(scale_k)
            sv = per_key(scale_v).expand_as(sc)
        m_ = vm[:, None, None]
        sc = torch.where(m_, sc, NEG)
        m = sc.amax(dim=-1)
        p = torch.where(m_, torch.exp(sc - m[..., None]), 0.0)
        parts.append((m, p.sum(dim=-1),
                      torch.einsum("bkgs,bskd->bkgd", p * sv, vv)))
    m_all = torch.stack([m for m, _, _ in parts]).amax(dim=0)
    l_all = torch.zeros_like(m_all)
    acc = torch.zeros_like(parts[0][2])
    for m, l, a in parts:                          # split order
        f = torch.exp(m - m_all)
        l_all = l_all + f * l
        acc = acc + f[..., None] * a
    return (acc / torch.clamp(l_all, min=1e-30)[..., None]).reshape(b, 1, h,
                                                                    d)


def _paged_decode_case(seed, b, h, k, d, page, npg, quant, only_split=None):
    """Shuffled pages; the last slot sees no key, slot 0 only the first of
    its splits when ``only_split`` (pages per split) is given, the others a
    prefix of random length.  Returns the clean numpy inputs and torch
    copies with NaN / inf (int8: -128 bytes and NaN / inf scales) wherever
    no query looks."""
    rng = np.random.default_rng(seed)
    p = b * npg + 1
    block = rng.permutation(np.arange(1, p))[: b * npg].astype(np.int32) \
        .reshape(b, npg)
    s_tot = npg * page
    pos = rng.integers(0, s_tot, b)
    if only_split is not None:
        pos[0] = min(only_split * page, s_tot) - 1
    valid = np.arange(s_tot)[None, :] <= pos[:, None]
    valid[-1] = False
    q = rng.normal(size=(b, 1, h, d)).astype(np.float32)
    if quant:
        pools = [rng.integers(-128, 128, (p, page, k, d)).astype(np.int8)
                 for _ in range(2)]
        scales = [(rng.random((p, k)) * 0.05).astype(np.float32)
                  for _ in range(2)]
    else:
        pools = [rng.normal(size=(p, page, k, d)).astype(np.float32)
                 for _ in range(2)]
        scales = []
    dirty = [torch.from_numpy(t.copy()) for t in pools]
    bi, s = np.nonzero(~valid)
    for t, x in zip(dirty, (float("nan"), float("inf"))):
        t[block[bi, s // page], s % page] = -128 if quant else x
    dirty_scales = [torch.from_numpy(t.copy()) for t in scales]
    if quant:
        reached = valid.reshape(b, npg, page).any(axis=2)
        hidden = np.ones(p, bool)
        hidden[block[reached]] = False
        dirty_scales[0][hidden] = float("nan")
        dirty_scales[1][hidden] = float("inf")
    return q, pools, scales, block, valid, dirty, dirty_scales


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("page,npg,split,only", [
    (16, 6, None, None),   # the host's own split
    (8, 9, 2, 2),          # slot 0 sees only its first split
    (4, 12, 3, None),
])
def test_paged_split_merge_matches_the_reference(quant, page, npg, split,
                                                 only):
    """Page-aligned splits merged in split order against the reference's
    ``decode_attention_paged`` (Pallas, interpret mode) on the clean
    inputs, within the kernel's 1e-4; the garbage where no query looks
    never reaches the model's result, and the slot that sees nothing
    returns exactly 0."""
    b, h, k, d = 3, 6, 2, 32
    split = split or da.paged_split_pages(b, k, npg, page)
    q, pools, scales, block, valid, dirty, dirty_scales = _paged_decode_case(
        7, b, h, k, d, page, npg, quant, only and split)
    ref = np.asarray(jops.decode_attention_paged(
        jnp.asarray(q), *map(jnp.asarray, pools), jnp.asarray(block),
        jnp.asarray(valid), *map(jnp.asarray, scales)))
    got = paged_split_merge(torch.from_numpy(q), *dirty,
                            torch.from_numpy(block), torch.from_numpy(valid),
                            split, *dirty_scales)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=ATT_ATOL)
    assert (got[-1] == 0).all()                    # sees no key: exactly 0


def test_paged_split_pages_come_from_shapes_and_fill_the_card():
    """Whole pages of at least 32 positions per split, about two blocks per
    SM: qwen2's L and S decode (B*K 8, 34 pages of 16) 17 splits of 2
    pages, 136 blocks; zamba2's (B*K 128, 18 pages) 3 splits; never more
    than 256 splits, nor a split past the kernel's staging limits."""
    assert da.paged_split_pages(4, 2, 34, 16) == 2
    assert da.paged_split_pages(8, 1, 34, 16) == 2
    assert da.paged_split_pages(4, 32, 18, 16) == 6
    for b, k, npg, page in [(4, 2, 34, 16), (4, 2, 136, 4), (2, 2, 9, 4),
                            (1, 1, 5000, 16), (64, 8, 256, 16), (3, 1, 1, 8),
                            (1, 1, 4096, 4)]:
        split = da.paged_split_pages(b, k, npg, page)
        n = -(-npg // split)
        assert 1 <= n <= da.MAX_SPLITS
        assert split <= da.PAGED_MAX_SPLIT_PAGES
        assert split * page <= da.PAGED_MAX_SPLIT_POSITIONS
        assert split * page >= min(da.SPLIT_UNIT, npg * page) or n == 1
        cap = min(da.PAGED_MAX_SPLIT_PAGES,
                  da.PAGED_MAX_SPLIT_POSITIONS // page)
        assert b * k * n < b * k + da.SPLIT_TARGET_BLOCKS or split == cap
    with pytest.raises(ValueError, match="splits"):
        da.paged_split_pages(1, 1, 64 * 256 + 1, 16)


# ---------------------------------------------------------------------------
# (d) the SSD kernel: three TF32 passes per float32 product
# ---------------------------------------------------------------------------

SSD_ATOL, SSD_RTOL = 1e-4, 1e-4


def _tf32(x):
    """float32 truncated to TF32's 10 mantissa bits: the kernel's hi, and
    what the tensor core reads of any float32 operand."""
    bits = x.contiguous().view(torch.int32)
    return (bits & ~0x1FFF).view(torch.float32)


def mm_tf32(a, b, passes=3):
    """a @ b as the kernel's MMAs: TF32 operands, float32 accumulation; with
    3 passes each operand is hi = tf32(x) and lo = x - hi (read as
    tf32(lo)), summed as lo.hi + hi.lo + hi.hi."""
    ah, bh = _tf32(a), _tf32(b)
    if passes == 1:
        return ah @ bh
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def ssd_tensor_core(x, dt, A, B, C, passes=3):
    """The SSD kernel's arithmetic in torch float32: a_cs a sequential sum,
    C.B^T on the tensor cores, W = C.B^T exp(a_cs[i] - a_cs[j]) for j <= i
    only (the exp's argument selected, then its result), y_diag = W (dt x)
    and S = (w_end dt x)^T B on the tensor cores."""
    q = x.shape[2]
    a_cs = torch.cumsum(dt * A, dim=2)                          # (b,nc,Q,H)
    tri = torch.tril(torch.ones((q, q), dtype=torch.bool))[None, None, None]
    ah = a_cs.permute(0, 1, 3, 2)                               # (b,nc,H,Q)
    diff = torch.where(tri, ah[..., :, None] - ah[..., None, :], 0.0)
    cb = mm_tf32(C, B.transpose(-1, -2), passes)[:, :, None]     # (b,nc,1,Q,Q)
    w = torch.where(tri, cb * torch.exp(diff), 0.0)
    dx = (dt[..., None] * x).permute(0, 1, 3, 2, 4)             # (b,nc,H,Q,P)
    y = mm_tf32(w, dx, passes).permute(0, 1, 3, 2, 4)
    wdt = torch.exp(ah[..., -1:] - ah) * dt.permute(0, 1, 3, 2)  # (b,nc,H,Q)
    xs = wdt[..., None] * x.permute(0, 1, 3, 2, 4)
    S = mm_tf32(xs.transpose(-1, -2), B[:, :, None], passes)
    return y, S, torch.exp(a_cs[:, :, -1]), torch.exp(a_cs)


def _ssd64(x, dt, A, B, C):
    """The four outputs in float64 (the reference's einsums)."""
    x, dt, A, B, C = (t.double() for t in (x, dt, A, B, C))
    q = x.shape[2]
    a_cs = torch.cumsum(dt * A, dim=2)
    tri = torch.tril(torch.ones((q, q), dtype=torch.bool))[None, None, :, :,
                                                           None]
    diff = a_cs[:, :, :, None, :] - a_cs[:, :, None, :, :]
    decay = torch.where(tri, torch.exp(torch.where(tri, diff, 0.0)), 0.0)
    cb = torch.einsum("bcin,bcjn->bcij", C, B)
    dx = x * dt[..., None]
    y = torch.einsum("bcij,bcijh,bcjhp->bcihp", cb, decay, dx)
    to_end = torch.exp(a_cs[:, :, -1:, :] - a_cs)
    S = torch.einsum("bcjh,bcjhp,bcjn->bchpn", to_end, dx, B)
    return y, S, torch.exp(a_cs[:, :, -1]), torch.exp(a_cs)


def _worst(got, want):
    """max |got - want| / (atol + rtol |want|) over the four outputs."""
    return max(((g.double() - w.double()).abs()
                / (SSD_ATOL + SSD_RTOL * w.double().abs())).max().item()
               for g, w in zip(got, want))


def test_ssd_tensor_core_split_meets_the_tolerance():
    """Three TF32 passes at the real Q 128, P 64, N 128 (b and nc cut to 1
    and 2, four heads), against float64 and against ``ssd_chunk_pallas``
    in interpret mode, all four outputs within 1e-4 + 1e-4 |ref|; one TF32
    pass misses it.  The worst error, as a share of the tolerance, is
    printed."""
    rng = np.random.default_rng(11)
    b, nc, q, h, p, n = 1, 2, 128, 4, 64, 128
    x = rng.normal(size=(b, nc, q, h, p)).astype(np.float32)
    dt = (rng.random((b, nc, q, h)) * 0.5).astype(np.float32)
    A = (-rng.random(h) - 0.2).astype(np.float32)
    B = rng.normal(size=(b, nc, q, n)).astype(np.float32)
    C = rng.normal(size=(b, nc, q, n)).astype(np.float32)
    args = tuple(map(torch.from_numpy, (x, dt, A, B, C)))
    got = ssd_tensor_core(*args)
    want64 = _ssd64(*args)
    pallas = tuple(torch.from_numpy(np.array(t)) for t in ssd_chunk_pallas(
        *map(jnp.asarray, (x, dt, A, B, C)), interpret=True))
    vs64, vs_pallas = _worst(got, want64), _worst(got, pallas)
    one_pass = _worst(ssd_tensor_core(*args, passes=1), want64)
    print(f"3xTF32 worst error / tolerance: {vs64:.2e} against float64, "
          f"{vs_pallas:.2e} against ssd_chunk_pallas; one TF32 pass "
          f"{one_pass:.2e}")
    assert all(torch.isfinite(t).all() for t in got)
    assert vs64 <= 1.0 and vs_pallas <= 1.0
    assert one_pass > 1.0
    # the plain version, the card's yardstick, agrees with the model too
    assert _worst(got, ssd_scan.ssd_chunk_ref(*args)) <= 1.0


def test_ssd_tensor_core_padded_tail_is_exact():
    """dt = 0 past a row's length: under the three-pass model, as in the
    kernel, S and g do not move whatever x holds there (a zero operand adds
    exact zeros), and g is exp(a_cs) at the length bit for bit."""
    rng = np.random.default_rng(12)
    b, nc, q, h, p, n, live = 1, 1, 64, 2, 16, 32, 40
    x = torch.from_numpy(rng.normal(size=(b, nc, q, h, p)).astype(np.float32))
    dt = torch.from_numpy((rng.random((b, nc, q, h)) * 0.5).astype(np.float32))
    dt[:, :, live:] = 0.0
    A = torch.from_numpy((-rng.random(h) - 0.2).astype(np.float32))
    B = torch.from_numpy(rng.normal(size=(b, nc, q, n)).astype(np.float32))
    C = torch.from_numpy(rng.normal(size=(b, nc, q, n)).astype(np.float32))
    _, S, g, eacs = ssd_tensor_core(x, dt, A, B, C)
    x2 = x.clone()
    x2[:, :, live:] = 1e4
    _, S2, g2, _ = ssd_tensor_core(x2, dt, A, B, C)
    assert torch.equal(S2, S) and torch.equal(g2, g)
    assert torch.equal(g, eacs[:, :, live - 1])


def test_ssd_heads_per_block_come_from_shapes():
    """One block per SM: mamba2-370m's L admission 4 heads a block (128
    blocks), its S tier 2 (128), zamba2-2.7b's L 5 (128); never more blocks
    than the target unless a block holds the most heads it may."""
    assert ssd_scan.ssd_heads_per_block(4, 4, 32) == 4
    assert ssd_scan.ssd_heads_per_block(8, 4, 8) == 2
    assert ssd_scan.ssd_heads_per_block(4, 2, 80) == 5
    top = ssd_scan.MAX_HEADS_PER_BLOCK
    for b, nc, h in [(1, 1, 3), (2, 3, 24), (100, 10, 4), (1, 1, 1),
                     (64, 4, 64)]:
        hb = ssd_scan.ssd_heads_per_block(b, nc, h)
        blocks = b * nc * -(-h // hb)
        assert 1 <= hb <= min(h, top)
        assert blocks <= ssd_scan.TARGET_BLOCKS or hb == min(h, top)
        assert hb == 1 or b * nc * -(-h // (hb - 1)) > ssd_scan.TARGET_BLOCKS


# ---------------------------------------------------------------------------
# (e) the gate: rows split across blocks, partial states merged in order
# ---------------------------------------------------------------------------

CONF_ATOL, CONF_RTOL = 1e-5, 1e-4
F32 = torch.float32


def _gate_state(x):
    """(m, z, s1, t2, arg) of one split's float32 values ``x`` (C,) at
    columns starting 0: the max first, then one exp per element against
    it, as each of the kernel's threads does over its registers."""
    m = x.max()
    arg = int(torch.argmax(x))                    # first index of the max
    rest = torch.cat([x[:arg], x[arg + 1:]])
    t2 = rest.max() if len(rest) else torch.tensor(float("-inf"))
    d = x - m
    e = torch.exp(d)
    return m, e.sum(), (e * d).sum(), t2, arg


def _gate_warp_merge(states):
    """csrc/hi_gate.cu warp_merge(): the lanes' max M first; then each
    lane's (z, s1) rescaled to M and summed, the lowest arg among lanes at
    M, and t2 = M when two lanes hold M, else the largest of the M lane's
    t2 and the other lanes' maxima."""
    live = [st for st in states if st is not None]
    M = max(st[0] for st in live)
    z = s1 = torch.tensor(0.0)
    arg, t2, tops = None, torch.tensor(float("-inf")), 0
    for m, zz, ss, tt, aa in live:
        d = m - M
        e = torch.exp(d)
        z, s1 = z + e * zz, s1 + e * (d * zz + ss)
        if m == M:
            tops += 1
            arg = aa if arg is None else min(arg, aa)
            t2 = torch.maximum(t2, tt)
        else:
            t2 = torch.maximum(t2, m)
    return M, z, s1, (M if tops > 1 else t2), arg


def gate_split_merge(logits, theta, metric, splits=None):
    """The kernel's algorithm in float32: row r's 16-byte-aligned body (the
    rows lie back to back from an aligned base) in ``splits`` ranges of
    whole 16-byte vectors, split 0 also taking the unaligned head and the
    last split the tail; per-split states; the row's last block merges them,
    split i in lane i of a warp, two-step (so at most 32 splits); then
    conf, pred and ``conf < theta``."""
    x = logits.float()
    n, c = x.shape
    size = logits.element_size()
    vec = 16 // size
    splits = splits or hg.gate_splits(n, c)
    conf, pred = torch.empty(n, dtype=F32), torch.empty(n, dtype=torch.int32)
    for r in range(n):
        mis = (r * c * size) % 16 // size
        a0 = min(c, vec - mis if mis else 0)
        nv = (c - a0) // vec
        a1 = a0 + nv * vec
        per = -(-nv // splits)
        assert splits <= 32
        lanes = [None] * 32
        for sp in range(splits):
            lo = a0 + min(nv, sp * per) * vec
            hi = a0 + min(nv, sp * per + per) * vec
            lo = 0 if sp == 0 else lo
            hi = c if sp == splits - 1 else hi
            if hi > lo:
                m, z, s1, t2, arg = _gate_state(x[r, lo:hi])
                lanes[sp] = (m, z, s1, t2, lo + arg)
        m, z, s1, t2, arg = _gate_warp_merge(lanes)
        if metric == "max_prob":
            conf[r] = 1.0 / z
        elif metric == "margin":
            conf[r] = (1.0 - torch.exp(t2 - m)) / z
        else:
            conf[r] = 1.0 - (torch.log(z) - s1 / z) / math.log(float(c))
        pred[r] = arg
    return conf, pred, (conf < theta).to(torch.int32)


def _gate_logits(seed, n, c, dtype):
    """Rows that reach the kernel's edges: row 0's max duplicated in split 0
    and in the middle split, row 1's max in the last column (the last
    split, in the tail when C is not a multiple of the vector), row 2
    uniform (its conf is exact in every metric: 1/C, 0, 0), the rest
    random."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(n, c)) * 3).astype(np.float32)
    x[0, 5] = x[0, c // 2] = x[0].max() + 2.0
    x[1, c - 1] = x[1].max() + 1.0
    x[2] = 0.0
    return torch.from_numpy(x).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("metric", ["max_prob", "margin", "entropy"])
@pytest.mark.parametrize("n,c", [(4, 8195), (3, 4099), (5, 12_000)])
def test_gate_split_merge_matches_the_reference(dtype, metric, n, c):
    """Per-split states merged in split order (the splits ``gate_splits``
    picks, one, seven and 32) against the reference's ``hi_gate_pallas``
    (interpret mode) and ``hi_gate_plain``: conf within 1e-5 +
    1e-4 |conf|, pred and offload equal; the duplicated max across splits
    gives the lower index (and margin 0), the max in the last split is
    found; C is no multiple of 4 or 8.  A row exactly at theta stays."""
    x = _gate_logits(n * c, n, c, dtype)
    assert hg.gate_splits(n, c) > 1
    jx = jnp.asarray(x.float().numpy())
    if dtype == torch.bfloat16:
        jx = jx.astype(jnp.bfloat16)
    theta = 0.3
    conf_j, pred_j, off_j = (torch.from_numpy(np.array(t)) for t in
                             hi_gate_pallas(jx, theta, metric, interpret=True))
    conf_p, pred_p, off_p = hg.hi_gate_plain(x, theta, metric)
    for splits in (None, 1, 7, 32):
        conf, pred, off = gate_split_merge(x, theta, metric, splits)
        for ref_conf, ref_pred, ref_off in ((conf_j, pred_j, off_j),
                                            (conf_p, pred_p, off_p)):
            torch.testing.assert_close(conf, ref_conf.float(), atol=CONF_ATOL,
                                       rtol=CONF_RTOL)
            assert torch.equal(pred, ref_pred.to(torch.int32))
            assert torch.equal(off, ref_off.to(torch.int32))
        assert int(pred[0]) == 5 and int(pred[1]) == c - 1
        if metric == "margin":
            assert float(conf[0]) == 0.0
        # the uniform row's conf is exact, and a row at theta stays
        assert float(conf[2]) == {"max_prob": np.float32(1.0) / np.float32(c),
                                  "margin": 0.0, "entropy": 0.0}[metric]
        _, _, at = gate_split_merge(x, conf[2], metric, splits)
        assert int(at[2]) == 0


def test_gate_splits_come_from_shapes_and_fill_the_card():
    """At least ``MIN_SPLIT_COLS`` columns a split and at most
    ``MAX_SPLITS`` (one a lane of the merging warp), about two blocks per
    SM in all unless C runs out of columns or the splits reach that cap
    first, one split for small C; the path's shapes: the S tier
    (8, 151,936) 32 splits (256 blocks), the L tier and the chunk lane 32,
    mamba2 (8, 50,280) 24, zamba2 (8, 32,000) 15.  Every split row's
    workspace fits the first one the wrapper allocates."""
    assert hg.gate_splits(8, 151_936) == 32
    assert hg.gate_splits(4, 151_936) == 32
    assert hg.gate_splits(2, 151_936) == 32
    assert hg.gate_splits(8, 50_280) == 24
    assert hg.gate_splits(8, 32_000) == 15
    target, least = hg.TARGET_BLOCKS, hg.MIN_SPLIT_COLS
    for n in (1, 2, 4, 8):
        for c in (2, 7, 4099, 32_000, 50_280, 151_936, 262_144):
            k = hg.gate_splits(n, c)
            assert 1 <= k <= hg.MAX_SPLITS == 32
            assert k == 1 or c // k >= least
            assert n * k < target + n                 # about two per SM
            assert (n * k >= target or k == max(1, c // least)
                    or k == hg.MAX_SPLITS)
            if c < 2 * least:
                assert k == 1
            if k > 1:                   # fits the wrapper's one workspace
                assert n < target and n * k < 2 * target
    assert hg.gate_splits(300, 151_936) == 1
    for n in range(1, 300):
        k = hg.gate_splits(n, 10 ** 6)
        assert k == 1 or (n < target and n * k < 2 * target)


def test_gate_scratch_refuses_rows_that_overrun_it():
    """The kernel writes the workspace and the counters unchecked, so the
    wrapper checks their size: every split row of ``gate_splits`` fits, and
    more rows or splits than they hold are refused."""
    dev, stream = torch.device("cpu"), -1
    try:
        for n in range(1, 300):
            k = hg.gate_splits(n, 10 ** 6)
            if k > 1:
                hg._scratch(dev, stream, n, k)
        target = hg.TARGET_BLOCKS
        with pytest.raises(ValueError, match="overrun the merge workspace"):
            hg._scratch(dev, stream, target + 1, 2)
        with pytest.raises(ValueError, match="overrun the merge workspace"):
            hg._scratch(dev, stream, 8, 2 * target // 8 + 1)
    finally:
        hg._SCRATCH.pop((dev.index, stream), None)


# ---------------------------------------------------------------------------
# (f) copy_pages' host preparation, made once per tuple of pools
# ---------------------------------------------------------------------------

def _old_real_pairs(src, dst):
    """The wrapper's pair checks as they were (numpy, per call)."""
    src = np.asarray(src, np.int32).reshape(-1)
    dst = np.asarray(dst, np.int32).reshape(-1)
    if src.shape != dst.shape:
        raise ValueError(f"copy_pages: src {src.shape} and dst {dst.shape} "
                         "differ in length")
    keep = ~((src == 0) & (dst == 0))
    src, dst = src[keep], dst[keep]
    if (dst == 0).any():
        raise ValueError("copy_pages: a real pair writes the null page 0")
    if len(set(dst.tolist())) != len(dst):
        raise ValueError(f"copy_pages: destination pages repeat: {dst}")
    if set(dst.tolist()) & set(src.tolist()):
        raise ValueError("copy_pages: a destination page is also a source; "
                         "an in-place copy would depend on its order")
    return src, dst


def _old_launch_args(pools, src, dst):
    """The block the wrapper built per call before: base addresses, layer
    and page bytes from tensor views, the pairs, the pools' checks."""
    if not 1 <= len(pools) <= 4:
        raise ValueError(f"copy_pages: 1..4 pools, got {len(pools)}")
    p0 = pools[0]
    if p0.ndim < 2:
        raise ValueError(f"copy_pages: pool {tuple(p0.shape)} must be "
                         "(L, P, ...)")
    for p in pools[1:]:
        if p.ndim < 2 or p.shape[:2] != p0.shape[:2] or p.device != p0.device:
            raise ValueError("copy_pages: pools must share (L, P) and device")
    if not all(p.is_contiguous() for p in pools):
        raise ValueError("copy_pages: pools must be contiguous")
    if len({p.data_ptr() for p in pools}) != len(pools):
        raise ValueError("copy_pages: a pool is passed twice")
    s, d = _old_real_pairs(src, dst)
    n_pages = p0.shape[1]
    if len(d) and (s.min() < 0 or max(s.max(), d.max()) >= n_pages):
        raise ValueError(f"copy_pages: page ids outside 0..{n_pages - 1}")
    return ([p.data_ptr() for p in pools],
            [p[0].numel() * p.element_size() for p in pools],
            [p[0, 0].numel() * p.element_size() for p in pools], s, d)


def _pools(kind, layers=3, pages=40):
    if kind == "bf16":
        return tuple(torch.zeros((layers, pages, 16, 2, 128),
                                 dtype=torch.bfloat16) for _ in range(2))
    return (tuple(torch.zeros((layers, pages, 16, 2, 128), dtype=torch.int8)
                  for _ in range(2))
            + tuple(torch.zeros((layers, pages, 2)) for _ in range(2)))


@pytest.mark.parametrize("kind", ["bf16", "int8"])
@pytest.mark.parametrize("src,dst", [
    ([3, 0, 7, 0], [5, 0, 9, 0]),                 # padded, as a tick's
    ([1], [2]),
    ([0, 0], [0, 0]),                             # all padding
    (list(range(1, 301)), list(range(301, 601))),  # two launches
])
def test_copy_pages_launch_args_equal_the_old_wrapper(kind, src, dst):
    """``_launch_args`` gives the bases, strides and pairs that the wrapper
    computed per call before (bf16 pools; int8 pools with their scale
    rows), pairs packed as sources then destinations in buffers of at most
    256 pairs; a second call hits the cache, a pool reallocated at the same
    shape misses it."""
    pools = _pools(kind, pages=700)
    bases, layer_bytes, page_bytes, s, d = _old_launch_args(pools, src, dst)
    args, batches = cp._launch_args(pools, np.array(src, np.int32),
                                    np.array(dst, np.int32))
    n = len(pools)
    assert list(args.block) == bases + layer_bytes + page_bytes
    assert (args.n_tensors, args.layers, args.n_pages) == (n, 3, 700)
    assert args.int8 == (kind == "int8") and args.device == -1
    assert [len(b) // 2 for b in batches] == \
        [min(cp.MAX_PAIRS, len(d) - at) for at in range(0, len(d),
                                                          cp.MAX_PAIRS)]
    got = [np.array(b, np.int32).reshape(2, -1) for b in batches]
    if got:
        np.testing.assert_array_equal(np.concatenate([g[0] for g in got]), s)
        np.testing.assert_array_equal(np.concatenate([g[1] for g in got]), d)
    assert cp._launch_args(pools, src, dst)[0] is args           # cached
    moved = (pools[0].clone(),) + pools[1:]
    again, _ = cp._launch_args(moved, src, dst)
    assert again is not args and again.bases[0] == moved[0].data_ptr()


def _refusals():
    bf = _pools("bf16", pages=10)
    q8 = _pools("int8", pages=10)
    return [
        (bf, [3, 0], [5]),                        # lengths differ
        (bf, [3], [0]),                           # the null page
        (bf, [3, 4], [5, 5]),                     # repeated destinations
        (bf, [3, 2], [2, 5]),                     # a destination is a source
        (bf, [3], [10]),                          # out of range
        (bf, [-1], [4]),
        ((), [1], [2]),                           # no pool
        (q8 + bf[:1], [1], [2]),                  # five tensors
        ((torch.zeros(4),), [1], [2]),            # not (L, P, ...)
        ((bf[0], torch.zeros((3, 11, 2))), [1], [2]),   # mixed P
        ((bf[0], torch.zeros((4, 10, 2))), [1], [2]),   # mixed L
        ((bf[0].transpose(2, 3),), [1], [2]),     # not contiguous
        ((bf[0], bf[0]), [1], [2]),               # the same pool twice
    ]


@pytest.mark.parametrize("case", range(len(_refusals())))
def test_copy_pages_launch_args_refuse_as_before(case):
    """Every refusal of the old per-call checks (``real_pairs``, the pools'
    checks, the page range) still raises, with the same message."""
    pools, src, dst = _refusals()[case]
    with pytest.raises(ValueError) as old:
        _old_launch_args(pools, src, dst)
    with pytest.raises(ValueError) as new:
        cp._launch_args(pools, src, dst)
    assert str(new.value) == str(old.value)


def test_copy_pages_refuses_a_negative_destination():
    """A negative destination page passed the old per-call range check
    (it tested the sources' minimum only) and reached the kernel, which
    would write before the pool's first page; it is refused on the host."""
    pools = _pools("bf16", pages=10)
    _old_launch_args(pools, [3], [-1])             # the old check let it by
    with pytest.raises(ValueError, match="page ids outside 0..9"):
        cp._launch_args(pools, [3], [-1])
