"""The arithmetic of the two attention kernels' designs, on the CPU.

The CUDA kernels run only on the card (tests/test_torch_cuda.py holds them
against their plain versions there).  These tests hold the two algorithms
they implement, written out in torch, against the reference and the plain
versions here:

* the drain kernel (``csrc/decode_attention.cu``) splits the cache
  positions into contiguous ranges, one block each, and merges the ranges'
  partial online-softmax states (m, l, acc) in a fixed order;
* the chunk kernel (``csrc/chunk_paged_attention.cu``) runs Q.K^T and P.V
  on bf16 tensor cores with float32 accumulators, splitting each float32
  operand into bf16 terms: hi = bf16(x), mid = bf16(x - hi) and
  lo = bf16(x - hi - mid).
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention import decode_attention_pallas
from repro_torch.kernels import decode_attention as da

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
