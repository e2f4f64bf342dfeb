"""The port's CUDA kernels on the card, against their plain versions.

These tests need an NVIDIA card; each decides inside itself, never at import
time, and skips with a reason where there is none.  This file imports no
jax, so it runs on a machine without it:

    PYTHONPATH=src python -m pytest -q -p no:cacheprovider --noconftest \
        -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import hi_gate as hg
from repro_torch.kernels import ops
from repro_torch.kernels import ssd_scan

pytestmark = pytest.mark.cuda

# kernel and plain version both compute in float32; only sum order differs
CONF_ATOL, CONF_RTOL = 1e-5, 1e-4
ATT_ATOL = 1e-4
# the int8 bodies' counters, which a bf16 run leaves at 0
NO_INT8 = {"decode_attention_paged[int8]": 0,
           "decode_attention_chunk_paged[int8]": 0, "copy_pages[int8]": 0}
# the MoE family's kernels, which a dense model leaves at 0
NO_MOE = {"grouped_swiglu": 0, "route_pairs": 0}


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (run on the chip)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.parametrize("metric", ["max_prob", "margin", "entropy"])
@pytest.mark.parametrize("n,c", [(1, 2), (8, 10), (33, 7), (16, 512),
                                 (5, 4099), (4, 262_144)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_hi_gate_kernel_matches_plain(gen, metric, n, c, dtype):
    x = (torch.randn((n, c), generator=gen, device="cuda") * 3)
    if c > 2:
        x[0, 1] = x[0, c - 1] = x[0].max() + 1.0      # duplicated max
    x = x.to(dtype)
    theta = torch.tensor(0.3, device="cuda")
    conf_p, pred_p, off_p = hg.hi_gate_plain(x, theta, metric)
    before = hg.hi_gate_cuda.launches
    conf_k, pred_k, off_k = ops.hi_gate(x, theta, metric)
    torch.cuda.synchronize()
    assert hg.hi_gate_cuda.launches == before + 1
    torch.testing.assert_close(conf_k, conf_p, atol=CONF_ATOL, rtol=CONF_RTOL)
    assert torch.equal(pred_k, pred_p)
    assert torch.equal(off_k, (conf_k < theta).to(torch.int32))
    if c > 2:
        assert int(pred_k[0]) == 1
        if metric == "margin":
            assert float(conf_k[0]) == 0.0


def test_hi_gate_reads_theta_through_its_pointer(gen):
    x = torch.tensor([[10.0, -10.0], [0.1, 0.0], [0.0, 0.0]], device="cuda")
    theta = torch.tensor(0.9, device="cuda")
    _, _, off = ops.hi_gate(x, theta)
    assert off.tolist() == [0, 1, 1]
    # the same tensor, moved on the device: row 1 (conf 0.525) now stays,
    # row 2 (conf 0.5) now escalates
    theta.fill_(0.52)
    _, _, off = ops.hi_gate(x, theta)
    assert off.tolist() == [0, 0, 1]


def _gate_rows(gen, n, c, dtype):
    """Row 0's max duplicated in split 0 and in the middle split, row 1's in
    the last column (the last split), the rest random."""
    x = torch.randn((n, c), generator=gen, device="cuda") * 3
    x[0, 3] = x[0, c // 2] = x[0].max() + 2.0
    if n > 1:
        x[1, c - 1] = x[1].max() + 1.0
    return x.to(dtype)


@pytest.mark.parametrize("metric", ["max_prob", "margin", "entropy"])
@pytest.mark.parametrize("n", [1, 2, 4, 8])
@pytest.mark.parametrize("c", [32_000, 50_280, 151_936])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_hi_gate_split_kernel_at_the_path_shapes(gen, metric, n, c, dtype):
    """The path's shapes, each row split over ``gate_splits`` blocks and
    merged in one launch: a max duplicated across splits gives the lower
    index (and margin 0), a max in the last split is found; a row exactly
    at theta stays."""
    assert hg.gate_splits(n, c) > 1
    x = _gate_rows(gen, n, c, dtype)
    conf_p, pred_p, _ = hg.hi_gate_plain(x, 0.0, metric)
    theta = conf_p[-1].clone()
    before = hg.hi_gate_cuda.launches
    conf_k, pred_k, off_k = ops.hi_gate(x, theta, metric)
    torch.cuda.synchronize()
    assert hg.hi_gate_cuda.launches == before + 1
    torch.testing.assert_close(conf_k, conf_p, atol=CONF_ATOL, rtol=CONF_RTOL)
    assert torch.equal(pred_k, pred_p)
    assert torch.equal(off_k, (conf_k < theta).to(torch.int32))
    assert int(pred_k[0]) == 3
    if n > 1:
        assert int(pred_k[1]) == c - 1
    if metric == "margin":
        assert float(conf_k[0]) == 0.0


@pytest.mark.parametrize("n,c", [(8, 151_936), (2, 32_000), (5, 4099)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_hi_gate_gives_the_same_bits_twice(gen, n, c, dtype):
    """The last block of a row merges the splits in a fixed order, so the
    bits do not depend on which block finished last."""
    x = _gate_rows(gen, n, c, dtype)
    theta = torch.tensor(0.3, device="cuda")
    for metric in ("max_prob", "margin", "entropy"):
        one = ops.hi_gate(x, theta, metric)
        two = ops.hi_gate(x, theta, metric)
        torch.cuda.synchronize()
        assert torch.equal(one[0].view(torch.int32), two[0].view(torch.int32))
        assert torch.equal(one[1], two[1]) and torch.equal(one[2], two[2])


def test_hi_gate_merge_counters_return_to_zero(gen):
    """The row counters are 0 after every call: one at N = 2, then one at
    N = 8 (which reuses the first rows' counters), then N = 2 again."""
    theta = torch.tensor(0.3, device="cuda")
    key = (torch.cuda.current_device(),
           torch.cuda.current_stream().cuda_stream)
    for n in (2, 8, 2):
        x = _gate_rows(gen, n, 151_936, torch.float32)
        conf, pred, _ = ops.hi_gate(x, theta)
        torch.cuda.synchronize()
        counters = hg._SCRATCH[key][0]
        assert int(counters.abs().sum()) == 0
        ref = hg.hi_gate_plain(x, theta)
        torch.testing.assert_close(conf, ref[0], atol=CONF_ATOL,
                                   rtol=CONF_RTOL)
        assert torch.equal(pred, ref[1])


def test_hi_gate_graph_replay_equals_the_eager_call(gen):
    """Captured in a CUDA graph (warmed up on the capture stream, so the
    call allocates no scratch while captured), a replay gives the eager
    call's bits, and moves with theta."""
    x = _gate_rows(gen, 8, 151_936, torch.float32)
    theta = torch.tensor(0.3, device="cuda")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        eager = ops.hi_gate(x, theta, "entropy")
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    eager = tuple(t.clone() for t in eager)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        out = ops.hi_gate(x, theta, "entropy")
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out[0].view(torch.int32), eager[0].view(torch.int32))
    assert torch.equal(out[1], eager[1]) and torch.equal(out[2], eager[2])
    theta.fill_(2.0)                               # every row escalates
    graph.replay()
    torch.cuda.synchronize()
    assert out[2].tolist() == [1] * 8
    assert torch.equal(out[0].view(torch.int32), eager[0].view(torch.int32))


@pytest.mark.parametrize("d", da.HEAD_DIMS)
@pytest.mark.parametrize("b,h,k,s", [(1, 4, 1, 128), (2, 8, 2, 256),
                                     (2, 6, 6, 192), (3, 12, 2, 1000),
                                     (2, 16, 2, 77)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_kernel_matches_plain(gen, d, b, h, k, s, dtype):
    q = torch.randn((b, 1, h, d), generator=gen, device="cuda")
    ck = torch.randn((b, s, k, d), generator=gen, device="cuda").to(dtype)
    cv = torch.randn((b, s, k, d), generator=gen, device="cuda").to(dtype)
    kpos = torch.arange(s, device="cuda")
    for valid in (kpos <= s // 3, (kpos <= s - 2) & (s - 2 - kpos < 40),
                  torch.ones(s, dtype=torch.bool, device="cuda"),
                  torch.zeros(s, dtype=torch.bool, device="cuda")):
        out_k = ops.decode_attention(q, ck, cv, valid)
        out_p = da.decode_attention_plain(q, ck, cv, valid)
        torch.cuda.synchronize()
        torch.testing.assert_close(out_k, out_p, atol=ATT_ATOL, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,k,s,d", [(4, 12, 2, 1000, 128),
                                       (8, 3, 1, 1024, 128),
                                       (1, 8, 1, 4099, 64),
                                       (2, 4, 2, 333, 80)])
def test_decode_attention_splits_merge_in_a_fixed_order(gen, dtype, b, h, k,
                                                        s, d):
    """The drain kernel splits the positions across blocks and merges the
    splits in order: S not a multiple of the split, a mask true only in the
    last split, one true only in the first, and two calls of one input give
    the same bits; one call is one counted launch."""
    split = da.drain_split_len(b, k, s)
    assert -(-s // split) > 1                      # several splits
    q = torch.randn((b, 1, h, d), generator=gen, device="cuda")
    ck = torch.randn((b, s, k, d), generator=gen, device="cuda").to(dtype)
    cv = torch.randn((b, s, k, d), generator=gen, device="cuda").to(dtype)
    kpos = torch.arange(s, device="cuda")
    last = (s - 1) // split * split
    for valid in (kpos >= last, kpos >= s - 3, kpos < 5,
                  (kpos % 7 == 0) & (kpos > split)):
        before = da.decode_attention_cuda.launches
        out = ops.decode_attention(q, ck, cv, valid)
        again = ops.decode_attention(q, ck, cv, valid)
        torch.cuda.synchronize()
        assert da.decode_attention_cuda.launches == before + 2
        assert torch.equal(out, again)
        torch.testing.assert_close(
            out, da.decode_attention_plain(q, ck, cv, valid),
            atol=ATT_ATOL, rtol=0)


def test_decode_attention_bf16_query_keeps_its_dtype(gen):
    q = torch.randn((2, 1, 4, 64), generator=gen, device="cuda")
    kv = torch.randn((2, 64, 2, 64), generator=gen, device="cuda")
    valid = torch.ones(64, dtype=torch.bool, device="cuda")
    out = ops.decode_attention(q.bfloat16(), kv.bfloat16(), kv.bfloat16(),
                               valid)
    assert out.dtype == torch.bfloat16
    ref = da.decode_attention_plain(q.bfloat16(), kv.bfloat16(),
                                    kv.bfloat16(), valid)
    torch.testing.assert_close(out, ref, atol=1e-2, rtol=1e-2)


def test_wrappers_raise_on_what_the_kernels_do_not_take(gen):
    x = torch.randn((4, 32), generator=gen, device="cuda")
    theta = torch.tensor(0.5, device="cuda")
    with pytest.raises(TypeError):
        ops.hi_gate(x.half(), theta)
    with pytest.raises(ValueError):
        ops.hi_gate(x.t(), theta)                   # not contiguous
    with pytest.raises(ValueError):
        ops.hi_gate(x, 0.5)                         # theta not on the device
    q = torch.randn((1, 1, 4, 48), device="cuda")
    kv = torch.randn((1, 8, 1, 48), device="cuda")
    valid = torch.ones(8, dtype=torch.bool, device="cuda")
    with pytest.raises(ValueError, match="head dim"):
        ops.decode_attention(q, kv, kv, valid)      # D = 48
    q = torch.randn((1, 1, 18, 64), device="cuda")
    kv = torch.randn((1, 8, 1, 64), device="cuda")
    with pytest.raises(ValueError, match="group"):
        ops.decode_attention(q, kv, kv, valid)      # G = 18 > 8
    kv = torch.randn((1, 8, 2, 64), device="cuda")
    with pytest.raises(ValueError):
        ops.decode_attention(q[:, :, :4], kv.transpose(1, 2).contiguous()
                             .transpose(1, 2), kv, valid)
    with pytest.raises(TypeError):
        ops.decode_attention(q[:, :, :4], kv, kv, valid.int())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_refuses_a_misaligned_cache(gen, dtype):
    """A contiguous view one element into its storage is not 16-byte
    aligned; the wrapper raises before the kernel's 16-byte loads would
    fault, and the context stays usable."""
    b, s, k, d = 1, 8, 1, 64
    q = torch.randn((b, 1, 2, d), generator=gen, device="cuda")
    valid = torch.ones(s, dtype=torch.bool, device="cuda")
    flat = torch.randn(b * s * k * d + 1, generator=gen, device="cuda")
    bad = flat.to(dtype)[1:].view(b, s, k, d)
    good = bad.clone()
    assert bad.is_contiguous() and bad.data_ptr() % 16
    with pytest.raises(ValueError, match="16-byte"):
        ops.decode_attention(q, bad, good, valid)
    with pytest.raises(ValueError, match="16-byte"):
        ops.decode_attention(q, good, bad, valid)
    out = ops.decode_attention(q, good, good, valid)
    torch.testing.assert_close(
        out, da.decode_attention_plain(q, good, good, valid), atol=ATT_ATOL,
        rtol=0)


def test_engine_on_card_matches_cpu_teacher_forced(gen):
    """Reduced qwen2-1.5b cascade: the card (kernels) against the CPU (plain
    versions) on the same params; one host fetch per serve; the launch
    counts follow the loop."""
    from repro_torch.configs.base import HIConfig
    from repro_torch.configs.registry import ARCHS
    from repro_torch.models import model_zoo
    from repro_torch.parity import greedy_agreement
    from repro_torch.serving.engine import HIEngine, TierModel

    cfg = ARCHS["qwen2-1.5b"].reduced()
    s_cfg = cfg.s_variant(4)
    g = torch.Generator().manual_seed(0)
    cpu = [TierModel(c, model_zoo.init_params(g, c)) for c in (s_cfg, cfg)]

    def to(tree, dev):
        return {k: to(v, dev) if isinstance(v, dict) else v.to(dev)
                for k, v in tree.items()}

    gpu = [TierModel(t.cfg, to(t.params, "cuda")) for t in cpu]
    hi = HIConfig(theta=0.6, capacity_factor=0.5)
    toks = np.random.default_rng(0).integers(1, cfg.vocab_size, (8, 16))
    outs = {}
    for name, tiers in (("cpu", cpu), ("cuda", gpu)):
        eng = HIEngine(*tiers, hi, cache_len=32, max_new_tokens=6)
        ops.reset_launch_counts()
        outs[name] = eng.serve(toks.astype(np.int32))
        counts = ops.launch_counts()
    assert counts == {"hi_gate": 2 * 6,
                      "decode_attention": 6 * (s_cfg.num_layers
                                               + cfg.num_layers),
                      # the paged kernels belong to serve_stream
                      "decode_attention_paged": 0,
                      "decode_attention_chunk_paged": 0, "copy_pages": 0,
                      "ssd_chunk": 0, **NO_INT8, **NO_MOE}
    # teacher-forced S-tier logits along the CPU's tokens
    logs = {}
    for name, tier, dev in (("cpu", cpu[0], "cpu"), ("cuda", gpu[0], "cuda")):
        cache = model_zoo.init_cache(s_cfg, 8, 32, device=dev)
        lg, cache = model_zoo.prefill(tier.params, s_cfg,
                                      torch.as_tensor(toks, device=dev), cache)
        steps = [lg.cpu().numpy()]
        for i in range(5):
            tok = torch.as_tensor(outs["cpu"]["s_tokens"][:, i:i + 1],
                                  dtype=torch.int64, device=dev)
            lg, cache = model_zoo.decode_step(tier.params, s_cfg, tok, cache)
            steps.append(lg.cpu().numpy())
        logs[name] = np.stack(steps)
    np.testing.assert_allclose(logs["cuda"], logs["cpu"], atol=5e-3, rtol=5e-3)
    n, agree = greedy_agreement(logs["cpu"], logs["cuda"], 5e-3)
    assert n > 0 and agree == n


def test_cascade_never_synchronises_with_the_host(gen):
    """Between the tiers everything stays on the card: the whole cascade
    (both tiers' prefill and decode, hi_gate, route, gather, scatter-merge,
    agreement) runs under the sync debugger set to raise."""
    from repro_torch.configs.base import HIConfig
    from repro_torch.configs.registry import ARCHS
    from repro_torch.core.router import capacity_for
    from repro_torch.kernels import build
    from repro_torch.models import model_zoo
    from repro_torch.serving.engine import _make_cascade, build_engine

    cfg = ARCHS["gemma3-1b"].reduced()
    hi = HIConfig(theta=0.6, capacity_factor=0.5)
    eng = build_engine(cfg, hi, max_new_tokens=4, cache_len=32)
    build.library()                                  # build outside the check
    cap = capacity_for(8, hi.capacity_factor)
    fn = _make_cascade(eng.s.cfg, eng.l.cfg, hi, 4, cap)
    s_cache = model_zoo.init_cache(eng.s.cfg, 8, 32)
    l_cache = model_zoo.init_cache(eng.l.cfg, cap, 32)
    toks = torch.randint(0, cfg.vocab_size, (8, 16), generator=gen,
                         device="cuda")
    theta = torch.tensor(0.6, device="cuda")
    fn(eng.s.params, eng.l.params, toks, theta, s_cache, l_cache)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out, _, _ = fn(eng.s.params, eng.l.params, toks, theta, s_cache,
                       l_cache)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert out["tokens"].shape == (8, 4) and out["tokens"].is_cuda


# ---------------------------------------------------------------------------
# paged kernels (continuous serving)
# ---------------------------------------------------------------------------

def _paged_inputs(gen, b, h, k, d, page, npg, c, dtype, window=None,
                  masked_slot=True):
    """Shuffled physical pages; slot 0 holds only the pages its queries
    reach (the rest of its row is the null page 0); the last slot sees no
    key when ``masked_slot``.  Every key position no query of its slot may
    see, and page 0, hold NaN or inf: the kernels must skip them."""
    p = b * npg + 3
    pool_k = torch.randn((p, page, k, d), generator=gen, device="cuda")
    pool_v = torch.randn((p, page, k, d), generator=gen, device="cuda")
    perm = torch.randperm(p - 1, generator=gen, device="cuda")[: b * npg] + 1
    block = perm.to(torch.int32).reshape(b, npg)
    s_tot = npg * page
    hi = torch.randint(c, s_tot + 1, (b,), generator=gen, device="cuda")
    pos = hi - c                                   # first query position
    pos[0] = min(3 * page + 1, s_tot - c)
    qpos = pos[:, None] + torch.arange(c, device="cuda")[None, :]
    kpos = torch.arange(s_tot, device="cuda")
    valid = kpos[None, None, :] <= qpos[:, :, None]
    if window is not None:
        valid &= qpos[:, :, None] - kpos[None, None, :] < window
    if masked_slot and b > 1:
        valid[-1] = False
    last_page = int(pos[0] + c - 1) // page
    block[0, last_page + 1:] = 0
    seen = valid.any(dim=1)                        # (B, S_tot)
    clean_k, clean_v = pool_k.clone(), pool_v.clone()
    bi, s = torch.nonzero(~seen, as_tuple=True)
    pg, off = block[bi, s // page].long(), s % page
    pool_k[pg, off] = float("nan")
    pool_v[pg, off] = float("inf")
    pool_k[0], pool_v[0] = float("nan"), float("-inf")
    q = torch.randn((b, c, h, d), generator=gen, device="cuda")
    return (q, pool_k.to(dtype), pool_v.to(dtype), block, valid,
            clean_k.to(dtype), clean_v.to(dtype))


@pytest.mark.parametrize("d", da.PAGED_HEAD_DIMS)
@pytest.mark.parametrize("b,h,k,page,npg", [(4, 12, 2, 16, 34),
                                            (8, 3, 1, 16, 34),
                                            (3, 8, 1, 8, 5),
                                            (2, 4, 2, 4, 9)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [None, 40])
def test_paged_decode_kernel_matches_plain(gen, d, b, h, k, page, npg, dtype,
                                           window):
    q, pk, pv, block, valid, ck, cv = _paged_inputs(
        gen, b, h, k, d, page, npg, 1, dtype, window)
    before = da.decode_attention_paged_cuda.launches
    out = ops.decode_attention_paged(q, pk, pv, block, valid[:, 0])
    torch.cuda.synchronize()
    assert da.decode_attention_paged_cuda.launches == before + 1
    assert torch.isfinite(out).all()
    ref = da.decode_attention_paged_plain(q, ck, cv, block, valid[:, 0])
    torch.testing.assert_close(out, ref, atol=ATT_ATOL, rtol=0)
    assert (out[-1] == 0).all()                    # sees no key: returns 0


# (C, H, K): C in 1, 7, 17, 64, 256 (not all multiples of the chunk
# kernel's 32-row tile), group sizes 1, 3, 4, 6 and 8
CHUNK_SHAPES = [(64, 12, 2), (64, 3, 1), (4, 8, 2), (7, 6, 1), (1, 4, 4),
                (17, 8, 1), (256, 12, 2), (17, 3, 3)]


@pytest.mark.parametrize("c,h,k", CHUNK_SHAPES)
@pytest.mark.parametrize("d", [64, 80, 120, 128, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [None, 24])
def test_paged_chunk_kernel_matches_plain(gen, c, h, k, d, dtype, window):
    """The chunk kernel (C > 1 on the tensor cores, C = 1 the decode
    kernel) with NaN / inf planted in page 0 and every row no query of a
    slot sees; the last slot sees no key and one query token of slot 0
    none either: both return exactly 0.  The 24-position window gives the
    rows of one 32-row block different visible keys."""
    q, pk, pv, block, valid, ck, cv = _paged_inputs(
        gen, 3, h, k, d, 16, max(12, c // 16 + 4), c, dtype, window)
    valid[0, c // 2] = False
    before = da.decode_attention_chunk_paged_cuda.launches
    out = ops.decode_attention_chunk_paged(q, pk, pv, block, valid)
    torch.cuda.synchronize()
    assert da.decode_attention_chunk_paged_cuda.launches == before + 1
    assert torch.isfinite(out).all()
    assert (out[-1] == 0).all() and (out[0, c // 2] == 0).all()
    ref = da.decode_attention_chunk_paged_plain(q, ck, cv, block, valid)
    torch.testing.assert_close(out, ref, atol=ATT_ATOL, rtol=0)
    # the plain version skips the same garbage
    torch.testing.assert_close(
        da.decode_attention_chunk_paged_plain(q, pk, pv, block, valid), ref,
        atol=0, rtol=0)


def test_paged_wrappers_refuse_what_the_kernel_does_not_take(gen):
    q, pk, pv, block, valid, _, _ = _paged_inputs(gen, 2, 4, 2, 64, 8, 4, 1,
                                                  torch.bfloat16)
    with pytest.raises(ValueError, match="head dim"):
        da.decode_attention_paged_cuda(q[..., :48], pk[..., :48].contiguous(),
                                       pv[..., :48].contiguous(), block,
                                       valid[:, 0])
    with pytest.raises(TypeError, match="dtypes"):
        da.decode_attention_paged_cuda(q, pk, pv.float(), block, valid[:, 0])
    with pytest.raises(ValueError, match="agree"):
        da.decode_attention_chunk_paged_cuda(q, pk, pv, block[:1], valid)


def _int8_inputs(gen, b, h, k, d, page, npg, c, window=None):
    """``_paged_inputs``' layout with int8 pools and (P, K) scales.  Returns
    (q, pools, scales, block, valid) with garbage where no query of a slot
    may look (arbitrary bytes in unseen rows; NaN / inf scales on page 0,
    on pages no slot holds and on pages a slot holds but does not see), and
    the same inputs with every scale finite."""
    q, pk, _, block, valid, _, _ = _paged_inputs(gen, b, h, k, d, page, npg,
                                                 c, torch.float32, window)
    p = pk.shape[0]

    def levels():
        return torch.randint(-128, 128, pk.shape, generator=gen,
                             device="cuda").to(torch.int8)

    pools = (levels(), levels())
    clean = tuple(torch.rand((p, k), generator=gen, device="cuda") * 0.05
                  for _ in range(2))
    seen = valid.any(dim=1).reshape(b, npg, page).any(dim=2)  # page seen
    hidden = torch.ones(p, dtype=torch.bool, device="cuda")
    hidden[block[seen].long()] = False
    dirty = tuple(t.clone() for t in clean)
    dirty[0][hidden], dirty[1][hidden] = float("nan"), float("inf")
    return q, pools, dirty, clean, block, valid


@pytest.mark.parametrize("d,b,h,k,page,npg", [(128, 4, 12, 2, 16, 34),
                                              (128, 8, 3, 1, 16, 34),
                                              (80, 4, 32, 32, 16, 18),
                                              (120, 4, 32, 8, 16, 34),
                                              (120, 8, 8, 8, 8, 68),
                                              (64, 3, 8, 1, 8, 5),
                                              (32, 2, 4, 2, 4, 9),
                                              (256, 2, 8, 2, 16, 6)])
@pytest.mark.parametrize("window", [None, 40])
def test_paged_int8_decode_kernel_matches_plain(gen, d, b, h, k, page, npg,
                                                window):
    """The int8 body (``_paged_kernel_quant``): dequantise each staged row
    by its page's scale, then the float32 online softmax; garbage rows and
    scales no query may see never reach a result."""
    q, (pk, pv), dirty, clean, block, valid = _int8_inputs(
        gen, b, h, k, d, page, npg, 1, window)
    before = (da.decode_attention_paged_cuda.launches,
              da.decode_attention_paged_cuda.launches_int8)
    out = ops.decode_attention_paged(q, pk, pv, block, valid[:, 0], *dirty)
    torch.cuda.synchronize()
    assert (da.decode_attention_paged_cuda.launches,
            da.decode_attention_paged_cuda.launches_int8) == \
        (before[0], before[1] + 1)
    assert torch.isfinite(out).all()
    ref = da.decode_attention_paged_plain(q, pk, pv, block, valid[:, 0],
                                          *clean)
    torch.testing.assert_close(out, ref, atol=ATT_ATOL, rtol=0)
    assert (out[-1] == 0).all()


@pytest.mark.parametrize("c,h,k", [(256, 12, 2), (64, 3, 1), (7, 32, 32),
                                   (4, 8, 2), (1, 6, 1), (17, 8, 1)])
@pytest.mark.parametrize("d", [64, 80, 120, 128, 256])
@pytest.mark.parametrize("window", [None, 40])
def test_paged_int8_chunk_kernel_matches_plain(gen, c, h, k, d, window):
    """The int8 chunk body (``_chunk_paged_kernel_quant``): arbitrary bytes
    in rows no query of a slot sees and NaN / inf scales on every page no
    query reaches never reach a result; the slot that sees no key returns
    exactly 0."""
    q, (pk, pv), dirty, clean, block, valid = _int8_inputs(
        gen, 2, h, k, d, 16, 34, c, window)
    before = da.decode_attention_chunk_paged_cuda.launches_int8
    out = ops.decode_attention_chunk_paged(q, pk, pv, block, valid, *dirty)
    torch.cuda.synchronize()
    assert da.decode_attention_chunk_paged_cuda.launches_int8 == before + 1
    assert torch.isfinite(out).all()
    assert (out[-1] == 0).all()
    ref = da.decode_attention_chunk_paged_plain(q, pk, pv, block, valid,
                                                *clean)
    torch.testing.assert_close(out, ref, atol=ATT_ATOL, rtol=0)


@pytest.mark.parametrize("page", [4, 8])
@pytest.mark.parametrize("c,h,k,d", [(17, 8, 1, 64), (64, 12, 2, 128),
                                     (40, 32, 8, 120)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("window", [None, 24])
def test_paged_chunk_kernel_at_small_pages(gen, page, c, h, k, d, dtype,
                                           window):
    """Pages of 4 and 8 keys: one 64-key tile of the chunk kernel spans
    several pages, each found through the block table, with the garbage of
    ``_paged_inputs`` / ``_int8_inputs`` planted where no query looks."""
    npg = c // page + 6
    if dtype == "int8":
        q, (pk, pv), scales, clean, block, valid = _int8_inputs(
            gen, 3, h, k, d, page, npg, c, window)
        ck, cv = pk, pv
    else:
        q, pk, pv, block, valid, ck, cv = _paged_inputs(
            gen, 3, h, k, d, page, npg, c, getattr(torch, dtype), window)
        scales = clean = ()
    valid[0, c // 2] = False
    counter = "launches_int8" if dtype == "int8" else "launches"
    before = getattr(da.decode_attention_chunk_paged_cuda, counter)
    out = ops.decode_attention_chunk_paged(q, pk, pv, block, valid, *scales)
    torch.cuda.synchronize()
    assert getattr(da.decode_attention_chunk_paged_cuda, counter) == \
        before + 1
    assert torch.isfinite(out).all()
    assert (out[-1] == 0).all() and (out[0, c // 2] == 0).all()
    ref = da.decode_attention_chunk_paged_plain(q, ck, cv, block, valid,
                                                *clean)
    torch.testing.assert_close(out, ref, atol=ATT_ATOL, rtol=0)


def test_paged_launch_refuses_unknown_dtype_codes(gen):
    """Both C entry points, the decode kernel's (C = 1) and the chunk
    kernel's (C > 1), refuse a dtype code they do not know, and int8
    without scales or bf16 with them, with cudaErrorInvalidValue (1), and
    launch nothing; each refuses the other's C."""
    from repro_torch.kernels import build
    q, (pk, pv), _, clean, block, valid = _int8_inputs(gen, 2, 4, 2, 64, 8,
                                                       4, 1)
    out = torch.zeros((2, 1, 4, 64), device="cuda")
    lib = build.library()
    stream = torch.cuda.current_stream().cuda_stream
    vb = valid.contiguous()

    def launch(code, sk, sv, c=1, entry=lib.paged_attention_launch):
        head = (q.data_ptr(), pk.data_ptr(), pv.data_ptr(), sk, sv,
                block.data_ptr(), vb.data_ptr())
        if entry is lib.paged_attention_launch:
            # one split of the 4 pages: no workspace, no counters
            return entry(*head, None, None, out.data_ptr(), code, 2, c, 2, 2,
                         64, 8, 4, 4, 0.125, stream)
        return entry(*head, out.data_ptr(), code, 2, c, 2, 2, 64, 8, 4,
                     0.125, stream)

    s = (clean[0].data_ptr(), clean[1].data_ptr())
    chunk = {"c": 2, "entry": lib.chunk_paged_attention_launch}
    for kw in ({}, chunk):
        assert launch(3, None, None, **kw) == 1
        assert launch(-1, *s, **kw) == 1
        assert launch(2, None, None, **kw) == 1
        assert launch(2, s[0], None, **kw) == 1
        assert launch(1, *s, **kw) == 1
    assert launch(1, None, None, c=2) == 1
    assert launch(1, None, None, c=1,
                  entry=lib.chunk_paged_attention_launch) == 1
    torch.cuda.synchronize()
    assert (out == 0).all()


@pytest.mark.parametrize("page", [4, 8, 16])
@pytest.mark.parametrize("d", [80, 120, 128])
@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_paged_decode_split_kernel_matches_plain(gen, page, d, dtype):
    """The split decode kernel at qwen2's L decode widths (B 4, H 12, K 2,
    544 positions: 17 splits of whole pages at pages of 4, 8 and 16), with
    NaN / inf in page 0 and every row no query sees (int8: -128 bytes there
    and NaN / inf scales on every page no query reaches); the last slot
    sees nothing and returns exactly 0."""
    b, h, k, npg = 4, 12, 2, 544 // page
    assert -(-npg // da.paged_split_pages(b, k, npg, page)) > 1
    if dtype == "int8":
        q, (pk, pv), scales, clean, block, valid = _int8_inputs(
            gen, b, h, k, d, page, npg, 1)
        ck, cv = pk, pv
        counter = "launches_int8"
    else:
        q, pk, pv, block, valid, ck, cv = _paged_inputs(
            gen, b, h, k, d, page, npg, 1, torch.bfloat16)
        scales = clean = ()
        counter = "launches"
    before = getattr(da.decode_attention_paged_cuda, counter)
    out = ops.decode_attention_paged(q, pk, pv, block, valid[:, 0], *scales)
    torch.cuda.synchronize()
    assert getattr(da.decode_attention_paged_cuda, counter) == before + 1
    assert torch.isfinite(out).all()
    ref = da.decode_attention_paged_plain(q, ck, cv, block, valid[:, 0],
                                          *clean)
    torch.testing.assert_close(out, ref, atol=ATT_ATOL, rtol=0)
    assert (out[-1] == 0).all()


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_paged_decode_split_kernel_with_one_split_seen(gen, dtype):
    """Slot 0 sees keys of one split only (a window inside its fifth split):
    every other split of it writes m = -1e30, l = 0, acc = 0 and the merge
    keeps the one it sees; slot 1 sees a prefix; slot 2 sees nothing and
    returns exactly 0.  NaN / inf (int8: -128 bytes, and NaN / inf scales
    on pages no query reaches) in page 0 and every row no query sees."""
    b, h, k, d, page, npg = 3, 12, 2, 128, 16, 34
    split = da.paged_split_pages(b, k, npg, page)
    lo = 4 * split * page
    s_tot = npg * page
    valid = torch.zeros((b, s_tot), dtype=torch.bool, device="cuda")
    valid[0, lo + 3:lo + split * page - 5] = True
    valid[1, :lo // 2] = True
    p = b * npg + 1
    block = (torch.randperm(p - 1, generator=gen, device="cuda")[: b * npg]
             + 1).to(torch.int32).reshape(b, npg)
    q = torch.randn((b, 1, h, d), generator=gen, device="cuda")
    kpos = torch.arange(s_tot, device="cuda")
    rows = (block.long()[:, kpos // page] * page + kpos % page)[~valid]
    if dtype == "int8":
        clean = [torch.randint(-127, 128, (p, page, k, d), generator=gen,
                               device="cuda").to(torch.int8)
                 for _ in range(2)]
        scales = [torch.rand((p, k), generator=gen, device="cuda") * 0.05
                  for _ in range(2)]
        dirty = [t.clone() for t in clean]
        for t in dirty:
            t.view(-1, k, d)[rows] = -128
            t[0] = -128
        reached = valid.reshape(b, npg, page).any(dim=2)
        hidden = torch.ones(p, dtype=torch.bool, device="cuda")
        hidden[block[reached].long()] = False
        dirty_scales = [t.clone() for t in scales]
        dirty_scales[0][hidden] = float("nan")
        dirty_scales[1][hidden] = float("inf")
    else:
        clean = [torch.randn((p, page, k, d), generator=gen,
                             device="cuda").to(torch.bfloat16)
                 for _ in range(2)]
        dirty = [t.clone() for t in clean]
        for t, x in zip(dirty, (float("nan"), float("inf"))):
            t.view(-1, k, d)[rows] = x
            t[0] = float("nan")
        scales = dirty_scales = []
    out = da.decode_attention_paged_cuda(q, *dirty, block, valid,
                                         *dirty_scales)
    ref = da.decode_attention_paged_plain(q, *clean, block, valid, *scales)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all() and (out[2] == 0).all()
    torch.testing.assert_close(out, ref, atol=ATT_ATOL, rtol=0)


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
@pytest.mark.parametrize("b,h,k,d,npg", [(4, 12, 2, 128, 34),
                                         (4, 32, 32, 80, 18),
                                         (4, 32, 8, 120, 34)])
def test_paged_decode_split_kernel_gives_the_same_bits_twice(gen, dtype, b,
                                                              h, k, d, npg):
    """The splits merge in a fixed order, whichever block finishes last:
    two calls on the same inputs give the same bits (qwen2's L shape, 17
    splits; zamba2's, 3)."""
    if dtype == "int8":
        q, (pk, pv), scales, _, block, valid = _int8_inputs(
            gen, b, h, k, d, 16, npg, 1)
    else:
        q, pk, pv, block, valid, _, _ = _paged_inputs(
            gen, b, h, k, d, 16, npg, 1, torch.bfloat16)
        scales = ()
    one = da.decode_attention_paged_cuda(q, pk, pv, block, valid[:, 0],
                                         *scales)
    two = da.decode_attention_paged_cuda(q, pk, pv, block, valid[:, 0],
                                         *scales)
    torch.cuda.synchronize()
    assert torch.equal(one.view(torch.int32), two.view(torch.int32))


def _bits(t):
    return t.view(torch.int16) if t.element_size() == 2 else \
        t.view(torch.int32)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("layers,pages,pairs", [(28, 393, 4), (7, 785, 8),
                                                (2, 700, 300)])
def test_copy_pages_kernel_copies_only_its_pairs(gen, dtype, layers, pages,
                                                 pairs):
    """In place, across all layers and both pools in one launch (two past
    256 pairs); every page that is not a destination keeps its bits, NaN
    included."""
    shape = (layers, pages, 16, 2, 128)
    pk = torch.full(shape, float("nan"), device="cuda").to(dtype)
    pv = torch.full(shape, float("nan"), device="cuda").to(dtype)
    perm = torch.randperm(pages - 1, generator=gen,
                          device="cuda").cpu().numpy() + 1
    src, dst = perm[:pairs].astype(np.int32), perm[pairs:2 * pairs] \
        .astype(np.int32)
    for t in (pk, pv):
        t[:, src] = torch.randn((layers, pairs) + shape[2:], generator=gen,
                                device="cuda").to(dtype)
    src_p = np.concatenate([src, [0, 0]]).astype(np.int32)  # (0, 0) pads
    dst_p = np.concatenate([dst, [0, 0]]).astype(np.int32)
    want_k, want_v = pk.clone(), pv.clone()
    from repro_torch.kernels import copy_pages as cp
    cp.copy_pages_plain((want_k, want_v), src_p, dst_p)
    before = cp.copy_pages_cuda.launches
    ops.copy_pages((pk, pv), src_p, dst_p)
    torch.cuda.synchronize()
    assert cp.copy_pages_cuda.launches == before + -(-pairs // cp.MAX_PAIRS)
    assert torch.equal(_bits(pk), _bits(want_k))
    assert torch.equal(_bits(pv), _bits(want_v))
    assert torch.equal(_bits(pk[:, dst]), _bits(pk[:, src]))
    with pytest.raises(ValueError, match="also a source"):
        ops.copy_pages((pk, pv), src[:2], np.array([dst[0], src[0]]))


@pytest.mark.parametrize("kh", [1, 2, 4, 32])
def test_copy_pages_kernel_moves_int8_pages_with_their_scale_rows(gen, kh):
    """K and V int8 pools and their (L, P, K) float32 scale rows (4, 8, 16
    and 128 bytes a row) in one launch, bit-equal to the plain version."""
    from repro_torch.kernels import copy_pages as cp
    layers, pages, pairs = 4, 97, 5
    shape = (layers, pages, 16, kh, 80)
    pools = [torch.randint(-128, 128, shape, generator=gen,
                           device="cuda").to(torch.int8) for _ in range(2)]
    scales = [torch.full((layers, pages, kh), float("nan"), device="cuda")
              for _ in range(2)]
    perm = torch.randperm(pages - 1, generator=gen,
                          device="cuda").cpu().numpy() + 1
    src, dst = perm[:pairs].astype(np.int32), perm[pairs:2 * pairs] \
        .astype(np.int32)
    for t in scales:
        t[:, src] = torch.rand((layers, pairs, kh), generator=gen,
                               device="cuda")
    tensors = pools + scales
    want = [t.clone() for t in tensors]
    cp.copy_pages_plain(want, src, dst)
    before = (cp.copy_pages_cuda.launches, cp.copy_pages_cuda.launches_int8)
    ops.copy_pages(tensors, src, dst)
    torch.cuda.synchronize()
    assert (cp.copy_pages_cuda.launches, cp.copy_pages_cuda.launches_int8) \
        == (before[0], before[1] + 1)
    for got, ref in zip(tensors, want):
        assert torch.equal(got.view(torch.uint8), ref.view(torch.uint8))
    assert torch.equal(scales[0][:, dst], scales[0][:, src])


def test_copy_pages_after_a_pool_is_reallocated(gen):
    """The wrapper keeps each tuple of pools' launch block: a pool
    reallocated at the same shape (while the old one lives, so at another
    address) misses that cache, and its copy lands in the new pool, bytes
    equal to the plain version's, the old pool untouched."""
    from repro_torch.kernels import copy_pages as cp
    shape = (4, 50, 16, 2, 128)

    def pools():
        return [torch.randn(shape, generator=gen, device="cuda")
                .to(torch.bfloat16) for _ in range(2)]

    src, dst = np.array([3, 0, 5], np.int32), np.array([7, 0, 9], np.int32)
    old = pools()
    want = [t.clone() for t in old]
    cp.copy_pages_plain(want, src, dst)
    ops.copy_pages(old, src, dst)
    new = [old[0].clone(), pools()[1]]
    new[0][:, 7] = 0
    snapshot = [t.clone() for t in old]
    want_new = [t.clone() for t in new]
    cp.copy_pages_plain(want_new, src, dst)
    ops.copy_pages(new, src, dst)
    torch.cuda.synchronize()
    assert new[0].data_ptr() != old[0].data_ptr()
    for got, ref in zip(old + new, want + want_new):
        assert torch.equal(_bits(got), _bits(ref))
    for got, ref in zip(old, snapshot):
        assert torch.equal(_bits(got), _bits(ref))


def _reduced_tiers(name="qwen2-1.5b"):
    from repro_torch.configs.registry import ARCHS
    from repro_torch.models import model_zoo
    from repro_torch.serving.engine import TierModel
    cfg = ARCHS[name].reduced()
    g = torch.Generator().manual_seed(0)
    cpu = [TierModel(c, model_zoo.init_params(g, c))
           for c in (cfg.s_variant(4), cfg)]

    def to(tree, dev):
        return {k: to(v, dev) if isinstance(v, dict) else v.to(dev)
                for k, v in tree.items()}

    return cpu, [TierModel(t.cfg, to(t.params, "cuda")) for t in cpu]


def _stream_requests(vocab, n=10, seed=0):
    from repro_torch.serving.batcher import Request
    rng = np.random.default_rng(seed)
    # repeats of a 14-token prefix land in the 20 bucket (a partial tail
    # page: restores copy it) and take the admit lane (chunk_size 20); the
    # 48-bucket prompts take the chunk lane
    base = rng.integers(1, vocab, 14).astype(np.int32)
    reqs = []
    for i in range(n):
        if i % 3 == 0:                              # shared prefix, repeats
            p = np.concatenate([base, np.full(4 + i % 2, 7, np.int32)])
        else:
            p = rng.integers(1, vocab, int(rng.integers(4, 48))) \
                .astype(np.int32)
        reqs.append(Request(i, p, max_new_tokens=int(rng.integers(2, 7))))
    return reqs


STREAM_KW = dict(buckets=(8, 20, 48), num_slots=4, l_slots=2, page_size=8,
                 decode_block=2, chunk_prefill=True, chunk_size=20,
                 chunk_width=2, validate=True)


def test_stream_on_card_matches_cpu(gen, monkeypatch):
    """Reduced qwen2-1.5b ``serve_stream`` (prefix sharing with COW, the
    chunk lane) on the card against the CPU's plain versions: equal
    statuses, tokens equal up to the CPU's first non-decisive position
    (teacher-forced), one host fetch per tick, and each kernel's launches
    exactly what the host's lane flags predict."""
    from repro_torch.configs.base import HIConfig
    from repro_torch.models import model_zoo
    from repro_torch.parity import decisive
    from repro_torch.serving import engine as engine_mod
    from repro_torch.serving.batcher import pad_to_bucket
    from repro_torch.serving.engine import HIEngine
    from repro_torch.serving.faults import STATUSES

    cpu, gpu = _reduced_tiers()
    reqs = _stream_requests(cpu[0].cfg.vocab_size)
    fetches = []
    real = engine_mod._host_fetch
    monkeypatch.setattr(engine_mod, "_host_fetch",
                        lambda tree: (fetches.append(1), real(tree))[1])
    outs = {}
    for name, tiers in (("cpu", cpu), ("cuda", gpu)):
        eng = HIEngine(*tiers, HIConfig(theta=0.02, capacity_factor=1.0),
                       max_new_tokens=6)
        ops.reset_launch_counts()
        n0 = len(fetches)
        outs[name] = eng.serve_stream(reqs, **STREAM_KW)
        assert len(fetches) - n0 == eng.stats["stream_ticks"]
        counts = ops.launch_counts()
        sched = eng._stream[1]
    s, l = sched.srt, sched.lrt
    kb = STREAM_KW["decode_block"]
    ls, ll = s.pool.cfg.num_layers, l.pool.cfg.num_layers
    assert counts == {
        "hi_gate": sum(t.lane_ticks["admit"] + t.lane_ticks["chunk"]
                       + kb * t.lane_ticks["live"] for t in (s, l)),
        "decode_attention": 0,
        "decode_attention_paged": kb * (ls * s.lane_ticks["live"]
                                        + ll * l.lane_ticks["live"]),
        "decode_attention_chunk_paged": (ls * s.lane_ticks["chunk"]
                                         + ll * l.lane_ticks["chunk"]),
        "copy_pages": s.lane_ticks["cow"] + l.lane_ticks["cow"],
        "ssd_chunk": 0, **NO_INT8, **NO_MOE}
    assert counts["copy_pages"] > 0 and counts["decode_attention_chunk_paged"]
    assert s.pool.held_slots == l.pool.held_slots == []
    for r in reqs:
        c, g = outs["cpu"][r.request_id], outs["cuda"][r.request_id]
        assert c["status"] == g["status"] and g["status"] in STATUSES
        prompt = np.zeros(pad_to_bucket(len(r.prompt), STREAM_KW["buckets"]),
                          np.int64)
        prompt[: len(r.prompt)] = r.prompt
        # the CPU's logits along its own S tokens decide what counts
        tier = cpu[0]
        cache = model_zoo.init_cache(tier.cfg, 1, 64, device="cpu")
        lg, cache = model_zoo.prefill(tier.params, tier.cfg,
                                      torch.from_numpy(prompt[None]), cache)
        logs = [lg[0].numpy()]
        for t in c["s_tokens"][:-1]:
            lg, cache = model_zoo.decode_step(
                tier.params, tier.cfg, torch.tensor([[int(t)]]), cache)
            logs.append(lg[0].numpy())
        dec = decisive(np.stack(logs), 1e-2)
        first = int(np.argmin(dec)) if not dec.all() else len(dec)
        np.testing.assert_array_equal(g["s_tokens"][:first],
                                      c["s_tokens"][:first])


def test_stream_tick_synchronises_only_in_host_fetch(gen, monkeypatch):
    """Inside a tick nothing reads the card on the host: every tick of a
    reduced ``serve_stream`` runs under the sync debugger set to raise,
    which ``_host_fetch`` alone lifts for its one copy."""
    _ticks_under_the_sync_debugger(monkeypatch, "qwen2-1.5b")


def test_moe_stream_tick_synchronises_only_in_host_fetch(gen, monkeypatch):
    """The same for the MoE family: the routing, its drop policy and the
    expert scatter read nothing back on the host."""
    _ticks_under_the_sync_debugger(monkeypatch, "deepseek-moe-16b")


def _ticks_under_the_sync_debugger(monkeypatch, name):
    from repro_torch.configs.base import HIConfig
    from repro_torch.kernels import build
    from repro_torch.serving import engine as engine_mod
    from repro_torch.serving.engine import HIEngine

    _, gpu = _reduced_tiers(name)
    reqs = _stream_requests(gpu[0].cfg.vocab_size, seed=1)
    eng = HIEngine(*gpu, HIConfig(theta=0.02, capacity_factor=1.0),
                   max_new_tokens=6)
    build.library()
    eng.serve_stream(reqs, **STREAM_KW)           # warm: allocations, build
    torch.cuda.synchronize()
    real = engine_mod._host_fetch

    def fetch(tree):
        torch.cuda.set_sync_debug_mode("default")
        try:
            return real(tree)
        finally:
            torch.cuda.set_sync_debug_mode("error")

    monkeypatch.setattr(engine_mod, "_host_fetch", fetch)
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = eng.serve_stream(reqs, **STREAM_KW)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert len(out) == len(reqs)


@pytest.mark.parametrize("name", ["qwen2-1.5b", "zamba2-2.7b"])
def test_int8_paged_trace_on_card_matches_cpu(gen, name):
    """``parity.paged_trace`` over reduced ``name``'s int8 pool (prefill,
    a COW of a part-filled page, decode steps, a chunk that writes one page
    several times and crosses into the next) on the card against the CPU,
    same params, under ``parity.traces_close``: logits within the family's
    ``TRACE_LOGIT_TOL``, levels within 1, scale rows within rtol 5e-3; the
    int8 bodies and the scale-row copy launched."""
    from repro_torch.configs.registry import ARCHS
    from repro_torch.models import model_zoo
    from repro_torch.parity import TRACE_LOGIT_TOL, paged_trace, traces_close
    cfg = ARCHS[name].reduced()
    params = model_zoo.init_params(torch.Generator().manual_seed(2), cfg)
    cpu = paged_trace(params, cfg, torch.int8)
    ops.reset_launch_counts()
    card = paged_trace(_cuda(params), cfg, torch.int8, "cuda")
    counts = ops.launch_counts()
    traces_close(card, cpu, TRACE_LOGIT_TOL[name])
    assert counts["decode_attention_paged[int8]"] > 0
    assert counts["copy_pages[int8]"] == 1
    assert (counts["decode_attention_chunk_paged[int8]"] > 0) \
        == (name == "qwen2-1.5b")
    assert counts["decode_attention_paged"] == counts["copy_pages"] == 0


def _cuda(tree):
    if isinstance(tree, dict):
        return {k: _cuda(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_cuda(v) for v in tree]
    return tree.cuda()


# ---------------------------------------------------------------------------
# the SSD intra-chunk kernel, the paged kernel at head dim 80, and the
# recurrent families' continuous serving
# ---------------------------------------------------------------------------

# float32 on both sides; the kernel sums in another order over <= 128 terms
SSD_ATOL, SSD_RTOL = 1e-4, 1e-4


def _ssd_inputs(gen, b, nc, q, h, p, n, live=None):
    x = torch.randn((b, nc, q, h, p), generator=gen, device="cuda")
    dt = torch.rand((b, nc, q, h), generator=gen, device="cuda") * 0.5
    if live is not None:
        dt[:, :, live:] = 0.0            # a right-padded row's tail
    A = -torch.rand((h,), generator=gen, device="cuda") - 0.2
    B = torch.randn((b, nc, q, n), generator=gen, device="cuda")
    C = torch.randn((b, nc, q, n), generator=gen, device="cuda")
    return x, dt, A, B, C


@pytest.mark.parametrize("b,nc,q,h,p,n", [
    (2, 2, 32, 4, 16, 16),               # reduced test shape
    (1, 3, 16, 3, 8, 8),                 # heads not a multiple of 4
    (4, 4, 128, 32, 64, 128),            # mamba2-370m L admission
    (8, 4, 128, 8, 64, 128),             # mamba2-370m S admission
    (2, 2, 128, 80, 64, 64),             # zamba2-2.7b L
    (2, 2, 64, 4, 16, 32),               # Q 64, small P and N
    (1, 2, 64, 3, 8, 8),
    (2, 1, 8, 2, 8, 8),                  # Q and P below one 16-row tile
    (1, 3, 24, 5, 24, 24),               # Q and P padded to 32
])
def test_ssd_chunk_kernel_matches_plain(gen, b, nc, q, h, p, n):
    args = _ssd_inputs(gen, b, nc, q, h, p, n)
    want = ssd_scan.ssd_chunk_ref(*args)
    before = ssd_scan.ssd_chunk_cuda.launches
    got = ops.ssd_chunk(*args)
    torch.cuda.synchronize()
    assert ssd_scan.ssd_chunk_cuda.launches == before + 1
    for g, w in zip(got, want):
        assert g.shape == w.shape and bool(torch.isfinite(g).all())
        torch.testing.assert_close(g, w, atol=SSD_ATOL, rtol=SSD_RTOL)


def test_ssd_chunk_kernel_padded_tail_is_exact(gen):
    """dt = 0 past a row's length: g is exp(a_cs) at the length bit for bit
    and S does not move, whatever x holds in the tail."""
    x, dt, A, B, C = _ssd_inputs(gen, 2, 2, 128, 8, 64, 128, live=77)
    y, S, g, eacs = ssd_scan.ssd_chunk_cuda(x, dt, A, B, C)
    x2 = x.clone()
    x2[:, :, 77:] = 1e4
    _, S2, g2, _ = ssd_scan.ssd_chunk_cuda(x2, dt, A, B, C)
    torch.cuda.synchronize()
    assert torch.equal(S2, S) and torch.equal(g2, g)
    assert torch.equal(g, eacs[:, :, 76])
    assert bool(torch.isfinite(y).all())


@pytest.mark.parametrize("b,nc,q,h,p,n", [(4, 4, 128, 32, 64, 128),
                                          (4, 2, 128, 80, 64, 64)])
def test_ssd_chunk_kernel_gives_the_same_bits_twice(gen, b, nc, q, h, p, n):
    args = _ssd_inputs(gen, b, nc, q, h, p, n)
    one = ssd_scan.ssd_chunk_cuda(*args)
    two = ssd_scan.ssd_chunk_cuda(*args)
    torch.cuda.synchronize()
    for u, v in zip(one, two):
        assert torch.equal(u.view(torch.int32), v.view(torch.int32))


def test_ssd_through_ops_matches_plain_on_the_card(gen):
    """``ops.ssd`` (kernel + torch recurrence) against the model's plain
    chunked path, lengths not a multiple of the chunk."""
    from repro_torch.models import mamba2
    b, l, h, p, n = 2, 300, 8, 64, 128
    x = torch.randn((b, l, h, p), generator=gen, device="cuda")
    dt = torch.rand((b, l, h), generator=gen, device="cuda") * 0.5
    A = -torch.rand((h,), generator=gen, device="cuda") - 0.2
    B = torch.randn((b, l, n), generator=gen, device="cuda")
    C = torch.randn((b, l, n), generator=gen, device="cuda")
    y, hT = ops.ssd(x, dt, A, B, C, chunk=128)
    yr, hr = mamba2.ssd_chunked(x, dt, A, B, C, 128)
    torch.testing.assert_close(y, yr, atol=3e-4, rtol=3e-4)
    torch.testing.assert_close(hT, hr, atol=3e-4, rtol=3e-4)


def test_ssd_wrapper_refuses_what_the_kernel_does_not_take(gen):
    args = list(_ssd_inputs(gen, 1, 1, 32, 4, 16, 16))
    with pytest.raises(TypeError, match="float32"):
        ssd_scan.ssd_chunk_cuda(args[0].double(), *args[1:])
    with pytest.raises(ValueError, match="not supported"):
        ssd_scan.ssd_chunk_cuda(*_ssd_inputs(gen, 1, 1, 256, 4, 16, 16))
    with pytest.raises(ValueError, match="CUDA"):
        ssd_scan.ssd_chunk_cuda(*(t.cpu() for t in args))


def test_paged_decode_kernel_at_head_dim_80(gen):
    """zamba2-2.7b's shared block at its L-tier decode shape: 32 heads over
    32 kv heads of 80, bf16 pages, NaN and inf in every position no query
    may see (page 0, unallocated pages, stale tails)."""
    from repro_torch.kernels import decode_attention as da
    b, h, d, page, npg = 4, 32, 80, 16, 18
    pages = b * npg + 9
    pool_k = torch.randn((pages, page, h, d), generator=gen,
                         device="cuda").to(torch.bfloat16)
    pool_v = torch.randn_like(pool_k)
    block = (torch.randperm(pages - 1, generator=gen, device="cuda")[
        : b * npg] + 1).to(torch.int32).reshape(b, npg)
    block[1, 10:] = 0                     # a slot with unallocated pages
    pos = torch.tensor([250, 120, 17, 287], device="cuda")
    kpos = torch.arange(npg * page, device="cuda")
    valid = kpos[None, :] <= pos[:, None]
    for bi in range(b):
        hidden = (~valid[bi]).nonzero()[:, 0]
        phys = block[bi].long()[hidden // page]
        pool_k[phys, hidden % page] = float("nan")
        pool_v[phys, hidden % page] = float("inf")
    pool_k[0], pool_v[0] = float("nan"), float("nan")
    q = torch.randn((b, 1, h, d), generator=gen, device="cuda")
    out_k = da.decode_attention_paged_cuda(q, pool_k, pool_v, block, valid)
    out_p = da.decode_attention_paged_plain(q, pool_k, pool_v, block, valid)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(out_k).all())
    torch.testing.assert_close(out_k, out_p, atol=ATT_ATOL, rtol=0)


RECURRENT_KW = dict(buckets=(8, 20, 48), num_slots=4, l_slots=2, page_size=8,
                    decode_block=2, chunk_prefill=True, chunk_size=20,
                    chunk_width=2, validate=True)


@pytest.mark.parametrize("name", ["mamba2-370m", "zamba2-2.7b"])
def test_recurrent_stream_on_card_matches_cpu(gen, monkeypatch, name):
    """Reduced mamba2 / zamba2 ``serve_stream`` (whole-prompt restores, the
    chunk lane) on the card against the CPU: equal statuses and decisive S
    tokens, one host fetch per tick, and the launches the lane flags
    predict: ``ssd_chunk`` once per mamba layer per prefill, the paged
    kernel once per group per decode step (chunk-lane steps included)."""
    from repro_torch.configs.base import HIConfig
    from repro_torch.models import model_zoo
    from repro_torch.parity import decisive
    from repro_torch.serving import engine as engine_mod
    from repro_torch.serving.batcher import pad_to_bucket
    from repro_torch.serving.engine import HIEngine

    cpu, gpu = _reduced_tiers(name)
    reqs = _stream_requests(cpu[0].cfg.vocab_size)
    fetches = []
    real = engine_mod._host_fetch
    monkeypatch.setattr(engine_mod, "_host_fetch",
                        lambda tree: (fetches.append(1), real(tree))[1])
    outs = {}
    for dev, tiers in (("cpu", cpu), ("cuda", gpu)):
        eng = HIEngine(*tiers, HIConfig(theta=0.02, capacity_factor=1.0),
                       max_new_tokens=6)
        ops.reset_launch_counts()
        n0 = len(fetches)
        outs[dev] = eng.serve_stream(reqs, **RECURRENT_KW)
        assert len(fetches) - n0 == eng.stats["stream_ticks"]
        counts = ops.launch_counts()
        sched = eng._stream[1]
    kb, c = RECURRENT_KW["decode_block"], RECURRENT_KW["chunk_size"]
    want = dict.fromkeys(counts, 0)
    for rt in (sched.srt, sched.lrt):
        cfg, t = rt.pool.cfg, rt.lane_ticks
        want["hi_gate"] += t["admit"] + t["chunk"] + kb * t["live"]
        want["ssd_chunk"] += cfg.num_layers * t["prefill"]
        if cfg.family == "hybrid":
            g = cfg.num_layers // cfg.shared_attn_every
            want["decode_attention_paged"] += g * (kb * t["live"]
                                                   + c * t["chunk"])
            want["copy_pages"] += t["cow"]
    assert counts == want
    assert counts["ssd_chunk"] > 0 and sched.srt.lane_ticks["chunk"] > 0
    assert sched.srt.pool.held_slots == sched.lrt.pool.held_slots == []
    for r in reqs:
        cr, gr = outs["cpu"][r.request_id], outs["cuda"][r.request_id]
        assert cr["status"] == gr["status"]
        prompt = np.zeros(pad_to_bucket(len(r.prompt),
                                        RECURRENT_KW["buckets"]), np.int64)
        prompt[: len(r.prompt)] = r.prompt
        tier = cpu[0]
        cache = model_zoo.init_cache(tier.cfg, 1, 64, device="cpu")
        lg, cache = model_zoo.prefill(tier.params, tier.cfg,
                                      torch.from_numpy(prompt[None]), cache)
        logs = [lg[0].numpy()]
        for t in cr["s_tokens"][:-1]:
            lg, cache = model_zoo.decode_step(
                tier.params, tier.cfg, torch.tensor([[int(t)]]), cache)
            logs.append(lg[0].numpy())
        dec = decisive(np.stack(logs), 1e-2)
        first = int(np.argmin(dec)) if not dec.all() else len(dec)
        np.testing.assert_array_equal(gr["s_tokens"][:first],
                                      cr["s_tokens"][:first])


def test_mamba2_stream_synchronises_only_in_host_fetch(gen, monkeypatch):
    """Every tick of a reduced mamba2 ``serve_stream`` (the SSD kernel in
    the admit lane, the chunk lane's staged rollback, whole-prompt
    restores) runs under the sync debugger set to raise, which
    ``_host_fetch`` alone lifts."""
    from repro_torch.configs.base import HIConfig
    from repro_torch.kernels import build
    from repro_torch.serving import engine as engine_mod
    from repro_torch.serving.engine import HIEngine

    _, gpu = _reduced_tiers("mamba2-370m")
    reqs = _stream_requests(gpu[0].cfg.vocab_size, seed=1)
    eng = HIEngine(*gpu, HIConfig(theta=0.02, capacity_factor=1.0),
                   max_new_tokens=6)
    build.library()
    eng.serve_stream(reqs, **RECURRENT_KW)       # warm: allocations, build
    torch.cuda.synchronize()
    real = engine_mod._host_fetch

    def fetch(tree):
        torch.cuda.set_sync_debug_mode("default")
        try:
            return real(tree)
        finally:
            torch.cuda.set_sync_debug_mode("error")

    monkeypatch.setattr(engine_mod, "_host_fetch", fetch)
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = eng.serve_stream(reqs, **RECURRENT_KW)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert len(out) == len(reqs)


# ---------------------------------------------------------------------------
# the speculative verify shape; fault, speculative and observability streams
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_chunk_kernel_at_the_verify_shape(gen, dtype):
    """The verify lane's chunk at qwen2-1.5b's widths: q (8, 4, 12, 128),
    the L tier's 8 slots of 34 pages of 16, with garbage planted where no
    query may look (NaN / inf in bf16; arbitrary bytes and NaN / inf scales
    in int8); the same bits twice."""
    kernel = da.decode_attention_chunk_paged_cuda
    attr = "launches_int8" if dtype == "int8" else "launches"
    if dtype == "int8":
        q, (pk, pv), dirty, clean, block, valid = _int8_inputs(
            gen, 8, 12, 2, 128, 16, 34, 4)
        args, ref_args = (pk, pv, block, valid, *dirty), \
            (pk, pv, block, valid, *clean)
    else:
        q, pk, pv, block, valid, ck, cv = _paged_inputs(
            gen, 8, 12, 2, 128, 16, 34, 4, torch.bfloat16)
        args, ref_args = (pk, pv, block, valid), (ck, cv, block, valid)
    before = getattr(kernel, attr)
    out = ops.decode_attention_chunk_paged(q, *args)
    again = ops.decode_attention_chunk_paged(q, *args)
    torch.cuda.synchronize()
    assert getattr(kernel, attr) == before + 2
    assert torch.isfinite(out).all() and (out[-1] == 0).all()
    assert torch.equal(out, again)
    ref = da.decode_attention_chunk_paged_plain(q, *ref_args)
    torch.testing.assert_close(out, ref, atol=ATT_ATOL, rtol=0)


SPEC_KW = dict(STREAM_KW, speculative=True)


def _counted(eng, reqs, kw, fetches, **extra):
    n0, t0 = len(fetches), eng.stats["stream_ticks"]
    ops.reset_launch_counts()
    out = eng.serve_stream(reqs, **kw, **extra)
    assert len(fetches) - n0 == eng.stats["stream_ticks"] - t0 > 0
    sched = eng._stream[1]
    assert sched.srt.pool.held_slots == sched.lrt.pool.held_slots == []
    return out, ops.launch_counts(), sched


def _fetch_counter(monkeypatch):
    from repro_torch.serving import engine as engine_mod
    fetches = []
    real = engine_mod._host_fetch
    monkeypatch.setattr(engine_mod, "_host_fetch",
                        lambda tree: (fetches.append(1), real(tree))[1])
    return fetches


def _bucketed(req, buckets):
    from repro_torch.serving.batcher import pad_to_bucket
    prompt = np.zeros(pad_to_bucket(len(req.prompt), buckets), np.int32)
    prompt[: len(req.prompt)] = req.prompt
    return prompt


def _decisive_prefix(tier, prompt, toks, tol=1e-2):
    """How many of ``toks`` the CPU tier's contiguous path chooses by a
    margin over ``tol`` (teacher-forced, up to the first that is not)."""
    from repro_torch.models import model_zoo
    from repro_torch.parity import decisive
    cache = model_zoo.init_cache(tier.cfg, 1, 64, device="cpu")
    lg, cache = model_zoo.prefill(tier.params, tier.cfg,
                                  torch.from_numpy(prompt[None]).long(),
                                  cache)
    logs = [lg[0].numpy()]
    for t in toks[:-1]:
        lg, cache = model_zoo.decode_step(tier.params, tier.cfg,
                                          torch.tensor([[int(t)]]), cache)
        logs.append(lg[0].numpy())
    dec = decisive(np.stack(logs), tol)
    return int(np.argmin(dec)) if not dec.all() else len(dec)


def test_spec_stream_on_card_matches_cpu(gen, monkeypatch):
    """Reduced qwen2-1.5b ``serve_stream(speculative=True)`` (sharing with
    COW, the chunk lane) on the card against the CPU: one host fetch per
    tick, the chunk kernel once per L layer and verify tick besides the
    chunk lanes, and tokens equal up to the first position the CPU's host
    oracle chose by a margin under 1e-2 (or where the CPU's stream and
    oracle part)."""
    from repro_torch.configs.base import HIConfig
    from repro_torch.serving.engine import HIEngine
    from repro_torch.serving.token_cascade import TokenCascade

    cpu, gpu = _reduced_tiers()
    reqs = _stream_requests(cpu[0].cfg.vocab_size)
    fetches = _fetch_counter(monkeypatch)
    hi = HIConfig(theta=0.5, capacity_factor=1.0)
    outs = {}
    for name, tiers in (("cpu", cpu), ("cuda", gpu)):
        eng = HIEngine(*tiers, hi, max_new_tokens=6)
        outs[name], counts, sched = _counted(eng, reqs, SPEC_KW, fetches)
    s, l = sched.srt, sched.lrt
    kb = SPEC_KW["decode_block"]
    ls, ll = s.pool.cfg.num_layers, l.pool.cfg.num_layers
    assert counts == {
        "hi_gate": sum(t.lane_ticks["admit"] + t.lane_ticks["chunk"]
                       for t in (s, l)) + kb * s.lane_ticks["live"],
        "decode_attention": 0,
        "decode_attention_paged": kb * ls * s.lane_ticks["live"],
        "decode_attention_chunk_paged": (ll * l.lane_ticks["live"]
                                         + ls * s.lane_ticks["chunk"]
                                         + ll * l.lane_ticks["chunk"]),
        "copy_pages": s.lane_ticks["cow"] + l.lane_ticks["cow"],
        "ssd_chunk": 0, **NO_INT8, **NO_MOE}
    assert l.lane_ticks["live"] > 0
    tc = TokenCascade(s_cfg=cpu[0].cfg, l_cfg=cpu[1].cfg,
                      s_params=cpu[0].params, l_params=cpu[1].params, hi=hi,
                      block=kb, cache_len=64)
    compared = 0
    for r in reqs:
        c, g = outs["cpu"][r.request_id], outs["cuda"][r.request_id]
        assert c["status"] == g["status"] == "ok"
        ref = tc.generate_speculative(_bucketed(r, STREAM_KW["buckets"])[None],
                                      min(r.max_new_tokens, 6))
        same = c["tokens"] == ref["tokens"][0]
        ok = (ref["margins"] > 1e-2) & same
        first = int(np.argmin(ok)) if not ok.all() else len(ok)
        np.testing.assert_array_equal(g["tokens"][:first],
                                      c["tokens"][:first])
        compared += first
    assert compared > 0


def test_fault_stream_on_card_matches_cpu(gen, monkeypatch):
    """Reduced qwen2-1.5b under a seeded schedule (loss, delay, an L
    outage, a spike) at theta 1.1, where every request escalates: the
    records' host fields on the card equal the CPU's exactly, tokens up to
    the CPU's first non-decisive position, one fetch per tick, no slot
    held; a second card run on a fresh engine gives equal records."""
    from repro_torch.configs.base import HIConfig
    from repro_torch.serving.engine import HIEngine
    from repro_torch.serving.faults import (STATUSES, FaultSchedule,
                                            RetryPolicy)

    cpu, gpu = _reduced_tiers()
    reqs = _stream_requests(cpu[0].cfg.vocab_size, seed=2)
    fetches = _fetch_counter(monkeypatch)
    kw = dict(faults=FaultSchedule(seed=5, loss_prob=0.25, delay_ticks=1,
                                   delay_jitter=2, outages=((2, 6),),
                                   spikes=((7, 10),)),
              retry=RetryPolicy(ack_timeout_ticks=2, max_retries=2,
                                backoff_cap_ticks=4, breaker_threshold=2,
                                breaker_cooldown_ticks=4))
    hi = HIConfig(theta=1.1, capacity_factor=1.0)
    outs = []
    for tiers in (cpu, gpu, gpu):
        eng = HIEngine(*tiers, hi, max_new_tokens=6)
        outs.append(_counted(eng, reqs, STREAM_KW, fetches, **kw)[0])
    c_out, g_out, g2_out = outs
    fields = ("status", "escalation_retries", "queue_wait_ticks",
              "esc_created_tick", "served_remote", "dropped", "offloaded")
    assert {r["status"] for r in c_out.values()} >= {"ok", "degraded_local"}
    for r in reqs:
        c, g = c_out[r.request_id], g_out[r.request_id]
        assert g["status"] in STATUSES
        for key in fields:
            assert g[key] == c[key], (r.request_id, key)
        for key, v in g.items():
            if key != "ttft":
                np.testing.assert_array_equal(g2_out[r.request_id][key], v)
        prompt = _bucketed(r, STREAM_KW["buckets"])
        first = _decisive_prefix(cpu[0], prompt, c["s_tokens"])
        np.testing.assert_array_equal(g["s_tokens"][:first],
                                      c["s_tokens"][:first])
        if c["served_remote"]:
            first = _decisive_prefix(cpu[1], prompt, c["tokens"])
            np.testing.assert_array_equal(g["tokens"][:first],
                                          c["tokens"][:first])


@pytest.mark.parametrize("kind", ["collectors", "speculative"])
def test_observed_and_speculative_streams_sync_only_in_host_fetch(
        gen, monkeypatch, kind):
    """With every collector on (telemetry, audit, watchdog, flight
    recorder), and with the speculative lane, a reduced stream runs under
    the sync debugger set to raise, which ``_host_fetch`` alone lifts: the
    verify takes the draft's tensors and the S rollback L's ``keep`` on the
    card.  The tokens equal those of the same stream with the collectors
    off (and the debugger off) on a fresh engine."""
    from repro_torch.configs.base import HIConfig
    from repro_torch.kernels import build
    from repro_torch.serving import engine as engine_mod
    from repro_torch.serving.audit import (GateAudit, SLOThresholds,
                                           SLOWatchdog)
    from repro_torch.serving.engine import HIEngine
    from repro_torch.serving.flight_recorder import FlightRecorder
    from repro_torch.serving.telemetry import Telemetry

    _, gpu = _reduced_tiers()
    reqs = _stream_requests(gpu[0].cfg.vocab_size, seed=1)
    hi = HIConfig(theta=0.5, capacity_factor=1.0)
    kw = SPEC_KW if kind == "speculative" else STREAM_KW
    base = HIEngine(*gpu, hi, max_new_tokens=6).serve_stream(reqs, **kw)
    eng = HIEngine(*gpu, hi, max_new_tokens=6)
    build.library()
    eng.serve_stream(reqs, **kw)                  # warm: allocations, build
    torch.cuda.synchronize()
    eng._stream = None
    eng.serve_stream([], **kw)        # a fresh scheduler, built out here
    extra = {}
    if kind == "collectors":
        extra = dict(telemetry=Telemetry(), audit=GateAudit(),
                     watchdog=SLOWatchdog(SLOThresholds(ttft_p95=1e-9)),
                     flight_recorder=FlightRecorder(capacity=4))
    real = engine_mod._host_fetch

    def fetch(tree):
        torch.cuda.set_sync_debug_mode("default")
        try:
            return real(tree)
        finally:
            torch.cuda.set_sync_debug_mode("error")

    monkeypatch.setattr(engine_mod, "_host_fetch", fetch)
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = eng.serve_stream(reqs, **kw, **extra)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    for r in reqs:
        np.testing.assert_array_equal(out[r.request_id]["tokens"],
                                      base[r.request_id]["tokens"])
    if kind == "collectors":
        assert set(extra["telemetry"].traces) == set(out)
        assert extra["flight_recorder"].dumps     # the 1 ns TTFT bound


# ---------------------------------------------------------------------------
# the paper's classifier cascade, the legacy path and the sampler
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("metric", ["max_prob", "margin", "entropy"])
def test_hi_gate_at_the_cascade_shape(gen, metric):
    """CNN logits (2,000, 10): one split per row."""
    x = torch.randn((2000, 10), generator=gen, device="cuda") * 3
    theta = torch.tensor(0.5, device="cuda")
    assert hg.gate_splits(2000, 10) == 1
    conf_p, pred_p, _ = hg.hi_gate_plain(x, theta, metric)
    conf_k, pred_k, off_k = hg.hi_gate_cuda(x, theta, metric)
    torch.cuda.synchronize()
    torch.testing.assert_close(conf_k, conf_p, atol=CONF_ATOL, rtol=CONF_RTOL)
    assert torch.equal(pred_k, pred_p)
    assert torch.equal(off_k, (conf_k < theta).to(torch.int32))


def _cifar_cascade(use_kernel, theta, cfgs=None, binary=False):
    from repro_torch.configs.base import HIConfig
    from repro_torch.core.cascade import HICascade
    from repro_torch.models import cnn
    s_cfg, l_cfg = cfgs or (cnn.SML_CIFAR, cnn.LML_CIFAR)
    return HICascade(lambda p, x: cnn.apply_cnn(p, s_cfg, x),
                     lambda p, x: cnn.apply_cnn(p, l_cfg, x),
                     HIConfig(theta=theta, capacity_factor=0.5,
                              binary_relevance=binary),
                     use_kernel=use_kernel)


def test_cascade_on_card_launches_hi_gate_and_matches_plain(gen):
    """HICascade over SML/LML_CIFAR on the card: use_kernel launches
    hi_gate once and gives the plain metric's decisions; the card's
    cascade equals the CPU's where the S tier's margin is decisive."""
    from repro_torch.data.images import make_dataset
    from repro_torch.models import cnn
    g = torch.Generator().manual_seed(1)
    sp = cnn.init_cnn(g, cnn.SML_CIFAR, "cpu")
    lp = cnn.init_cnn(g, cnn.LML_CIFAR, "cpu")
    x, _ = make_dataset(256, seed=2)
    xc, xg = torch.from_numpy(x), torch.from_numpy(x).cuda()
    spg, lpg = _cuda(sp), _cuda(lp)
    s_logits = cnn.apply_cnn(spg, cnn.SML_CIFAR, xg)
    # theta in the widest gap between neighbouring confidences near the
    # median: no row sits within rounding of it on either device
    conf = np.sort(s_logits.softmax(-1).amax(-1).cpu().numpy())
    mid = len(conf) // 2
    j = mid - 20 + int(np.argmax(np.diff(conf[mid - 20:mid + 20])))
    theta = float((conf[j] + conf[j + 1]) / 2)
    before = hg.hi_gate_cuda.launches
    k = _cifar_cascade(True, theta).infer(spg, lpg, xg)
    assert hg.hi_gate_cuda.launches == before + 1
    p = _cifar_cascade(False, theta).infer(spg, lpg, xg)
    c = _cifar_cascade(False, theta).infer(sp, lp, xc)
    top2 = s_logits.softmax(-1).topk(2, -1).values
    sure = ((top2[:, 0] - top2[:, 1]) > 1e-4).cpu()
    for key in ("offload_mask", "served_remote", "dropped"):
        assert torch.equal(k[key], p[key]), key
    assert torch.equal(k["pred"].cpu()[sure], p["pred"].cpu()[sure])
    for key in ("offload_mask", "served_remote"):
        assert torch.equal(p[key].cpu(), c[key])
    assert 0 < int(k["n_offloaded"]) < 256 and int(k["dropped"]) >= 0
    # a one-logit head scores with the sigmoid: no kernel launch
    bp = _cuda(cnn.init_cnn(g, cnn.SML_BINARY, "cpu"))
    before = hg.hi_gate_cuda.launches
    b = _cifar_cascade(True, 0.5, (cnn.SML_BINARY, cnn.SML_BINARY),
                       binary=True).infer(bp, bp, xg)
    assert hg.hi_gate_cuda.launches == before
    want = torch.sigmoid(cnn.apply_cnn(bp, cnn.SML_BINARY, xg))[:, 0]
    torch.testing.assert_close(b["conf"], want)



def test_legacy_on_card_matches_serve(gen):
    """Reduced qwen2-1.5b: serve_legacy on the card launches the drain
    kernel once per layer and token of both tiers' loops, no hi_gate, and
    agrees with serve on offloads and confidences."""
    from repro_torch.configs.base import HIConfig
    from repro_torch.configs.registry import ARCHS
    from repro_torch.serving.engine import build_engine
    cfg = ARCHS["qwen2-1.5b"].reduced()
    eng = build_engine(cfg, HIConfig(theta=0.6, capacity_factor=0.5),
                       max_new_tokens=6, cache_len=32)
    toks = np.random.default_rng(0).integers(1, cfg.vocab_size,
                                             (8, 16)).astype(np.int32)
    new = eng.serve(toks)
    ops.reset_launch_counts()
    old = eng.serve_legacy(toks)
    counts = ops.launch_counts()
    assert counts["decode_attention"] == (16 + 6) * (
        eng.s.cfg.num_layers + cfg.num_layers)
    assert counts["hi_gate"] == 0
    np.testing.assert_array_equal(old["offloaded"], new["offloaded"])
    np.testing.assert_allclose(old["confidence"], new["confidence"],
                               atol=1e-4, rtol=1e-4)


def test_sampler_bits_on_card_equal_the_cpus(gen):
    """Keys and bits are integer arithmetic: the card's equal the CPU's
    (which equal jax's, tests/test_torch_sampler.py), and a sampled draw
    picks the same tokens."""
    from repro_torch.serving import sampler
    seeds = torch.tensor([0, 1, 7, 31, 12345, 65535, 1000003, 2 ** 31 - 1])
    idx = torch.tensor([0, 1, 2, 3, 15, 16, 100, 2 ** 31 - 1])
    kc = sampler.request_keys(seeds, idx)
    kg = sampler.request_keys(seeds.cuda(), idx.cuda())
    assert torch.equal(kg.cpu(), kc)
    assert torch.equal(sampler.random_bits(kg, (151_936,)).cpu(),
                       sampler.random_bits(kc, (151_936,)))
    assert torch.equal(sampler.uniform(kg, (151_936,)).cpu(),
                       sampler.uniform(kc, (151_936,)))
    logits = torch.randn((8, 151_936), generator=gen, device="cuda") * 3
    tc = sampler.sample(kc, logits.cpu(), 0.7)
    tg = sampler.sample(kg, logits, 0.7)
    assert (tg.cpu() == tc).sum() >= 7


# ---------------------------------------------------------------------------
# the MoE family's shapes (deepseek-moe-16b: 16 / 16 heads of 128, S tier
# 4 / 4, vocab 102,400) and llava-next-34b's group of 7 (56 over 8 heads)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,h,k", [(4, 16, 16), (8, 4, 4), (4, 56, 8)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, "int8"])
def test_paged_decode_kernel_at_the_moe_and_llava_shapes(gen, b, h, k,
                                                         dtype):
    if dtype == "int8":
        q, (pk, pv), scales, clean, block, valid = _int8_inputs(
            gen, b, h, k, 128, 16, 34, 1)
        ref = da.decode_attention_paged_plain(q, pk, pv, block, valid[:, 0],
                                              *clean)
    else:
        q, pk, pv, block, valid, ck, cv = _paged_inputs(
            gen, b, h, k, 128, 16, 34, 1, dtype)
        scales = ()
        ref = da.decode_attention_paged_plain(q, ck, cv, block, valid[:, 0])
    out = da.decode_attention_paged_cuda(q, pk, pv, block, valid[:, 0],
                                         *scales)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out, ref, atol=ATT_ATOL, rtol=0)


@pytest.mark.parametrize("c,b,h,k", [(256, 2, 16, 16), (256, 2, 4, 4),
                                     (4, 8, 16, 16), (256, 2, 56, 8),
                                     (4, 8, 56, 8)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, "int8"])
def test_chunk_kernel_at_the_moe_and_llava_shapes(gen, c, b, h, k, dtype):
    """The chunk lane's q (2, 256, H, 128) and the verify lane's
    (8, 4, H, 128) at group 1 (deepseek) and group 7 (llava)."""
    npg = max(12, c // 16 + 4)
    if dtype == "int8":
        q, (pk, pv), scales, clean, block, valid = _int8_inputs(
            gen, b, h, k, 128, 16, npg, c)
        ref = da.decode_attention_chunk_paged_plain(q, pk, pv, block, valid,
                                                    *clean)
    else:
        q, pk, pv, block, valid, ck, cv = _paged_inputs(
            gen, b, h, k, 128, 16, npg, c, dtype)
        scales = ()
        ref = da.decode_attention_chunk_paged_plain(q, ck, cv, block, valid)
    out = da.decode_attention_chunk_paged_cuda(q, pk, pv, block, valid,
                                               *scales)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out, ref, atol=ATT_ATOL, rtol=0)


@pytest.mark.parametrize("b,h,k", [(4, 16, 16), (8, 4, 4)])
def test_drain_kernel_at_the_moe_shapes(gen, b, h, k):
    s = 1024
    q = torch.randn((b, 1, h, 128), generator=gen, device="cuda")
    ck = torch.randn((b, s, k, 128), generator=gen,
                     device="cuda").to(torch.bfloat16)
    cv = torch.randn((b, s, k, 128), generator=gen,
                     device="cuda").to(torch.bfloat16)
    valid = torch.arange(s, device="cuda") <= 520
    out = da.decode_attention_cuda(q, ck, cv, valid)
    ref = da.decode_attention_plain(q, ck, cv, valid)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref, atol=ATT_ATOL, rtol=0)


@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("metric", ["max_prob", "entropy"])
def test_hi_gate_at_the_moe_vocab(gen, n, metric):
    x = _gate_rows(gen, n, 102_400, torch.float32)
    theta = torch.tensor(0.3, device="cuda")
    conf_p, pred_p, _ = hg.hi_gate_plain(x, theta, metric)
    conf_k, pred_k, off_k = hg.hi_gate_cuda(x, theta, metric)
    torch.cuda.synchronize()
    torch.testing.assert_close(conf_k, conf_p, atol=CONF_ATOL, rtol=CONF_RTOL)
    assert torch.equal(pred_k, pred_p)
    assert torch.equal(off_k, (conf_k < theta).to(torch.int32))


@pytest.mark.parametrize("name", ["deepseek-moe-16b", "arctic-480b"])
def test_reduced_moe_decode_step_gives_the_same_bits_twice(gen, name):
    """One paged decode step of a reduced MoE model on the card, twice on
    the same pool: the dropless dispatch sorts the pairs stably and the
    grouped kernel sums each row in a fixed order, with no atomics, so the
    logits (and the appended pages) are the same bits."""
    from repro_torch.configs.registry import ARCHS
    from repro_torch.models import model_zoo
    cfg = ARCHS[name].reduced()
    params = model_zoo.init_params(
        torch.Generator(device="cuda").manual_seed(0), cfg)
    block = torch.arange(1, 9, dtype=torch.int32,
                         device="cuda").reshape(2, 4)
    cache = model_zoo.init_paged_cache(cfg, 2, 9, 8, device="cuda")
    toks = torch.randint(1, cfg.vocab_size, (2, 16), generator=gen,
                         device="cuda")
    lg, cache = model_zoo.prefill_paged(
        params, cfg, toks, torch.tensor([16, 11], device="cuda"),
        torch.arange(2, device="cuda"), block, cache)
    tok = lg.argmax(-1)[:, None]
    pos = torch.tensor([16, 11], device="cuda")
    runs = []
    for _ in range(2):
        pools = {k: v.clone() for k, v in cache.items()}
        before = da.decode_attention_paged_cuda.launches
        out, pools = model_zoo.decode_step_paged(params, cfg, tok, pos,
                                                 block, pools)
        torch.cuda.synchronize()
        assert da.decode_attention_paged_cuda.launches == \
            before + cfg.num_layers
        runs.append((out, pools))
    (a, pa), (b, pb) = runs
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    for key in pa:
        assert torch.equal(_bits(pa[key]), _bits(pb[key]))


# ---------------------------------------------------------------------------
# h2o-danube-3-4b's head dim 120 (d_model 3,840 over 32 heads): the L tier
# 32 query heads over 8 kv heads, the S tier (``s_variant(4)``) 8 over 8
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,h,k", [(4, 32, 8), (8, 8, 8)])
@pytest.mark.parametrize("page", [4, 8, 16])
@pytest.mark.parametrize("dtype", [torch.bfloat16, "int8"])
def test_paged_kernels_at_danube_shapes(gen, b, h, k, page, dtype):
    """Decode and the C = 256 chunk at D 120 with garbage planted where no
    query looks (NaN / inf rows, int8 NaN / inf scales), against the plain
    versions; each kernel gives the same bits twice."""
    for c in (1, 256):
        npg = max(544 // page, (c + 64) // page + 4)
        if dtype == "int8":
            q, (pk, pv), scales, clean, block, valid = _int8_inputs(
                gen, b if c == 1 else 2, h, k, 120, page, npg, c)
            ref = da.decode_attention_chunk_paged_plain(q, pk, pv, block,
                                                        valid, *clean)
        else:
            q, pk, pv, block, valid, ck, cv = _paged_inputs(
                gen, b if c == 1 else 2, h, k, 120, page, npg, c, dtype)
            scales = ()
            ref = da.decode_attention_chunk_paged_plain(q, ck, cv, block,
                                                        valid)
        if c == 1:
            outs = [da.decode_attention_paged_cuda(q, pk, pv, block,
                                                   valid[:, 0], *scales)
                    for _ in range(2)]
        else:
            outs = [da.decode_attention_chunk_paged_cuda(q, pk, pv, block,
                                                         valid, *scales)
                    for _ in range(2)]
        torch.cuda.synchronize()
        assert torch.isfinite(outs[0]).all()
        torch.testing.assert_close(outs[0], ref, atol=ATT_ATOL, rtol=0)
        assert torch.equal(outs[0].view(torch.int32),
                           outs[1].view(torch.int32))


@pytest.mark.parametrize("b,h,k", [(4, 32, 8), (8, 8, 8)])
def test_drain_kernel_at_danube_shapes(gen, b, h, k):
    s = 1024
    q = torch.randn((b, 1, h, 120), generator=gen, device="cuda")
    ck = torch.randn((b, s, k, 120), generator=gen,
                     device="cuda").to(torch.bfloat16)
    cv = torch.randn((b, s, k, 120), generator=gen,
                     device="cuda").to(torch.bfloat16)
    valid = torch.arange(s, device="cuda") <= 520
    ck[:, 521:], cv[:, 521:] = float("nan"), float("inf")
    one = da.decode_attention_cuda(q, ck, cv, valid)
    two = da.decode_attention_cuda(q, ck, cv, valid)
    ref = da.decode_attention_plain(q, ck[:, :521], cv[:, :521],
                                    valid[:521])
    torch.cuda.synchronize()
    torch.testing.assert_close(one, ref, atol=ATT_ATOL, rtol=0)
    assert torch.equal(one.view(torch.int32), two.view(torch.int32))


# ---------------------------------------------------------------------------
# training on the card: ssd_chunk under autograd, a reduced step per family
# against the CPU, the CNN trainer's step
# ---------------------------------------------------------------------------

def test_ssd_chunk_backward_on_the_card_matches_plain(gen):
    """A recorded call launches the kernel once (the backward recomputes
    the plain version); grads of every input against autograd through
    ``ssd_chunk_ref`` on the same inputs, at mamba2-370m's L shape."""
    args = _ssd_inputs(gen, 2, 4, 128, 32, 64, 128)
    cots = [torch.randn(o.shape, generator=gen, device="cuda")
            for o in ssd_scan.ssd_chunk_ref(*args)]

    def vjp(fn):
        xs = [a.clone().requires_grad_() for a in args]
        torch.autograd.backward(fn(*xs), cots)
        return [x.grad for x in xs]

    before = ssd_scan.ssd_chunk_cuda.launches
    got = vjp(ops.ssd_chunk)
    assert ssd_scan.ssd_chunk_cuda.launches == before + 1
    want = vjp(ssd_scan.ssd_chunk_ref)
    torch.cuda.synchronize()
    for g, w in zip(got, want):       # the same plain maths, recomputed
        torch.testing.assert_close(g, w, atol=1e-6, rtol=1e-6)


def _train_step_on(device, name, seed=0):
    from repro_torch.configs.base import TrainConfig
    from repro_torch.configs.registry import ARCHS
    from repro_torch.models import model_zoo
    from repro_torch.optim import adamw
    from repro_torch.training import trainer
    cfg = ARCHS[name].reduced()
    params = _tree_to(model_zoo.init_params(
        torch.Generator().manual_seed(seed), cfg), device)
    rng = np.random.default_rng(seed)
    batch = {k: torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 32)))
             .to(device) for k in ("tokens", "labels")}
    tcfg = TrainConfig(bf16_state=False, remat=False, lr=1e-3,
                       warmup_steps=1)
    opt = adamw.init_state(params, tcfg)
    grads, metrics = trainer.grads_and_metrics(params, cfg, tcfg, batch)
    params, opt, m = adamw.apply_updates(params, grads, opt, tcfg)
    return grads, params, {**metrics, **m}


def _tree_to(t, device):
    if isinstance(t, dict):
        return {k: _tree_to(v, device) for k, v in t.items()}
    if isinstance(t, list):
        return [_tree_to(v, device) for v in t]
    return t.to(device)


def _leaves(t):
    from repro_torch import tree
    return tree.leaves(t)


@pytest.mark.parametrize("name", ["qwen2-1.5b", "deepseek-moe-16b",
                                  "mamba2-370m", "zamba2-2.7b",
                                  "granite-3-2b", "h2o-danube-3-4b",
                                  "gemma3-1b", "arctic-480b"])
def test_reduced_train_step_on_card_matches_cpu(gen, name):
    """One step on bridged params, TF32 off: loss and grad norm within
    1e-4, every grad within 1e-3 of the CPU's (float32 in both, sums in
    another order; the SSM and hybrid forwards through the ``ssd_chunk``
    kernel's three TF32 passes), and the updated params within lr of each
    other, all but 1 in 1,000 within 1e-4 (Adam's update takes either sign
    where a gradient is at rounding noise)."""
    before = ssd_scan.ssd_chunk_cuda.launches
    g_card, p_card, m_card = _train_step_on("cuda", name)
    recurrent = name in ("mamba2-370m", "zamba2-2.7b")
    assert (ssd_scan.ssd_chunk_cuda.launches > before) == recurrent
    g_cpu, p_cpu, m_cpu = _train_step_on("cpu", name)
    for k in ("loss", "grad_norm"):
        torch.testing.assert_close(m_card[k].cpu(), m_cpu[k], rtol=1e-4,
                                   atol=0)
    for a, b in zip(_leaves(g_card), _leaves(g_cpu)):
        scale = max(1.0, float(b.abs().max()))
        torch.testing.assert_close(a.cpu(), b, rtol=1e-3, atol=1e-5 * scale)
    off = total = 0
    for a, b in zip(_leaves(p_card), _leaves(p_cpu)):
        diff = (a.cpu() - b).abs()
        assert float(diff.max()) <= 1e-3 + 1e-6
        off += int((diff > 1e-6 + 1e-4 * b.abs()).sum())
        total += diff.numel()
    assert off <= 1e-3 * total, (off, total)


def test_cnn_train_step_on_card_matches_cpu(gen):
    """``cnn_trainer``'s step (cuDNN convolutions, TF32 off) from the same
    init on both devices: the loss and the updated params."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data import images
    from repro_torch.models import cnn
    from repro_torch.optim import adamw
    from repro_torch.training import cnn_trainer
    x, y = images.make_dataset(128, seed=0)
    init = cnn.init_cnn(torch.Generator().manual_seed(0), cnn.SML_CIFAR,
                        device="cpu")
    tcfg = TrainConfig(lr=2e-3, warmup_steps=1, total_steps=10,
                       weight_decay=0.01, bf16_state=False)
    out = {}
    for dev in ("cuda", "cpu"):
        params = _tree_to(init, dev)
        opt = adamw.init_state(params, tcfg)
        loss = cnn_trainer._step(params, opt, cnn.SML_CIFAR, tcfg,
                                 torch.as_tensor(x).to(dev),
                                 torch.as_tensor(y).to(dev))
        out[dev] = (loss.cpu(), _tree_to(params, "cpu"))
    torch.testing.assert_close(out["cuda"][0], out["cpu"][0], rtol=1e-5,
                               atol=0)
    for a, b in zip(_leaves(out["cuda"][1]), _leaves(out["cpu"][1])):
        assert float((a - b).abs().max()) <= 2 * 2e-3


# ---------------------------------------------------------------------------
# the (1, 1) mesh on the card: a world-size-1 NCCL group
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_debug_mesh_stream_on_card_equals_single_device(gen, kv):
    """Reduced qwen2 through ``serve_stream(mesh=make_serving_mesh(1, 1))``
    on the card (NCCL): tokens, statuses and offloads bitwise the
    single-device run's, one host fetch per tick, clean pools."""
    from repro_torch.configs.base import HIConfig
    from repro_torch.configs.registry import ARCHS
    from repro_torch.launch.mesh import make_serving_mesh
    from repro_torch.serving import engine as engine_mod
    from repro_torch.serving.batcher import Request
    from repro_torch.serving.engine import build_engine
    cfg = ARCHS["qwen2-1.5b"].reduced()
    rng = np.random.default_rng(0)
    reqs = [Request(i, rng.integers(0, cfg.vocab_size, 8).astype(np.int32),
                    max_new_tokens=4) for i in range(6)]
    kw = dict(buckets=(8,), num_slots=2, page_size=8, kv_dtype=kv,
              validate=True)

    def engine(theta):
        return build_engine(cfg, HIConfig(theta=theta, capacity_factor=1.0),
                            max_new_tokens=4, cache_len=32)

    first = engine(0.5).serve_stream(reqs, **kw)
    theta = float(np.float32(np.median([r["confidence"]
                                        for r in first.values()])))
    ref = engine(theta).serve_stream(reqs, **kw)
    fetches = []
    real = engine_mod._host_fetch
    engine_mod._host_fetch = lambda tree: (fetches.append(1), real(tree))[1]
    try:
        e = engine(theta)
        out = e.serve_stream(reqs, mesh=make_serving_mesh(1, 1), **kw)
    finally:
        engine_mod._host_fetch = real
    assert len(fetches) == e.stats["stream_ticks"] > 0
    for rid, a in ref.items():
        assert np.array_equal(a["tokens"], out[rid]["tokens"]), rid
        assert a["status"] == out[rid]["status"]
        assert a["offloaded"] == out[rid]["offloaded"]
    sched = e._stream[1]
    for rt in (*sched.srts, sched.lrt):
        rt.pool.check_invariants()
        assert not rt.pool.held_slots


@pytest.mark.parametrize("capacity", [2.0, 0.5])
def test_moe_ffn_sharded_on_card_equals_moe_ffn(gen, capacity):
    """The expert-parallel dispatch on the (1, 1) NCCL mesh: the same
    outputs, aux and dropped pairs as ``moe_ffn``, bit for bit."""
    from repro_torch.configs.registry import ARCHS
    from repro_torch.launch.mesh import make_serving_mesh
    from repro_torch.models import model_zoo, moe
    from repro_torch.models.transformer import layer_params
    cfg = ARCHS["deepseek-moe-16b"].reduced()
    params = model_zoo.init_params(gen, cfg)
    lp = layer_params(params["layers"], 0)
    x = torch.randn((4, 8, cfg.d_model), generator=gen, device="cuda")
    y0, aux0 = moe.moe_ffn(lp, cfg, x, capacity)
    y1, aux1 = moe.moe_ffn_sharded(lp, cfg, x, capacity,
                                   make_serving_mesh(1, 1))
    assert torch.equal(y0, y1) and torch.equal(aux0, aux1)


@pytest.mark.parametrize("s,mask", [(1024, "ring"), (4096, "window"),
                                    (8192, "global")])
def test_drain_kernel_at_head_dim_256(gen, s, mask):
    """gemma3's split-cache shapes: q (1, 1, 4, 256) over one kv head, a
    ring whose every slot is written, a 1,024 window ending at the last
    row, and every row."""
    q = torch.randn((1, 1, 4, 256), generator=gen, device="cuda")
    ck = torch.randn((1, s, 1, 256), generator=gen,
                     device="cuda").to(torch.bfloat16)
    cv = torch.randn((1, s, 1, 256), generator=gen,
                     device="cuda").to(torch.bfloat16)
    kpos = torch.arange(s, device="cuda")
    valid = {"ring": kpos >= 0, "window": kpos > s - 1 - 1024,
             "global": kpos <= s - 1}[mask]
    before = da.decode_attention_cuda.launches
    out = ops.decode_attention(q, ck, cv, valid)
    again = ops.decode_attention(q, ck, cv, valid)
    torch.cuda.synchronize()
    assert da.decode_attention_cuda.launches == before + 2
    torch.testing.assert_close(out, da.decode_attention_plain(q, ck, cv,
                                                              valid),
                               atol=ATT_ATOL, rtol=0)
    assert torch.equal(out, again)


def test_decode_step_split_on_card_matches_uniform(gen):
    """Reduced gemma3-1b (6 layers: five windowed, one global; window 4)
    over 10 tokens: the split-cache decode against the uniform one on the
    card (bf16 caches), and the same bits twice."""
    import dataclasses
    from repro_torch.configs.registry import ARCHS
    from repro_torch.models import model_zoo, transformer
    cfg = dataclasses.replace(ARCHS["gemma3-1b"].reduced(num_layers=6),
                              sliding_window=4)
    params = model_zoo.init_params(
        torch.Generator(device="cuda").manual_seed(0), cfg)
    toks = torch.randint(0, cfg.vocab_size, (2, 10), generator=gen,
                         device="cuda")
    runs = []
    for _ in range(2):
        uni = model_zoo.init_cache(cfg, 2, 16, torch.bfloat16, "cuda")
        spl = transformer.init_split_cache(cfg, 2, 16, torch.bfloat16,
                                           "cuda")
        before = da.decode_attention_cuda.launches
        with torch.inference_mode():
            for t in range(10):
                lu, uni = transformer.decode_step(params, cfg,
                                                  toks[:, t:t + 1], uni)
                ls, spl = transformer.decode_step_split(params, cfg,
                                                        toks[:, t:t + 1], spl)
        torch.cuda.synchronize()
        assert da.decode_attention_cuda.launches == before + 2 * 10 * 6
        torch.testing.assert_close(ls, lu, atol=2e-3, rtol=2e-3)
        runs.append((ls, spl))
    assert torch.equal(runs[0][0], runs[1][0])
    for key in ("local_k", "local_v", "global_k", "global_v"):
        assert torch.equal(runs[0][1][key], runs[1][1][key])


# ---------------------------------------------------------------------------
# the chunk lane at its live rows' width (``scheduler.chunk_lane_width``)
# ---------------------------------------------------------------------------

# cuBLAS picks other tiles at another row count, so a row's float32 sums run
# in another order.  Over bf16 pages a K/V element whose float32 value moves
# across a bf16 rounding moves by 2^-8 of itself, and the lane's logits by
# up to 1.8e-3 (NVIDIA H100, the first card reading of this test)
LANE_LOGIT_ATOL = {"float32": 1e-4, "bfloat16": 5e-3}


@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("pages", ["float32", "bfloat16"])
def test_chunk_lane_width_on_card_matches_the_full_lane(gen, n, pages):
    """A danube-shaped dense chunk lane (the published widths: d 3,840, 32
    query heads over 8 kv heads of 120, SwiGLU 10,240, vocab 32,000; 2
    layers), W = 8 rows of C = 256 over pages of 16, float32 params, TF32
    off.  Its first ``n`` rows run alone give the logits of the same rows
    run at W within ``LANE_LOGIT_ATOL``, and the same tokens wherever W's
    top two logits lie more than twice that apart.  Rows past ``n`` are the
    lane's padding, as the scheduler builds it: zero tokens over the null
    page.  Both passes are the rows' second chunk, over the pages the first
    chunk wrote."""
    import dataclasses
    from repro_torch.configs.registry import ARCHS
    from repro_torch.models import model_zoo
    from repro_torch.parity import decisive
    cfg = dataclasses.replace(ARCHS["h2o-danube-3-4b"], num_layers=2)
    w, c, page = 8, 256, 16
    npg = 2 * c // page
    tol = LANE_LOGIT_ATOL[pages]
    params = model_zoo.init_params(
        torch.Generator(device="cuda").manual_seed(0), cfg)
    pools = model_zoo.init_paged_cache(cfg, w, 1 + w * npg, page,
                                       getattr(torch, pages), "cuda")
    live = torch.arange(w, device="cuda") < n
    block = torch.where(
        live[:, None],
        1 + torch.arange(w * npg, device="cuda").view(w, npg), 0).int()
    toks = torch.randint(0, cfg.vocab_size, (w, 2 * c), generator=gen,
                         device="cuda")
    toks = torch.where(live[:, None], toks, 0).int()
    pos = torch.zeros((w,), dtype=torch.int32, device="cuda")
    runs = {}
    with torch.inference_mode():
        model_zoo.forward_chunk_paged(params, cfg, toks[:, :c], pos, block,
                                      pools, write_block=block)
        for m in (w, n):
            cache = {k: v.clone() for k, v in pools.items()}
            logits, _, _ = model_zoo.forward_chunk_paged(
                params, cfg, toks[:m, c:], pos[:m] + c, block[:m], cache,
                write_block=block[:m])
            runs[m] = logits[:n].cpu()
    full, cut = runs[w], runs[n]
    mask = decisive(full.numpy(), 2 * tol)
    print(f"{pages} pages, width {n} of {w}: largest logit gap "
          f"{float((cut - full).abs().max()):.3e} (logits up to "
          f"{float(full.abs().max()):.3f}), {mask.mean():.4f} of "
          f"{mask.size} positions decisive")
    torch.testing.assert_close(cut, full, atol=tol, rtol=0)
    assert mask.mean() > 0.95
    np.testing.assert_array_equal(cut.argmax(-1).numpy()[mask],
                                  full.argmax(-1).numpy()[mask])


# ---------------------------------------------------------------------------
# the MoE family's grouped kernel (``kernels/grouped_ffn.py``) at the
# deepseek-moe.chat cell's shapes: the L tier's 64 experts of 1,408 over
# d 2,048 and the S tier's 16 of 352 over 512, top 6, a decode step of the
# tier's slots and a chunk pass of 8 x 256 tokens
# ---------------------------------------------------------------------------

# (experts, d, f, tokens): L decode (48 pairs), L chunk (12,288), S decode
# (192), S chunk (12,288)
GROUPED_SHAPES = [(64, 2048, 1408, 8), (64, 2048, 1408, 2048),
                  (16, 512, 352, 32), (16, 512, 352, 2048)]
# kernel and plain version: float32 IEEE products over the same rows, only
# the order of the K sums differs (sums of up to 2,048 terms of O(1))
GROUPED_ATOL = 1e-4


def _grouped_case(gen, e, d, f, t, k=6, dead=0.25):
    """Routed pairs as ``moe.dropless_ffn`` builds them, with a quarter of
    the tokens dead (their rows NaN), and the weights of every expert that
    holds no pair NaN: neither may reach the output."""
    x = torch.randn((t, d), generator=gen, device="cuda")
    live = torch.rand((t,), generator=gen, device="cuda") >= dead
    live[0] = True
    x[~live] = float("nan")
    scores = torch.rand((t, e), generator=gen, device="cuda")
    gate, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    gate, idx = gate[:, :k], idx[:, :k]
    gate = gate / gate.sum(-1, keepdim=True)
    idx = torch.where(live[:, None], idx, e)
    ids, pairs = torch.sort(idx.reshape(-1), stable=True)
    offsets = torch.searchsorted(ids, torch.arange(e + 1, device="cuda"))
    w = [torch.randn((e, d, f), generator=gen, device="cuda") / d ** 0.5,
         torch.randn((e, d, f), generator=gen, device="cuda") / d ** 0.5,
         torch.randn((e, f, d), generator=gen, device="cuda") / f ** 0.5]
    idle = (offsets[1:] == offsets[:-1])
    for m in w:
        m[idle] = float("nan")
    return x, pairs, offsets, w, gate.reshape(-1), live, k


@pytest.mark.parametrize("e,d,f,t", GROUPED_SHAPES)
def test_grouped_kernel_matches_plain_at_the_cell_shapes(gen, e, d, f, t):
    from repro_torch.kernels import grouped_ffn as gf
    x, pairs, offsets, (wg, wi, wo), gate, live, k = _grouped_case(
        gen, e, d, f, t)
    want = gf.grouped_swiglu_plain(x, pairs, offsets, wg, wi, wo, gate, k)
    runs = []
    for _ in range(2):
        before = gf.grouped_swiglu_cuda.launches
        runs.append(ops.grouped_swiglu(x, pairs, offsets, wg, wi, wo, gate,
                                       k))
        torch.cuda.synchronize()
        assert gf.grouped_swiglu_cuda.launches == before + 1
    got = runs[0]
    # the same bits on two runs
    assert torch.equal(got.view(torch.int32), runs[1].view(torch.int32))
    assert torch.isfinite(got).all()
    # a dead token's pairs are zero rows
    dead = ~live.repeat_interleave(k)
    assert (got[dead] == 0).all()
    err = float((got - want).abs().max())
    print(f"grouped ({e}, {d}, {f}) x {t * k} pairs: largest error "
          f"{err:.3e} (outputs up to {float(want.abs().max()):.3f})")
    torch.testing.assert_close(got, want, atol=GROUPED_ATOL, rtol=0)


def test_grouped_kernel_serves_the_dropless_ffn_on_card(gen):
    """One deepseek-moe-16b layer at its published widths (d 2,048, 64
    experts of 1,408, top 6, 2 shared): ``dropless_ffn`` on the card
    against the plain reference's every-pair MoE on the CPU (float64)
    over a decode step's 8 tokens, and the same on two runs."""
    from repro_torch.configs.registry import ARCHS
    from repro_torch.models import model_zoo, moe
    from repro_torch.models.transformer import layer_params
    import dataclasses
    cfg = dataclasses.replace(ARCHS["deepseek-moe-16b"], num_layers=1,
                              vocab_size=512)
    params = model_zoo.init_params(
        torch.Generator(device="cuda").manual_seed(0), cfg)
    lp = layer_params(params["layers"], 0)
    x = torch.randn((8, 1, cfg.d_model), generator=gen, device="cuda")
    with torch.inference_mode():
        a = moe.serving_ffn(lp, cfg, x)
        b = moe.serving_ffn(lp, cfg, x)
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    lp64 = {k: ({kk: vv.double().cpu() for kk, vv in v.items()}
                if isinstance(v, dict) else v.double().cpu())
            for k, v in lp.items() if k in ("router", "experts", "shared")}
    xf = x.reshape(8, -1).double().cpu()
    probs = torch.softmax(xf @ lp64["router"], -1)
    g, idx = torch.topk(probs, 6, dim=-1)
    g = g / g.sum(-1, keepdim=True)
    ref = torch.zeros_like(xf)
    ex = lp64["experts"]
    for t in range(8):
        for j in range(6):
            e = int(idx[t, j])
            h = torch.nn.functional.silu(xf[t] @ ex["wg"][e]) * \
                (xf[t] @ ex["wi"][e])
            ref[t] += g[t, j] * (h @ ex["wo"][e])
    sh = lp64["shared"]
    ref += (torch.nn.functional.silu(xf @ sh["wg"]) * (xf @ sh["wi"])) \
        @ sh["wo"]
    err = float((a.reshape(8, -1).double().cpu() - ref).abs().max())
    print(f"dropless_ffn on the card vs float64: {err:.3e}")
    assert err < 1e-4


@pytest.mark.parametrize("t,e", [(8, 64), (32, 16), (32, 64), (2048, 64),
                                 (2048, 16)])
def test_route_kernel_matches_plain(gen, t, e):
    """``route_pairs`` on the card against its plain version: a decode step
    of the L tier (8 tokens over 64 experts) and of the S tier (32 over 16),
    the verify lane's 8 x 4 tokens (32 over 64) and a chunk pass (2,048
    tokens over 64 blocks), each one call of the kernel pair; ties planted
    (a row whose experts all tie, a row with its 6th and 7th tied), a third
    of the tokens dead.  Offsets and every pair's place (the dead tokens'
    last) exactly, the gates within 1e-6, the same bits twice."""
    from repro_torch.kernels import grouped_ffn as gf
    k = 6
    logits = torch.randn((t, e), generator=gen, device="cuda") * 2
    logits[0] = 0.5
    top = torch.sort(logits[1], descending=True).values
    logits[1][logits[1] == top[6]] = top[5]
    live = torch.rand((t,), generator=gen, device="cuda") > 0.33
    live[:2] = True
    want = gf.route_pairs_plain(logits, k, live)
    before = gf.route_pairs_cuda.launches
    runs = [ops.route_pairs(logits, k, live) for _ in range(2)]
    torch.cuda.synchronize()
    assert gf.route_pairs_cuda.launches == before + 2
    (gate, pairs, offsets), again = runs
    assert torch.equal(offsets, want[2])
    assert int(offsets[-1]) == k * int(live.sum())
    assert torch.equal(pairs, want[1])
    assert torch.equal(again[1], pairs) and torch.equal(again[2], offsets)
    assert torch.equal(again[0].view(torch.int32), gate.view(torch.int32))
    torch.testing.assert_close(gate, want[0], atol=1e-6, rtol=0)


# ---------------------------------------------------------------------------
# the decode lanes as CUDA graphs (``serving/lane_graphs.py``): each case's
# stream with the graphs (the scheduler's own rule) against the same stream
# with the eager lane (``lane_graphs.engages`` monkeypatched to refuse)
# ---------------------------------------------------------------------------

def _graph_tiers(name):
    """Both tiers on the card: the danube- and deepseek-shaped ones at
    their published widths and 2 layers (vocab 32,000; deepseek's 102,400
    cut to 32,000), S = ``s_variant(4)``; mamba2 and zamba2 reduced."""
    import dataclasses
    from repro_torch.configs.registry import ARCHS
    from repro_torch.models import model_zoo
    from repro_torch.serving.engine import TierModel
    if name in ("mamba2-370m", "zamba2-2.7b"):
        return _reduced_tiers(name)[1]
    cfg = dataclasses.replace(ARCHS[name], num_layers=2, vocab_size=32_000)
    g = torch.Generator(device="cuda").manual_seed(0)
    return [TierModel(c, model_zoo.init_params(g, c))
            for c in (cfg.s_variant(4), cfg)]


# (tiers, pool dtype, prefix sharing, sampled, chunk lane)
GRAPH_CASES = [
    ("h2o-danube-3-4b", "bf16", True, False, True),
    ("h2o-danube-3-4b", "int8", True, False, True),
    ("h2o-danube-3-4b", "bf16", False, True, True),
    ("h2o-danube-3-4b", "bf16", True, True, False),
    ("deepseek-moe-16b", "bf16", True, False, True),
    ("deepseek-moe-16b", "int8", False, True, True),
    ("mamba2-370m", "bf16", True, False, True),
    ("zamba2-2.7b", "int8", True, True, True),
    ("zamba2-2.7b", "bf16", False, False, False)]


def _graph_stream(tiers, kw, temp, graphs, monkeypatch, tel=None, eng=None):
    """A stream of ``_stream_requests`` (every request escalated) on ``eng``
    or a new engine, with the graphs or the eager lane: (records,
    scheduler, launch counts, engine)."""
    from repro_torch.configs.base import HIConfig
    from repro_torch.serving import lane_graphs
    from repro_torch.serving.engine import HIEngine
    monkeypatch.setattr(
        lane_graphs, "engages",
        lane_graphs.engages if graphs else lambda *a: False)
    reqs = _stream_requests(tiers[0].cfg.vocab_size)
    for r in reqs:
        r.temperature = temp
    if eng is None:
        eng = HIEngine(*tiers, HIConfig(theta=1.1, capacity_factor=1.0),
                       max_new_tokens=6)
    ops.reset_launch_counts()
    with torch.inference_mode():
        out = eng.serve_stream(reqs, telemetry=tel, **kw)
    torch.cuda.synchronize()
    return out, eng._stream[1], ops.launch_counts(), eng


@pytest.mark.parametrize("name,kv,sharing,sampled,chunk", GRAPH_CASES)
def test_graph_lane_equals_the_eager_lane_on_card(gen, monkeypatch, name, kv,
                                                  sharing, sampled, chunk):
    """Tokens, statuses, offloads and confidences bit for bit, and every
    kernel's launches equal; each tier captures once a key and replays its
    other decode-lane ticks; the S and L graphs replay in the same ticks on
    one stream, over one hi_gate merge workspace."""
    from repro_torch.serving.telemetry import Telemetry
    tiers = _graph_tiers(name)
    kw = dict(STREAM_KW, decode_block=4, kv_dtype=kv, prefix_sharing=sharing,
              chunk_prefill=chunk)
    temp = 0.8 if sampled else 0.0
    tel = Telemetry()
    got, sched, counts, _ = _graph_stream(tiers, kw, temp, True,
                                          monkeypatch, tel)
    ref, ref_sched, ref_counts, _ = _graph_stream(tiers, kw, temp, False,
                                                  monkeypatch)
    assert ref_sched._graphs is None
    assert got.keys() == ref.keys()
    for rid in ref:
        for key in ("tokens", "s_tokens", "offloaded", "served_remote",
                    "status"):
            np.testing.assert_array_equal(got[rid][key], ref[rid][key],
                                          err_msg=f"{rid} {key}")
        assert np.float32(got[rid]["confidence"]).view(np.int32) == \
            np.float32(ref[rid]["confidence"]).view(np.int32), rid
    assert counts == ref_counts
    for rt, ref_rt in ((sched.srt, ref_sched.srt), (sched.lrt, ref_sched.lrt)):
        assert rt.lane_ticks == ref_rt.lane_ticks
    st = sched.stats
    live = {rt.name: rt.lane_ticks["live"] for rt in (sched.srt, sched.lrt)}
    assert {t: st["graph_captures"][t] + st["graph_replays"][t]
            for t in live} == live
    assert st["graph_captures"] == {"S": 1, "L": 1}
    assert st["graph_eager_ticks"] == {}
    both = [t for t in tel.ticks
            if {sp.tier for sp in t.lanes if sp.graph} == {"S", "L"}]
    assert both, "no tick replayed both tiers' graphs"
    if hg.gate_splits(kw["num_slots"], tiers[0].cfg.vocab_size) > 1:
        # the gate's rows split: both tiers' graphs merge in the capture
        # stream's one workspace
        assert (0, sched._graphs.stream.cuda_stream) in hg._SCRATCH
    print(f"{name} {kv} sharing {sharing} sampled {sampled} chunk {chunk}: "
          f"{len(ref)} requests, live ticks {live}, replays "
          f"{st['graph_replays']}, {len(both)} ticks replayed both")


def test_graph_lane_kernels_in_the_profiler_trace(gen, monkeypatch):
    """Under ``torch.profiler``, a stream whose graphs were captured before
    the profiler started shows the replayed kernels by name, launched by
    ``cudaGraphLaunch``, as many as the eager stream's and with their device
    time within 10% of the eager lane's."""
    from collections import defaultdict
    from torch.profiler import ProfilerActivity, profile
    tiers = _graph_tiers("h2o-danube-3-4b")
    kw = dict(STREAM_KW, decode_block=4, num_slots=8, l_slots=8,
              chunk_prefill=False)
    names = ("paged_attention_split_kernel", "hi_gate_kernel")
    runs = {}
    for graphs in (True, False):
        # the first stream captures, before the profiler starts
        eng = _graph_stream(tiers, kw, 0.0, graphs, monkeypatch)[3]
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            _graph_stream(tiers, kw, 0.0, graphs, monkeypatch, eng=eng)
        evs = list(prof.profiler.kineto_results.events())
        launch = {e.correlation_id(): e.name() for e in evs
                  if e.device_type().name == "CPU"
                  and e.name().startswith("cu")}
        n, t, by = defaultdict(int), defaultdict(float), defaultdict(set)
        for e in evs:
            if e.device_type().name != "CUDA" or e.end_ns() <= e.start_ns():
                continue
            for k in names:
                if k in e.name():
                    n[k] += 1
                    t[k] += (e.end_ns() - e.start_ns()) / 1e3
                    by[k].add(launch.get(e.correlation_id(), "?"))
        runs[graphs] = (n, t, by)
    (gn, gt, gby), (en, et, eby) = runs[True], runs[False]
    print({k: (gn[k], round(gt[k], 1), en[k], round(et[k], 1)) for k in names})
    for k in names:
        assert gn[k] == en[k] > 0, k
        assert "cudaGraphLaunch" in gby[k], (k, gby[k])
        assert abs(gt[k] - et[k]) <= 0.1 * et[k], (k, gt[k], et[k])


def test_benchmark_tally_runs_the_lanes_eagerly(gen, monkeypatch):
    """``hibench/program.tally_kernels`` wraps the two paged entry points:
    a stream under it on a scheduler that holds graphs runs its decode
    lanes eagerly, so the tally records every paged decode call, as many
    as the kernel's launches and the lane flags predict."""
    from hibench import program
    tiers = _graph_tiers("h2o-danube-3-4b")
    kw = dict(STREAM_KW, decode_block=4)
    from repro_torch.configs.base import HIConfig
    from repro_torch.serving.engine import HIEngine
    eng = HIEngine(*tiers, HIConfig(theta=1.1, capacity_factor=1.0),
                   max_new_tokens=6)
    reqs = _stream_requests(tiers[0].cfg.vocab_size)
    with torch.inference_mode():
        eng.serve_stream(reqs, **kw)
        sched = eng._stream[1]
        replays = dict(sched.stats["graph_replays"])
        live0 = {rt.name: rt.lane_ticks["live"]
                 for rt in (sched.srt, sched.lrt)}
        before = ops.launch_counts()["decode_attention_paged"]
        calls = {}
        with program.tally_kernels(calls):
            eng.serve_stream(reqs, **kw)
    torch.cuda.synchronize()
    live = {rt.name: rt.lane_ticks["live"] - live0[rt.name]
            for rt in (sched.srt, sched.lrt)}
    assert sched.stats["graph_replays"] == replays
    assert sched.stats["graph_eager_ticks"] == live
    ran = ops.launch_counts()["decode_attention_paged"] - before
    layers = {rt.name: rt.pool.cfg.num_layers for rt in (sched.srt, sched.lrt)}
    assert len(calls["decode_attention_paged"]) == ran == sum(
        4 * layers[t] * n for t, n in live.items()) > 0
