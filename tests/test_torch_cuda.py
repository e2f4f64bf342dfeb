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

pytestmark = pytest.mark.cuda

# kernel and plain version both compute in float32; only sum order differs
CONF_ATOL, CONF_RTOL = 1e-5, 1e-4
ATT_ATOL = 1e-4


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
                                               + cfg.num_layers)}
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
