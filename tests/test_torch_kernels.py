"""The port's kernels, through their plain versions on the CPU, against the
reference's Pallas kernels (interpret mode, as tests/test_kernels.py runs
them), on the same numpy-seeded inputs.  The CUDA kernels themselves are
held against these plain versions on the card (tests/test_torch_cuda.py,
chip_smoke.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import decode_attention as tda
from repro_torch.kernels import hi_gate as thg
from repro_torch.kernels import ops

RNG = np.random.default_rng(7)
# both sides compute in float32 from identical inputs (bf16 inputs are
# upcast exactly); only reduction order differs
CONF_TOL = 1e-5
# decode attention: float32 accumulation over <= 256 positions; a bf16
# output is one bf16 rounding away
ATT_TOL = {np.float32: 3e-5, "bfloat16": 1e-2}


def _t(x, dtype=torch.float32):
    return torch.as_tensor(np.asarray(x, np.float32)).to(dtype)


@pytest.mark.parametrize("metric", ["max_prob", "margin", "entropy"])
@pytest.mark.parametrize("n,c", [(8, 10), (33, 7), (16, 512)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hi_gate_plain_matches_pallas(metric, n, c, dtype):
    x = RNG.normal(size=(n, c)) * 3
    x[0, 3] = x[0, 5] = x[0].max() + 1.0       # a duplicated max
    jx = jnp.asarray(x, jnp.float32).astype(getattr(jnp, dtype))
    tx = _t(x, getattr(torch, dtype))
    np.testing.assert_array_equal(np.asarray(jx.astype(jnp.float32)),
                                  tx.float().numpy())
    conf_j, pred_j, off_j = jops.hi_gate(jx, 0.55, metric)
    conf_t, pred_t, off_t = ops.hi_gate(tx, 0.55, metric)
    np.testing.assert_allclose(conf_t.numpy(), np.asarray(conf_j),
                               rtol=CONF_TOL, atol=CONF_TOL)
    assert pred_t.dtype == off_t.dtype == torch.int32
    np.testing.assert_array_equal(pred_t.numpy(), np.asarray(pred_j))
    assert pred_t[0] == 3                      # first index of the max
    if metric == "margin":
        assert conf_t[0] == 0.0                # duplicated max -> margin 0
    far = np.abs(np.asarray(conf_j) - 0.55) > CONF_TOL
    np.testing.assert_array_equal(off_t.numpy()[far], np.asarray(off_j)[far])


def test_hi_gate_threshold_semantics():
    """offload = conf < theta, strictly: a row exactly at theta stays local;
    theta may be a float or a 0-d tensor."""
    logits = torch.tensor([[10.0, -10.0], [0.1, 0.0], [0.0, 0.0]])
    conf, pred, off = ops.hi_gate(logits, 0.9, "max_prob")
    assert off.tolist()[:2] == [0, 1] and pred[0] == 0
    assert conf[2] == 0.5
    _, _, off_at = ops.hi_gate(logits, torch.tensor(0.5), "max_prob")
    assert off_at[2] == 0
    conf_j, _, off_j = jops.hi_gate(jnp.asarray(logits.numpy()), 0.5,
                                    "max_prob")
    assert int(off_j[2]) == 0 and float(conf_j[2]) == 0.5


SHAPES = [(1, 128, 4, 1, 16), (2, 256, 8, 2, 32), (2, 192, 6, 6, 16)]


@pytest.mark.parametrize("b,s,h,k,d", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_plain_matches_pallas(b, s, h, k, d, dtype):
    q = RNG.normal(size=(b, 1, h, d))
    ck = RNG.normal(size=(b, s, k, d))
    cv = RNG.normal(size=(b, s, k, d))
    valid = np.arange(s) <= s // 3
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    out_j = jops.decode_attention(jnp.asarray(q).astype(jd),
                                  jnp.asarray(ck).astype(jd),
                                  jnp.asarray(cv).astype(jd),
                                  jnp.asarray(valid), block_s=64)
    out_t = ops.decode_attention(_t(q, td), _t(ck, td), _t(cv, td),
                                 torch.as_tensor(valid))
    assert out_t.dtype == td and tuple(out_t.shape) == (b, 1, h, d)
    tol = ATT_TOL[np.float32 if dtype == "float32" else "bfloat16"]
    np.testing.assert_allclose(out_t.float().numpy(),
                               np.asarray(out_j.astype(jnp.float32)),
                               rtol=tol, atol=tol)


def test_decode_attention_plain_sliding_window_and_bf16_cache():
    """A window mask drops old positions exactly; an f32 query over a bf16
    cache (the serving case) keeps the query in f32, as the Pallas kernel
    does."""
    b, s, h, k, d = 2, 128, 4, 1, 64
    q = RNG.normal(size=(b, 1, h, d))
    ck = RNG.normal(size=(b, s, k, d))
    cv = RNG.normal(size=(b, s, k, d))
    pos, win = 100, 16
    kpos = np.arange(s)
    valid = (kpos <= pos) & (pos - kpos < win)
    out_j = jops.decode_attention(jnp.asarray(q, jnp.float32),
                                  jnp.asarray(ck).astype(jnp.bfloat16),
                                  jnp.asarray(cv).astype(jnp.bfloat16),
                                  jnp.asarray(valid), block_s=32)
    tk, tv = _t(ck, torch.bfloat16), _t(cv, torch.bfloat16)
    out_t = ops.decode_attention(_t(q), tk, tv, torch.as_tensor(valid))
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), rtol=3e-5,
                               atol=3e-5)
    # positions outside the window do not matter at all
    tk2, tv2 = tk.clone(), tv.clone()
    tk2[:, :pos - win + 1] = 7.0
    tv2[:, :pos - win + 1] = -7.0
    out_t2 = ops.decode_attention(_t(q), tk2, tv2, torch.as_tensor(valid))
    torch.testing.assert_close(out_t2, out_t, rtol=0, atol=0)


def test_decode_attention_fully_masked_gives_zero():
    q = torch.ones(1, 1, 2, 16)
    kv = torch.ones(1, 8, 1, 16)
    out = ops.decode_attention(q, kv, kv, torch.zeros(8, dtype=torch.bool))
    assert torch.equal(out, torch.zeros_like(out))


def test_cpu_tensors_take_the_plain_version_without_launching():
    ops.reset_launch_counts()
    ops.hi_gate(torch.randn(4, 32), 0.5)
    ops.decode_attention(torch.randn(1, 1, 2, 16), torch.randn(1, 8, 1, 16),
                         torch.randn(1, 8, 1, 16), torch.ones(8, dtype=bool))
    assert ops.launch_counts() == {"hi_gate": 0, "decode_attention": 0}


def test_kernel_wrappers_refuse_non_cuda_tensors():
    """The CUDA wrappers never fall back: a CPU tensor is refused, and the
    public ops refuse devices that have neither a kernel nor a plain
    version."""
    x = torch.randn(4, 32)
    with pytest.raises(ValueError, match="CUDA"):
        thg.hi_gate_cuda(x, torch.tensor(0.5))
    with pytest.raises(ValueError, match="CUDA"):
        tda.decode_attention_cuda(torch.randn(1, 1, 2, 16),
                                  torch.randn(1, 8, 1, 16),
                                  torch.randn(1, 8, 1, 16),
                                  torch.ones(8, dtype=bool))
    with pytest.raises(ValueError, match="no kernel for device meta"):
        ops.hi_gate(torch.empty(4, 32, device="meta"), 0.5)


def test_build_commands_target_sm90a_in_parallel(tmp_path):
    """One nvcc per source, all for sm_90a with ptxas statistics, then one
    link into a single shared library; the build key follows the sources."""
    from repro_torch.kernels import build
    compiles, link = build.compile_commands("nvcc", tmp_path)
    assert len(compiles) == len(build.SOURCES) == 2
    for cmd in compiles:
        assert "arch=compute_90a,code=sm_90a" in cmd and "-c" in cmd
        assert "-Xptxas" in cmd and "-v" in cmd and "-O3" in cmd
        assert (build.CSRC / cmd[cmd.index("-c") + 1]).exists()
    assert "-shared" in link and link[link.index("-o") + 1].endswith(".so")
    assert len(build.source_hash()) == 16
    lines = build._ptxas_lines(
        "ptxas info    : Used 40 registers, used 1 barriers, 41216 bytes "
        "smem\n    0 bytes stack frame, 0 bytes spill stores\nnoise\n")
    assert len(lines) == 2
