"""The port's dense decoder against the JAX reference, on bridged params.

Reduced qwen2-1.5b and gemma3-1b (2 layers, d_model 256, vocab 512), both
tiers.  The same numpy-seeded tokens go through the reference's
``model_zoo.forward`` / ``prefill`` / ``decode_step(use_kernel=True)``
(Pallas in interpret mode) and through the port's counterparts on the CPU,
where the port's decode attention runs its kernel's plain version.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCHS as JAX_ARCHS
from repro.models import model_zoo as jzoo
from repro_torch.bridge import params_from_numpy
from repro_torch.configs.registry import ARCHS
from repro_torch.models import model_zoo as tzoo
from repro_torch.models import transformer
from repro_torch.parity import greedy_agreement
from repro_torch.serving.engine import disable_tf32

B, S, CACHE, T = 3, 24, 48, 4
# forward is float32 end to end: only summation order differs
FWD_TOL = 1e-4
# prefill/decode round K/V (and q, in the prefill attention) to bf16; a
# float32 difference of ~1e-7 flips a value across a bf16 rounding boundary
# now and then (one bf16 ulp is 2^-8..2^-7 relative), which moves logits by ~1e-3
LOGIT_TOL = 5e-3
# bf16 spacing at 1.0: one bf16 ulp of x is at most BF16_EPS * |x|
BF16_EPS = 2.0 ** -7

TIERS = [(arch, tier) for arch in ("qwen2-1.5b", "gemma3-1b")
         for tier in ("L", "S")]


def _cfgs(arch, tier):
    jc, tc = JAX_ARCHS[arch].reduced(), ARCHS[arch].reduced()
    if tier == "S":
        jc, tc = jc.s_variant(4), tc.s_variant(4)
    return jc, tc


@pytest.fixture(scope="module", params=TIERS, ids=lambda p: "-".join(p))
def bridged(request):
    disable_tf32()
    jcfg, tcfg = _cfgs(*request.param)
    params = jzoo.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_numpy(jax.tree.map(np.asarray, params),
                                device="cpu")
    return jcfg, tcfg, params, tparams


def _close_bf16(a, b):
    """bf16 caches: layer 0 equal up to one bf16 ulp; deeper layers inherit
    the rounding flips of the layers below, so they are held at the logit
    tolerance; and nearly every element is bitwise equal."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    # near zero a float32 dot product carries an absolute error of ~1e-7,
    # which is many ulps of a tiny value: hence the absolute floor
    diff = np.abs(a[0] - b[0])
    assert (diff <= BF16_EPS * np.maximum(np.abs(a[0]), np.abs(b[0]))
            + 1e-5).all()
    np.testing.assert_allclose(b, a, rtol=LOGIT_TOL, atol=LOGIT_TOL)
    assert (a != b).mean() < 1e-2


def test_config_derivations_match_reference():
    for arch in ARCHS:
        for jc, tc in ((JAX_ARCHS[arch], ARCHS[arch]),
                       (JAX_ARCHS[arch].reduced(), ARCHS[arch].reduced()),
                       (JAX_ARCHS[arch].s_variant(4), ARCHS[arch].s_variant(4)),
                       (JAX_ARCHS[arch].reduced().s_variant(4),
                        ARCHS[arch].reduced().s_variant(4))):
            for f in tc.__dataclass_fields__:
                assert getattr(tc, f) == getattr(jc, f), (arch, f)
            assert tc.resolved_head_dim == jc.resolved_head_dim
            assert transformer.layer_windows(tc, 100) == \
                np.asarray(jax.jit(lambda: jzoo.transformer.layer_windows(
                    jc, 100))()).tolist()


def test_bridge_keeps_reference_layout(bridged):
    """The port keeps (L, in, out) stacked weights applied as x @ W."""
    jcfg, tcfg, params, tparams = bridged
    jflat = jax.tree_util.tree_flatten_with_path(params)[0]
    assert len(jflat) > 0
    for path, leaf in jflat:
        t = tparams
        for k in path:
            t = t[k.key]
        assert tuple(t.shape) == leaf.shape
        np.testing.assert_array_equal(t.numpy(), np.asarray(leaf))
    hd = tcfg.resolved_head_dim
    assert tuple(tparams["layers"]["attn"]["wq"].shape) == (
        tcfg.num_layers, tcfg.d_model, tcfg.num_heads * hd)
    fresh = tzoo.init_params(torch.Generator().manual_seed(0), tcfg)
    assert jax.tree.structure(jax.tree.map(lambda a: 0, params)) == \
        jax.tree.structure(jax.tree.map(lambda a: 0, fresh))
    for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(fresh)):
        assert tuple(b.shape) == a.shape


def test_forward_matches_reference(bridged):
    jcfg, tcfg, params, tparams = bridged
    toks = np.random.default_rng(0).integers(0, jcfg.vocab_size, (B, S))
    jl, _ = jax.jit(lambda p, t: jzoo.forward(p, jcfg, {"tokens": t}))(
        params, jnp.asarray(toks, jnp.int32))
    tl = tzoo.forward(tparams, tcfg, torch.as_tensor(toks))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=FWD_TOL,
                               atol=FWD_TOL)


def test_prefill_and_decode_match_reference(bridged):
    """prefill, then T teacher-forced decode steps: logits allclose, bf16
    caches equal to within one ulp, decisive greedy tokens equal."""
    jcfg, tcfg, params, tparams = bridged
    rng = np.random.default_rng(1)
    toks = rng.integers(0, jcfg.vocab_size, (B, S))
    jcache = jzoo.init_cache(jcfg, B, CACHE)
    jl, jcache = jax.jit(lambda p, t, c: jzoo.prefill(p, jcfg, t, c))(
        params, jnp.asarray(toks, jnp.int32), jcache)
    tcache = tzoo.init_cache(tcfg, B, CACHE, device="cpu")
    tl, tcache = tzoo.prefill(tparams, tcfg, torch.as_tensor(toks), tcache)
    assert tcache["pos"] == int(jcache["pos"]) == S
    jlogs, tlogs = [np.asarray(jl)], [tl.numpy()]
    step = jax.jit(lambda p, t, c: jzoo.decode_step(p, jcfg, t, c,
                                                    use_kernel=True))
    for _ in range(T):
        tok = rng.integers(0, jcfg.vocab_size, (B, 1))
        jl, jcache = step(params, jnp.asarray(tok, jnp.int32), jcache)
        tl, tcache = tzoo.decode_step(tparams, tcfg, torch.as_tensor(tok),
                                      tcache)
        jlogs.append(np.asarray(jl))
        tlogs.append(tl.numpy())
    assert tcache["pos"] == S + T
    np.testing.assert_allclose(np.stack(tlogs), np.stack(jlogs),
                               rtol=LOGIT_TOL, atol=LOGIT_TOL)
    for k in ("k", "v"):
        _close_bf16(np.asarray(jcache[k].astype(jnp.float32)),
                    tcache[k].float().numpy())
    n, agree = greedy_agreement(np.stack(jlogs), np.stack(tlogs), LOGIT_TOL)
    assert n > 0 and agree == n


def test_prefill_chunked_attention_matches_reference():
    """S = 1024 takes the query-chunked attention (s > 512, s % 512 == 0)."""
    disable_tf32()
    jcfg, tcfg = _cfgs("gemma3-1b", "S")
    params = jzoo.init_params(jax.random.PRNGKey(1), jcfg)
    tparams = params_from_numpy(jax.tree.map(np.asarray, params),
                                device="cpu")
    toks = np.random.default_rng(2).integers(0, jcfg.vocab_size, (1, 1024))
    jl, jc = jax.jit(lambda p, t, c: jzoo.prefill(p, jcfg, t, c))(
        params, jnp.asarray(toks, jnp.int32), jzoo.init_cache(jcfg, 1, 1024))
    tl, tc = tzoo.prefill(tparams, tcfg, torch.as_tensor(toks),
                          tzoo.init_cache(tcfg, 1, 1024, device="cpu"))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=LOGIT_TOL,
                               atol=LOGIT_TOL)
    _close_bf16(np.asarray(jc["k"].astype(jnp.float32)), tc["k"].float().numpy())


def test_encdec_prefill_raises_the_reference_error():
    """Every family is ported; the serving entry refuses the enc-dec
    family as the reference's ``model_zoo.prefill`` does."""
    cfg = ARCHS["whisper-large-v3"].reduced()
    cache = tzoo.init_cache(cfg, 1, 8, device="cpu")
    with pytest.raises(ValueError,
                       match="prefill not supported for family 'encdec'"):
        tzoo.prefill({}, cfg, torch.zeros((1, 8), dtype=torch.int64), cache)
