"""The registry's ten archs and the families the port added beside the MoE:
the VLM (llava-next-34b), the enc-dec (whisper-large-v3) and two dense
configs (granite-3-2b, h2o-danube-3-4b), against the JAX reference at
reduced size, on bridged params.

* Every config, its ``reduced()`` and ``s_variant(4)``, field for field.
* ``forward`` of granite, danube and llava (with the patch prefix: logits
  (B, P + S, V)) and whisper (frames + tokens), and whisper's decode ==
  its forward via ``precompute_cross`` (``tests/test_models.py:43``).
* The bridge over the MoE, arctic and whisper trees: the port's own init
  gives the reference's tree, leaf for leaf in shape and dtype.
* ``model_zoo`` raises ``NotImplementedError`` for no family; the enc-dec
  family refuses ``prefill`` and the paged API with the reference's
  ``ValueError``, and the serve CLI refuses it (and the VLM) as the
  reference's does.

Tolerances: ``FWD_TOL`` = 1e-4 (float32 end to end, only the order of
sums differs); whisper's decode against its forward at the reference's
2e-3.  TF32 off.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCHS as JAX_ARCHS
from repro.launch import serve as jserve
from repro.models import model_zoo as jzoo
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import base
from repro_torch.configs.registry import ARCHS, get_arch
from repro_torch.launch import serve as tserve
from repro_torch.models import model_zoo as tzoo
from repro_torch.models import whisper
from repro_torch.serving.engine import disable_tf32

FWD_TOL = 1e-4
B, S = 2, 12


def test_registry_has_the_reference_archs_field_for_field():
    assert list(ARCHS) == list(JAX_ARCHS)
    for name, jc in JAX_ARCHS.items():
        tc = get_arch(name)
        for derive in (lambda c: c, lambda c: c.reduced(),
                       lambda c: c.s_variant(4),
                       lambda c: c.reduced().s_variant(4)):
            assert dataclasses.asdict(derive(tc)) == \
                dataclasses.asdict(derive(jc)), name
        assert (tc.attention_free, tc.sub_quadratic, tc.resolved_head_dim) \
            == (jc.attention_free, jc.sub_quadratic, jc.resolved_head_dim)
    assert base.FAMILIES == ("dense", "moe", "ssm", "hybrid", "encdec", "vlm")


def _bridged(name, seed=0):
    disable_tf32()
    jcfg, tcfg = JAX_ARCHS[name].reduced(), ARCHS[name].reduced()
    jparams = jzoo.init_params(jax.random.PRNGKey(seed), jcfg)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams),
                                device="cpu")
    return jcfg, jparams, tcfg, tparams


def _inputs(cfg, seed=0):
    """Seeded tokens, and the stubbed frontends' embeddings."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    extra = {}
    if cfg.family == "vlm":
        extra["patches"] = rng.normal(size=(B, cfg.num_patches, cfg.d_model))
    if cfg.family == "encdec":
        extra["frames"] = rng.normal(
            size=(B, cfg.num_audio_frames, cfg.d_model))
    return toks, {k: v.astype(np.float32) for k, v in extra.items()}


@pytest.mark.parametrize("name", ["granite-3-2b", "h2o-danube-3-4b",
                                  "llava-next-34b", "whisper-large-v3"])
def test_forward_matches_reference(name):
    jcfg, jparams, tcfg, tparams = _bridged(name)
    toks, extra = _inputs(jcfg)
    jl, _ = jzoo.forward(jparams, jcfg, {"tokens": jnp.asarray(toks),
                                         **{k: jnp.asarray(v)
                                            for k, v in extra.items()}})
    tl = tzoo.forward(tparams, tcfg, torch.as_tensor(toks),
                      **{k: torch.as_tensor(v) for k, v in extra.items()})
    n = S + (tcfg.num_patches if tcfg.family == "vlm" else 0)
    assert tl.shape == (B, n, tcfg.vocab_size) and tl.dtype == torch.float32
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=FWD_TOL,
                               atol=FWD_TOL)


def test_llava_patches_are_a_prefix():
    """Without patches the VLM is its dense LM; with them the text logits
    move (the patches are attended)."""
    _, _, tcfg, tparams = _bridged("llava-next-34b")
    toks, extra = _inputs(tcfg)
    toks = torch.as_tensor(toks)
    text = tzoo.forward(tparams, tcfg, toks)
    assert text.shape == (B, S, tcfg.vocab_size)
    both = tzoo.forward(tparams, tcfg, toks,
                        patches=torch.as_tensor(extra["patches"]))
    assert (both[:, tcfg.num_patches:] - text).abs().max() > 1e-3


def test_whisper_decode_matches_forward():
    """tests/test_models.py:43 — decode over the precomputed cross K/V
    equals the teacher-forced forward, and the reference's decode."""
    jcfg, jparams, tcfg, tparams = _bridged("whisper-large-v3")
    toks, extra = _inputs(tcfg, seed=1)
    frames = torch.as_tensor(extra["frames"])
    full = tzoo.forward(tparams, tcfg, torch.as_tensor(toks), frames=frames)
    cache = tzoo.init_cache(tcfg, B, 16, dtype=torch.float32, device="cpu")
    cache = whisper.precompute_cross(tparams, tcfg, frames, cache)
    jcache = jzoo.init_cache(jcfg, B, 16, dtype=jnp.float32)
    from repro.models import whisper as jwhisper
    jcache = jwhisper.precompute_cross(jparams, jcfg,
                                       jnp.asarray(extra["frames"]), jcache)
    np.testing.assert_allclose(cache["ck"].numpy(), np.asarray(jcache["ck"]),
                               rtol=FWD_TOL, atol=FWD_TOL)
    for t in range(S):
        tok = toks[:, t:t + 1]
        last, cache = tzoo.decode_step(tparams, tcfg, torch.as_tensor(tok),
                                       cache)
        jlast, jcache = jzoo.decode_step(jparams, jcfg, jnp.asarray(tok),
                                         jcache)
        np.testing.assert_allclose(last.numpy(), np.asarray(jlast),
                                   rtol=FWD_TOL, atol=FWD_TOL)
    assert cache["pos"] == S
    np.testing.assert_allclose(last.numpy(), full[:, -1].numpy(), rtol=2e-3,
                               atol=2e-3)


def _tree(t):
    if isinstance(t, dict):
        return {k: _tree(v) for k, v in t.items()}
    return tuple(t.shape), str(t.dtype).replace("torch.", "")


@pytest.mark.parametrize("name", ["deepseek-moe-16b", "arctic-480b",
                                  "whisper-large-v3", "llava-next-34b"])
def test_bridge_carries_the_stacked_trees(name):
    """The experts are nested dicts of (L, E, ...) leaves, whisper's two
    stacks and position tables likewise: the bridge converts leaves only,
    and the port's own init gives the same tree."""
    jcfg, jparams, tcfg, tparams = _bridged(name)
    own = tzoo.init_params(torch.Generator().manual_seed(0), tcfg)
    ref = jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)), jparams)
    assert _tree(tparams) == _tree(own) == ref
    flat_j = jax.tree.leaves(jparams)
    flat_t = jax.tree.leaves(jax.tree.map(lambda t: t.numpy(), tparams))
    assert all(np.array_equal(np.asarray(a), b)
               for a, b in zip(flat_j, flat_t))


@pytest.mark.parametrize("name", sorted(JAX_ARCHS))
def test_model_zoo_takes_every_family(name):
    """No ``NotImplementedError`` anywhere: every arch's reduced config
    makes its params and its decode cache."""
    cfg = ARCHS[name].reduced()
    params = tzoo.init_params(torch.Generator().manual_seed(0), cfg)
    assert params["lm_head"].shape == (cfg.d_model, cfg.vocab_size)
    cache = tzoo.init_cache(cfg, 1, 8, device="cpu")
    assert isinstance(cache, dict)


def test_encdec_refuses_the_serving_api_as_the_reference():
    cfg = ARCHS["whisper-large-v3"].reduced()
    jcfg = JAX_ARCHS["whisper-large-v3"].reduced()
    toks = torch.zeros((1, 8), dtype=torch.int64)
    with pytest.raises(ValueError, match="prefill not supported for family "
                                         "'encdec'"):
        tzoo.prefill({}, cfg, toks, {})
    with pytest.raises(ValueError, match="prefill not supported for family "
                                         "'encdec'"):
        jzoo.prefill({}, jcfg, jnp.zeros((1, 8), jnp.int32), {})
    for what, call in (
            ("paged cache", lambda z, c: z.init_paged_cache(c, 2, 8, 4)),
            ("prefill_paged", lambda z, c: z.prefill_paged(
                {}, c, toks, None, None, None, {})),
            ("decode_step_paged", lambda z, c: z.decode_step_paged(
                {}, c, toks, None, None, {})),
            ("forward_chunk_paged", lambda z, c: z.forward_chunk_paged(
                {}, c, toks, None, None, {}))):
        msg = f"{what} not supported for family 'encdec'"
        with pytest.raises(ValueError, match=msg):
            call(tzoo, cfg)
        with pytest.raises(ValueError, match=msg):
            call(jzoo, jcfg)
    with pytest.raises(ValueError, match="prefix cache not supported"):
        tzoo.init_prefix_cache(cfg, 2, device="cpu")


@pytest.mark.parametrize("name", ["whisper-large-v3", "llava-next-34b"])
def test_serve_cli_refuses_as_the_reference(name):
    with pytest.raises(SystemExit) as ref:
        jserve.run(name, requests=1)
    with pytest.raises(SystemExit) as got:
        tserve.run(name, requests=1, device="cpu")
    assert str(got.value) == str(ref.value)
