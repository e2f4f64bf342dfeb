"""The split-cache decode (``transformer.decode_step_split``): ring buffers
for the sliding-window layers, full stacks for the global ones, against
the JAX reference at reduced size on bridged params.

* The port's ``decode_step_split`` against the reference's on reduced
  gemma3-1b (6 layers: five local, one global) and h2o-danube-3-4b (every
  layer local, zero-size global stacks), ``sliding_window=4``, 10 tokens:
  logits each step and the caches at the end, within ``SPLIT_TOL``.
* The reference's ``test_split_cache_decode_matches_uniform``
  (``tests/test_models.py:134``) restated on the port, at its 2e-3.
* ``num_local_layers``, the ring positions and the split cache's shapes
  against the reference's for every sliding-window config.

``SPLIT_TOL`` = 1e-4: float32 caches and params end to end; the port's
local layers run the drain kernel's plain version (q in float32, K/V
upcast) where the reference runs ``_sdpa``, the same products summed in
another order.  TF32 off.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCHS as JAX_ARCHS
from repro.models import model_zoo as jzoo
from repro.models import transformer as jtr
from repro_torch.bridge import params_from_numpy
from repro_torch.configs.registry import ARCHS
from repro_torch.models import layers as L
from repro_torch.models import model_zoo as tzoo
from repro_torch.models import transformer as ttr
from repro_torch.serving.engine import disable_tf32

SPLIT_TOL = 1e-4
B, T, CACHE = 2, 10, 16
CASES = (("gemma3-1b", dict(sliding_window=4, num_layers=6)),
         ("h2o-danube-3-4b", dict(sliding_window=4)))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small ops: one intra-op thread runs them about as fast and adds no
    contention beside the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bridged(arch, patch, seed=0):
    disable_tf32()
    jcfg = dataclasses.replace(JAX_ARCHS[arch].reduced(), **patch)
    tcfg = dataclasses.replace(ARCHS[arch].reduced(), **patch)
    jparams = jzoo.init_params(jax.random.PRNGKey(seed), jcfg)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams),
                                device="cpu")
    toks = np.random.default_rng(seed).integers(
        0, jcfg.vocab_size, (B, T)).astype(np.int32)
    return jcfg, jparams, tcfg, tparams, toks


@pytest.mark.parametrize("arch,patch", CASES, ids=[a for a, _ in CASES])
def test_decode_step_split_matches_reference(arch, patch):
    jcfg, jparams, tcfg, tparams, toks = _bridged(arch, patch)
    jc = jtr.init_split_cache(jcfg, B, CACHE, dtype=jnp.float32)
    tc = ttr.init_split_cache(tcfg, B, CACHE, torch.float32, "cpu")
    n_global = tcfg.num_layers - ttr.num_local_layers(tcfg)
    assert tc["global_k"].shape[0] == n_global == (1 if arch == "gemma3-1b"
                                                   else 0)
    for t in range(T):
        jl, jc = jtr.decode_step_split(jparams, jcfg,
                                       jnp.asarray(toks[:, t:t + 1]), jc)
        tl, tc = ttr.decode_step_split(tparams, tcfg,
                                       torch.as_tensor(toks[:, t:t + 1]), tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   rtol=SPLIT_TOL, atol=SPLIT_TOL)
    assert tc["pos"] == T == int(jc["pos"])
    for key in ("local_k", "local_v", "global_k", "global_v"):
        np.testing.assert_allclose(tc[key].numpy(), np.asarray(jc[key]),
                                   rtol=SPLIT_TOL, atol=SPLIT_TOL)


@pytest.mark.parametrize("arch,patch", CASES, ids=[a for a, _ in CASES])
def test_split_cache_decode_matches_uniform(arch, patch):
    """Ring-buffer local caches == the uniform full cache (the reference's
    test, on the port: its own init, its 2e-3)."""
    cfg = dataclasses.replace(ARCHS[arch].reduced(), **patch)
    params = tzoo.init_params(torch.Generator().manual_seed(0), cfg)
    tokens = torch.randint(0, cfg.vocab_size, (B, T),
                           generator=torch.Generator().manual_seed(1))
    uni = tzoo.init_cache(cfg, B, CACHE, torch.float32, "cpu")
    spl = ttr.init_split_cache(cfg, B, CACHE, torch.float32, "cpu")
    for t in range(T):
        tok = tokens[:, t:t + 1]
        last_u, uni = ttr.decode_step(params, cfg, tok, uni)
        last_s, spl = ttr.decode_step_split(params, cfg, tok, spl)
    np.testing.assert_allclose(last_s.numpy(), last_u.numpy(), rtol=2e-3,
                               atol=2e-3)


def test_split_cache_refuses_a_full_attention_arch():
    cfg = ARCHS["qwen2-1.5b"].reduced()
    with pytest.raises(ValueError, match="sliding-window"):
        ttr.decode_step_split({}, cfg, torch.zeros((1, 1), dtype=torch.int64),
                              {})


@pytest.mark.parametrize("pos,w", [(0, 4), (3, 4), (4, 4), (9, 4), (1030, 1024)])
def test_ring_positions_match_reference(pos, w):
    ref = np.asarray(jtr._ring_positions(jnp.asarray(pos), w))
    np.testing.assert_array_equal(L.ring_positions(pos, w, "cpu").numpy(), ref)


@pytest.mark.parametrize("arch", [a for a, c in ARCHS.items()
                                  if c.sliding_window])
def test_split_cache_specs_match_reference(arch):
    """Every sliding-window config, full size: the local-layer count and
    the split cache's leaves, shape and dtype (on meta: no allocation)."""
    jcfg, tcfg = JAX_ARCHS[arch], ARCHS[arch]
    assert ttr.num_local_layers(tcfg) == jtr.num_local_layers(jcfg)
    for batch, seq in ((1, 524_288), (128, 32_768)):
        js = jtr.split_cache_spec(jcfg, batch, seq)
        ts = ttr.split_cache_spec(tcfg, batch, seq)
        assert set(ts) == set(js)
        for key, leaf in ts.items():
            if key == "pos":
                assert leaf == 0
                continue
            assert leaf.device.type == "meta"
            assert tuple(leaf.shape) == js[key].shape, key
            assert str(leaf.dtype).split(".")[-1] == str(js[key].dtype)
