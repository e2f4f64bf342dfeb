"""The port's MoE family (``models/moe.py``) against the JAX reference, at
reduced size (2 layers, d_model 256, 4 experts, top-2, vocab 512).

* ``moe_capacity`` on the reference's cases (``tests/test_property.py:96``).
* ``moe_ffn`` against the reference's at the serving capacity 2.0 and at a
  forced-drop 0.5: outputs and aux loss within ``FWD_TOL`` (inside the
  logit tolerance), and the dropped (token, choice) set, read back from
  the reference's own output (:func:`_reference_drops`).
* reduced deepseek-moe-16b and arctic-480b (its dense residual): ``forward``
  (capacity 1.25), ``prefill``, ``decode_step`` and the paged API
  (``prefill_paged`` with and without ``start``, ``decode_step_paged``,
  ``forward_chunk_paged``) over bf16 and int8 pools, against the
  reference's on bridged params.
* The reference's own MoE cases on the port: decode == forward at the
  no-drop capacity E/k (``tests/test_models.py:31``), bounded drops
  (``:122``), chunk == per-token at its 5e-3 (``tests/test_chunk_lane.py:90``).

Tolerances.  ``FWD_TOL`` = 1e-4: float32 end to end, only the order of
sums differs.  ``LOGIT_TOL`` = 5e-3 where K/V are rounded to bf16
(``test_torch_model.py``, ``test_torch_paged.py``); int8 pools at the
qwen2 limit of ``test_torch_int8.py``, 1.5e-2 absolute, with levels held
within 1.  The reference's own tolerances for its own cases.  TF32 off.
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCHS as JAX_ARCHS
from repro.models import model_zoo as jzoo
from repro.models import moe as jmoe
from repro_torch.bridge import params_from_numpy
from repro_torch.configs.registry import ARCHS
from repro_torch.models import model_zoo as tzoo
from repro_torch.models import moe
from repro_torch.models.transformer import layer_params
from repro_torch.serving.engine import disable_tf32

FWD_TOL = 1e-4
LOGIT_TOL = 5e-3
INT8_LOGIT_TOL = 1.5e-2
POOL_TOL = 2e-2
ARCH_NAMES = ["deepseek-moe-16b", "arctic-480b"]
B, S, CACHE = 2, 12, 16
PAGE, SLOTS, NPG, PROMPT = 8, 2, 6, 16


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


@pytest.fixture(scope="module", params=ARCH_NAMES)
def model(request):
    disable_tf32()
    jcfg, tcfg = JAX_ARCHS[request.param].reduced(), \
        ARCHS[request.param].reduced()
    jparams = jzoo.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams),
                                device="cpu")
    return jcfg, jparams, tcfg, tparams


@pytest.mark.parametrize("e,k,factor", [(2, 1, 1.0), (6, 2, 1.0),
                                        (64, 6, 2.0), (4, 2, 0.5),
                                        (128, 2, 1.25), (3, 2, 2.0)])
@pytest.mark.parametrize("t", [1, 4, 32, 2048])
def test_moe_capacity_matches_reference(e, k, factor, t):
    cap = moe.moe_capacity(t, e, k, factor)
    assert cap == jmoe.moe_capacity(t, e, k, factor)
    if factor >= 1.0:
        assert cap * e >= t * k          # full capacity covers every choice


# ---------------------------------------------------------------------------
# the routed FFN and its drops
# ---------------------------------------------------------------------------

def _reference_drops(lp, cfg, x, factor):
    """The reference's output and its dropped (token, choice) pairs, read
    from that output: y_t = sum over kept choices j of gate_tj * f_e(x_t),
    with f_e expert e's SwiGLU (an empty or dropped slot gives 0), so the
    kept subset of each token's k choices is the one that reproduces y_t.
    Returns (y, aux, dropped set, the worst fit, the best wrong fit)."""
    y, aux = jmoe.moe_ffn(lp, cfg, jnp.asarray(x), factor)
    y = np.asarray(y).reshape(-1, x.shape[-1])
    xf = jnp.asarray(x.reshape(-1, x.shape[-1]))
    probs = jax.nn.softmax(xf @ lp["router"], axis=-1)
    gate, idx = jax.lax.top_k(probs, cfg.experts_per_token)
    gate = np.asarray(gate / jnp.maximum(gate.sum(-1, keepdims=True), 1e-9))
    idx = np.asarray(idx)
    ex = lp["experts"]
    f = np.asarray(jax.vmap(lambda wi, wg, wo: (
        jax.nn.silu(xf @ wg) * (xf @ wi)) @ wo)(ex["wi"], ex["wg"], ex["wo"]))
    dropped, worst, wrong = set(), 0.0, np.inf
    k = cfg.experts_per_token
    for t in range(y.shape[0]):
        fits = {}
        for keep in itertools.product((0, 1), repeat=k):
            guess = sum(keep[j] * gate[t, j] * f[idx[t, j], t]
                        for j in range(k))
            fits[keep] = float(np.abs(y[t] - guess).max())
        best = min(fits, key=fits.get)
        worst = max(worst, fits[best])
        wrong = min([wrong] + [v for kk, v in fits.items() if kk != best])
        dropped |= {(t, j) for j in range(k) if not best[j]}
    return y, float(aux), dropped, worst, wrong


@pytest.mark.parametrize("factor", [2.0, 0.5])
def test_moe_ffn_matches_reference_with_the_same_drops(model, factor):
    jcfg, jparams, tcfg, tparams = model
    lpj = jax.tree.map(lambda a: a[0], jparams["layers"])
    lpt = layer_params(tparams["layers"], 0)
    x = np.random.default_rng(1).normal(size=(3, 8, jcfg.d_model)) \
        .astype(np.float32)
    y, aux, dropped, worst, wrong = _reference_drops(lpj, jcfg, x, factor)
    # the reading is unambiguous: the kept subset fits to rounding, any
    # other subset misses by far more than the tolerance
    assert worst < 1e-5 and wrong > 100 * FWD_TOL
    ty, taux = moe.moe_ffn(lpt, tcfg, torch.from_numpy(x), factor)
    np.testing.assert_allclose(ty.reshape(y.shape).numpy(), y,
                               rtol=FWD_TOL, atol=FWD_TOL)
    assert abs(float(taux) - aux) <= FWD_TOL
    t = x.shape[0] * x.shape[1]
    cap = moe.moe_capacity(t, tcfg.num_experts, tcfg.experts_per_token,
                           factor)
    keep = moe.route(lpt, tcfg, torch.from_numpy(x).reshape(t, -1), cap)[3]
    got = {(int(i), int(j)) for i, j in torch.nonzero(~keep)}
    assert got == dropped
    assert (len(dropped) > 0) == (factor < 1)


def test_route_breaks_ties_to_the_lower_expert():
    """Equal router probabilities: ``lax.top_k`` takes the lower index."""
    cfg = ARCHS["deepseek-moe-16b"].reduced()
    lp = {"router": torch.zeros(cfg.d_model, cfg.num_experts)}
    gate, idx, pos, keep, _ = moe.route(lp, cfg, torch.ones(3, cfg.d_model),
                                        cap=2)
    assert idx.tolist() == [[0, 1]] * 3
    assert torch.equal(gate, torch.full((3, 2), 0.5))
    # three tokens for two slots of each chosen expert: the third drops
    assert keep.tolist() == [[True, True], [True, True], [False, False]]
    assert pos.tolist() == [[0, 0], [1, 1], [1, 1]]


# ---------------------------------------------------------------------------
# the model against the reference
# ---------------------------------------------------------------------------

def test_forward_matches_reference(model):
    jcfg, jparams, tcfg, tparams = model
    toks = np.random.default_rng(2).integers(0, jcfg.vocab_size, (B, S))
    jl, jaux = jzoo.forward(jparams, jcfg, {"tokens": jnp.asarray(toks)})
    tl, taux = moe.forward(tparams, tcfg, torch.as_tensor(toks))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=FWD_TOL,
                               atol=FWD_TOL)
    assert abs(float(taux) - float(jaux)) <= FWD_TOL
    torch.testing.assert_close(
        tzoo.forward(tparams, tcfg, torch.as_tensor(toks)), tl, rtol=0,
        atol=0)


def test_prefill_and_decode_match_reference(model):
    """Teacher-forced along seeded tokens: the prefill's and each decode
    step's logits, and the bf16 caches."""
    jcfg, jparams, tcfg, tparams = model
    rng = np.random.default_rng(3)
    toks = rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    nxt = rng.integers(0, jcfg.vocab_size, (3, B, 1)).astype(np.int32)
    jl, jc = jzoo.prefill(jparams, jcfg, jnp.asarray(toks),
                          jzoo.init_cache(jcfg, B, CACHE + 4))
    tl, tc = tzoo.prefill(tparams, tcfg, torch.as_tensor(toks),
                          tzoo.init_cache(tcfg, B, CACHE + 4, device="cpu"))
    js, ts = [_np(jl)], [tl.numpy()]
    for tok in nxt:
        jl, jc = jzoo.decode_step(jparams, jcfg, jnp.asarray(tok), jc,
                                  use_kernel=True)
        tl, tc = tzoo.decode_step(tparams, tcfg, torch.as_tensor(tok), tc)
        js.append(_np(jl))
        ts.append(tl.numpy())
    np.testing.assert_allclose(np.stack(ts), np.stack(js), rtol=LOGIT_TOL,
                               atol=LOGIT_TOL)
    assert tc["pos"] == S + 3
    for key in ("k", "v"):
        np.testing.assert_allclose(tc[key][:, :, :S + 3].float().numpy(),
                                   _np(jc[key])[:, :, :S + 3],
                                   rtol=POOL_TOL, atol=POOL_TOL)


def test_decode_matches_forward_without_drops(model):
    """tests/test_models.py:31 — at capacity E/k neither path drops."""
    _, _, tcfg, tparams = model
    toks = torch.as_tensor(np.random.default_rng(4).integers(
        0, tcfg.vocab_size, (B, S)))
    nodrop = tcfg.num_experts / tcfg.experts_per_token
    full, _ = moe.forward(tparams, tcfg, toks, capacity_factor=nodrop)
    cache = tzoo.init_cache(tcfg, B, CACHE, dtype=torch.float32,
                            device="cpu")
    for t in range(S):
        last, cache = tzoo.decode_step(tparams, tcfg, toks[:, t:t + 1], cache)
    np.testing.assert_allclose(last.numpy(), full[:, -1].numpy(), rtol=2e-3,
                               atol=2e-3)


def test_capacity_drops_are_bounded(model):
    """tests/test_models.py:122 — generous capacity equals a huge one."""
    _, _, tcfg, tparams = model
    toks = torch.as_tensor(np.random.default_rng(5).integers(
        0, tcfg.vocab_size, (2, 16)))
    l1, _ = moe.forward(tparams, tcfg, toks, capacity_factor=8.0)
    l2, _ = moe.forward(tparams, tcfg, toks, capacity_factor=16.0)
    np.testing.assert_allclose(l1.numpy(), l2.numpy(), rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# the paged API against the reference, bf16 and int8 pools
# ---------------------------------------------------------------------------

def _pools_close(jcache, tcache, int8):
    """Every page but the null page 0 (raced writes of padded rows)."""
    for key in ("kp", "vp"):
        got = tcache[key][:, 1:].float().numpy()
        ref = _np(jcache[key])[:, 1:]
        if int8:
            assert np.abs(got - ref).max() <= 1
        else:
            np.testing.assert_allclose(got, ref, rtol=POOL_TOL,
                                       atol=POOL_TOL)
    if int8:
        for key in ("ks", "vs"):
            np.testing.assert_allclose(tcache[key][:, 1:].numpy(),
                                       _np(jcache[key])[:, 1:], rtol=5e-3,
                                       atol=1e-6)


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_paged_api_matches_reference(model, int8):
    """A two-row admission, a shared-prefix admission (``start`` = 16: its
    first two pages aliased, read-only), three decode steps with a masked
    write row, and a C = 4 chunk, teacher-forced: logits within the
    tolerance and the pools close after every call."""
    jcfg, jparams, tcfg, tparams = model
    tol = INT8_LOGIT_TOL if int8 else LOGIT_TOL
    rtol = 0 if int8 else tol
    jd = jnp.int8 if int8 else jnp.bfloat16
    td = torch.int8 if int8 else torch.bfloat16
    rng = np.random.default_rng(6)
    n_pages = SLOTS * NPG + 8
    perm = rng.permutation(np.arange(1, n_pages)).astype(np.int32)
    block = perm[: SLOTS * NPG].reshape(SLOTS, NPG)
    free = perm[SLOTS * NPG:]
    toks = rng.integers(0, jcfg.vocab_size, (SLOTS, PROMPT)).astype(np.int32)
    lens = np.array([PROMPT, PROMPT - 5], np.int32)
    jc = jzoo.init_paged_cache(jcfg, SLOTS + 1, n_pages, PAGE, dtype=jd)
    tc = tzoo.init_paged_cache(tcfg, SLOTS + 1, n_pages, PAGE, dtype=td,
                               device="cpu")

    def both(jfn, tfn, jargs, targs, **kw):
        nonlocal jc, tc
        jout = jfn(jparams, jcfg, *jargs, jc, **kw.get("j", {}))
        tout = tfn(tparams, tcfg, *targs, tc, **kw.get("t", {}))
        jc, tc = jout[1], tout[1]
        np.testing.assert_allclose(tout[0].numpy(), _np(jout[0]), rtol=rtol,
                                   atol=tol)
        _pools_close(jc, tc, int8)

    both(jzoo.prefill_paged, tzoo.prefill_paged,
         (jnp.asarray(toks), jnp.asarray(lens),
          jnp.arange(SLOTS, dtype=jnp.int32), jnp.asarray(block)),
         (torch.as_tensor(toks), torch.as_tensor(lens), torch.arange(SLOTS),
          torch.as_tensor(block)))
    # a third request shares slot 0's first two pages
    row = np.zeros((1, NPG), np.int32)
    row[0, :2], row[0, 2:5] = block[0, :2], free[:3]
    t2 = np.concatenate([toks[0], rng.integers(0, jcfg.vocab_size, 8)
                         .astype(np.int32)])[None, :]
    l2, st = np.array([24], np.int32), np.array([16], np.int32)
    shared = tc["kp"][:, block[0, :2]].clone()
    both(jzoo.prefill_paged, tzoo.prefill_paged,
         (jnp.asarray(t2), jnp.asarray(l2), jnp.zeros((1,), jnp.int32),
          jnp.asarray(row)),
         (torch.as_tensor(t2), torch.as_tensor(l2), torch.zeros(1),
          torch.as_tensor(row)),
         j=dict(start=jnp.asarray(st)), t=dict(start=torch.as_tensor(st)))
    assert torch.equal(tc["kp"][:, block[0, :2]], shared)
    pos = lens.copy()
    wblock = block.copy()
    wblock[1] = 0                              # slot 1's appends drop
    for i in range(3):
        tok = rng.integers(0, jcfg.vocab_size, (SLOTS, 1)).astype(np.int32)
        wb = wblock if i == 0 else block
        both(jzoo.decode_step_paged, tzoo.decode_step_paged,
             (jnp.asarray(tok), jnp.asarray(pos), jnp.asarray(block)),
             (torch.as_tensor(tok), torch.as_tensor(pos),
              torch.as_tensor(block)),
             j=dict(use_kernel=True, write_block=jnp.asarray(wb)),
             t=dict(write_block=torch.as_tensor(wb)))
        pos = pos + 1
    chunk = rng.integers(0, jcfg.vocab_size, (SLOTS, 4)).astype(np.int32)
    jl, jc, jst = jzoo.forward_chunk_paged(
        jparams, jcfg, jnp.asarray(chunk), jnp.asarray(pos),
        jnp.asarray(block), jc, use_kernel=True)
    tl, tc, tst = tzoo.forward_chunk_paged(
        tparams, tcfg, torch.as_tensor(chunk), torch.as_tensor(pos),
        torch.as_tensor(block), tc)
    assert jst == tst == {}
    np.testing.assert_allclose(tl.numpy(), _np(jl), rtol=rtol, atol=tol)
    _pools_close(jc, tc, int8)


def test_chunk_pass_matches_per_token_path(model):
    """tests/test_chunk_lane.py:90 — forward_chunk_paged == C x
    decode_step_paged at the reference's MoE tolerance 5e-3 (no drops at
    the serving capacity), greedy tokens equal."""
    jcfg, _, tcfg, tparams = model
    rng = np.random.default_rng(7)
    n_pages = SLOTS * NPG + 1
    block = np.arange(1, n_pages, dtype=np.int32).reshape(SLOTS, NPG)
    toks = torch.as_tensor(rng.integers(0, tcfg.vocab_size, (SLOTS, PROMPT)))
    lens = torch.tensor([PROMPT, PROMPT - 3])
    cache = tzoo.init_paged_cache(tcfg, SLOTS, n_pages, PAGE, device="cpu")
    tzoo.prefill_paged(tparams, tcfg, toks, lens, torch.arange(SLOTS),
                       torch.as_tensor(block), cache)
    steps = {k: v.clone() for k, v in cache.items()}
    chunk = torch.as_tensor(rng.integers(0, tcfg.vocab_size, (SLOTS, 4)))
    out, _, staged = tzoo.forward_chunk_paged(
        tparams, tcfg, chunk, lens, torch.as_tensor(block), cache)
    assert staged == {}
    ref = []
    for i in range(4):
        lg, steps = tzoo.decode_step_paged(
            tparams, tcfg, chunk[:, i:i + 1], lens + i,
            torch.as_tensor(block), steps)
        ref.append(lg)
    ref = torch.stack(ref, 1)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=5e-3,
                               atol=5e-3)
    assert torch.equal(out.argmax(-1), ref.argmax(-1))
