"""The port's SSM (mamba2) and hybrid (zamba2) families against the JAX
reference, at reduced size, on the CPU.

* The plain version of the SSD intra-chunk kernel (``ssd_chunk_ref``)
  against the reference's ``ssd_chunk_pallas`` in interpret mode, and the
  port's ``ops.ssd`` against the reference's ``ssd_ref`` and its Pallas
  ``ops.ssd``, lengths that are not a multiple of the chunk included
  (``tests/test_kernels.py``'s SSD cases re-stated).
* The models: ``forward``, ``prefill`` / ``decode_step`` and the paged API
  against the reference's (``use_kernel=False`` and ``True``) on params
  carried across with ``bridge.params_from_numpy``.
* The chunk lane: chunk == per-token bitwise, and the staged rollback
  (``tests/test_chunk_lane.py:77,116``).
* The reference's fault: the full-depth zamba2 cascade cannot be built,
  in either package.

Tolerances.  Both packages compute the SSM in float32; sums run in another
order: ``SSD_TOL`` = 1e-4 on the kernel terms (3e-4 on whole sequences, as
the reference's own SSD tests), ``LOGIT_TOL`` = 1e-4 on the logits of the
mamba2 paths and of the hybrid's prompt paths.  The hybrid's decode
attention keeps q in float32, as the reference's Pallas kernels do, where
the reference's plain path rounds q to bf16: ``DECODE_TOL`` = 5e-3 there
(1.6e-3 measured at this size).  bf16 conv windows and pages are compared
within ``POOL_TOL`` = 2e-2, two bf16 steps at their magnitude.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCHS as JAX_ARCHS
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.ssd_scan import ssd_chunk_pallas
from repro.models import model_zoo as jzoo
from repro_torch.bridge import params_from_numpy
from repro_torch.configs.registry import ARCHS
from repro_torch.kernels import ops
from repro_torch.kernels import ssd_scan
from repro_torch.models import mamba2
from repro_torch.models import model_zoo as tzoo

SSD_TOL = 1e-4
SEQ_TOL = 3e-4
LOGIT_TOL = 1e-4
DECODE_TOL = 5e-3
POOL_TOL = 2e-2
PAGE = 8
ARCH_NAMES = ["mamba2-370m", "zamba2-2.7b"]


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


def _t(a):
    return torch.from_numpy(np.asarray(a))


# ---------------------------------------------------------------------------
# the SSD kernel's plain version
# ---------------------------------------------------------------------------

def _chunk_inputs(seed, b, nc, q, h, p, n):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, nc, q, h, p)).astype(np.float32)
    dt = (rng.random((b, nc, q, h)) * 0.5).astype(np.float32)
    A = (-rng.random(h) - 0.2).astype(np.float32)
    B = rng.standard_normal((b, nc, q, n)).astype(np.float32)
    C = rng.standard_normal((b, nc, q, n)).astype(np.float32)
    return x, dt, A, B, C


@pytest.mark.parametrize("b,nc,q,h,p,n", [(1, 2, 16, 2, 8, 4),
                                          (2, 2, 32, 4, 16, 16),
                                          (1, 3, 16, 3, 8, 16)])
def test_ssd_chunk_ref_matches_pallas_interpret(b, nc, q, h, p, n):
    args = _chunk_inputs(0, b, nc, q, h, p, n)
    want = ssd_chunk_pallas(*map(jnp.asarray, args), interpret=True)
    got = ssd_scan.ssd_chunk_ref(*map(_t, args))
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), _np(w), rtol=SSD_TOL,
                                   atol=SSD_TOL)


def _seq_inputs(seed, b, l, h, p, n):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, l, h, p)).astype(np.float32)
    dt = (rng.random((b, l, h)) * 0.5).astype(np.float32)
    A = (-rng.random(h) - 0.2).astype(np.float32)
    B = rng.normal(size=(b, l, n)).astype(np.float32)
    C = rng.normal(size=(b, l, n)).astype(np.float32)
    return x, dt, A, B, C


@pytest.mark.parametrize("b,l,h,p,n,chunk", [
    (1, 64, 2, 8, 4, 16), (2, 96, 4, 16, 8, 32), (1, 80, 3, 8, 16, 16),
    (2, 70, 4, 16, 16, 32), (1, 9, 2, 8, 8, 32),
])
def test_ssd_matches_reference(b, l, h, p, n, chunk):
    """``ops.ssd`` against the reference's chunked jnp path and its Pallas
    path (interpret mode)."""
    args = _seq_inputs(1, b, l, h, p, n)
    y, hT = ops.ssd(*map(_t, args), chunk=chunk)
    for ref in (jref.ssd_ref(*map(jnp.asarray, args), chunk),
                jops.ssd(*map(jnp.asarray, args), chunk=chunk)):
        np.testing.assert_allclose(y.numpy(), _np(ref[0]), rtol=SEQ_TOL,
                                   atol=SEQ_TOL)
        np.testing.assert_allclose(hT.numpy(), _np(ref[1]), rtol=SEQ_TOL,
                                   atol=SEQ_TOL)
    yc, hc = mamba2.ssd_chunked(*map(_t, args), chunk)
    np.testing.assert_allclose(yc.numpy(), y.numpy(), rtol=SEQ_TOL,
                               atol=SEQ_TOL)
    np.testing.assert_allclose(hc.numpy(), hT.numpy(), rtol=SEQ_TOL,
                               atol=SEQ_TOL)


def test_ssd_chunked_matches_naive_recurrence():
    """tests/test_kernels.py: the chunked algorithm IS the recurrence."""
    x, dt, A, B, C = map(_t, _seq_inputs(2, 2, 48, 2, 8, 4))
    y_r, h_r = ops.ssd(x, dt, A, B, C, chunk=16)
    state = torch.zeros((2, 2, 8, 4))
    ys = []
    for t in range(48):
        y_t, state = mamba2.ssd_recurrent_step(state, x[:, t], dt[:, t], A,
                                               B[:, t], C[:, t])
        ys.append(y_t)
    np.testing.assert_allclose(y_r.numpy(), torch.stack(ys, 1).numpy(),
                               rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(h_r.numpy(), state.numpy(), rtol=2e-3,
                               atol=2e-3)


def test_ssd_chunk_independence():
    """tests/test_kernels.py: the chunk size does not change the result."""
    args = list(map(_t, _seq_inputs(3, 1, 64, 2, 8, 4)))
    args[2] = args[2] - 0.3
    y16, _ = ops.ssd(*args, chunk=16)
    y64, _ = ops.ssd(*args, chunk=64)
    np.testing.assert_allclose(y16.numpy(), y64.numpy(), rtol=SEQ_TOL,
                               atol=SEQ_TOL)


def test_ssd_padded_tail_is_an_exact_no_op():
    """Positions past a row's length carry dt = 0: their decay is exactly 1
    and their input exactly 0, so g and S are the state at the length, bit
    for bit, whatever x holds there."""
    x, dt, A, B, C = map(_t, _chunk_inputs(4, 2, 1, 32, 4, 8, 8))
    dt[:, :, 20:] = 0.0
    y, S, g, eacs = ssd_scan.ssd_chunk_ref(x, dt, A, B, C)
    x2 = x.clone()
    x2[:, :, 20:] = 1e4
    _, S2, g2, _ = ssd_scan.ssd_chunk_ref(x2, dt, A, B, C)
    assert torch.equal(S2, S) and torch.equal(g2, g)
    assert torch.equal(g, eacs[:, :, 19])
    assert torch.equal(eacs[:, :, 20:], eacs[:, :, 19:20].expand_as(
        eacs[:, :, 20:]))
    assert torch.isfinite(y).all()


# ---------------------------------------------------------------------------
# the models against the reference
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=ARCH_NAMES)
def bridged(request):
    """(jax cfg, jax params, port cfg, port params) for one reduced arch."""
    name = request.param
    jcfg, tcfg = JAX_ARCHS[name].reduced(), ARCHS[name].reduced()
    jparams = jzoo.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams),
                                device="cpu")
    return jcfg, jparams, tcfg, tparams


def _tokens(cfg, shape, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


def _decode_tol(cfg):
    return DECODE_TOL if cfg.family == "hybrid" else LOGIT_TOL


@pytest.mark.parametrize("use_kernel", [False, True])
def test_forward_matches_reference(bridged, use_kernel):
    jcfg, jparams, tcfg, tparams = bridged
    toks = _tokens(jcfg, (2, 40))
    want, _ = jzoo.forward(jparams, jcfg, {"tokens": jnp.asarray(toks)},
                           use_kernel=use_kernel)
    got = tzoo.forward(tparams, tcfg, torch.as_tensor(toks).long())
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=LOGIT_TOL,
                               atol=LOGIT_TOL)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_prefill_and_decode_match_reference(bridged, use_kernel):
    jcfg, jparams, tcfg, tparams = bridged
    toks = _tokens(jcfg, (2, 40), seed=1)
    jl, jc = jzoo.prefill(jparams, jcfg, jnp.asarray(toks),
                          jzoo.init_cache(jcfg, 2, 48), use_kernel=use_kernel)
    tl, tc = tzoo.prefill(tparams, tcfg, torch.as_tensor(toks).long(),
                          tzoo.init_cache(tcfg, 2, 48, device="cpu"))
    np.testing.assert_allclose(tl.numpy(), _np(jl), rtol=LOGIT_TOL,
                               atol=LOGIT_TOL)
    np.testing.assert_allclose(tc["state"].numpy(), _np(jc["state"]),
                               rtol=SEQ_TOL, atol=SEQ_TOL)
    np.testing.assert_allclose(tc["conv"].float().numpy(), _np(jc["conv"]),
                               rtol=POOL_TOL, atol=POOL_TOL)
    assert tc["pos"] == 40
    nxt = _tokens(jcfg, (2, 3), seed=2)
    for i in range(3):
        tok = nxt[:, i:i + 1]
        jl, jc = jzoo.decode_step(jparams, jcfg, jnp.asarray(tok), jc)
        tl, tc = tzoo.decode_step(tparams, tcfg, torch.as_tensor(tok).long(),
                                  tc)
        np.testing.assert_allclose(tl.numpy(), _np(jl),
                                   rtol=_decode_tol(tcfg),
                                   atol=_decode_tol(tcfg))


def _paged_pair(jcfg, tcfg, slots=3, npg=6):
    jcache = jzoo.init_paged_cache(jcfg, slots, slots * npg + 1, PAGE)
    tcache = tzoo.init_paged_cache(tcfg, slots, slots * npg + 1, PAGE,
                                   device="cpu")
    block = np.arange(1, slots * npg + 1, dtype=np.int32).reshape(slots, npg)
    return jcache, tcache, block


def _states_close(jcache, tcache, slots, tol=SEQ_TOL):
    """Recurrent rows of the real slots (the port's padding row excluded)."""
    axis = 1 if "kp" not in tcache else 2
    for key, t in (("state", tol), ("conv", POOL_TOL)):
        got = tcache[key].float().narrow(axis, 0, slots).numpy()
        np.testing.assert_allclose(got, _np(jcache[key]), rtol=t, atol=t)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_paged_api_matches_reference(bridged, use_kernel):
    """prefill_paged over right-padded rows (one padded admission row with
    the sentinel slot), then decode_step_paged and a chunk pass."""
    jcfg, jparams, tcfg, tparams = bridged
    slots = 3
    jcache, tcache, block = _paged_pair(jcfg, tcfg, slots)
    toks = _tokens(jcfg, (3, 24), seed=3)
    lens = np.array([24, 13, 1], np.int32)
    adm_slots = np.array([2, 0, slots], np.int32)       # row 2: padding
    rows = block[[2, 0, 0]]
    rows[2] = 0
    jl, jcache = jzoo.prefill_paged(
        jparams, jcfg, jnp.asarray(toks), jnp.asarray(lens),
        jnp.asarray(adm_slots), jnp.asarray(rows), jcache,
        use_kernel=use_kernel)
    tl, tcache = tzoo.prefill_paged(
        tparams, tcfg, torch.as_tensor(toks).long(), torch.as_tensor(lens),
        torch.as_tensor(adm_slots), torch.as_tensor(rows), tcache)
    np.testing.assert_allclose(tl[:2].numpy(), _np(jl)[:2], rtol=LOGIT_TOL,
                               atol=LOGIT_TOL)
    _states_close(jcache, tcache, slots)
    pos = np.array([13, 0, 24], np.int32)
    for i in range(2):
        tok = _tokens(jcfg, (slots, 1), seed=4 + i)
        jl, jcache = jzoo.decode_step_paged(
            jparams, jcfg, jnp.asarray(tok), jnp.asarray(pos + i),
            jnp.asarray(block), jcache, use_kernel=use_kernel)
        tl, tcache = tzoo.decode_step_paged(
            tparams, tcfg, torch.as_tensor(tok).long(),
            torch.as_tensor(pos + i), torch.as_tensor(block), tcache)
        live = [0, 2]                  # slot 1 decodes from an empty prompt
        np.testing.assert_allclose(tl[live].numpy(), _np(jl)[live],
                                   rtol=_decode_tol(tcfg),
                                   atol=_decode_tol(tcfg))
    _states_close(jcache, tcache, slots, tol=_decode_tol(tcfg))
    if "kp" in tcache:
        # page 0, the null page, takes the padding row's raced writes
        for key in ("kp", "vp"):
            np.testing.assert_allclose(tcache[key][:, 1:].float().numpy(),
                                       _np(jcache[key])[:, 1:], rtol=POOL_TOL,
                                       atol=POOL_TOL)


def test_paged_prefill_with_start_skips_restored_rows_pages(bridged):
    """``start`` = bucket (a full restore) redirects every page write of
    the row to the null page; ``start`` = 0 writes them all."""
    jcfg, jparams, tcfg, tparams = bridged
    _, tcache, block = _paged_pair(jcfg, tcfg, 2)
    block = torch.as_tensor(block)
    toks = _tokens(jcfg, (2, 16), seed=6)
    lens = np.array([16, 16], np.int32)
    before = {k: v.clone() for k, v in tcache.items()}
    tzoo.prefill_paged(tparams, tcfg, torch.as_tensor(toks).long(),
                       torch.as_tensor(lens), torch.arange(2), block, tcache,
                       start=torch.tensor([16, 0]))
    if "kp" not in tcache:
        return
    for key in ("kp", "vp"):
        assert torch.equal(tcache[key][:, block[0]], before[key][:, block[0]])
        assert not torch.equal(tcache[key][:, block[1, :2]],
                               before[key][:, block[1, :2]])


# ---------------------------------------------------------------------------
# the chunk lane (tests/test_chunk_lane.py)
# ---------------------------------------------------------------------------

def _paged_setup(cfg, params, slots=2, npg=6, prompt_len=16, seed=0):
    cache = tzoo.init_paged_cache(cfg, slots, slots * npg + 1, PAGE,
                                  device="cpu")
    block = torch.arange(1, slots * npg + 1,
                         dtype=torch.int32).reshape(slots, npg)
    toks = torch.as_tensor(_tokens(cfg, (slots, prompt_len), seed)).long()
    lens = torch.full((slots,), prompt_len, dtype=torch.int32)
    _, cache = tzoo.prefill_paged(params, cfg, toks, lens,
                                  torch.arange(slots), block, cache)
    pos = torch.full((slots,), prompt_len, dtype=torch.int32)
    return cache, block, pos


def _clone(cache):
    return {k: v.clone() for k, v in cache.items()}


@pytest.mark.parametrize("c", [1, 4])
def test_chunk_pass_matches_per_token_path(bridged, c):
    """tests/test_chunk_lane.py:77 — the recurrent chunk IS a loop of the
    per-token step: bitwise equal logits and caches; one staged snapshot
    per token."""
    _, _, cfg, params = bridged
    cache, block, pos = _paged_setup(cfg, params)
    chunk = torch.as_tensor(_tokens(cfg, (2, c), seed=7)).long()
    ref_cache = _clone(cache)
    ref = []
    for i in range(c):
        lg, ref_cache = tzoo.decode_step_paged(params, cfg, chunk[:, i:i + 1],
                                               pos + i, block, ref_cache)
        ref.append(lg)
    out, got_cache, staged = tzoo.forward_chunk_paged(params, cfg, chunk, pos,
                                                      block, _clone(cache))
    assert torch.equal(out, torch.stack(ref, dim=1))
    for key in ref_cache:
        assert torch.equal(got_cache[key], ref_cache[key]), key
    assert set(staged) == {"state", "conv"}
    assert all(a.shape[0] == c for a in staged.values())


def test_chunk_staged_rollback_restores_boundary(bridged):
    """tests/test_chunk_lane.py:116 — select_stage(staged, keep) then
    restore_stage equals the state after exactly ``keep`` steps, bitwise;
    staging with the host's keep counts gives the same rows."""
    _, _, cfg, params = bridged
    cache, block, pos = _paged_setup(cfg, params)
    c, keep = 4, [2, 3]
    chunk = torch.as_tensor(_tokens(cfg, (2, c), seed=8)).long()
    _, cache_c, staged = tzoo.forward_chunk_paged(params, cfg, chunk, pos,
                                                  block, _clone(cache))
    sel = tzoo.select_stage(cfg, staged, torch.tensor(keep))
    _, _, sel_host = tzoo.forward_chunk_paged(params, cfg, chunk, pos, block,
                                              _clone(cache), keep=keep)
    for key in sel:
        assert torch.equal(sel_host[key], sel[key])
    rolled = tzoo.restore_stage(cfg, cache_c, sel, torch.ones(2, dtype=bool))
    for row, k in enumerate(keep):
        ref = _clone(cache)
        for i in range(k):
            _, ref = tzoo.decode_step_paged(params, cfg, chunk[:, i:i + 1],
                                            pos + i, block, ref)
        axis = 1 if cfg.family == "ssm" else 2
        for key in ("state", "conv"):
            assert torch.equal(rolled[key].select(axis, row),
                               ref[key].select(axis, row)), (row, key)


def test_recurrent_hooks_update_in_place_and_copy_stages(bridged):
    """The scheduler uses no return value of the hooks: each writes the
    pool it is given; ``chunk_stage`` is a copy the later decode steps do
    not move; sentinel indices land in the padding and drop rows."""
    _, _, cfg, params = bridged
    cache, block, pos = _paged_setup(cfg, params)
    axis = 1 if cfg.family == "ssm" else 2
    prefix = tzoo.init_prefix_cache(cfg, 2, device="cpu")
    assert prefix["logits"].shape[0] == 3
    assert prefix["state"].shape[axis] == 3
    assert cache["state"].shape[axis] == 3            # 2 slots + padding
    stage = tzoo.chunk_stage(cfg, cache)
    saved = stage["state"].clone()
    tzoo.decode_step_paged(params, cfg, torch.ones((2, 1), dtype=torch.long),
                           pos, block, cache)
    assert torch.equal(stage["state"], saved)
    assert not torch.equal(cache["state"], saved)
    tzoo.restore_stage(cfg, cache, stage, torch.tensor([True, False]))
    assert torch.equal(cache["state"].select(axis, 0), saved.select(axis, 0))
    assert not torch.equal(cache["state"].select(axis, 1),
                           saved.select(axis, 1))
    # save slot 1 into row 0, sentinel save into the drop row 2
    tzoo.snapshot_save(cfg, cache, prefix, torch.tensor([0, 2]),
                       torch.tensor([1, 2]))
    assert torch.equal(prefix["state"].select(axis, 0),
                       cache["state"].select(axis, 1))
    # restore row 0 into slot 0, sentinel restore into the padding row
    tzoo.snapshot_restore(cfg, cache, prefix, torch.tensor([0, 1]),
                          torch.tensor([0, 2]))
    assert torch.equal(cache["state"].select(axis, 0),
                       cache["state"].select(axis, 1))
    mini = tzoo.gather_chunk_slots(cfg, cache, torch.tensor([1, 2]),
                                   fresh=torch.tensor([False, True]))
    assert torch.equal(mini["state"].select(axis, 0),
                       cache["state"].select(axis, 1))
    assert not mini["state"].select(axis, 1).any()
    mini["state"].add_(1.0)
    tzoo.scatter_chunk_slots(cfg, cache, mini, mini, torch.tensor([0, 2]))
    assert torch.equal(cache["state"].select(axis, 0),
                       mini["state"].select(axis, 0))


# ---------------------------------------------------------------------------
# the reference's own fault, kept
# ---------------------------------------------------------------------------

def test_full_depth_zamba2_cascade_raises_in_both_packages():
    """zamba2-2.7b's S tier has 54 // 4 = 13 layers, which the hybrid's
    groups of 6 do not divide: the reference raises, and so does the port
    (ROADMAP Queue C)."""
    msg = "num_layers 13 must divide by shared_attn_every 6"
    jcfg = JAX_ARCHS["zamba2-2.7b"].s_variant(4)
    tcfg = ARCHS["zamba2-2.7b"].s_variant(4)
    with pytest.raises(ValueError, match=msg):
        jzoo.init_cache(jcfg, 1, 8)
    with pytest.raises(ValueError, match=msg):
        tzoo.init_cache(tcfg, 1, 8, device="cpu")
    with pytest.raises(ValueError, match=msg):
        tzoo.init_params(torch.Generator().manual_seed(0), tcfg)
