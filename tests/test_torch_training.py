"""The port's training substrate (``optim/adamw.py``, ``training/trainer.py``,
``checkpoint/io.py``, ``data/tokens.py``, ``model_zoo.loss`` and ``remat``,
``launch/train.py``) against the JAX reference, at reduced size.

* ``tests/test_training.py``'s eight cases, re-stated on the port.
* Loss and grads against ``jax.value_and_grad`` of the reference's loss on
  bridged params, for reduced qwen2-1.5b (dense), deepseek-moe-16b (MoE),
  mamba2-370m (SSM) and zamba2-2.7b (hybrid); a whole train step against
  the reference's unmeshed ``make_train_step`` (its meshed path fails on
  jax 0.9.0, ROADMAP Queue C).
* ``apply_updates`` against the reference's, one step and three in a row,
  float32 and bf16 moments, plain and factored v.
* ``lm_batches`` bit for bit; checkpoints written by each package read by
  the other (a bf16 leaf, nested dicts built in unsorted key order).
* ``ssd_chunk``'s autograd wrapper: its backward against autograd of the
  plain version (the kernel's forward stood in for by the plain one: the
  kernel itself runs only on the card, ``tests/test_torch_cuda.py``).

Tolerances.  ``GRAD_RTOL`` / ``GRAD_ATOL``: float32 end to end in both
packages, only the order of sums differs (XLA fuses and reorders; the
measured worst is about a tenth of these).  Adam moments in bf16 may land
one bf16 step apart where the float32 values before rounding differ in the
last bit, hence ``BF16_RTOL`` (2^-7) on bf16 moments.  A whole step's
params: ``STEP_SHARE`` (see the test).  TF32 off.
"""
import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch

from repro.checkpoint import io as jckpt
from repro.configs.base import TrainConfig as JTrainConfig
from repro.configs.registry import ARCHS as JAX_ARCHS
from repro.data import tokens as jtokens
from repro.models import model_zoo as jzoo
from repro.optim import adamw as jadamw
from repro.training import trainer as jtrainer
from repro_torch import tree
from repro_torch.bridge import params_from_numpy
from repro_torch.checkpoint import io as ckpt_io
from repro_torch.configs.base import TrainConfig
from repro_torch.configs.registry import ARCHS
from repro_torch.data import tokens
from repro_torch.kernels import ops
from repro_torch.kernels import ssd_scan
from repro_torch.launch.train import run
from repro_torch.models import model_zoo as zoo
from repro_torch.optim import adamw
from repro_torch.serving.engine import disable_tf32
from repro_torch.training import trainer

GRAD_RTOL, GRAD_ATOL = 1e-3, 1e-5
UPD_RTOL, UPD_ATOL = 1e-5, 1e-7
BF16_RTOL = 2 ** -7
STEP_SHARE = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _threads():
    """Reduced models are small ops: a few intra-op threads run them
    fastest on a shared machine, and other files in the worker keep
    theirs."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    disable_tf32()
    yield
    torch.set_num_threads(n)


def _to_np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _bridge(jparams):
    return params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")


def _batch(cfg, seed=0, b=4, s=16):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
           "labels": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}
    if cfg.family == "encdec":
        out["frames"] = rng.standard_normal(
            (b, cfg.num_audio_frames, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        out["patches"] = rng.standard_normal(
            (b, cfg.num_patches, cfg.d_model)).astype(np.float32)
    return out


def _tb(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _assert_trees_close(port, ref, rtol=GRAD_RTOL, atol=GRAD_ATOL):
    pl, rl = tree.leaves(port), jax.tree.leaves(ref)
    assert len(pl) == len(rl)
    for p, r in zip(pl, rl):
        r = _to_np(r)
        np.testing.assert_allclose(p.detach().float().numpy(), r, rtol=rtol,
                                   atol=atol * max(1.0, float(np.abs(r).max())))


def _model(name):
    jcfg, tcfg = JAX_ARCHS[name].reduced(), ARCHS[name].reduced()
    jparams = jzoo.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, jparams, tcfg, _bridge(jparams)


# ---------------------------------------------------------------------------
# tests/test_training.py on the port
# ---------------------------------------------------------------------------

def test_grad_accum_equivalence():
    """grads(accum=4) must equal grads(accum=1) on the same global batch."""
    _, _, cfg, params = _model("qwen2-1.5b")
    batch = _tb(_batch(cfg, b=8))
    g1, m1 = trainer.grads_and_metrics(
        params, cfg, TrainConfig(grad_accum=1, remat=False), batch)
    g4, m4 = trainer.grads_and_metrics(
        params, cfg, TrainConfig(grad_accum=4, remat=False), batch)
    for a, b in zip(tree.leaves(g1), tree.leaves(g4)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-4, atol=2e-5)
    torch.testing.assert_close(m4["nll"], m1["nll"], rtol=1e-5, atol=1e-6)


def test_remat_equivalence():
    _, _, cfg, params = _model("granite-3-2b")
    batch = _tb(_batch(cfg))
    g_no, _ = trainer.grads_and_metrics(
        params, cfg, TrainConfig(grad_accum=1, remat=False), batch)
    g_rm, _ = trainer.grads_and_metrics(
        params, cfg, TrainConfig(grad_accum=1, remat=True), batch)
    for a, b in zip(tree.leaves(g_no), tree.leaves(g_rm)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-6)


def test_adamw_minimises_quadratic():
    tcfg = TrainConfig(lr=0.1, warmup_steps=1, total_steps=100,
                       weight_decay=0.0, bf16_state=False)
    params = {"w": torch.tensor([5.0, -3.0])}
    state = adamw.init_state(params, tcfg)
    for _ in range(100):
        grads = {"w": 2 * params["w"]}
        params, state, _ = adamw.apply_updates(params, grads, state, tcfg)
    assert float(params["w"].abs().max()) < 0.5


def test_lr_schedule_shape():
    tcfg = TrainConfig(lr=1e-3, warmup_steps=10, total_steps=100)
    lrs = [float(adamw.lr_schedule(tcfg, torch.tensor(s))) for s in range(100)]
    assert lrs[0] < lrs[9] <= 1e-3 + 1e-9       # warmup rises
    assert lrs[-1] < lrs[15]                     # cosine decays
    assert lrs[-1] >= 0.1 * 1e-3 - 1e-9          # floor at 10%
    jcfg = JTrainConfig(lr=1e-3, warmup_steps=10, total_steps=100)
    ref = [float(jadamw.lr_schedule(jcfg, jnp.asarray(s))) for s in range(100)]
    np.testing.assert_allclose(lrs, ref, rtol=1e-6)


def test_grad_clip():
    g = {"a": torch.tensor([3.0, 4.0])}          # norm 5
    clipped, norm = adamw.clip_by_global_norm(g, 1.0)
    assert abs(float(norm) - 5.0) < 1e-5
    assert abs(float(torch.linalg.norm(clipped["a"])) - 1.0) < 1e-5


def test_loss_decreases_end_to_end():
    losses = run("gemma3-1b", steps=15, batch=4, seq=32, lr=2e-3,
                 device="cpu")
    assert losses[-1] < losses[0] * 0.8
    assert run.stats["tokens_per_s"] > 0


def test_checkpoint_roundtrip(tmp_path):
    _, _, cfg, params = _model("mamba2-370m")
    d = str(tmp_path / "ckpt")
    ckpt_io.save(d, params, step=7)
    assert ckpt_io.exists(d)
    like = tree.tree_map(torch.zeros_like, params)
    restored, step = ckpt_io.restore(d, like)
    assert step == 7
    for a, b in zip(tree.leaves(params), tree.leaves(restored)):
        assert torch.equal(a, b)


def test_checkpoint_shape_mismatch_rejected(tmp_path):
    _, _, cfg, params = _model("mamba2-370m")
    d = str(tmp_path / "ckpt2")
    ckpt_io.save(d, params, step=1)
    bad = tree.tree_map(lambda x: torch.zeros(x.shape + (1,)), params)
    with pytest.raises(ValueError):
        ckpt_io.restore(d, bad)


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["qwen2-1.5b", "deepseek-moe-16b",
                                  "mamba2-370m", "zamba2-2.7b"])
def test_loss_and_grads_match_reference(name):
    jcfg, jparams, cfg, params = _model(name)
    batch = _batch(cfg, seed=1)
    (jl, jm), jg = jax.value_and_grad(
        lambda p: jzoo.loss(p, jcfg, _jb(batch)), has_aux=True)(jparams)
    g, m = trainer.grads_and_metrics(params, cfg,
                                     TrainConfig(remat=False), _tb(batch))
    np.testing.assert_allclose(float(m["loss"]), float(jl), rtol=1e-5)
    np.testing.assert_allclose(float(m["aux"]), float(jm["aux"]), rtol=1e-5,
                               atol=1e-7)
    _assert_trees_close(g, jg)


@pytest.mark.parametrize("name", ["qwen2-1.5b", "zamba2-2.7b"])
def test_train_step_matches_unmeshed_reference(name):
    """A whole step (loss, grads, clipping, AdamW at the default bf16
    moments) against the reference's ``make_train_step``, twice in a row."""
    jcfg, jparams, cfg, params = _model(name)
    kw = dict(grad_accum=2, remat=True, lr=1e-3, warmup_steps=1)
    jstep = jax.jit(jtrainer.make_train_step(jcfg, JTrainConfig(**kw)))
    step = trainer.make_train_step(cfg, TrainConfig(**kw))
    jopt = jadamw.init_state(jparams, JTrainConfig(**kw))
    opt = adamw.init_state(params, TrainConfig(**kw))
    for i in range(2):
        batch = _batch(cfg, seed=10 + i)
        jparams, jopt, jm = jstep(jparams, jopt, _jb(batch))
        params, opt, m = step(params, opt, _tb(batch))
        for k in ("loss", "nll", "grad_norm", "lr"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-4)
    # Adam divides m by sqrt(v): where a gradient is at float32 rounding
    # noise the two packages' updates may take either sign, so a few
    # elements (at most STEP_SHARE of them) may differ by up to lr a step.
    # qwen2's key bias has an exact gradient of 0 (a shift of every score of
    # a query, which the softmax ignores): all of it is noise
    noise = params["layers"].get("attn", {}).get("bk")
    n_off = n_all = 0
    for a, r in zip(tree.leaves(params), jax.tree.leaves(jparams)):
        diff = np.abs(a.numpy() - _to_np(r))
        assert diff.max() <= 2 * kw["lr"] * 2, diff.max()
        if a is not noise:
            n_off += int((diff > 1e-6 + 1e-4 * np.abs(_to_np(r))).sum())
            n_all += diff.size
    assert n_off <= STEP_SHARE * n_all, (n_off, n_all)
    _assert_trees_close(opt["v"], jopt["v"], rtol=BF16_RTOL, atol=1e-9)
    assert int(opt["step"]) == int(jopt["step"]) == 2


def _opt_inputs(seed, bf16):
    rng = np.random.default_rng(seed)
    shapes = {"w": (6, 5), "stack": (3, 4, 8), "b": (5,), "col": (7, 1)}
    dt = jnp.bfloat16 if bf16 else jnp.float32
    p = {k: jnp.asarray(rng.standard_normal(s), dt) for k, s in shapes.items()}
    grads = [{k: jnp.asarray(rng.standard_normal(s) * 0.5, dt)
              for k, s in shapes.items()} for _ in range(3)]
    return p, grads


@pytest.mark.parametrize("bf16_state", [False, True])
@pytest.mark.parametrize("factored_v", [False, True])
@pytest.mark.parametrize("steps", [1, 3])
def test_apply_updates_matches_reference(bf16_state, factored_v, steps):
    """Float32 and bf16 params (the bf16 case with bf16 moments), a 3-D
    stack and a column that the Adafactor rule leaves unfactored, the
    clip active (a small grad_clip) on the first step."""
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=5, weight_decay=0.1,
              bf16_state=bf16_state, factored_v=factored_v, grad_clip=2.0)
    jp, jgrads = _opt_inputs(3, bf16_state)
    p = _bridge(jp)
    jstate = jadamw.init_state(jp, JTrainConfig(**kw))
    state = adamw.init_state(p, TrainConfig(**kw))
    for i in range(steps):
        jp, jstate, jm = jadamw.apply_updates(jp, jgrads[i], jstate,
                                              JTrainConfig(**kw))
        p, state, m = adamw.apply_updates(p, _bridge(jgrads[i]), state,
                                          TrainConfig(**kw))
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(m["lr"]), float(jm["lr"]), rtol=1e-6)
    rtol = BF16_RTOL if bf16_state else UPD_RTOL
    _assert_trees_close(p, jp, rtol=rtol, atol=UPD_ATOL)
    _assert_trees_close(state["m"], jstate["m"], rtol=rtol, atol=UPD_ATOL)
    _assert_trees_close(state["v"], jstate["v"], rtol=rtol, atol=UPD_ATOL)
    assert int(state["step"]) == steps
    for a, b in zip(tree.leaves(p), jax.tree.leaves(jp)):
        assert str(a.dtype).endswith(str(b.dtype))


def test_lm_batches_bit_for_bit():
    mine = list(tokens.lm_batches(vocab=97, batch=4, seq=33, steps=3, seed=5))
    ref = list(jtokens.lm_batches(vocab=97, batch=4, seq=33, steps=3, seed=5))
    for a, b in zip(mine, ref):
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
        assert a["tokens"].shape == (4, 33) and a["tokens"].max() < 97


def _mixed_tree():
    """Nested dicts built in unsorted key order, a list, a bf16 leaf, an
    int32 scalar."""
    rng = np.random.default_rng(2)
    return {"z": {"w": rng.standard_normal((3, 2)).astype(np.float32),
                  "b": rng.standard_normal(4).astype(np.float32)},
            "a": [rng.standard_normal(5).astype(np.float32),
                  {"y": np.int32(7), "c": rng.standard_normal(
                      (2, 2)).astype(np.float32)}],
            "m": rng.standard_normal((2, 3)).astype(np.float32)}


def test_checkpoints_load_both_ways(tmp_path):
    base = _mixed_tree()
    jt = jax.tree.map(jnp.asarray, base)
    tt = tree.tree_map(torch.as_tensor, base)
    tt["m"] = tt["m"].to(torch.bfloat16)
    jt["m"] = jt["m"].astype(jnp.bfloat16)
    jckpt.save(str(tmp_path / "j"), jt, step=3, extra={"who": "jax"})
    ckpt_io.save(str(tmp_path / "t"), tt, step=3, extra={"who": "jax"})
    # the manifests are the same bytes; so are the leaves, bf16 included
    assert (tmp_path / "j" / "manifest.msgpack").read_bytes() == \
        (tmp_path / "t" / "manifest.msgpack").read_bytes()
    manifest = msgpack.unpackb(
        (tmp_path / "t" / "manifest.msgpack").read_bytes())
    m_at = [i for i, x in enumerate(tree.leaves(tt)) if x is tt["m"]]
    assert m_at == [3] and manifest["dtypes"][3] == "bfloat16"
    jz, tz = (np.load(tmp_path / d / "arrays.npz") for d in ("j", "t"))
    for i in range(manifest["num_leaves"]):
        assert jz[f"a{i}"].dtype == tz[f"a{i}"].dtype
        assert jz[f"a{i}"].tobytes() == tz[f"a{i}"].tobytes()
    # the port reads the reference's checkpoint, the bf16 leaf included
    like = tree.tree_map(torch.zeros_like, tt)
    got, step = ckpt_io.restore(str(tmp_path / "j"), like)
    assert step == 3 and got["m"].dtype == torch.bfloat16
    for a, b in zip(tree.leaves(got), tree.leaves(tt)):
        assert torch.equal(a, b)
    # the reference reads the port's float32 leaves in their places
    tt32 = dict(tt, m=tt["m"].float())
    ckpt_io.save(str(tmp_path / "t32"), tt32, step=4)
    jlike = jax.tree.map(jnp.zeros_like, dict(jt, m=jt["m"].astype(
        jnp.float32)))
    jgot, jstep = jckpt.restore(str(tmp_path / "t32"), jlike)
    assert jstep == 4
    for a, b in zip(jax.tree.leaves(jgot), tree.leaves(tt32)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    # a bf16 leaf: the reference cannot restore its own (numpy reads it
    # back as void, which jnp.asarray will not cast), nor the port's
    for d in ("j", "t"):
        with pytest.raises(ValueError):
            jckpt.restore(str(tmp_path / d), jax.tree.map(jnp.zeros_like, jt))


# ---------------------------------------------------------------------------
# ssd_chunk under autograd
# ---------------------------------------------------------------------------

def test_ssd_chunk_backward_is_the_plain_vjp(monkeypatch):
    """``SSDChunk``'s backward against autograd through ``ssd_chunk_ref``,
    every output's cotangent nonzero.  The forward's kernel is the plain
    version here (no card)."""
    rng = np.random.default_rng(4)
    b, nc, q, h, p, n = 2, 2, 16, 3, 8, 8
    ins = [rng.standard_normal(s).astype(np.float32) for s in
           ((b, nc, q, h, p), (b, nc, q, h), (h,), (b, nc, q, n),
            (b, nc, q, n))]
    ins[1] = np.abs(ins[1]) * 0.3
    ins[2] = -np.abs(ins[2])
    cots = [torch.as_tensor(rng.standard_normal(s).astype(np.float32))
            for s in ((b, nc, q, h, p), (b, nc, h, p, n), (b, nc, h),
                      (b, nc, q, h))]

    def vjp(fn):
        xs = [torch.tensor(a, requires_grad=True) for a in ins]
        outs = fn(*xs)
        torch.autograd.backward(outs, cots)
        return [o.detach() for o in outs], [x.grad for x in xs]

    calls = []

    def kernel(*xs):
        calls.append(len(xs))
        with torch.no_grad():
            return ssd_scan.ssd_chunk_ref(*xs)

    monkeypatch.setattr(ssd_scan, "ssd_chunk_cuda", kernel)
    outs, grads = vjp(ssd_scan.SSDChunk.apply)
    assert calls == [5]
    ref_outs, ref_grads = vjp(ssd_scan.ssd_chunk_ref)
    for a, r in zip(outs + grads, ref_outs + ref_grads):
        torch.testing.assert_close(a, r, rtol=0, atol=0)


def test_ssd_chunk_records_autograd_only_where_grads_are_taken(monkeypatch):
    """On the card ``ops.ssd_chunk`` goes through ``SSDChunk`` only when
    autograd records the call; under ``inference_mode`` the kernel runs
    alone (serving)."""
    calls = []
    monkeypatch.setattr(ops, "_on_cpu", lambda t: False)
    monkeypatch.setattr(ssd_scan, "ssd_chunk_cuda",
                        lambda *xs: calls.append("kernel") or
                        ssd_scan.ssd_chunk_ref(*xs))
    monkeypatch.setattr(ssd_scan.SSDChunk, "apply",
                        lambda *xs: calls.append("autograd") or
                        ssd_scan.ssd_chunk_ref(*xs))
    x = [torch.zeros(1, 1, 8, 1, 8), torch.zeros(1, 1, 8, 1),
         torch.zeros(1), torch.zeros(1, 1, 8, 8), torch.zeros(1, 1, 8, 8)]
    w = x[0].clone().requires_grad_()
    with torch.inference_mode():
        ops.ssd_chunk(*x)
    ops.ssd_chunk(*x)
    ops.ssd_chunk(w, *x[1:])
    with torch.no_grad():
        ops.ssd_chunk(w, *x[1:])
    assert calls == ["kernel", "kernel", "autograd", "kernel"]


# ---------------------------------------------------------------------------
# tests/test_arch_smoke.py::test_forward_and_train_step on the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_forward_and_train_step(arch):
    cfg = ARCHS[arch].reduced()
    params = zoo.init_params(torch.Generator().manual_seed(0), cfg)
    batch = _tb(_batch(cfg, b=2))
    logits = zoo.forward(params, cfg, batch["tokens"],
                         patches=batch.get("patches"),
                         frames=batch.get("frames"))
    exp_s = 16 + (cfg.num_patches if cfg.family == "vlm" else 0)
    assert logits.shape == (2, exp_s, cfg.vocab_size)
    assert torch.isfinite(logits).all()

    tcfg = TrainConfig(grad_accum=1, bf16_state=False, remat=False)
    opt = adamw.init_state(params, tcfg)
    before = tree.tree_map(torch.clone, params)
    params2, opt2, metrics = trainer.make_train_step(cfg, tcfg)(
        params, opt, batch)
    assert torch.isfinite(metrics["loss"])
    assert torch.isfinite(metrics["grad_norm"])
    moved = sum(float((a - b).abs().sum())
                for a, b in zip(tree.leaves(before), tree.leaves(params2)))
    assert moved > 0
    ev = trainer.eval_step(params2, batch, mcfg=cfg)
    assert torch.isfinite(ev["nll"]) and 0.0 <= float(ev["acc"]) <= 1.0


def test_ssd_chunk_plain_grads_stay_finite_where_the_exp_overflows():
    """At a full-width chunk of 128 with mamba2's init (A = -1, dt near
    softplus(0)), a_cs falls by ~89 over the chunk, so exp of the
    difference above the diagonal overflows float32.  The port's plain
    version (the backward of ``SSDChunk``) zeroes the difference before the
    exp: its grads are finite and equal float64's.  The reference's
    ``ssd_chunked``, which selects after the exp only, gives NaN grads
    there (a fault of the reference, ROADMAP Queue C)."""
    from repro.models import mamba2 as jmamba2
    rng = np.random.default_rng(6)
    b, l, h, p, n = 1, 128, 2, 8, 8
    x = rng.standard_normal((b, l, h, p)).astype(np.float32)
    dt = np.full((b, l, h), 0.72, np.float32)
    A = np.full((h,), -1.0, np.float32)
    B = rng.standard_normal((b, l, n)).astype(np.float32)
    C = rng.standard_normal((b, l, n)).astype(np.float32)

    def port(dtype):
        xs = [torch.tensor(a, dtype=dtype, requires_grad=True)
              for a in (x, dt, A, B, C)]
        y, _ = ssd_scan_ssd(*xs)
        y.sum().backward()
        return [t.grad for t in xs]

    def ssd_scan_ssd(x, dt, A, B, C):
        cs = 128
        xc = x.reshape(b, 1, cs, h, p)
        out = ssd_scan.ssd_chunk_ref(xc, dt.reshape(b, 1, cs, h), A,
                                     B.reshape(b, 1, cs, n),
                                     C.reshape(b, 1, cs, n))
        return out[0], None

    g32, g64 = port(torch.float32), port(torch.float64)
    for a, r in zip(g32, g64):
        assert torch.isfinite(a).all()
        np.testing.assert_allclose(a.numpy(), r.numpy(), rtol=1e-3,
                                   atol=1e-4 * float(r.abs().max()))
    # the NaN reaches the grads of dt and A (through exp's derivative)
    jg = jax.grad(lambda d: jmamba2.ssd_chunked(
        jnp.asarray(x), d, jnp.asarray(A), jnp.asarray(B), jnp.asarray(C),
        128)[0].sum())(jnp.asarray(dt))
    assert not np.isfinite(np.asarray(jg)).all()
