"""Mesh serving on the port (``serve_stream(mesh=...)``):
``tests/test_mesh_serving.py`` restated over torch.distributed.

* The (1, 1) debug mesh, in process (a world-size-1 gloo group): tokens,
  statuses and offloads bitwise the single-device path's, bf16 and int8;
  one ``_host_fetch`` per tick with prefix sharing, the chunk lane and the
  staging all on; the faulted, escalation-heavy run leaves every replica
  pool and the L pool clean; the reference's two refusals; a config of
  every served family; the ``transfer_overlap`` phase and the staging
  gauges.
* (2, 1) and (2, 2) on gloo ranks (``test_torch_sharding.run_ranks``),
  reduced qwen2-1.5b (on the reference's params, below) and
  deepseek-moe-16b (on the port's): two S replicas, the L tier
  tensor parallel at model 2.  Every rank returns the same records; each
  pool passes ``check_invariants``; against ``mesh=None`` the tokens agree
  by the port's margin rule (``parity.decisive``): the mesh=None tokens,
  teacher-forced through the contiguous path of the tier that produced
  them, are compared up to the first position whose top1 - top2 margin is
  under 2 ``LOGIT_TOL``.  Replicas batch fewer rows and tensor
  parallelism sums in another order, so bitwise is not expected.  Statuses
  and offloads agree where the request's confidence is more than
  ``CONF_TOL`` from theta.
* Against the reference's own mesh path (``repro``'s
  ``serve_stream(mesh=make_serving_mesh(...))``), on reduced qwen2-1.5b
  params made by the reference and bridged into the port, the same
  requests: (1, 1) in bf16 and int8 and under faults, in a subprocess
  with 4 forced host devices that also runs (2, 1) and (2, 2), held
  against the port's in-process (1, 1) runs and its gloo ranks.  Where
  the reference's decision is decisive (its S tokens are the port's and
  its confidence is more than ``REF_CONF_TOL`` from theta), offloads,
  L service and statuses agree; where every decision of the run agrees,
  the tick fields (``queue_wait_ticks``, ``esc_created_tick``,
  ``escalation_retries``, ``dropped``) and the admission log, every
  (tick, runtime, slot, request) the S replicas and the L tier admitted,
  agree exactly: that is the L tier's one-tick-late admission through the
  staging and the replica each request was served on.  bf16 tokens are
  held by the margin rule of ``test_torch_stream.py`` (``_check_tokens``,
  teacher forced through both packages' contiguous paths at its
  ``LOGIT_TOL``); the int8 tokens against the reference's are
  ``test_torch_int8.py``'s, and here the int8 mesh tokens are bitwise the
  port's int8 ``mesh=None`` tokens.

Tolerances.  ``LOGIT_TOL`` = 1e-3: the (2, 2) job also measures the L
tier's tensor-parallel prefill logits against the whole model's on the
same prompts, and holds them under ``TP_LOGIT_TOL`` = 5e-4 (float32
params, whose sums over heads and ``d_ff`` halves run in another order;
K/V are rounded to bf16 before attention, and a reordered sum that lands
on the other side of a bf16 rounding moves an element by 2^-8 of itself:
2.1e-4 measured on reduced qwen2 / deepseek-moe).
``CONF_TOL`` = 1e-4 on mean max-prob confidences.  Against the
reference, ``REF_CONF_TOL`` = 5e-4, ``test_torch_stream.py``'s
``CONF_TOL`` and for its reason (the port keeps q in float32 where the
reference's plain path rounds it to bf16).
"""
import os
import pickle
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import HIConfig as JHIConfig
from repro.configs.registry import ARCHS as J_ARCHS
from repro.serving.engine import build_engine as jax_build_engine
from repro_torch.bridge import params_from_numpy
from repro_torch.configs.base import HIConfig
from repro_torch.configs.registry import ARCHS
from repro_torch.launch.mesh import make_serving_mesh
from repro_torch.models import model_zoo as zoo
from repro_torch.parity import decisive
from repro_torch.serving import engine as engine_mod
from repro_torch.serving.batcher import Request
from repro_torch.serving.engine import HIEngine, TierModel, build_engine
from repro_torch.serving.faults import FaultSchedule, RetryPolicy
from repro_torch.serving.scheduler import ContinuousScheduler
from repro_torch.serving.telemetry import Telemetry
from test_torch_sharding import JOIN_TIMEOUT, SRC, run_ranks
from test_torch_stream import _check_tokens

STEPS = 4
KW = dict(buckets=(8,), num_slots=2, page_size=8)
LOGIT_TOL = 1e-3
TP_LOGIT_TOL = 5e-4
CONF_TOL = 1e-4
REF_CONF_TOL = 5e-4
ARCH = "qwen2-1.5b"
FAULTS = dict(seed=7, loss_prob=0.3, delay_ticks=1, delay_jitter=2,
              outages=((4, 8),))
RETRY = dict(max_retries=2, backoff_base_ticks=1, backoff_cap_ticks=4,
             breaker_threshold=3, breaker_cooldown_ticks=4)
TICK_KEYS = ("queue_wait_ticks", "esc_created_tick", "escalation_retries",
             "dropped")

# the admission log, defined here and in the subprocesses alike: every
# (tick, runtime, slot, request id) a ``_try_admit`` call admitted
_ADMIT_LOG = """
def log_admissions(cls, log):
    real = cls._try_admit

    def logged(self, rt, queue, *args, **kwargs):
        real(self, rt, queue, *args, **kwargs)
        tick = self.counters.ticks - self._tick0
        log.extend((tick, rt.name, s, rt.slot_req[s].adm.request.request_id)
                   for s in rt.admitted)
    return logged
"""
exec(_ADMIT_LOG)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Reduced models are small ops: one intra-op thread runs them about as
    fast and adds no contention beside the suite's other workers (their
    own threads are restored afterwards)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _reqs(cfg, n):
    rng = np.random.default_rng(0)
    return [Request(i, rng.integers(0, cfg.vocab_size, 8).astype(np.int32),
                    max_new_tokens=STEPS) for i in range(n)]


def _engine(cfg, theta, cache_len=32):
    return build_engine(cfg, HIConfig(theta=theta, capacity_factor=1.0),
                        max_new_tokens=STEPS, cache_len=cache_len,
                        device="cpu")


def _median_theta(cfg, n):
    """Theta at the median S confidence of the trace: about half the
    requests escalate, so local finishes and the staging path both run."""
    out = _engine(cfg, 0.5).serve_stream(_reqs(cfg, n), **KW)
    return float(np.float32(np.median([r["confidence"]
                                       for r in out.values()])))


@pytest.fixture(scope="module")
def cfg():
    return ARCHS[ARCH].reduced()


@pytest.fixture(scope="module")
def theta(cfg):
    return _median_theta(cfg, 6)


@pytest.fixture(scope="module")
def mesh():
    return make_serving_mesh(1, 1, device="cpu")


@pytest.fixture(scope="module")
def ref(cfg, theta):
    return {kv: _engine(cfg, theta).serve_stream(
        _reqs(cfg, 6), validate=True, kv_dtype=kv, **KW)
        for kv in ("bf16", "int8")}


def _assert_bitwise(ref_out, out):
    assert out.keys() == ref_out.keys()
    for rid, a in ref_out.items():
        b = out[rid]
        np.testing.assert_array_equal(a["tokens"], b["tokens"])
        assert a["status"] == b["status"], rid
        assert a["offloaded"] == b["offloaded"], rid


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_debug_mesh_token_identity(cfg, theta, mesh, ref, kv):
    """(1, 1): the replica runtime, the L tier under its sub-mesh and the
    staging buffer give bitwise the single-device tokens, statuses and
    offload decisions, in both pool dtypes; escalations admit a tick
    later."""
    out_none = ref[kv]
    assert 0 < sum(r["offloaded"] for r in out_none.values()) < len(out_none)
    e = _engine(cfg, theta)
    out = e.serve_stream(_reqs(cfg, 6), validate=True, kv_dtype=kv,
                         mesh=mesh, **KW)
    _assert_bitwise(out_none, out)
    assert e.stats["stream_compiles"] == 1
    sched = e._stream[1]
    assert [rt.name for rt in sched.srts] == ["S0"]
    assert sched.local_srt is sched.srt
    assert sched.mesh_report["replicated"] == []


def test_mesh_one_fetch_per_tick_all_features(cfg, theta, mesh, monkeypatch):
    """Prefix sharing, the chunk lane and the staging all on: one build,
    exactly one host fetch per tick (the S gather and the validate
    checksums ride in it), and the same records as without the mesh."""
    calls = []
    real = engine_mod._host_fetch

    def counting(tree):
        calls.append(sorted(tree))
        return real(tree)

    kw = dict(KW, buckets=(8, 16), prefix_sharing=True, chunk_prefill=True,
              chunk_size=4)
    reqs = _reqs(cfg, 6) + [Request(7, np.arange(16, dtype=np.int32) + 3,
                                    max_new_tokens=STEPS)]
    plain = _engine(cfg, theta).serve_stream(reqs, validate=True, **kw)
    monkeypatch.setattr(engine_mod, "_host_fetch", counting)
    e = _engine(cfg, theta)
    out = e.serve_stream(reqs, validate=True, mesh=mesh, **kw)
    assert e.stats["stream_compiles"] == 1
    assert len(calls) == e.stats["stream_ticks"] > 0
    assert all("s" in c and "check" in c for c in calls)
    assert e._stream[1].lrt.lane_ticks["chunk"] > 0
    _assert_bitwise(plain, out)


def test_mesh_pool_shards_clean_after_faulted_escalations(cfg, mesh):
    """Escalation-heavy faulted traffic (theta > 1: everything wants L;
    losses and an outage drive retries, the breaker and degradation):
    every replica pool and the L pool pass check_invariants with no held
    slot, and every record ends with a legal status."""
    e = _engine(cfg, 1.1)
    out = e.serve_stream(_reqs(cfg, 8), faults=FaultSchedule(**FAULTS),
                         retry=RetryPolicy(**RETRY), validate=True,
                         mesh=mesh, **KW)
    assert len(out) == 8
    assert all(r["status"] in ("ok", "degraded_local", "dropped", "rejected")
               for r in out.values())
    sched = e._stream[1]
    for rt in (*sched.srts, sched.lrt):
        rt.pool.check_invariants()
        assert all(r is None for r in rt.slot_req)
    assert e.stats["stream_compiles"] == 1


class _NoModelAxis:
    shape = {"data": 1}


def test_mesh_rejects_bad_configs(cfg, mesh):
    """The reference's refusals, with its messages: speculative with a
    mesh, and a mesh without both serving axes."""
    from repro_torch.serving.scheduler import ContinuousScheduler
    e = _engine(cfg, 0.5)
    kw = dict(max_prompt_len=8, max_new_tokens=STEPS, num_slots=2,
              page_size=8)
    with pytest.raises(NotImplementedError, match="speculative"):
        ContinuousScheduler(e.s, e.l, e.hi, speculative=True, mesh=mesh, **kw)
    with pytest.raises(ValueError, match="serving mesh needs axes"):
        ContinuousScheduler(e.s, e.l, e.hi, mesh=_NoModelAxis(), **kw)


def test_mesh_telemetry_marks_the_staging(cfg, theta, mesh):
    """The ``transfer_overlap`` phase is marked on every mesh tick, and
    the gauges carry the staging buffer's occupancy, write half and the
    replica count beside the per-replica ``@S0`` pool gauges."""
    tel = Telemetry()
    e = _engine(cfg, theta)
    e.serve_stream(_reqs(cfg, 6), telemetry=tel, mesh=mesh, **KW)
    assert len(tel.ticks) == e.stats["stream_ticks"]
    for tick in tel.ticks:
        assert "transfer_overlap" in [p for p, _, _ in tick.segments]
        assert tick.gauges["replicas"] == 1
        assert tick.gauges["stage_wix"] in (0, 1)
        assert "free_pages@S0" in tick.gauges
    assert max(t.gauges["stage_occupancy"] for t in tel.ticks) > 0


@pytest.mark.parametrize("arch", ["gemma3-1b", "llava-next-34b",
                                  "mamba2-370m", "zamba2-2.7b",
                                  "deepseek-moe-16b"])
def test_every_family_at_the_debug_mesh(arch, mesh):
    """Each served family through the (1, 1) mesh (qwen2-1.5b above;
    gemma3's local / global windows for the dense family, llava's VLM,
    mamba2's SSM, zamba2's hybrid, deepseek's MoE): the records of
    ``mesh=None`` bitwise (the MoE L tier's experts on one ``model``
    rank: the dropless dispatch, as without a mesh)."""
    c = ARCHS[arch].reduced()
    th = _median_theta(c, 4)
    a = _engine(c, th, cache_len=48).serve_stream(_reqs(c, 4), **KW)
    b = _engine(c, th, cache_len=48).serve_stream(_reqs(c, 4), mesh=mesh,
                                                  validate=True, **KW)
    _assert_bitwise(a, b)


# ---------------------------------------------------------------------------
# against the reference's mesh path
# ---------------------------------------------------------------------------

# name: (mesh shape, kv dtype, faulted); the faulted run is at theta 1.1
REF_RUNS = {"1x1-bf16": ((1, 1), "bf16", False),
            "1x1-int8": ((1, 1), "int8", False),
            "1x1-faults": ((1, 1), "bf16", True),
            "2x1": ((2, 1), "bf16", False),
            "2x2": ((2, 2), "bf16", False)}
JAX_TIMEOUT = 240

# the reference's serve_stream on each mesh of REF_RUNS; argv = args, out
_JAX_SCRIPT = _ADMIT_LOG + """
import pickle, sys
import jax
import jax.numpy as jnp
from repro.configs.base import HIConfig
from repro.configs.registry import ARCHS
from repro.launch.mesh import make_serving_mesh
from repro.serving import scheduler
from repro.serving.batcher import Request
from repro.serving.engine import HIEngine, TierModel
from repro.serving.faults import FaultSchedule, RetryPolicy

with open(sys.argv[1], "rb") as f:
    A = pickle.load(f)
LOG = []
scheduler.ContinuousScheduler._try_admit = log_admissions(
    scheduler.ContinuousScheduler, LOG)
cfg = ARCHS[A["arch"]].reduced()
out = {}
for name, (shape, kv, theta, faulted) in A["runs"].items():
    hi = HIConfig(theta=theta, capacity_factor=1.0)
    e = HIEngine(*[TierModel(c, jax.tree.map(jnp.asarray, p)) for c, p in
                   zip((cfg.s_variant(hi.s_scale), cfg), A["params"])],
                 hi, cache_len=32, max_new_tokens=A["steps"])
    kw = dict(faults=FaultSchedule(**A["faults"]),
              retry=RetryPolicy(**A["retry"])) if faulted else {}
    reqs = [Request(i, p, max_new_tokens=A["steps"])
            for i, p in enumerate(A["prompts"])]
    LOG.clear()
    recs = e.serve_stream(reqs, validate=True, kv_dtype=kv,
                          mesh=make_serving_mesh(*shape), **kw, **A["kw"])
    out[name] = (recs, list(LOG))
with open(sys.argv[2], "wb") as f:
    pickle.dump(out, f)
"""


def _bridged_engine(cfg, params, theta):
    """The port's engine on (S, L) numpy params made by the reference."""
    hi = HIConfig(theta=theta, capacity_factor=1.0)
    s, l_ = (params_from_numpy(p, device="cpu") for p in params)
    return HIEngine(TierModel(cfg.s_variant(hi.s_scale), s),
                    TierModel(cfg, l_), hi, cache_len=32,
                    max_new_tokens=STEPS)


@pytest.fixture(scope="module")
def bridged():
    """Reduced qwen2-1.5b's (S, L) params made by the reference, as numpy;
    the reference's engine on them; theta at the port's median S
    confidence over 8 requests."""
    jeng = jax_build_engine(J_ARCHS[ARCH].reduced(),
                            JHIConfig(theta=0.5, capacity_factor=1.0),
                            max_new_tokens=STEPS, cache_len=32)
    params = tuple(jax.tree.map(np.asarray, t.params)
                   for t in (jeng.s, jeng.l))
    cfg = ARCHS[ARCH].reduced()
    out = _bridged_engine(cfg, params, 0.5).serve_stream(_reqs(cfg, 8), **KW)
    theta = float(np.float32(np.median([r["confidence"]
                                        for r in out.values()])))
    return jeng, params, theta


@pytest.fixture(scope="module", autouse=True)
def _jax_job(bridged, tmp_path_factory):
    """The reference's mesh runs, started with the module so that they
    overlap its other tests: a subprocess with 4 forced host devices (the
    reference's own ``tests/test_mesh_serving.py`` pattern)."""
    _, params, theta = bridged
    d = tmp_path_factory.mktemp("jax_mesh")
    runs = {name: (shape, kv, 1.1 if faulted else theta, faulted)
            for name, (shape, kv, faulted) in REF_RUNS.items()}
    with open(d / "args.pkl", "wb") as f:
        pickle.dump(dict(arch=ARCH, params=params, steps=STEPS, kw=KW,
                         faults=FAULTS, retry=RETRY, runs=runs,
                         prompts=[r.prompt for r in
                                  _reqs(ARCHS[ARCH].reduced(), 8)]), f)
    flags = (os.environ.get("XLA_FLAGS", "")
             + " --xla_force_host_platform_device_count=4"
             " --xla_cpu_multi_thread_eigen=false"
             " intra_op_parallelism_threads=1").strip()
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS=flags)
    with open(d / "log.txt", "w") as log:
        proc = subprocess.Popen(
            [sys.executable, "-c", _JAX_SCRIPT, str(d / "args.pkl"),
             str(d / "out.pkl")], env=env, stdout=log,
            stderr=subprocess.STDOUT)
    yield proc, d
    if proc.poll() is None:
        proc.kill()
        proc.wait()


@pytest.fixture(scope="module")
def jref(_jax_job):
    """A function giving the reference's (records, admission log) of each
    run in REF_RUNS; it waits for them when first called, so that a test
    can do its own work first."""
    proc, d = _jax_job
    done = {}

    def load():
        if not done:
            try:
                proc.wait(timeout=JAX_TIMEOUT)
            except subprocess.TimeoutExpired:
                proc.kill()
                pytest.fail(f"the reference's mesh runs outlived "
                            f"{JAX_TIMEOUT} s")
            assert proc.returncode == 0, \
                (d / "log.txt").read_text()[-4000:]
            with open(d / "out.pkl", "rb") as f:
                done.update(pickle.load(f))
        return done
    return load


def _hold_to_reference(ref, got, theta, reqs, tiers=None):
    """The port's (records, admission log) ``got`` against the
    reference's ``ref`` on the same params and requests, by the rules of
    the module docstring; ``tiers`` = ((reference S, port S), (reference
    L, port L)) holds the tokens too.  Returns whether every offload
    decision agreed, so that the tick fields and the logs were held."""
    (jout, jlog), (out, log) = ref, got
    assert out.keys() == jout.keys()
    same = True
    for req in reqs:
        j, t = jout[req.request_id], out[req.request_id]
        if tiers is not None:
            _check_tokens(*tiers[0], req.prompt, j["s_tokens"],
                          t["s_tokens"], 32)
        if np.array_equal(j["s_tokens"], t["s_tokens"]) \
                and abs(j["confidence"] - theta) > REF_CONF_TOL:
            for key in ("offloaded", "served_remote", "status"):
                assert t[key] == j[key], (req.request_id, key)
            if tiers is not None and j["served_remote"]:
                _check_tokens(*tiers[1], req.prompt, j["tokens"],
                              t["tokens"], 32)
        same &= t["offloaded"] == j["offloaded"]
    if same:
        for rid, j in jout.items():
            for key in TICK_KEYS:
                assert out[rid][key] == j[key], (rid, key)
        assert log == jlog
    return same


def _logged_run(monkeypatch, e, reqs, **kw):
    log = []
    monkeypatch.setattr(ContinuousScheduler, "_try_admit",
                        log_admissions(ContinuousScheduler, log))
    return e.serve_stream(reqs, validate=True, **kw, **KW), log


# ---------------------------------------------------------------------------
# (2, 1) and (2, 2) on gloo ranks
# ---------------------------------------------------------------------------

_SCRIPT = _ADMIT_LOG + """
import numpy as np
from repro_torch.bridge import params_from_numpy
from repro_torch.configs.base import HIConfig
from repro_torch.configs.registry import ARCHS
from repro_torch.launch.mesh import make_serving_mesh
from repro_torch.models import model_zoo
from repro_torch.serving import scheduler
from repro_torch.serving.batcher import Request
from repro_torch.serving.engine import HIEngine, TierModel, build_engine
from repro_torch.sharding import act, specs

LOG = []
scheduler.ContinuousScheduler._try_admit = log_admissions(
    scheduler.ContinuousScheduler, LOG)
data, model = ARGS["shape"]
mesh = make_serving_mesh(data, model, device="cpu")
out = {}
for arch, theta in ARGS["thetas"].items():
    cfg = ARCHS[arch].reduced()
    rng = np.random.default_rng(0)
    reqs = [Request(i, rng.integers(0, cfg.vocab_size, 8).astype(np.int32),
                    max_new_tokens=ARGS["steps"]) for i in range(8)]
    hi = HIConfig(theta=theta, capacity_factor=1.0)
    if arch in ARGS["params"]:
        s, l_ = (params_from_numpy(p, device="cpu")
                 for p in ARGS["params"][arch])
        e = HIEngine(TierModel(cfg.s_variant(hi.s_scale), s),
                     TierModel(cfg, l_), hi, cache_len=32,
                     max_new_tokens=ARGS["steps"])
    else:
        e = build_engine(cfg, hi, max_new_tokens=ARGS["steps"], cache_len=32,
                         device="cpu")
    LOG.clear()
    recs = e.serve_stream(reqs, validate=True, mesh=mesh, **ARGS["kw"])
    sched = e._stream[1]
    for rt in (*sched.srts, sched.lrt):
        rt.pool.check_invariants()
        assert not rt.pool.held_slots
    busy = [rt.lane_ticks["admit"] for rt in sched.srts]
    out[arch] = {"recs": recs, "log": list(LOG),
                 "replicas": len(sched.srts), "busy": busy,
                 "compiles": e.stats["stream_compiles"],
                 "report": sched.mesh_report,
                 "kv_heads": sched.lrt.pool.buffers["kp"].shape[3]}
    if model > 1:
        # the L tier's tensor-parallel prefill against the whole model's
        toks = torch.as_tensor(np.stack([r.prompt for r in reqs]))
        whole, _ = model_zoo.prefill(e.l.params, cfg, toks,
                                     model_zoo.init_cache(cfg, 8, 16,
                                                          device="cpu"))
        lcfg = specs.local_config(cfg, mesh)
        with act.use_mesh(mesh.sub("model"), specs.cut_kinds(cfg, mesh)):
            tp, _ = model_zoo.prefill(
                specs.shard_params(e.l.params, cfg, mesh), lcfg, toks,
                model_zoo.init_cache(lcfg, 8, 16, device="cpu"))
        out[arch]["tp_err"] = float((tp - whole).abs().max())
if data * model > 1:
    # wall-clock budgets would part the ranks: refused before any tick
    try:
        e.serve_stream([Request(99, reqs[0].prompt, max_new_tokens=2,
                                latency_budget=5.0)], mesh=mesh,
                       **ARGS["kw"])
        out["budget"] = "served"
    except ValueError as err:
        out["budget"] = str(err)
save(out)
"""


@pytest.fixture(scope="module")
def refs(bridged):
    """mesh=None records, theta, and the tiers that teacher-force them:
    qwen2-1.5b on the reference's params (``bridged``), deepseek-moe-16b on
    the port's, theta at its median confidence."""
    _, params, theta = bridged
    c = ARCHS[ARCH].reduced()
    e = _bridged_engine(c, params, theta)
    out = {ARCH: (theta, e, e.serve_stream(_reqs(c, 8), **KW), _reqs(c, 8))}
    c = ARCHS["deepseek-moe-16b"].reduced()
    th = _median_theta(c, 8)
    e = _engine(c, th)
    out["deepseek-moe-16b"] = (th, e, e.serve_stream(_reqs(c, 8), **KW),
                               _reqs(c, 8))
    return out


def _forced(tier, prompt, toks):
    """The contiguous path's logits along ``toks`` after the prompt."""
    cache = zoo.init_cache(tier.cfg, 1, 32, device="cpu")
    lg, cache = zoo.prefill(tier.params, tier.cfg,
                            torch.as_tensor(prompt[None], dtype=torch.int64),
                            cache)
    rows = [lg[0].numpy()]
    for t in toks[:-1]:
        lg, cache = zoo.decode_step(
            tier.params, tier.cfg, torch.tensor([[int(t)]]), cache)
        rows.append(lg[0].numpy())
    return np.stack(rows)


@pytest.mark.parametrize("shape", [(2, 1), (2, 2)], ids=["2x1", "2x2"])
def test_gloo_mesh_agrees_with_single_device(refs, bridged, jref, shape,
                                             tmp_path):
    """The ranks agree with each other; each arch against its own
    ``mesh=None`` run by the margin rule; qwen2-1.5b against the
    reference's mesh path on the same mesh shape, the tick fields and the
    admission log (which replica admitted which request, and when the L
    tier did) exactly."""
    jeng, params, _ = bridged
    ranks = run_ranks(_SCRIPT, shape[0] * shape[1], tmp_path, args={
        "shape": shape, "steps": STEPS, "kw": KW,
        "thetas": {a: v[0] for a, v in refs.items()},
        "params": {ARCH: params}})
    for r in ranks[1:]:
        for arch in refs:
            assert r[arch]["log"] == ranks[0][arch]["log"]
            for rid, rec in ranks[0][arch]["recs"].items():
                np.testing.assert_array_equal(
                    r[arch]["recs"][rid]["tokens"], rec["tokens"])
    th, e, _, reqs = refs[ARCH]
    got = ranks[0][ARCH]
    assert {name for _, name, _, _ in got["log"]} == {"S0", "S1", "L"}
    assert _hold_to_reference(jref()[f"{shape[0]}x{shape[1]}"],
                              (got["recs"], got["log"]), th, reqs,
                              ((jeng.s, e.s), (jeng.l, e.l)))
    compared = 0
    for arch, (th, e, ref, reqs) in refs.items():
        got = ranks[0][arch]
        assert got["replicas"] == 2 and got["compiles"] == 1
        assert all(n > 0 for n in got["busy"]), "a replica never admitted"
        cfg = ARCHS[arch].reduced()
        assert got["kv_heads"] == cfg.num_kv_heads // shape[1]
        if shape[1] > 1:
            assert got["report"]["replicated"] == []
            assert got["tp_err"] < TP_LOGIT_TOL, (arch, got["tp_err"])
        for req in reqs:
            a, b = ref[req.request_id], got["recs"][req.request_id]
            if abs(a["confidence"] - th) > CONF_TOL:
                assert a["offloaded"] == b["offloaded"], req.request_id
                assert a["status"] == b["status"], req.request_id
            if a["offloaded"] != b["offloaded"]:
                continue
            tier = e.l if a["served_remote"] else e.s
            z = _forced(tier, req.prompt, a["tokens"])
            np.testing.assert_array_equal(z.argmax(-1), a["tokens"])
            dec = decisive(z, 2 * LOGIT_TOL)
            first = int(np.argmin(dec)) if not dec.all() else len(dec)
            np.testing.assert_array_equal(b["tokens"][:first],
                                          a["tokens"][:first])
            compared += first
    assert compared > 0
    if shape[0] * shape[1] > 1:
        assert "latency_budget" in ranks[0]["budget"]


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_debug_mesh_matches_the_reference_mesh(bridged, jref, mesh, kv,
                                               monkeypatch):
    """(1, 1), the port's and the reference's mesh path on the same
    params: decisions, statuses, bf16 tokens, and (every decision agreeing
    in this trace) the tick fields and the admission log exactly, which
    hold the staging's one-tick-late L admission."""
    jeng, params, theta = bridged
    cfg = ARCHS[ARCH].reduced()
    reqs = _reqs(cfg, 8)
    e = _bridged_engine(cfg, params, theta)
    got = _logged_run(monkeypatch, e, reqs, kv_dtype=kv, mesh=mesh)
    jout, jlog = jref()[f"1x1-{kv}"]
    assert 0 < sum(r["offloaded"] for r in jout.values()) < len(jout)
    assert any(name == "L" for _, name, _, _ in jlog)
    tiers = ((jeng.s, e.s), (jeng.l, e.l)) if kv == "bf16" else None
    assert _hold_to_reference(jref()[f"1x1-{kv}"], got, theta, reqs, tiers)


def test_debug_mesh_faults_match_the_reference_mesh(bridged, jref, mesh,
                                                    monkeypatch):
    """(1, 1) under the faulted schedule at theta 1.1 (every request
    wants L, so every decision is decisive): statuses, retries, drops,
    queue waits and the admission log exactly, tokens by the margin rule."""
    jeng, params, _ = bridged
    cfg = ARCHS[ARCH].reduced()
    reqs = _reqs(cfg, 8)
    e = _bridged_engine(cfg, params, 1.1)
    got = _logged_run(monkeypatch, e, reqs, mesh=mesh,
                      faults=FaultSchedule(**FAULTS),
                      retry=RetryPolicy(**RETRY))
    jout, _ = jref()["1x1-faults"]
    assert {r["status"] for r in jout.values()} - {"ok"}
    assert _hold_to_reference(jref()["1x1-faults"], got, 1.1, reqs,
                              ((jeng.s, e.s), (jeng.l, e.l)))
