"""The launch tooling of the port: the dry run (``launch/dryrun.py``) on
meta tensors in a fake process group, its case specs
(``launch/specs.py``), counters (``launch/counting.py``), H100 roofline
(``launch/roofline.py``) and the tier split (``launch/tier_split.py``),
against the JAX reference where the reference's answer has no device in
it.  The reference's ``launch/dryrun.py`` is never imported here: it sets
``XLA_FLAGS`` at import.  Its parameter counts are computed from
``repro.models.model_zoo.init_params_spec`` with its own formula.

* ``param_counts`` on all ten configs; ``text_len``, ``batch_specs``,
  ``grad_accum_for``, ``serving_fsdp`` and ``donate_for`` against the
  reference's on a stand-in with ``.shape`` (all they read of a mesh);
  the skip set over every config x shape x both meshes.
* The counters against closed forms: the FLOPs of a reduced dense
  forward from its matmul shapes; the collective bytes of qwen2-1.5b's
  decode case at (16, 16).
* The HI case's ``fn`` against the reference's ``hi_serve_step`` on
  reduced qwen2 and bridged params (float32 caches, ``HI_TOL``): merged
  logits and ``served_remote``.
* ``forward(last_only=True)`` == the last row of ``forward`` for one
  config of each family (``LAST_TOL``: one row's product against the
  same row of the whole product, float32).
* A meta call launches no kernel.
* In one subprocess (a fake world must not outlive its test in a pytest
  worker, whose other files may start their own group): three cases
  through ``main`` (dense decode, MoE train, hybrid prefill; exit 0) and
  the tier split (256 + 256 ranks, the S tier's peak below the L tier's,
  beta the reference's closed form).
"""
import json
import math
import os
import re
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import SHAPES as JAX_SHAPES
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.configs.registry import ARCHS as JAX_ARCHS
from repro.configs.registry import shape_applicable as jshape_applicable
from repro.core import router as jrouter
from repro.launch import specs as jspecs
from repro.models import model_zoo as jzoo
from repro_torch.bridge import params_from_numpy
from repro_torch.configs.base import SHAPES, ShapeConfig
from repro_torch.configs.registry import ARCHS
from repro_torch.kernels import ops
from repro_torch.launch import counting, dryrun
from repro_torch.launch import roofline as rl
from repro_torch.launch import specs
from repro_torch.models import model_zoo as tzoo
from repro_torch.serving.engine import disable_tf32

ROOT = Path(__file__).resolve().parents[1]
HI_TOL = 1e-4
LAST_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small ops: one intra-op thread runs them about as fast and adds no
    contention beside the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Mesh:
    """A stand-in mesh: the axis sizes, one rank at coordinate 0, and
    itself as its one-axis sub-mesh (enough at ``model`` = 1)."""

    def __init__(self, shape):
        self.shape = dict(shape)

    def sub(self, axis):
        return self

    def coord(self, axis):
        return 0


SINGLE = _Mesh({"data": 16, "model": 16})
MULTI = _Mesh({"pod": 2, "data": 16, "model": 16})


def _reference_counts(cfg):
    """The reference's ``dryrun.param_counts``, on its spec tree."""
    tree = jzoo.init_params_spec(cfg)
    total = expert = 0
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        n = math.prod(leaf.shape)
        total += n
        if any(getattr(p, "key", None) == "experts" for p in path):
            expert += n
    active = total - expert
    if cfg.num_experts:
        active += expert * cfg.experts_per_token / cfg.num_experts
    return total, active


@pytest.mark.parametrize("arch", list(ARCHS))
def test_param_counts_match_reference(arch):
    assert dryrun.param_counts(ARCHS[arch]) == \
        _reference_counts(JAX_ARCHS[arch])


@pytest.mark.parametrize("arch", list(ARCHS))
def test_params_spec_dtypes_match_reference(arch):
    """``init_params_spec(cfg, bf16)``: every leaf in the reference's dtype
    (the SSM decay terms and the MoE router stay float32); float32 by
    default, as ``init_params``."""
    want = {"/".join(str(getattr(p, "key", p)) for p in path): str(leaf.dtype)
            for path, leaf in jax.tree_util.tree_flatten_with_path(
                jzoo.init_params_spec(JAX_ARCHS[arch], jnp.bfloat16))[0]}
    flat = specs.sh.flatten_with_path(
        tzoo.init_params_spec(ARCHS[arch], torch.bfloat16))
    assert {"/".join(path): str(leaf.dtype).split(".")[-1]
            for path, leaf in flat} == want
    assert {leaf.dtype for _, leaf in specs.sh.flatten_with_path(
        tzoo.init_params_spec(ARCHS[arch]))} == {torch.float32}


@pytest.mark.parametrize("mesh", [SINGLE, MULTI], ids=["single", "multi"])
def test_case_helpers_match_reference(mesh):
    for arch in ARCHS:
        cfg, jcfg = ARCHS[arch], JAX_ARCHS[arch]
        assert specs.serving_fsdp(cfg, mesh) == jspecs.serving_fsdp(jcfg,
                                                                    mesh)
        for name, shape in SHAPES.items():
            jshape = JAX_SHAPES[name]
            assert specs.text_len(cfg, shape) == jspecs.text_len(jcfg, jshape)
            assert specs.grad_accum_for(cfg, shape, mesh) == \
                jspecs.grad_accum_for(jcfg, jshape, mesh)
            assert specs.donate_for(shape) == jspecs.donate_for(jshape)
            got = specs.batch_specs(cfg, shape)
            want = jspecs.batch_specs(jcfg, jshape)
            assert set(got) == set(want)
            for key, leaf in got.items():
                assert leaf.device.type == "meta"
                assert tuple(leaf.shape) == want[key].shape
                assert str(leaf.dtype).split(".")[-1] == \
                    str(want[key].dtype)


@pytest.mark.parametrize("multi_pod", [False, True], ids=["single", "multi"])
def test_skip_set_matches_reference(multi_pod):
    mesh = "multi" if multi_pod else "single"
    for arch in ARCHS:
        for name in SHAPES:
            ok, reason = jshape_applicable(JAX_ARCHS[arch], JAX_SHAPES[name])
            assert dryrun.skip_reason(arch, name) == ("" if ok else reason)
            if not ok:
                assert dryrun.run_case(arch, name, multi_pod=multi_pod) == {
                    "arch": arch, "shape": name, "mesh": mesh,
                    "status": "skipped", "reason": reason}
            hi = dryrun.skip_reason(arch, name, hi=True)
            assert bool(hi) == (not ok or not SHAPES[name].is_decode)


def test_flops_of_a_reduced_dense_forward():
    """Every matmul of qwen2's forward from its shapes: the projections,
    the attention's two products, the SwiGLU and the lm_head."""
    cfg = ARCHS["qwen2-1.5b"].reduced()
    b, s = 2, 16
    params = tzoo.init_params_spec(cfg)
    tokens = torch.empty((b, s), dtype=torch.int64, device="meta")
    _, counts = counting.count(
        lambda p, t: tzoo.forward(p, cfg, t), (params, tokens))
    d, ff, v = cfg.d_model, cfg.d_ff, cfg.vocab_size
    hq = cfg.num_heads * cfg.resolved_head_dim
    hk = cfg.num_kv_heads * cfg.resolved_head_dim
    per_layer = (2 * b * s * d * (hq + 2 * hk) + 2 * b * s * hq * d
                 + 2 * 2 * b * s * s * hq + 3 * 2 * b * s * d * ff)
    assert counts.flops == cfg.num_layers * per_layer + 2 * b * s * d * v
    assert counts.collectives == dict.fromkeys(counting.COLLECTIVES, 0)
    assert counts.argument_bytes == sum(
        leaf.numel() * 4 for _, leaf in
        specs.sh.flatten_with_path(params)) + b * s * 8
    assert counts.peak_bytes > counts.argument_bytes


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "deepseek-moe-16b",
                                  "mamba2-370m", "whisper-large-v3"])
def test_flops_equal_flop_counter_modes(arch):
    """The counter applies ``torch.utils.flop_counter``'s formulas op by
    op; ``FlopCounterMode`` over the same call (a reduced train step:
    forward, remat, backward, AdamW) gives the same total."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.configs.base import TrainConfig
    from repro_torch.optim import adamw
    from repro_torch.training import trainer
    cfg = ARCHS[arch].reduced()
    tcfg = TrainConfig(grad_accum=2)
    params = tzoo.init_params_spec(cfg)
    opt = adamw.init_state(params, tcfg)
    batch = specs.batch_specs(cfg, ShapeConfig("t", 16, 4, "train"))
    step = trainer.make_train_step(cfg, tcfg)
    _, counts = counting.count(step, (params, opt, batch))
    with FlopCounterMode(display=False) as mode:
        step(params, opt, batch)
    assert counts.flops == mode.get_total_flops() > 0


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "llava-next-34b",
                                  "deepseek-moe-16b", "mamba2-370m",
                                  "zamba2-2.7b", "whisper-large-v3"])
def test_forward_last_only_is_the_last_row(arch):
    disable_tf32()
    cfg = ARCHS[arch].reduced()
    params = tzoo.init_params(torch.Generator().manual_seed(0), cfg)
    g = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (2, 12), generator=g)
    extra = {}
    if cfg.family == "vlm":
        extra["patches"] = torch.randn((2, cfg.num_patches, cfg.d_model),
                                       generator=g)
    if cfg.family == "encdec":
        extra["frames"] = torch.randn((2, cfg.num_audio_frames,
                                       cfg.d_model), generator=g)
    full = tzoo.forward(params, cfg, tokens, **extra)
    last = tzoo.forward(params, cfg, tokens, last_only=True, **extra)
    assert last.shape == (2, 1, cfg.vocab_size)
    torch.testing.assert_close(last, full[:, -1:], rtol=LAST_TOL,
                               atol=LAST_TOL)


def test_hi_case_matches_reference_hi_serve_step():
    disable_tf32()
    jcfg, tcfg = JAX_ARCHS["qwen2-1.5b"].reduced(), \
        ARCHS["qwen2-1.5b"].reduced()
    b, seq = 4, 16
    jshape = JShapeConfig("hi_test", seq, b, "decode")
    tshape = ShapeConfig("hi_test", seq, b, "decode")
    jmesh = jax.make_mesh((1, 1), ("data", "model"))
    jfn, jargs, _, _ = jspecs.make_hi_decode_case(jcfg, jshape, jmesh)
    tfn, targs, _, _ = specs.make_hi_decode_case(
        tcfg, tshape, _Mesh({"data": 1, "model": 1}), dtype=torch.float32)
    rng = np.random.default_rng(0)
    s_jp = jzoo.init_params(jax.random.PRNGKey(0), jcfg.s_variant(4))
    l_jp = jzoo.init_params(jax.random.PRNGKey(1), jcfg)
    token = rng.integers(0, jcfg.vocab_size, (b, 1)).astype(np.int32)

    def cache(spec):
        return {k: (rng.normal(size=v.shape).astype(np.float32)
                    if k != "pos" else None) for k, v in spec.items()}

    s_np, l_np = cache(jargs[3]), cache(jargs[4])
    for spec, got in ((jargs[3], targs[3]), (jargs[4], targs[4])):
        for k in ("k", "v"):
            assert tuple(got[k].shape) == spec[k].shape
        assert got["pos"] == seq - 1

    def jcache(c):
        return {k: (jnp.asarray(v) if k != "pos" else jnp.int32(seq - 1))
                for k, v in c.items()}

    def tcache(c):
        return {k: (torch.as_tensor(v) if k != "pos" else seq - 1)
                for k, v in c.items()}

    jm, _, _, jserved = jfn(s_jp, l_jp, jnp.asarray(token), jcache(s_np),
                            jcache(l_np))
    tm, _, _, tserved = tfn(
        params_from_numpy(jax.tree.map(np.asarray, s_jp), device="cpu"),
        params_from_numpy(jax.tree.map(np.asarray, l_jp), device="cpu"),
        torch.as_tensor(token), tcache(s_np), tcache(l_np))
    np.testing.assert_array_equal(tserved.numpy(), np.asarray(jserved))
    assert 0 < int(tserved.sum()) < b
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=HI_TOL,
                               atol=HI_TOL)


def test_a_meta_call_launches_nothing():
    def meta(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device="meta")

    before = ops.launch_counts()
    conf, top, off = ops.hi_gate(meta(8, 151_936), 0.6)
    assert conf.shape == top.shape == off.shape == (8,)
    out = ops.decode_attention(meta(4, 1, 12, 128),
                               meta(4, 1024, 2, 128, dtype=torch.bfloat16),
                               meta(4, 1024, 2, 128, dtype=torch.bfloat16),
                               meta(1024, dtype=torch.bool))
    assert out.shape == (4, 1, 12, 128) and out.dtype == torch.float32
    pool = meta(33, 16, 2, 128, dtype=torch.bfloat16)
    block = meta(4, 8, dtype=torch.int32)
    out = ops.decode_attention_paged(meta(4, 1, 12, 128), pool, pool, block,
                                     meta(4, 128, dtype=torch.bool))
    assert out.shape == (4, 1, 12, 128)
    out = ops.decode_attention_chunk_paged(
        meta(4, 8, 12, 128), pool, pool, block,
        meta(4, 8, 128, dtype=torch.bool))
    assert out.shape == (4, 8, 12, 128)
    ops.copy_pages([meta(2, 33, 16, 2, 128, dtype=torch.bfloat16)],
                   np.array([1, 0]), np.array([2, 0]))
    y, s, g, e = ops.ssd_chunk(meta(1, 2, 8, 4, 16), meta(1, 2, 8, 4),
                               meta(4), meta(1, 2, 8, 16),
                               meta(1, 2, 8, 16))
    assert y.shape == (1, 2, 8, 4, 16)
    y, state = ops.ssd(meta(1, 20, 4, 16), meta(1, 20, 4), meta(4),
                       meta(1, 20, 16), meta(1, 20, 16), chunk=8)
    assert y.shape == (1, 20, 4, 16) and state.shape == (1, 4, 16, 16)
    assert ops.launch_counts() == before


def test_roofline_is_the_h100s():
    assert (rl.BF16_FLOP_PER_S, rl.F32_FLOP_PER_S, rl.HBM_BYTES_PER_S,
            rl.NVLINK_BYTES_PER_S) == (989e12, 67e12, 3.35e12, 450e9)
    assert rl.peak_flops(torch.bfloat16) == 989e12
    assert rl.peak_flops(torch.float32) == 67e12
    roof = rl.Roofline("a", "s", "single", 256, hlo_flops=989e12,
                       hlo_bytes=6.7e12, coll_bytes=45e9)
    assert (roof.compute_s, roof.memory_s, roof.collective_s) == \
        (1.0, 2.0, 0.1)
    assert roof.dominant == "memory" and roof.bound_s == 2.0
    assert set(roof.row()) == {"arch", "shape", "mesh", "compute_s",
                               "memory_s", "collective_s", "dominant",
                               "model_flops", "hlo_flops", "useful_ratio",
                               "peak_mem_gb"}
    # the reference's TPU v5e constants appear nowhere in the port
    tpu = re.compile(r"(?<![\d.])(197e12|819e9|50e9)\b|v5e")
    for f in (ROOT / "src" / "repro_torch").rglob("*.py"):
        assert not tpu.search(f.read_text()), f


_SCRIPT = textwrap.dedent("""
    import json, sys
    from concurrent.futures import ThreadPoolExecutor
    import subprocess
    from repro_torch.configs.base import SHAPES
    from repro_torch.configs.registry import ARCHS
    from repro_torch.launch.tier_split import lower_tier_split

    out_dir = sys.argv[1]
    cases = {"dense_decode": ["--arch", "qwen2-1.5b", "--shape",
                              "decode_32k"],
             "moe_train": ["--arch", "deepseek-moe-16b", "--shape",
                           "train_4k", "--variant", "ep_dp"],
             "hybrid_prefill": ["--arch", "zamba2-2.7b", "--shape",
                                "prefill_32k"]}

    def run(item):
        name, argv = item
        res = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.dryrun", *argv,
             "--out", f"{out_dir}/{name}.json"], capture_output=True,
            text=True, timeout=400)
        return name, res.returncode, res.stdout[-2000:] + res.stderr[-4000:]

    with ThreadPoolExecutor(3) as pool:
        runs = list(pool.map(run, cases.items()))
    r = lower_tier_split(ARCHS["qwen2-1.5b"], SHAPES["decode_32k"],
                         capacity_factor=0.5)

    # a world left by a failing case: torn down, its meshes forgotten
    import torch.distributed as dist
    from repro_torch.launch.mesh import _MESHES, dryrun_world, \
        make_serving_mesh
    try:
        with dryrun_world(4):
            make_serving_mesh(2, 2, device="cpu")
            assert dist.get_world_size() == 4 and len(_MESHES) == 1
            raise KeyError("boom")
    except KeyError:
        pass
    torn_down = not dist.is_initialized() and not _MESHES
    print(json.dumps({"runs": runs, "tier": [r.s_compile, r.l_compile,
                                             r.beta_bytes_per_step],
                      "torn_down": torn_down}))
""")


@pytest.fixture(scope="module")
def dryruns(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, "-c", _SCRIPT, str(out)], env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stdout + res.stderr
    got = json.loads(res.stdout.strip().splitlines()[-1])
    got["rows"] = {name: json.loads((out / f"{name}.json").read_text())
                   for name, rc, _ in got["runs"] if rc == 0}
    return got


def test_three_cases_through_main(dryruns):
    for name, rc, tail in dryruns["runs"]:
        assert rc == 0, (name, tail)
        assert "dry-run summary: 1 ok, 0 skipped, 0 errors of 1" in tail
        (row,) = dryruns["rows"][name]
        assert row["status"] == "ok" and row["chips"] == 256
        assert row["cost"]["loop_aware_flops_per_chip"] > 0
        assert row["memory"]["peak_gb_per_device"] >= \
            row["memory"]["argument_gb"]


def test_collective_bytes_of_the_qwen2_decode_case(dryruns):
    """qwen2-1.5b decode_32k at (16, 16): attention stays whole (2 kv
    heads), d_ff 8,960 and the vocab 151,936 divide by 16.  Per rank and
    step: one all-reduce of the MLP's (8, 1, 1,536) partial sums per
    layer, and one all-gather of the (8, 151,936) logits, both in the
    activation dtype (bf16 params; the lm_head's product is gathered
    before its float32 cast)."""
    cfg = ARCHS["qwen2-1.5b"]
    (row,) = dryruns["rows"]["dense_decode"]
    assert row["plan"].startswith("tp over model=16 cuts dense, lm_head, "
                                  "mlp; 8 of 128 rows")
    rows = SHAPES["decode_32k"].global_batch // 16
    assert row["collectives"] == {
        "all-gather": rows * cfg.vocab_size * 2,
        "all-reduce": cfg.num_layers * rows * cfg.d_model * 2,
        "reduce-scatter": 0, "all-to-all": 0, "collective-permute": 0}


def test_tier_split(dryruns):
    s, l, beta = dryruns["tier"]
    assert s["chips"] == 256 and l["chips"] == 256
    assert s["peak_gb_per_device"] < l["peak_gb_per_device"]
    b = JAX_SHAPES["decode_32k"].global_batch
    cap = jrouter.capacity_for(b, 0.5)
    cap = max(16, (cap // 16) * 16)
    assert beta == cap * 4 + cap * JAX_ARCHS["qwen2-1.5b"].vocab_size * 4


def test_dryrun_world_is_torn_down(dryruns):
    """Every case of the subprocess above ran in a world of its own, and a
    world whose block raised left no process group and no mesh behind
    (the next file's serving mesh must see its own world)."""
    assert dryruns["torn_down"]
