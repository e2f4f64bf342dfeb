"""The port's partition rules, mesh helpers and data-parallel train step
(``repro_torch.sharding``, ``launch/mesh.py``, ``trainer``'s ``mesh=``).

* ``tests/test_sharding.py`` restated: the port's ``param_specs`` equal the
  reference's leaf for leaf, on every arch, on both stand-in meshes
  (16 x 16 and 2 x 16 x 16, no process group), with ``fsdp`` and ``tp`` on
  and off; ``data_spec``; ``cache_specs`` on the reference's archs and
  shapes; ``paged_cache_specs`` on pools of both packages; the ``act``
  helpers outside a mesh.
* The executing path's cut: ``mesh_report`` on full qwen2-1.5b and
  mamba2-370m at ``model = 4`` (shapes only, on ``meta``), and
  ``local_config``.
* The data-parallel train step on 2 gloo ranks against the unmeshed step
  on the whole batch, and the (1, 1) step bitwise.

Multi-rank jobs run as plain subprocesses (:func:`run_ranks`): one intra-op
thread per rank, ``init_method="file://"`` under ``tmp_path`` (no TCP
ports under xdist), and a join timeout, so a hung collective fails the
test instead of eating the suite's clock.  They import no jax.

Tolerances (the 2-rank step): the loss within 1e-6 and the grads within
rtol 1e-5 / atol 1e-6 (float32; the two halves' means are summed in
another order); params within 1e-6 + 1e-4 |ref| except at most
``STEP_SHARE`` of them, where Adam's first step, lr times the gradient's
sign, may flip on a gradient at rounding noise (all within 2 lr).
"""
import os
import pickle
import subprocess
import sys
import textwrap
import time

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import SHAPES as J_SHAPES
from repro.configs.registry import ARCHS as J_ARCHS
from repro.configs.registry import shape_applicable as j_applicable
from repro.models import model_zoo as jzoo
from repro.serving.kv_pool import KVPool as JKVPool
from repro.sharding import act as jact
from repro.sharding import specs as jsh
from repro_torch import tree
from repro_torch.configs.base import SHAPES, TrainConfig
from repro_torch.configs.registry import ARCHS, get_shape, shape_applicable
from repro_torch.models import model_zoo as zoo
from repro_torch.optim import adamw
from repro_torch.serving.kv_pool import KVPool
from repro_torch.sharding import act
from repro_torch.sharding import specs as sh
from repro_torch.training import trainer

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
JOIN_TIMEOUT = 120
STEP_SHARE = 1e-3
LR = 1e-3


class FakeMesh:
    """Mesh stand-in exposing only .shape (the rules need nothing else)."""

    def __init__(self, **axes):
        self.shape = dict(axes)


PROD = FakeMesh(data=16, model=16)
PROD_MP = FakeMesh(pod=2, data=16, model=16)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Reduced models are small ops: one intra-op thread runs them about as
    fast and adds no contention beside the suite's other workers (their
    own threads are restored afterwards)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

# the child's prelude: argv = rank, world, init file, output dir
RANK_PRELUDE = textwrap.dedent("""
    import os, pickle, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    RANK, WORLD = int(sys.argv[1]), int(sys.argv[2])
    INIT, OUT = sys.argv[3], sys.argv[4]
    dist.init_process_group("gloo", init_method="file://" + INIT,
                            rank=RANK, world_size=WORLD)
    with open(os.path.join(OUT, "args.pkl"), "rb") as f:
        ARGS = pickle.load(f)

    def save(obj):
        with open(os.path.join(OUT, f"rank{RANK}.pkl"), "wb") as f:
            pickle.dump(obj, f)
""")


def run_ranks(script: str, world: int, tmp_path, args=None,
              timeout: float = JOIN_TIMEOUT):
    """Run ``RANK_PRELUDE + script`` on ``world`` gloo ranks, one
    subprocess each; returns each rank's ``save``d object.  A rank that
    fails or outlives ``timeout`` fails the test (all ranks are killed)."""
    out = tmp_path / f"ranks{world}"
    out.mkdir()
    with open(out / "args.pkl", "wb") as f:
        pickle.dump(args, f)
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1",
               MKL_NUM_THREADS="1")
    code = RANK_PRELUDE + textwrap.dedent(script) + \
        "\ndist.destroy_process_group()\n"
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, str(r), str(world), str(out / "init"),
         str(out)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    deadline = time.monotonic() + timeout
    logs = []
    try:
        for p in procs:
            left = max(1.0, deadline - time.monotonic())
            logs.append(p.communicate(timeout=left)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail(f"gloo job of {world} ranks outlived {timeout} s")
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r} failed:\n{logs[r][-4000:]}"
    results = []
    for r in range(world):
        with open(out / f"rank{r}.pkl", "rb") as f:
            results.append(pickle.load(f))
    return results


# ---------------------------------------------------------------------------
# the rules, against the reference's
# ---------------------------------------------------------------------------

_TREES = {}


def _trees(arch):
    """(reference shape tree, port meta tree) of one arch, built once."""
    if arch not in _TREES:
        _TREES[arch] = (jzoo.init_params_spec(J_ARCHS[arch]),
                        zoo.init_params_spec(ARCHS[arch]))
    return _TREES[arch]


def _jax_by_path(tree_, is_leaf=None):
    return {tuple(p.key if hasattr(p, "key") else str(p) for p in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(
                tree_, is_leaf=is_leaf)[0]}


def _is_p(x):
    return isinstance(x, jax.sharding.PartitionSpec)


def _norm(spec):
    """Entries as jax's PartitionSpec keeps them: a one-axis tuple is that
    axis."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in spec)


def _same_specs(ref_tree, port_tree):
    ref = {k: _norm(v) for k, v in _jax_by_path(ref_tree, _is_p).items()}
    got = {k: _norm(v) for k, v in sh.flatten_with_path(port_tree)}
    assert got == ref


@pytest.mark.parametrize("fsdp,tp", [(True, True), (True, False),
                                     (False, True), (False, False)])
@pytest.mark.parametrize("mesh", [PROD, PROD_MP], ids=["single", "multi"])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_specs_equal_reference(arch, mesh, fsdp, tp):
    """Leaf for leaf: the same paths and shapes (``init_params_spec`` on
    ``meta`` against the reference's shape tree), and the same spec."""
    jtree, ttree = _trees(arch)
    shapes = {k: tuple(v.shape) for k, v in _jax_by_path(jtree).items()}
    assert {k: tuple(v.shape) for k, v in sh.flatten_with_path(ttree)} \
        == shapes
    _same_specs(jsh.param_specs(jtree, mesh, fsdp=fsdp, tp=tp),
                sh.param_specs(ttree, mesh, fsdp=fsdp, tp=tp))


def test_data_spec_divisibility():
    for mesh in (PROD, PROD_MP, FakeMesh(data=2, model=2)):
        for batch in (1, 2, 8, 256):
            for ndim in (1, 2, 3):
                assert _norm(sh.data_spec(mesh, batch, ndim)) == \
                    _norm(jsh.data_spec(mesh, batch, ndim))
    assert sh.data_spec(PROD, 256, 2) == sh.P(("data",), None)
    assert sh.data_spec(PROD, 1, 2) == sh.P(None, None)


@pytest.mark.parametrize("shape", ["decode_32k", "long_500k"])
@pytest.mark.parametrize("arch", ["gemma3-1b", "mamba2-370m", "zamba2-2.7b"])
def test_cache_specs_equal_reference(arch, shape):
    """Where the assignment's skip rule applies, both packages skip alike;
    elsewhere the specs agree leaf for leaf and every sharded dim
    divides."""
    cfg, shp = ARCHS[arch], get_shape(shape)
    ok = shape_applicable(cfg, shp)
    assert ok == j_applicable(J_ARCHS[arch], J_SHAPES[shape])
    assert SHAPES[shape].global_batch == J_SHAPES[shape].global_batch
    if not ok[0]:
        return
    port = sh.cache_specs(cfg, PROD, shp)
    _same_specs(jsh.cache_specs(J_ARCHS[arch], PROD, J_SHAPES[shape]), port)
    for (path, leaf), (_, spec) in zip(
            sh.flatten_with_path(sh.shape_tree(cfg, shp)),
            sh.flatten_with_path(port)):
        for dim, ax in zip(getattr(leaf, "shape", ()), spec):
            n = 1
            for a in (ax if isinstance(ax, tuple) else (ax,) if ax else ()):
                n *= PROD.shape[a]
            assert dim % n == 0, (path, spec)


@pytest.mark.parametrize("kv", ["bf16", "int8"])
@pytest.mark.parametrize("arch", ["qwen2-1.5b", "zamba2-2.7b"])
def test_paged_cache_specs_equal_reference(arch, kv):
    """On each package's own pool (the port's host-only ``alloc=False``
    pool on ``meta``), at model 2 and 4."""
    import jax.numpy as jnp
    cfg = ARCHS[arch].reduced(num_layers=6 if arch == "zamba2-2.7b" else 2)
    jcfg = J_ARCHS[arch].reduced(
        num_layers=6 if arch == "zamba2-2.7b" else 2)
    dt = torch.int8 if kv == "int8" else torch.bfloat16
    pool = KVPool(cfg, 2, 32, 8, dtype=dt, alloc=False)
    jpool = JKVPool(jcfg, 2, 32, 8,
                    dtype=jnp.int8 if kv == "int8" else jnp.bfloat16,
                    alloc=False)
    assert all(b.device.type == "meta" for b in pool.buffers.values())
    pool.check_invariants()
    for m in (2, 4):
        mesh = FakeMesh(data=2, model=m)
        _same_specs(jsh.paged_cache_specs(jcfg, mesh, jpool.buffers),
                    sh.paged_cache_specs(cfg, mesh, pool.buffers))


def test_activation_helpers_are_noops_outside_a_mesh():
    x = torch.ones((4, 8, 16))
    for fn in (act.shard_hidden, act.shard_experts, act.shard_logits,
               act.shard_activation):
        assert fn(x) is x
    assert act.current_mesh() is None
    assert act.reduce_model(x, "attn") is x
    assert act.gather_vocab(x) is x
    # inside a mesh, plain tensors pass unchanged too
    with act.use_mesh(FakeMesh(data=2, model=2), frozenset({"attn"})):
        assert act.current_mesh() is not None
        assert act.shard_hidden(x) is x
    assert act.current_mesh() is None
    np.testing.assert_array_equal(
        np.asarray(jact.shard_hidden(jax.numpy.ones((4, 8, 16)))),
        x.numpy())


# ---------------------------------------------------------------------------
# the executing path's cut
# ---------------------------------------------------------------------------

def test_mesh_report_full_qwen2_at_model_4():
    """Full qwen2-1.5b has 2 kv heads: at model 4 the rule cuts the
    attention projections' columns (2 x 128 divide by 4) but not whole
    heads, so the executing path replicates attention; the MLP (8,960)
    and the lm_head (151,936) are cut."""
    cfg = ARCHS["qwen2-1.5b"]
    mesh = FakeMesh(data=1, model=4)
    rep = sh.mesh_report(zoo.init_params_spec(cfg), cfg, mesh)
    attn = sorted(f"layers/attn/{n}"
                  for n in ("wq", "wk", "wv", "wo", "bq", "bk", "bv"))
    assert sorted(rep["replicated"]) == attn
    assert sorted(rep["cut"]) == sorted(
        ["layers/mlp/wi", "layers/mlp/wg", "layers/mlp/wo", "lm_head"])
    assert rep["kinds"] == ["dense", "lm_head", "mlp"]
    local = sh.local_config(cfg, mesh)
    assert (local.num_heads, local.num_kv_heads, local.head_dim,
            local.d_ff) == (12, 2, 128, 2240)
    # at model 2 the heads divide: attention is cut, head dim pinned
    local2 = sh.local_config(cfg, FakeMesh(data=1, model=2))
    assert (local2.num_heads, local2.num_kv_heads, local2.head_dim) == \
        (6, 1, 128)


def test_mesh_report_mamba2_replicates_the_mixer():
    """mamba2-370m: the rule replicates the mixed ``in_proj`` and cuts
    ``out_proj``'s rows across the mixer's heads; the path keeps the
    mixer whole (reported) and cuts only the lm_head."""
    cfg = ARCHS["mamba2-370m"]
    rep = sh.mesh_report(zoo.init_params_spec(cfg), cfg,
                         FakeMesh(data=1, model=4))
    assert rep["replicated"] == ["layers/out_proj"]
    assert rep["cut"] == ["lm_head"]


def test_shard_params_slices_whole_heads():
    """On a (1, 2) stand-in at model coordinate 1: each cut leaf is the
    second half of its rule's ``model`` dim, every other leaf the same
    tensor."""
    cfg = ARCHS["qwen2-1.5b"].reduced()
    params = zoo.init_params(torch.Generator().manual_seed(0), cfg)

    class Rank1(FakeMesh):
        def coord(self, axis):
            return 1

    local = sh.shard_params(params, cfg, Rank1(data=1, model=2))
    at = dict(sh.flatten_with_path(local))
    for path, leaf in sh.flatten_with_path(params):
        got = at[path]
        if path[-1] in ("wq", "wk", "wv", "bq", "bk", "bv", "wi", "wg") \
                or path == ("lm_head",):
            n = leaf.shape[-1] // 2
            torch.testing.assert_close(got, leaf[..., n:], rtol=0, atol=0)
        elif path[-1] == "wo":
            n = leaf.shape[-2] // 2
            torch.testing.assert_close(got, leaf[..., n:, :], rtol=0, atol=0)
        else:
            assert got is leaf, path


# ---------------------------------------------------------------------------
# the data-parallel train step
# ---------------------------------------------------------------------------

def _step_inputs():
    cfg = ARCHS["qwen2-1.5b"].reduced()
    rng = np.random.default_rng(3)
    batch = {k: rng.integers(0, cfg.vocab_size, (4, 16)).astype(np.int64)
             for k in ("tokens", "labels")}
    return cfg, batch


def _unmeshed_step(cfg, batch, tcfg):
    params = zoo.init_params(torch.Generator().manual_seed(0), cfg)
    opt = adamw.init_state(params, tcfg)
    b = {k: torch.as_tensor(v) for k, v in batch.items()}
    grads, metrics = trainer.grads_and_metrics(params, cfg, tcfg, b)
    params, opt, m = trainer.make_train_step(cfg, tcfg)(params, opt, b)
    return params, m, grads


_DP_SCRIPT = """
from repro_torch.configs.base import TrainConfig
from repro_torch.configs.registry import ARCHS
from repro_torch.launch.mesh import make_serving_mesh
from repro_torch.models import model_zoo as zoo
from repro_torch.optim import adamw
from repro_torch.sharding import act
from repro_torch.training import trainer
from repro_torch import tree

cfg = ARCHS["qwen2-1.5b"].reduced()
tcfg = TrainConfig(**ARGS["tcfg"])
mesh = make_serving_mesh(2, 1, device="cpu")
assert mesh.coords == (RANK, 0) and mesh.shape == {"data": 2, "model": 1}
b = {k: torch.as_tensor(v) for k, v in ARGS["batch"].items()}
params = zoo.init_params(torch.Generator().manual_seed(0), cfg)
opt = adamw.init_state(params, tcfg)
local = trainer.local_batch(b, mesh)
grads, metrics = trainer.mean_over_data(
    *trainer.grads_and_metrics(params, cfg, tcfg, local), mesh)
params, opt, m = trainer.make_train_step(cfg, tcfg, mesh)(params, opt, b)
# the reference's activation constraint on a DTensor: batch over data
from torch.distributed.tensor import Replicate, distribute_tensor
h = distribute_tensor(torch.ones(4, 8, 16), mesh.device_mesh,
                      [Replicate(), Replicate()])
with act.use_mesh(mesh):
    placed = act.shard_hidden(h).placements
save({"params": [t.numpy() for t in tree.leaves(params)],
      "grads": [t.numpy() for t in tree.leaves(grads)],
      "metrics": {k: float(v) for k, v in m.items()},
      "rows": local["tokens"].numpy(),
      "placements": [repr(p) for p in placed]})
"""


def test_data_parallel_step_matches_the_whole_batch(tmp_path):
    """2 gloo ranks, each on its half of the batch: grads averaged over
    ``data``, then clipping and AdamW, against the unmeshed step on the
    whole batch; both ranks end with the same params."""
    cfg, batch = _step_inputs()
    kw = dict(lr=LR, warmup_steps=1, bf16_state=False, remat=False)
    ref_params, ref_m, ref_grads = _unmeshed_step(cfg, batch,
                                                  TrainConfig(**kw))
    ranks = run_ranks(_DP_SCRIPT, 2, tmp_path,
                      args={"tcfg": kw, "batch": batch})
    np.testing.assert_array_equal(ranks[0]["rows"], batch["tokens"][:2])
    np.testing.assert_array_equal(ranks[1]["rows"], batch["tokens"][2:])
    # the batch divides data x model: the reference's ZeRO-DP layout
    assert ranks[0]["placements"] == ["Shard(dim=0)", "Shard(dim=0)"]
    for a, b in zip(ranks[0]["params"], ranks[1]["params"]):
        np.testing.assert_array_equal(a, b)
    for g, r in zip(ranks[0]["grads"], tree.leaves(ref_grads)):
        np.testing.assert_allclose(g, r.numpy(), rtol=1e-5, atol=1e-6)
    for k in ("loss", "nll", "grad_norm"):
        np.testing.assert_allclose(ranks[0]["metrics"][k], float(ref_m[k]),
                                   rtol=1e-6 if k != "grad_norm" else 1e-5,
                                   atol=1e-6)
    n_off = n_all = 0
    for a, r in zip(ranks[0]["params"], tree.leaves(ref_params)):
        diff = np.abs(a - r.numpy())
        assert diff.max() <= 2 * LR + 1e-6
        n_off += int((diff > 1e-6 + 1e-4 * np.abs(r.numpy())).sum())
        n_all += diff.size
    assert n_off <= STEP_SHARE * n_all, (n_off, n_all)


def test_debug_mesh_step_is_bitwise_the_unmeshed_step():
    """The (1, 1) mesh (a world-size-1 gloo group in this process): the
    same batch, grads averaged over one rank, the same bits."""
    from repro_torch.launch.mesh import make_serving_mesh
    cfg, batch = _step_inputs()
    tcfg = TrainConfig(lr=LR, warmup_steps=1, grad_accum=2, remat=True)
    b = {k: torch.as_tensor(v) for k, v in batch.items()}
    outs = []
    for mesh in (None, make_serving_mesh(1, 1, device="cpu")):
        params = zoo.init_params(torch.Generator().manual_seed(0), cfg)
        opt = adamw.init_state(params, tcfg)
        params, opt, m = trainer.make_train_step(cfg, tcfg, mesh)(
            params, opt, b)
        outs.append((params, opt, m))
    (p0, o0, m0), (p1, o1, m1) = outs
    for a, c in zip(tree.leaves((p0, o0)), tree.leaves((p1, o1))):
        assert torch.equal(a, c)
    for k in m0:
        assert torch.equal(m0[k], m1[k]), k


def test_train_run_on_the_debug_mesh_gives_the_same_losses():
    """``launch/train.run(mesh=)`` on the (1, 1) mesh: the losses of the
    single-device run, bit for bit."""
    from repro_torch.launch.mesh import make_serving_mesh
    from repro_torch.launch.train import run
    kw = dict(steps=1, batch=2, seq=16, log_every=10)
    plain = run("qwen2-1.5b", device="cpu", **kw)
    meshed = run("qwen2-1.5b", mesh=make_serving_mesh(1, 1, device="cpu"),
                 **kw)
    assert meshed == plain


def test_meshes_refuse_the_wrong_world_size():
    """The world size is checked up front, with how to launch: a (2, 1)
    serving mesh in a one-rank process, the production meshes without
    256 / 512 ranks; the (1, 1) mesh is built once per process."""
    from repro_torch.launch.mesh import (make_debug_mesh,
                                         make_production_mesh,
                                         make_serving_mesh)
    mesh = make_serving_mesh(1, 1, device="cpu")
    assert make_debug_mesh(1, 1, device="cpu") is mesh
    assert (mesh.shape, mesh.coords, mesh.world) == \
        ({"data": 1, "model": 1}, (0, 0), 1)
    assert mesh.sub("model").shape == {"model": 1}
    with pytest.raises(RuntimeError, match="needs 2 ranks"):
        make_serving_mesh(2, 1, device="cpu")
    for multi in (False, True):
        with pytest.raises(RuntimeError, match="ranks for mesh"):
            make_production_mesh(multi_pod=multi, device="cpu")
