"""Expert parallelism over torch.distributed (``moe.moe_ffn_sharded``)
against the local scatter dispatch: ``tests/test_moe_sharded.py`` on the
port.

* 4 gloo ranks on a (2, 2) mesh, reduced deepseek-moe-16b (4 experts,
  top-2) at the no-drop capacity E / k: each rank holds its data block of
  the tokens and its ``model`` experts with F sharded over ``data``; ``y``
  against the port's ``moe_ffn`` and the reference's within 2e-4.  ``aux``
  is by design the mean over the data shards of each shard's load-balance
  statistic, not the one global statistic (the reference's Jensen gap,
  0.088 here): it is held to both packages' ``moe_ffn`` aux on each data
  block, averaged, within 1e-6.  Both schedules: tokens-move at
  the reduced ``d_ff_expert`` (512), weights-move at 8, where the expert
  weights are the smaller operand.
* In the same job, the ``model`` sub-mesh (the serving L tier's: tokens
  whole on every rank) at capacity 0.5: the union over the model ranks of
  the kept local pairs is exactly ``moe_ffn``'s kept (token, choice) set,
  and ``y`` agrees within 2e-4.
* In process, on the (1, 1) mesh: ``moe_ffn_sharded`` is ``moe_ffn`` bit
  for bit at both capacities, and ``moe_ffn_auto`` takes it.
* Whole experts under a (2, 2) mesh's shape: ``moe_ffn_sharded`` refuses
  them and ``moe_ffn_auto`` keeps them on the local scatter.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCHS as J_ARCHS
from repro.models import moe as jmoe
from repro_torch.bridge import params_from_numpy
from repro_torch.configs.registry import ARCHS
from repro_torch.models import model_zoo as zoo
from repro_torch.models import moe
from repro_torch.models.transformer import layer_params
from repro_torch.sharding import act
from test_torch_sharding import run_ranks

ARCH = "deepseek-moe-16b"
TOL = 2e-4
AUX_TOL = 1e-6
SCHEDULES = {"tokens_move": None, "weights_move": 8}   # d_ff_expert


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Reduced models are small ops: one intra-op thread runs them about as
    fast and adds no contention beside the suite's other workers (their
    own threads are restored afterwards)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(ff):
    jcfg, cfg = J_ARCHS[ARCH].reduced(), ARCHS[ARCH].reduced()
    if ff is not None:
        jcfg = dataclasses.replace(jcfg, d_ff_expert=ff)
        cfg = dataclasses.replace(cfg, d_ff_expert=ff)
    return jcfg, cfg


def _layer0(cfg, seed):
    """Layer-0 routed-FFN params of ``cfg``'s shapes from a numpy seed,
    at the packages' init scales (1 / sqrt(fan-in))."""
    rng = np.random.default_rng(seed)
    d, e, f = cfg.d_model, cfg.num_experts, cfg.d_ff_expert

    def dense(*shape):
        return (rng.standard_normal(shape) / np.sqrt(shape[-2])
                ).astype(np.float32)

    return {"router": dense(d, e),
            "experts": {"wi": dense(e, d, f), "wg": dense(e, d, f),
                        "wo": dense(e, f, d)}}


_SCRIPT = """
from repro_torch.launch.mesh import make_serving_mesh
from repro_torch.models import moe
from repro_torch.configs.registry import ARCHS
import dataclasses
mesh = make_serving_mesh(2, 2, device="cpu")
d, m = mesh.coords
out = {}
for name, (ff, lp_np, x_np) in ARGS["cases"].items():
    cfg = ARCHS["deepseek-moe-16b"].reduced()
    if ff is not None:
        cfg = dataclasses.replace(cfg, d_ff_expert=ff)
    e = cfg.num_experts
    el, f = e // 2, lp_np["experts"]["wi"].shape[-1]
    fl = f // 2
    ex = lp_np["experts"]
    local = {"router": torch.as_tensor(lp_np["router"]),
             "experts": {
                 "wi": torch.as_tensor(ex["wi"][m * el:(m + 1) * el, :,
                                                d * fl:(d + 1) * fl]),
                 "wg": torch.as_tensor(ex["wg"][m * el:(m + 1) * el, :,
                                                d * fl:(d + 1) * fl]),
                 "wo": torch.as_tensor(ex["wo"][m * el:(m + 1) * el,
                                                d * fl:(d + 1) * fl, :])}}
    x = torch.as_tensor(x_np)
    bl = x.shape[0] // 2
    nodrop = float(e / cfg.experts_per_token)
    y, aux = moe.moe_ffn_sharded(local, cfg, x[d * bl:(d + 1) * bl], nodrop,
                                 mesh)
    out[name] = {"y": y.numpy(), "aux": float(aux)}
# the serving L tier's sub-mesh: model only, every token on every rank,
# whole-F experts of this rank's model index
cfg = ARCHS["deepseek-moe-16b"].reduced()
lp_np, x_np = ARGS["drop"]
e, el = cfg.num_experts, cfg.num_experts // 2
ex = lp_np["experts"]
local = {"router": torch.as_tensor(lp_np["router"]),
         "experts": {k: torch.as_tensor(v[m * el:(m + 1) * el])
                     for k, v in ex.items()}}
sub = mesh.sub("model")
x = torch.as_tensor(x_np)
y, _ = moe.moe_ffn_sharded(local, cfg, x, 0.5, sub)
t = x.shape[0] * x.shape[1]
cap = moe.moe_capacity(t, e, cfg.experts_per_token, 0.5)
_, _, _, keep, _, _ = moe.route_local(local, cfg, x.reshape(t, -1), cap,
                                      m * el, el)
out["drop"] = {"y": y.numpy(), "keep": keep.numpy(), "coords": (d, m)}
save(out)
"""


def test_sharded_matches_local_on_a_2x2_mesh(tmp_path):
    rng = np.random.default_rng(1)
    cases, refs = {}, {}
    for name, ff in SCHEDULES.items():
        jcfg, cfg = _cfgs(ff)
        lp = _layer0(cfg, seed=len(cases))
        x = rng.standard_normal((4, 8, cfg.d_model)).astype(np.float32)
        nodrop = float(cfg.num_experts / cfg.experts_per_token)
        jy, jaux = jax.jit(lambda p, v: jmoe.moe_ffn(p, jcfg, v, nodrop))(
            jax.tree.map(jax.numpy.asarray, lp), jax.numpy.asarray(x))
        ty, _ = moe.moe_ffn(params_from_numpy(lp, device="cpu"), cfg,
                            torch.as_tensor(x), nodrop)
        # the aux loss of each data block (2 rows), averaged
        taux = np.mean([float(moe.moe_ffn(params_from_numpy(lp, device="cpu"),
                                          cfg, torch.as_tensor(x[i:i + 2]),
                                          nodrop)[1]) for i in (0, 2)])
        jaux = np.mean([float(jax.jit(
            lambda p, v: jmoe.moe_ffn(p, jcfg, v, nodrop))(
                jax.tree.map(jax.numpy.asarray, lp),
                jax.numpy.asarray(x[i:i + 2]))[1]) for i in (0, 2)])
        # which schedule the byte rule picks at this width
        e_l, cap = cfg.num_experts // 2, 16
        tokens_move = (2 * e_l * cap * 2 * cfg.d_model * 2
                       < 3 * e_l * cfg.d_model * cfg.d_ff_expert * 2)
        assert tokens_move == (name == "tokens_move")
        cases[name] = (ff, lp, x)
        refs[name] = (np.asarray(jy), jaux, ty.numpy(), taux)
    jcfg, cfg = _cfgs(None)
    lp = cases["tokens_move"][1]
    xd = rng.standard_normal((4, 8, cfg.d_model)).astype(np.float32)
    ranks = run_ranks(_SCRIPT, 4, tmp_path,
                      args={"cases": cases, "drop": (lp, xd)})

    for name, (jy, jaux, ty, taux) in refs.items():
        # the data blocks, in data order (ranks are (d, m) row-major)
        y = np.concatenate([ranks[0][name]["y"], ranks[2][name]["y"]])
        np.testing.assert_array_equal(ranks[1][name]["y"], ranks[0][name]["y"])
        np.testing.assert_allclose(y, ty, rtol=TOL, atol=TOL)
        np.testing.assert_allclose(y, jy, rtol=TOL, atol=TOL)
        for r in ranks:
            assert abs(r[name]["aux"] - taux) <= AUX_TOL
            assert abs(r[name]["aux"] - jaux) <= AUX_TOL

    # the model sub-mesh at capacity 0.5: the same drops as moe_ffn
    tp = params_from_numpy(lp, device="cpu")
    xt = torch.as_tensor(xd)
    ty, _ = moe.moe_ffn(tp, cfg, xt, 0.5)
    t = xt.shape[0] * xt.shape[1]
    cap = moe.moe_capacity(t, cfg.num_experts, cfg.experts_per_token, 0.5)
    _, _, _, keep, _ = moe.route(tp, cfg, xt.reshape(t, -1), cap)
    assert not keep.all(), "capacity 0.5 must drop pairs"
    for d in (0, 1):
        row = [r["drop"] for r in ranks if r["drop"]["coords"][0] == d]
        assert [r["coords"][1] for r in row] == [0, 1]
        assert not (row[0]["keep"] & row[1]["keep"]).any()
        np.testing.assert_array_equal(row[0]["keep"] | row[1]["keep"],
                                      keep.numpy())
        for r in row:
            np.testing.assert_allclose(r["y"], ty.numpy(), rtol=TOL,
                                       atol=TOL)


@pytest.mark.parametrize("capacity", [2.0, 0.5])
def test_debug_mesh_is_moe_ffn_bitwise(capacity):
    """(1, 1): the same capacity, positions and drops, the same sums in
    the same order; ``moe_ffn_auto`` takes the sharded dispatch there and
    the local one off a mesh."""
    from repro_torch.launch.mesh import make_serving_mesh
    cfg = ARCHS[ARCH].reduced()
    params = zoo.init_params(torch.Generator().manual_seed(0), cfg)
    lp = layer_params(params["layers"], 0)
    x = torch.randn((4, 8, cfg.d_model),
                    generator=torch.Generator().manual_seed(1))
    y0, aux0 = moe.moe_ffn(lp, cfg, x, capacity)
    mesh = make_serving_mesh(1, 1, device="cpu")
    y1, aux1 = moe.moe_ffn_sharded(lp, cfg, x, capacity, mesh)
    assert torch.equal(y0, y1) and torch.equal(aux0, aux1)
    calls = []
    real = moe.moe_ffn_sharded
    try:
        moe.moe_ffn_sharded = lambda *a: calls.append(1) or real(*a)
        with act.use_mesh(mesh.sub("model")):
            y2, _ = moe.moe_ffn_auto(lp, cfg, x, capacity)
        y3, _ = moe.moe_ffn_auto(lp, cfg, x, capacity)
    finally:
        moe.moe_ffn_sharded = real
    assert calls == [1]
    assert torch.equal(y2, y0) and torch.equal(y3, y0)


class _FullMesh:
    """A (2, 2) mesh's shape, with no process group: the layout guard
    decides before any collective."""
    shape = {"data": 2, "model": 2}


def test_whole_experts_on_a_full_mesh_stay_local():
    """Whole-F, all-E expert params under a (2, 2) mesh are not the
    sharded storage: ``moe_ffn_sharded`` refuses them, and
    ``moe_ffn_auto`` computes them with the local scatter, bit for bit
    ``moe_ffn`` (the sharded body would sum N full copies)."""
    cfg = ARCHS[ARCH].reduced()
    params = zoo.init_params(torch.Generator().manual_seed(0), cfg)
    lp = layer_params(params["layers"], 0)
    x = torch.randn((4, 8, cfg.d_model),
                    generator=torch.Generator().manual_seed(1))
    with pytest.raises(ValueError, match="not one rank's block"):
        moe.moe_ffn_sharded(lp, cfg, x, 2.0, _FullMesh())
    y0, aux0 = moe.moe_ffn(lp, cfg, x, 2.0)
    with act.use_mesh(_FullMesh()):
        y1, aux1 = moe.moe_ffn_auto(lp, cfg, x, 2.0)
    assert torch.equal(y0, y1) and torch.equal(aux0, aux1)
