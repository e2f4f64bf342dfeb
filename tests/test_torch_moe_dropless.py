"""The MoE family's dropless serving FFN (``models/moe.py``:
``serving_ffn`` -> ``dropless_ffn`` -> ``kernels/grouped_ffn.py``'s plain
version), on the CPU:

* it equals the capacity path ``moe_ffn`` at a capacity that drops
  nothing (factor E/k), within ``FFN_TOL``;
* with the router skewed so that the serving capacity 2.0 drops a quarter
  of the (token, choice) pairs or more, it equals the benchmark's plain
  reference (``hibench/reference/decoder.py``'s every-pair ``moe``) within
  ``FFN_TOL``, and the capacity path does not;
* padded positions (``live`` False) take no pair and change no live
  token's output, in the FFN and through ``prefill_paged``;
* reduced deepseek-moe-16b ``serve_stream`` over the chunk lane at the
  rule's widths 1, 2 and 4 equals the lane at W (``test_torch_chunk_width
  .py``'s check), with and without prefix sharing;
* one ``_host_fetch`` per tick, every serving pass routes k pairs for each
  of its live tokens in every layer, and each grouped call hits the
  experts the live tokens' top k name.

``FFN_TOL`` = 1e-5: float32 on both sides, the same products over rows
taken in another grouping and summed over the k choices in another order
(outputs of O(1)).
"""
import dataclasses

import pytest
import torch

import test_torch_chunk_width as cw
from hibench.reference import decoder
from hibench.reference.dims import Dims
from repro_torch.configs.registry import ARCHS
from repro_torch.kernels import ops
from repro_torch.models import model_zoo, moe
from repro_torch.models.transformer import layer_params
from repro_torch.serving import engine as engine_mod
from repro_torch.serving.engine import disable_tf32

ARCH = "deepseek-moe-16b"
FFN_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op torch thread, restored afterwards (the suite's other
    workers keep their cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    disable_tf32()
    yield
    torch.set_num_threads(n)


def _layer(cfg, seed=0):
    params = model_zoo.init_params(torch.Generator().manual_seed(seed), cfg)
    return layer_params(params["layers"], 0)


@pytest.mark.parametrize("name", ["deepseek-moe-16b", "arctic-480b"])
@pytest.mark.parametrize("b,s", [(1, 1), (4, 1), (2, 9), (3, 16)])
def test_dropless_equals_moe_ffn_without_drops(name, b, s):
    cfg = ARCHS[name].reduced()
    lp = _layer(cfg)
    x = torch.randn((b, s, cfg.d_model), generator=torch.Generator()
                    .manual_seed(b * 100 + s))
    nodrop = cfg.num_experts / cfg.experts_per_token
    want, _ = moe._ffn(lp, cfg, x, nodrop)
    got = moe.serving_ffn(lp, cfg, x)
    torch.testing.assert_close(got, want, atol=FFN_TOL, rtol=0)


def _skewed(seed=3, t=48):
    """A layer of 32 experts, top 6, 1 shared, whose router sends most
    tokens to the same six experts: tokens share a direction ``u`` that
    the first experts' router columns point along."""
    cfg = dataclasses.replace(ARCHS[ARCH].reduced(), num_experts=32,
                              experts_per_token=6)
    lp = _layer(cfg, seed)
    g = torch.Generator().manual_seed(seed)
    u = torch.randn((cfg.d_model,), generator=g)
    u = u / u.norm()
    lp["router"] = lp["router"].clone()
    lp["router"][:, :6] += 0.4 * u[:, None]
    x = torch.randn((1, t, cfg.d_model), generator=g) * 0.5 + 3.0 * u
    dm = Dims(name="skewed", family="moe", layers=1, d=cfg.d_model,
              heads=cfg.num_heads, kv_heads=cfg.num_kv_heads,
              head_dim=cfg.resolved_head_dim, ff=cfg.d_ff_expert,
              vocab=cfg.vocab_size, rope_theta=cfg.rope_theta,
              eps=cfg.norm_eps, experts=cfg.num_experts,
              top_k=cfg.experts_per_token, shared=cfg.num_shared_experts,
              ff_expert=cfg.d_ff_expert)
    return cfg, lp, x, dm


def test_dropless_equals_the_reference_where_capacity_drops():
    cfg, lp, x, dm = _skewed()
    t = x.shape[1]
    cap = moe.moe_capacity(t, cfg.num_experts, cfg.experts_per_token,
                           moe.SERVE_CAPACITY)
    keep = moe.route(lp, cfg, x[0], cap)[3]
    dropped = 1.0 - float(keep.float().mean())
    assert dropped >= 0.25, dropped
    ref = decoder.moe(lp, dm, x[0])
    got = moe.serving_ffn(lp, cfg, x)[0]
    torch.testing.assert_close(got, ref, atol=FFN_TOL, rtol=0)
    capped, _ = moe._ffn(lp, cfg, x, moe.SERVE_CAPACITY)
    assert float((capped[0] - ref).abs().max()) > 100 * FFN_TOL


def _route_recorder(monkeypatch):
    """``ops.route_pairs`` wrapped to record each call's routed pairs
    (``offsets[E]``) under the config of the serving pass that made it:
    returns {config name: [pairs of each call]}, filled as passes run."""
    routed, current = {}, []
    for name in ("prefill_paged", "decode_step_paged",
                 "forward_chunk_paged"):
        def wrapped(params, cfg, *args, _real=getattr(model_zoo, name),
                    **kw):
            current[:] = [cfg.name]
            return _real(params, cfg, *args, **kw)
        monkeypatch.setattr(model_zoo, name, wrapped)
    real = ops.route_pairs

    def recorded(logits, k, live=None):
        gate, pairs, offsets = real(logits, k, live)
        routed.setdefault(current[0], []).append(int(offsets[-1]))
        return gate, pairs, offsets
    monkeypatch.setattr(ops, "route_pairs", recorded)
    return routed


def test_padded_positions_change_no_live_output(monkeypatch):
    cfg = ARCHS[ARCH].reduced()
    lp = _layer(cfg)
    g = torch.Generator().manual_seed(4)
    x = torch.randn((3, 8, cfg.d_model), generator=g)
    live = torch.rand((3, 8), generator=g) < 0.6
    live[0, 0] = True
    y = torch.randn((3, 8, cfg.d_model), generator=g)
    noisy = torch.where(live[..., None], x, y * 1e3)
    routed = []
    real = ops.route_pairs

    def recorded(logits, k, live=None):
        out = real(logits, k, live)
        routed.append(int(out[2][-1]))
        return out
    monkeypatch.setattr(ops, "route_pairs", recorded)
    a = moe.dropless_ffn(lp, cfg, x, live)
    b = moe.dropless_ffn(lp, cfg, noisy, live)
    assert torch.equal(a[live], b[live])
    assert (a[~live] == 0).all() and (b[~live] == 0).all()
    n = int(live.sum())
    assert routed == [cfg.experts_per_token * n] * 2
    # the live tokens alone, as one batch
    alone = moe.dropless_ffn(lp, cfg, x[live][None])
    torch.testing.assert_close(a[live], alone[0], atol=FFN_TOL, rtol=0)


def test_prefill_paged_tails_change_no_logit():
    """Two admissions of bucketed prompts in an (A, S_max) pass whose
    padded tails hold other tokens: the logits are the same bits."""
    cfg = ARCHS[ARCH].reduced()
    params = model_zoo.init_params(torch.Generator().manual_seed(0), cfg)
    page, s_max = 8, 32
    lens = torch.tensor([16, 24])
    at = torch.arange(s_max)
    live = at < lens[:, None]
    g = torch.Generator().manual_seed(5)
    toks = torch.randint(1, cfg.vocab_size, (2, s_max), generator=g)
    other = torch.where(live, toks, torch.randint(
        1, cfg.vocab_size, (2, s_max), generator=g))
    block = torch.arange(1, 9).reshape(2, 4)
    outs = []
    for tk in (toks, other):
        cache = model_zoo.init_paged_cache(cfg, 2, 9, page, device="cpu")
        outs.append(model_zoo.prefill_paged(params, cfg, tk, lens,
                                            torch.arange(2), block, cache,
                                            live=live)[0])
    assert torch.equal(outs[0], outs[1])


@pytest.mark.parametrize("sharing", [False, True])
def test_chunk_lane_widths_equal_the_full_lane(sharing, monkeypatch):
    routed = _route_recorder(monkeypatch)
    got, sched = cw._serve(ARCH, sharing)
    pairs = {name: sum(n) for name, n in routed.items()}
    routed.clear()
    widths = {w for rt in (sched.srt, sched.lrt)
              for w in rt.chunk_width_ticks}
    assert {1, 2} <= widths, widths
    cw._full_width(monkeypatch)
    ref, ref_sched = cw._serve(ARCH, sharing)
    assert set(ref_sched.lrt.chunk_width_ticks) == {cw.W}
    cw._assert_records_equal(got, ref)
    for rt, ref_rt in ((sched.srt, ref_sched.srt),
                       (sched.lrt, ref_sched.lrt)):
        assert rt.lane_ticks == ref_rt.lane_ticks
        assert rt.chunk_tokens == ref_rt.chunk_tokens
    # the same live tokens routed whatever the lane's width, in each tier
    assert len(pairs) == 2 and all(pairs.values())
    assert {name: sum(n) for name, n in routed.items()} == pairs


def test_routed_pairs_equal_the_live_tokens(monkeypatch):
    """Every routed pass is recorded on the host: its tier's config, its
    live tokens (from the ``live`` mask the scheduler built) and each
    ``route_pairs`` call's routed pairs and the experts the live tokens'
    top k name; every grouped call the experts its runs hit.  Each pass
    routes k pairs a live token in every layer, and each grouped call hits
    the experts its route named."""
    passes, calls, fetches = [], [], []
    real_fetch = engine_mod._host_fetch
    monkeypatch.setattr(engine_mod, "_host_fetch",
                        lambda tree: (fetches.append(1), real_fetch(tree))[1])
    for name in ("prefill_paged", "decode_step_paged",
                 "forward_chunk_paged"):
        def wrapped(params, cfg, *args, _real=getattr(model_zoo, name),
                    **kw):
            passes.append((cfg, int(kw["live"].sum()), []))
            return _real(params, cfg, *args, **kw)
        monkeypatch.setattr(model_zoo, name, wrapped)
    real_route, real_grouped = ops.route_pairs, ops.grouped_swiglu

    def routed(logits, k, live=None):
        gate, pairs, offsets = real_route(logits, k, live)
        named = torch.topk(logits if live is None else logits[live], k)
        passes[-1][2].append((int(offsets[-1]),
                              int(named.indices.unique().numel())))
        return gate, pairs, offsets

    def grouped(x, pairs, offsets, *rest):
        calls.append(int((offsets[1:] > offsets[:-1]).sum()))
        return real_grouped(x, pairs, offsets, *rest)
    monkeypatch.setattr(ops, "route_pairs", routed)
    monkeypatch.setattr(ops, "grouped_swiglu", grouped)
    _, sched = cw._serve(ARCH, sharing=True)
    assert len(fetches) == sched.counters.ticks > 0
    assert {cfg.name for cfg, _, _ in passes} == {
        rt.pool.cfg.name for rt in (sched.srt, sched.lrt)}
    for cfg, live, routes in passes:
        assert [n for n, _ in routes] == \
            [cfg.experts_per_token * live] * cfg.num_layers
    named = [hit for _, _, routes in passes for _, hit in routes]
    assert calls == named and sum(named) > 0
