"""The plain reference against the port at reduced sizes on the CPU, for
the dense and the MoE family: the forward pass on the benchmark's own
weights, and the harness's whole run (the port's ``serve_stream`` with the
kernels' plain versions, held to the reference by ``check.py``)."""
import pytest
import torch

from hibench import program, run, weights
from hibench.reference import decoder, dims
from hibench.tests import tiny

FAMILIES = ["h2o-danube-3-4b", "deepseek-moe-16b"]


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", FAMILIES)
def test_forward_matches_the_port(name):
    from repro_torch.models import model_zoo, moe
    cell = tiny.cell(name)
    l = dims.from_config(cell.config)
    s = dims.s_tier(l, 4)
    lp, sp = weights.make_tiers(5, l, s, torch.device("cpu"))
    cfg = program.model_config(l)
    program.check_s_tier(cfg, s, 4)
    tokens = torch.randint(1, l.vocab, (1, 40),
                           generator=torch.Generator().manual_seed(3))
    if l.moe:
        # enough expert capacity that the port drops no (token, choice) pair
        port = moe.forward(lp, cfg, tokens, capacity_factor=64.0)[0][0]
    else:
        port = model_zoo.forward(lp, cfg, tokens)[0]
    ref = decoder.logits(lp, l, tokens[0], 0, kv_dtype=None)
    assert torch.allclose(port, ref, atol=2e-5, rtol=0), \
        float((port - ref).abs().max())
    # the configuration's bf16 K/V store moves the logits, a little
    rounded = decoder.logits(lp, l, tokens[0], 0)
    gap = float((rounded - ref).abs().max())
    assert 1e-6 < gap < 1e-1


@pytest.mark.parametrize("name", FAMILIES)
@pytest.mark.parametrize("traced", [0, 1])
def test_a_whole_run_is_correct(name, traced):
    cell = tiny.cell(name)
    res = run.execute(cell, 2 ** 31 + 11, 0.0, bool(traced), "cpu")
    assert res["correct"], tiny.dump(res)
    assert res["failed"] == 0 and res["attempted"] == 6
    assert list(res)[-1] == "checks"
    readings = res["window"]["readings"]
    assert readings["gap_s"] <= 1e-4 and readings["gap_l"] <= 1e-4
    assert res["checks"]["flips"]["value"] == 0
    if traced:
        names = set(res["metrics"])
        assert {"tick_ms", "dispatch_share", "offload_share", "mfu",
                "prefill_saved_share"} <= names
        # no device on the CPU: nothing to read, so no device metric
        assert not names & {"device_idle_share", "paged_decode_roofline",
                            "chunk_attn_roofline"}
    else:
        assert set(res["metrics"]) == {"tokens_per_s", "ttft_p95_ms",
                                       "peak_mem_gib", "setup_s"}


def test_the_seed_decides_inputs_and_weights():
    cell = tiny.cell("h2o-danube-3-4b")
    extra_a, extra_b, extra_c = {}, {}, {}
    run.execute(cell, 41, 0.0, False, "cpu", extra=extra_a)
    run.execute(cell, 41, 0.0, False, "cpu", extra=extra_b)
    run.execute(cell, 42, 0.0, False, "cpu", extra=extra_c)
    toks = [[list(r["tokens"]) for r in e["rows"]]
            for e in (extra_a, extra_b, extra_c)]
    assert toks[0] == toks[1] and toks[0] != toks[2]


def test_theta_calibrated_on_the_runs_own_model():
    """Theta comes from set-up's calibration pass: the quantile of the S
    tier's confidences at the cell's target share."""
    cell = tiny.cell("deepseek-moe-16b")
    extra = {}
    res = run.execute(cell, 2 ** 32 + 3, 0.0, False, "cpu", extra=extra)
    assert res["correct"], tiny.dump(res)
    theta = res["window"]["theta"]
    confs = [r["confidence"] for r in extra["rows"]]
    assert min(confs) < theta < max(confs)
    assert all(r["offloaded"] == (r["confidence"] < theta)
               for r in extra["rows"])


def test_the_traced_wave_holds_no_tally(monkeypatch):
    """The paged attention kernels' work is tallied in a wave of its own,
    after the profiled one: the profiled wave runs the kernels unwrapped."""
    from hibench import program
    from repro_torch.kernels import ops
    orig, serve, seen = ops.decode_attention_paged, program.serve_wave, {}

    def spy(engine, items, first_id, serve_kw, telemetry=None):
        seen[first_id] = (ops.decode_attention_paged is orig,
                          torch.autograd._profiler_enabled())
        return serve(engine, items, first_id, serve_kw, telemetry)
    monkeypatch.setattr(program, "serve_wave", spy)
    res = run.execute(tiny.cell("h2o-danube-3-4b"), 2 ** 31 + 7, 0.0, True,
                      "cpu")
    assert res["correct"], tiny.dump(res)
    traced = 10 ** 9 // 2
    assert seen[traced] == (True, True)
    assert seen[traced + 100_000] == (False, False)
