"""The port's HI core (``repro_torch.core``): the paper's published numbers,
the cost model, calibration, baselines and reports, re-stated from
``tests/test_core.py``; then ``HICascade`` against the reference's on the
same params, for a linear head and for the CIFAR CNNs, in all three
confidence metrics, with and without ``use_kernel`` (the reference's Pallas
``hi_gate`` in interpret mode, the port's plain version on the CPU).

Predictions, offload masks, served and dropped counts are compared exactly,
confidences to 1e-6: both packages compute them in float32 from logits that
differ in the order of their sums only.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import HIConfig as JHIConfig
from repro.core import baselines as jbase
from repro.core import calibrate as jcal
from repro.core import cost as jcost
from repro.core import metrics as jmetrics
from repro.core import replay as jreplay
from repro.core.cascade import classifier_cascade as jcascade
from repro.core.confidence import temperature_scale as jtemperature_scale
from repro.data.images import make_dataset
from repro.models import cnn as jcnn
from repro_torch.configs.base import HIConfig
from repro_torch.core import (CostReport, HICascade, calibrate, cost_closed_form,
                              replay)
from repro_torch.core import baselines, metrics
from repro_torch.core.baselines import (TimingModel, full_offload, oma, omd,
                                        partition_per_sample_ms, tinyml)
from repro_torch.core.cascade import classifier_cascade
from repro_torch.core.confidence import temperature_scale
from repro_torch.core.cost import (per_sample_cost, relative_cost_reduction,
                                   total_cost)
from repro_torch.models import cnn

CONF_TOL = 1e-6
METRICS = ("max_prob", "margin", "entropy")


# ---------------------------------------------------------------------------
# paper-number replay (Table 1, Table 3, Fig. 8): tests/test_core.py
# ---------------------------------------------------------------------------

def test_table1_exact():
    t = replay.table1(beta=0.5)
    hi = t["hi"]
    assert hi.offloaded == 3550
    assert hi.misclassified == 1648
    assert abs(hi.accuracy - 0.8352) < 1e-12
    assert hi.cost == 3550 * 0.5 + 1648
    assert t["full_offload"].cost == 10_000 * 0.5 + 500
    assert t["no_offload"].cost == 3742
    ref = jreplay.table1(beta=0.5)
    for k, r in ref.items():
        assert t[k].row() == r.row()


def test_table1_cost_reduction_range():
    lo = replay.table1_cost_reduction(0.25)
    hi = replay.table1_cost_reduction(0.999)
    assert 13.0 < lo < 20.0
    assert 45.0 < hi < 52.0
    for beta in (0.25, 0.5, 0.999):
        assert replay.table1_cost_reduction(beta) == \
            jreplay.table1_cost_reduction(beta)


def test_table3_dog_filter():
    d = replay.DogReplay()
    assert d.n_offloaded == 4433
    assert abs(d.accuracy - 0.912) < 1e-12
    assert d.cost_hi(0.5) == 912 * 0.5 + 3521
    for beta in (0.01, 0.5, 0.99):
        assert 50.0 < d.cost_reduction(beta) < 61.0
        assert d.cost_reduction(beta) == \
            jreplay.DogReplay().cost_reduction(beta)


def test_fig8_headline_numbers():
    f = replay.fig8_hi_vs_full_offload(0.5)
    assert abs(f["latency_reduction_pct"] - 63.15) < 0.2   # paper: 63.15%
    assert abs(f["offload_reduction_pct"] - 64.45) < 0.2   # paper: 64.45%
    assert abs(f["hi_accuracy_pct"] - 83.52) < 1e-9
    assert f == jreplay.fig8_hi_vs_full_offload(0.5)


# ---------------------------------------------------------------------------
# cost model, calibration, reports
# ---------------------------------------------------------------------------

def test_cost_closed_form_matches_report():
    r = CostReport("x", 100, 30, 5, 2, beta=0.4)
    assert r.cost == cost_closed_form(30, 5, 2, 0.4)
    assert r.accuracy == 1 - 7 / 100
    assert r.row() == jcost.CostReport("x", 100, 30, 5, 2, beta=0.4).row()


def test_relative_cost_reduction():
    assert relative_cost_reduction(50, 100) == 50.0


def test_per_sample_and_total_cost_match_the_reference():
    rng = np.random.default_rng(2)
    off, s_ok, l_ok = (rng.random(257) < p for p in (0.4, 0.7, 0.95))
    got = per_sample_cost(*(torch.from_numpy(a) for a in (off, s_ok, l_ok)),
                          beta=0.3)
    want = jcost.per_sample_cost(jnp.asarray(off), jnp.asarray(s_ok),
                                 jnp.asarray(l_ok), 0.3)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    tot = total_cost(*(torch.from_numpy(a) for a in (off, s_ok, l_ok)), 0.3)
    np.testing.assert_allclose(
        float(tot), float(jcost.total_cost(jnp.asarray(off), jnp.asarray(s_ok),
                                           jnp.asarray(l_ok), 0.3)),
        rtol=1e-6)


def test_brute_force_theta_optimal():
    rng = np.random.default_rng(1)
    conf = rng.random(1000)
    s_ok = rng.random(1000) < conf
    th, c = calibrate.brute_force_theta(conf, s_ok, beta=0.3)
    grid = np.linspace(0, 1, 1001)
    naive = min(np.sum(np.where(conf < t, 0.3, 1.0 - s_ok)) for t in grid)
    assert c <= naive + 1e-9
    l_ok = rng.random(1000) < 0.9
    for l in (None, l_ok):
        assert calibrate.brute_force_theta(conf, s_ok, 0.3, l) == \
            jcal.brute_force_theta(conf, s_ok, 0.3, l)


def test_theta_extremes():
    conf = np.array([0.1, 0.9])
    th, _ = calibrate.brute_force_theta(conf, np.array([False, False]),
                                        beta=0.1)
    assert th > 0.9
    th, _ = calibrate.brute_force_theta(conf, np.array([True, True]), beta=0.9)
    assert th <= 0.1 + 1e-9


def test_cost_curve_and_histogram_match_the_reference():
    rng = np.random.default_rng(4)
    conf = rng.random(300)
    s_ok = rng.random(300) < conf
    l_ok = rng.random(300) < 0.9
    for a, b in ((calibrate.cost_curve(conf, s_ok, 0.4, l_ok),
                  jcal.cost_curve(conf, s_ok, 0.4, l_ok)),
                 (calibrate.p_histogram(conf, s_ok, 16),
                  jcal.p_histogram(conf, s_ok, 16))):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


def test_reports_match_the_reference():
    rng = np.random.default_rng(8)
    n = 200
    labels = rng.integers(0, 10, n)
    pred = np.where(rng.random(n) < 0.8, labels, (labels + 1) % 10)
    served = rng.random(n) < 0.3
    offl = served | (rng.random(n) < 0.1)
    got = metrics.hi_report(pred, pred, served, offl, labels, None, 0.5)
    want = jmetrics.hi_report(pred, pred, served, offl, labels, None, 0.5)
    assert got.row() == want.row()
    tm, jtm = TimingModel(), jbase.TimingModel()
    s_ok = rng.random(n) < 0.6
    b = metrics.baseline_report(tinyml(s_ok, tm), 0.5)
    assert b.row() == jmetrics.baseline_report(jbase.tinyml(s_ok, jtm),
                                               0.5).row()
    h = metrics.hi_baseline_result(got, tm)
    assert dataclasses.asdict(h) == dataclasses.asdict(
        jmetrics.hi_baseline_result(want, jtm))
    assert metrics.format_table([got, b]) == jmetrics.format_table(
        [want, jmetrics.baseline_report(jbase.tinyml(s_ok, jtm), 0.5)])


def test_temperature_scale():
    x = np.random.default_rng(0).normal(size=(3, 10)).astype(np.float32)
    for t in (0.5, 2.0, 0.0):
        np.testing.assert_array_equal(
            temperature_scale(torch.from_numpy(x), t).numpy(),
            np.asarray(jtemperature_scale(jnp.asarray(x), t)))


# ---------------------------------------------------------------------------
# baselines + timing model (Appendix tables)
# ---------------------------------------------------------------------------

def test_partitioning_always_worse_than_full_offload():
    for layer in range(1, 8):
        assert partition_per_sample_ms(layer) > partition_per_sample_ms(0)
        assert partition_per_sample_ms(layer) == \
            jbase.partition_per_sample_ms(layer)
    assert 600 < partition_per_sample_ms(1) < 660
    l_ok = np.ones(50, bool)
    for layer in (0, 3):
        assert dataclasses.asdict(baselines.dnn_partitioning(l_ok, layer)) \
            == dataclasses.asdict(jbase.dnn_partitioning(l_ok, layer))


def test_omd_balances_makespan():
    tm = TimingModel()
    s_ok = np.ones(1000, bool)
    l_ok = np.ones(1000, bool)
    r = omd(s_ok, l_ok, tm)
    k = r.n - r.n_offloaded
    assert abs(k * tm.t_local_ms - r.n_offloaded * tm.t_offload_ms) \
        <= max(tm.t_local_ms, tm.t_offload_ms) * 2


def test_oma_worst_case_is_worst():
    rng = np.random.default_rng(5)
    s_ok = rng.random(500) < 0.6
    l_ok = rng.random(500) < 0.95
    tm = TimingModel()
    budget = tm.hi_makespan_ms(500, 150)
    r_rand = oma(s_ok, l_ok, budget, tm)
    r_worst = oma(s_ok, l_ok, budget, tm, worst_case=True)
    assert r_worst.accuracy <= r_rand.accuracy + 0.02
    jtm = jbase.TimingModel()
    for got, want in ((r_rand, jbase.oma(s_ok, l_ok, budget, jtm)),
                      (r_worst, jbase.oma(s_ok, l_ok, budget, jtm,
                                          worst_case=True)),
                      (omd(s_ok, l_ok, tm), jbase.omd(s_ok, l_ok, jtm))):
        assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_tinyml_fastest_full_offload_most_accurate():
    rng = np.random.default_rng(6)
    s_ok = rng.random(500) < 0.6
    l_ok = rng.random(500) < 0.95
    tm = TimingModel()
    t = tinyml(s_ok, tm)
    f = full_offload(l_ok, tm)
    assert t.makespan_ms < f.makespan_ms
    assert f.accuracy > t.accuracy
    assert (baselines.T_LOCAL_MS, baselines.T_OFFLOAD_MS) == (0.99, 74.34)


# ---------------------------------------------------------------------------
# HICascade against the reference's
# ---------------------------------------------------------------------------

def test_cascade_full_and_never_offload_limits():
    rng = np.random.default_rng(3)
    x = torch.as_tensor(rng.normal(size=(32, 8)), dtype=torch.float32)
    ws = torch.as_tensor(rng.normal(size=(8, 10)), dtype=torch.float32)
    wl = torch.as_tensor(rng.normal(size=(8, 10)) * 10, dtype=torch.float32)

    def apply_fn(p, xx):
        return xx @ p

    c0 = classifier_cascade(apply_fn, apply_fn,
                            HIConfig(theta=0.0, capacity_factor=1.0))
    out0 = c0.infer(ws, wl, x)
    assert torch.equal(out0["pred"], out0["s_pred"])
    assert int(out0["n_offloaded"]) == 0
    c1 = classifier_cascade(apply_fn, apply_fn,
                            HIConfig(theta=1.1, capacity_factor=1.0))
    out1 = c1.infer(ws, wl, x)
    np.testing.assert_array_equal(out1["pred"].numpy(),
                                  (x @ wl).argmax(-1).numpy())
    assert int(out1["n_offloaded"]) == 32


def _theta_between(conf, q):
    """A theta between two neighbouring confidences near quantile q, with
    a gap far above CONF_TOL, so that no row sits at theta."""
    c = np.sort(conf)
    gaps = np.diff(c)
    i = int(q * len(c))
    while gaps[i] < 1e3 * CONF_TOL:
        i += 1
    return float((c[i] + c[i + 1]) / 2)


def _compare(jout, tout):
    for k in ("pred", "s_pred", "offload_mask", "served_remote"):
        np.testing.assert_array_equal(tout[k].numpy(), np.asarray(jout[k]),
                                      err_msg=k)
    assert int(tout["dropped"]) == int(jout["dropped"])
    assert int(tout["n_offloaded"]) == int(jout["n_offloaded"])
    np.testing.assert_allclose(tout["conf"].numpy(), np.asarray(jout["conf"]),
                               rtol=CONF_TOL, atol=CONF_TOL)


def _linear():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(48, 16)).astype(np.float32)
    ws = rng.normal(size=(16, 10)).astype(np.float32)
    wl = (rng.normal(size=(16, 10)) * 3).astype(np.float32)
    return (lambda p, xx: xx @ p), (lambda p, xx: xx @ p), ws, wl, x


def _cnn_params(cfg, seed):
    """(reference params as numpy, the port's tensors): drawn by the port's
    ``init_cnn`` in the reference's layout."""
    tp = cnn.init_cnn(torch.Generator().manual_seed(seed), cfg, device="cpu")
    return jax.tree.map(lambda t: t.numpy(), tp), tp


@pytest.fixture(scope="module")
def cifar():
    """SML_CIFAR / LML_CIFAR params in both packages, and 64 images of
    ``data/images``."""
    js, ts = _cnn_params(cnn.SML_CIFAR, 11)
    jl, tl = _cnn_params(cnn.LML_CIFAR, 12)
    x, _ = make_dataset(64, seed=3)
    return js, jl, ts, tl, x


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("head", ["linear", "cifar"])
def test_cascade_matches_the_reference(cifar, head, metric, use_kernel):
    if head == "linear":
        jsa, jla, jsp, jlp, x = _linear()
        tsa, tla = jsa, jla
        tsp, tlp = torch.from_numpy(jsp), torch.from_numpy(jlp)
        jsp, jlp = jnp.asarray(jsp), jnp.asarray(jlp)
    else:
        jsp, jlp, tsp, tlp, x = cifar
        jsa = lambda p, xx: jcnn.apply_cnn(p, jcnn.SML_CIFAR, xx)  # noqa: E731
        jla = lambda p, xx: jcnn.apply_cnn(p, jcnn.LML_CIFAR, xx)  # noqa: E731
        tsa = lambda p, xx: cnn.apply_cnn(p, cnn.SML_CIFAR, xx)    # noqa: E731
        tla = lambda p, xx: cnn.apply_cnn(p, cnn.LML_CIFAR, xx)    # noqa: E731
    # theta inside the S tier's confidences, capacity under the offloads:
    # both branches of the rule run and the router drops escalations
    probe = jcascade(jsa, jla, JHIConfig(metric=metric, theta=0.5))
    conf = np.asarray(probe.infer(jsp, jlp, jnp.asarray(x))["conf"])
    theta = _theta_between(conf, 0.7)
    jc = jcascade(jsa, jla, JHIConfig(metric=metric, theta=theta,
                                      capacity_factor=0.5),
                  use_kernel=use_kernel)
    tc = classifier_cascade(tsa, tla, HIConfig(metric=metric, theta=theta,
                                               capacity_factor=0.5),
                            use_kernel=use_kernel)
    jout = jc.infer(jsp, jlp, jnp.asarray(x))
    tout = tc.infer(tsp, tlp, torch.from_numpy(x))
    _compare(jout, tout)
    n_off = int(tout["n_offloaded"])
    assert 0 < n_off < len(x) and int(tout["dropped"]) > 0
    assert set(tout) == set(jout)


def test_binary_relevance_follows_the_oracle():
    """SML_BINARY under the §5 rule (offload iff p >= theta): the port
    scores a one-logit head with the sigmoid on both paths, equal to the
    reference's oracle path.  The reference's kernel path gives every row
    confidence 1.0 there (a softmax over one column), so it offloads every
    sample: recorded here as the reference's fault (ROADMAP Queue C)."""
    jp, tp = _cnn_params(cnn.SML_BINARY, 5)
    x, _ = make_dataset(48, seed=4)
    japply = lambda p, xx: jcnn.apply_cnn(p, jcnn.SML_BINARY, xx)  # noqa: E731
    tapply = lambda p, xx: cnn.apply_cnn(p, cnn.SML_BINARY, xx)    # noqa: E731
    conf = np.asarray(jax.nn.sigmoid(japply(jp, jnp.asarray(x)))[:, 0])
    theta = _theta_between(conf, 0.5)
    hi = dict(theta=theta, capacity_factor=1.0, binary_relevance=True)
    joracle = jcascade(japply, japply, JHIConfig(**hi)).infer(
        jp, jp, jnp.asarray(x))
    for use_kernel in (False, True):
        tout = HICascade(tapply, tapply, HIConfig(**hi),
                         use_kernel=use_kernel).infer(tp, tp,
                                                      torch.from_numpy(x))
        _compare(joracle, tout)
    assert 0 < int(joracle["n_offloaded"]) < len(x)
    jkernel = jcascade(japply, japply, JHIConfig(**hi),
                       use_kernel=True).infer(jp, jp, jnp.asarray(x))
    assert (np.asarray(jkernel["conf"]) == 1.0).all()
    assert int(jkernel["n_offloaded"]) == len(x)
