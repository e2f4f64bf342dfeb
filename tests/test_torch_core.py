"""The port's decision pipeline (confidence -> policy -> router) against the
JAX reference on the same numpy inputs, plus the reference's own router and
policy cases re-stated against the port."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.confidence import confidence as jconfidence
from repro.core import policy as jpol
from repro.core import router as jrouter
from repro_torch.core import confidence as tconf
from repro_torch.core import policy as tpol
from repro_torch.core import router as trouter

RNG = np.random.default_rng(11)
# float32 softmax statistics on identical inputs; only reduction order differs
CONF_TOL = 1e-6


@pytest.mark.parametrize("metric", ["max_prob", "margin", "entropy"])
@pytest.mark.parametrize("shape", [(16, 10), (4, 3, 512), (5, 1)])
def test_confidence_matches_reference(metric, shape):
    x = (RNG.normal(size=shape) * 3).astype(np.float32)
    got = tconf.confidence(torch.as_tensor(x), metric).numpy()
    want = np.asarray(jconfidence(jnp.asarray(x), metric))
    np.testing.assert_allclose(got, want, rtol=CONF_TOL, atol=CONF_TOL)
    assert got.shape == shape[:-1] and ((got >= 0) & (got <= 1)).all()


def test_confidence_unknown_metric_raises():
    with pytest.raises(ValueError):
        tconf.confidence(torch.zeros(2, 4), "bogus")


def _route_both(mask, conf, cap):
    jd = jrouter.route(jnp.asarray(mask), jnp.asarray(conf, jnp.float32), cap)
    td = trouter.route(torch.as_tensor(mask),
                       torch.as_tensor(np.asarray(conf, np.float32)), cap)
    return jd, td


def _assert_same_decision(jd, td):
    for name in trouter.RouteDecision._fields:
        np.testing.assert_array_equal(getattr(td, name).numpy(),
                                      np.asarray(getattr(jd, name)), name)


@pytest.mark.parametrize("cap", [1, 3, 5, 8])
def test_route_matches_reference_random(cap):
    conf = RNG.random(8).astype(np.float32)
    mask = conf < 0.6
    _assert_same_decision(*_route_both(mask, conf, cap))


def test_route_tie_order_matches_lax_top_k():
    """lax.top_k breaks ties toward the lower index, torch.topk does not;
    the port's stable sort must pick [4, 0, 2, 3] here."""
    prio = np.asarray([-.3, -.5, -.3, -.3, 1.2, -.3, -.3, -.3], np.float32)
    mask = prio > 0                    # row 4 offloads: prio = 2 - conf
    conf = np.where(mask, 2.0 - prio, -prio).astype(np.float32)
    jd, td = _route_both(mask, conf, 4)
    assert td.indices.tolist() == [4, 0, 2, 3]
    _assert_same_decision(jd, td)


def test_route_padded_rows_tie_like_reference():
    """The batcher fills empty rows with identical pad prompts, which get
    identical confidences: every padded row ties."""
    conf = np.asarray([0.3, 0.7, 0.2, 0.9, 0.4, 0.4, 0.4, 0.4], np.float32)
    for theta in (0.35, 0.5, 1.0):
        for cap in (2, 4, 6):
            _assert_same_decision(*_route_both(conf < theta, conf, cap))


def test_route_respects_capacity_and_priority():
    conf = torch.tensor([0.1, 0.9, 0.2, 0.8, 0.05])
    d = trouter.route(conf < 0.5, conf, capacity=2)
    assert int(d.valid.sum()) == 2 and int(d.dropped) == 1
    assert d.dropped.dtype == torch.int32
    assert set(d.indices[d.valid].tolist()) == {0, 4}
    with pytest.raises(ValueError):
        trouter.route(conf < 0.5, conf, capacity=0)


def test_scatter_merge_gather_agreement_match_reference():
    conf = np.asarray([0.1, 0.9, 0.2, 0.05, 0.7, 0.3], np.float32)
    mask = conf < 0.5
    jd, td = _route_both(mask, conf, 3)
    s_out = RNG.integers(0, 50, (6, 4)).astype(np.int32)
    l_out = RNG.integers(0, 50, (3, 4)).astype(np.int32)
    l_out[0] = s_out[int(td.indices[0])]           # one agreeing slot
    ts, tl = torch.as_tensor(s_out), torch.as_tensor(l_out)
    np.testing.assert_array_equal(
        trouter.scatter_merge(ts, tl, td).numpy(),
        np.asarray(jrouter.scatter_merge(jnp.asarray(s_out),
                                         jnp.asarray(l_out), jd)))
    np.testing.assert_array_equal(
        trouter.gather(ts, td).numpy(),
        np.asarray(jrouter.gather(jnp.asarray(s_out), jd)))
    agree = trouter.agreement(ts, tl, td)
    np.testing.assert_array_equal(
        agree.numpy(), np.asarray(jrouter.agreement(jnp.asarray(s_out),
                                                    jnp.asarray(l_out), jd)))
    assert bool(agree[0])
    # not offloaded -> untouched
    merged = trouter.scatter_merge(ts, tl, td)
    assert torch.equal(merged[~td.served_remote], ts[~td.served_remote])


@pytest.mark.parametrize("batch", [1, 4, 7, 8, 33])
@pytest.mark.parametrize("factor", [0.0, 0.25, 0.5, 1.0, 2.0])
def test_capacity_for_matches_reference(batch, factor):
    assert trouter.capacity_for(batch, factor) == \
        jrouter.capacity_for(batch, factor)


def test_threshold_policies():
    conf = torch.tensor([0.59, 0.6, 0.61])
    assert tpol.ThresholdPolicy(theta=0.6).offload(conf).tolist() == \
        [True, False, False]
    conf = torch.tensor([0.49, 0.5, 0.9])
    assert tpol.BinaryRelevancePolicy(theta=0.5).offload(conf).tolist() == \
        [False, True, True]
    assert tpol.AlwaysOffload().offload(conf).all()
    assert not tpol.NeverOffload().offload(conf).any()


def test_online_policy_matches_reference_and_converges():
    rng = np.random.default_rng(0)
    conf = rng.random(800)
    for ok in (np.ones_like(conf, bool), np.zeros_like(conf, bool),
               rng.random(800) < 0.5):
        p = tpol.OnlineThresholdPolicy(beta=0.2, grid=64, eta_lr=0.3)
        r = jpol.OnlineThresholdPolicy(beta=0.2, grid=64, eta_lr=0.3)
        p.update(conf, ok)
        r.update(conf, ok)
        assert p.history == r.history
        np.testing.assert_array_equal(p.w, r.w)
    always_right = tpol.OnlineThresholdPolicy(beta=0.2, grid=64, eta_lr=0.3)
    always_right.update(conf, np.ones_like(conf, bool))
    assert always_right.theta < 0.25
    always_wrong = tpol.OnlineThresholdPolicy(beta=0.2, grid=64, eta_lr=0.3)
    always_wrong.update(conf, np.zeros_like(conf, bool))
    assert always_wrong.theta > 0.75
