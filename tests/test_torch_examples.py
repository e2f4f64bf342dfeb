"""The paper's five applications on the port (``examples/*_torch.py``), each
at its smallest settings on the CPU, in torch only: no example runs in JAX.

Their deterministic numbers are held against the reference's ``core``
functions on the port's own outputs: calibrated theta and its cost, the
router's served set and the cost model (quickstart); the latency model
(serve_cascade); the threshold S-ML's offloads and the bandwidth
(fault detection); theta*, the p-histogram, the Table 1 rows and the
replayed sweep (image classification); the Table 3 reductions and the
replayed counts (dog filter).  The data generators are the reference's bit
for bit (``tests/test_torch_cnn.py``), so the reference's generators give
the same samples.
"""
import importlib.util
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import replay as jreplay
from repro.core.baselines import TimingModel as JTimingModel
from repro.core.calibrate import brute_force_theta as jbrute_force_theta
from repro.core.calibrate import p_histogram as jp_histogram
from repro.core.confidence import confidence as jconfidence
from repro.core.cost import cost_closed_form as jcost_closed_form
from repro.core.metrics import hi_report as jhi_report
from repro.core.router import route as jroute
from repro.data import vibration as jvib

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"


def _example(name):
    spec = importlib.util.spec_from_file_location(
        f"{name}_torch", EXAMPLES / f"{name}_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True, scope="module")
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


def test_no_torch_example_imports_jax():
    """The examples run on the card, where there is no jax."""
    for f in sorted(EXAMPLES.glob("*_torch.py")):
        src = f.read_text()
        assert "import jax" not in src and "from repro." not in src and \
            "import repro." not in src, f
    assert len(list(EXAMPLES.glob("*_torch.py"))) == 5


def test_quickstart(capsys):
    out = _example("quickstart").main(device="cpu")
    ref_conf = np.asarray(jconfidence(jnp.asarray(out["logits"])))
    np.testing.assert_allclose(out["conf"], ref_conf, rtol=0, atol=1e-6)
    theta, cost = jbrute_force_theta(out["conf"], out["s_correct"], beta=0.4)
    assert (out["theta"], out["cost"]) == (float(theta), float(cost))
    offload = jnp.asarray(out["conf"] < out["theta"])
    d = jroute(offload, jnp.asarray(out["conf"]), 600)
    np.testing.assert_array_equal(np.asarray(d.served_remote), out["served"])
    assert out["dropped"] == int(d.dropped)
    wrong = int((~out["s_correct"] & ~out["served"]).sum())
    assert out["total_cost"] == jcost_closed_form(int(out["served"].sum()),
                                                  wrong, 0, beta=0.4)
    assert "calibrated theta*" in capsys.readouterr().out


@pytest.mark.parametrize("stream", [False, True])
def test_serve_cascade(stream):
    out = _example("serve_cascade").main(requests=8, batch=4,
                                         max_new_tokens=2, stream=stream,
                                         device="cpu")
    s = out["summary"]
    assert s["requests"] == 8 and 0 <= s["offloaded"] <= 8
    tm = JTimingModel(t_local_ms=out["per_s_ms"], t_offload_ms=out["per_l_ms"])
    assert out["hi_ms"] == pytest.approx(
        tm.hi_makespan_ms(s["requests"], int(s["offloaded"])), rel=1e-12)
    assert out["full_ms"] == pytest.approx(8 * out["per_l_ms"], rel=1e-12)


def test_fault_detection():
    out = _example("fault_detection").main(windows_per_state=8, epochs=1,
                                           device="cpu")
    _, y_op, means_op = jvib.make_dataset(windows_per_state=40, seed=2,
                                          normal_fraction=0.98)
    offload = jvib.threshold_sml(means_op, 0.07)
    np.testing.assert_array_equal(out["offload"], offload)
    assert out["full_bw"] == jvib.bandwidth_required(num_machines=100)
    assert out["missed"] == int((~offload & (y_op != 0)).sum())
    assert out["sml_acc"] == 1.0                 # the paper's 100%
    assert 0.0 <= out["cnn_acc"] <= 1.0


def test_image_classification():
    out = _example("image_classification_hi").main(
        device="cpu", n_train=256, n_val=200, n_test=200, epochs_s=1,
        epochs_l=1)
    s_ok = out["s_logits_va"].argmax(-1) == out["y_va"]
    theta, _ = jbrute_force_theta(out["conf_va"], s_ok, 0.5)
    assert out["theta"] == float(theta)
    ref_hist = jp_histogram(out["conf_va"], s_ok, bins=10)
    for k in ("edges", "correct", "incorrect"):
        np.testing.assert_array_equal(out["hist"][k], ref_hist[k])
    c = out["cascade"]
    ref = jhi_report(c["pred"], c["s_pred"], c["served_remote"],
                     c["offload_mask"], out["y_te"], None, 0.5)
    rep_no, rep_full, rep_hi = out["reports"]
    assert (rep_hi.n, rep_hi.offloaded, rep_hi.wrong_local,
            rep_hi.wrong_remote, rep_hi.cost) == \
        (ref.n, ref.offloaded, ref.wrong_local, ref.wrong_remote, ref.cost)
    assert rep_full.misclassified == int((out["l_pred"] != out["y_te"]).sum())
    for b, (_, paper) in out["sweep"].items():
        t = jreplay.table1(b)
        assert paper == (1 - t["hi"].cost / t["full_offload"].cost) * 100


def test_dog_filter():
    out = _example("dog_filter_hi").main(device="cpu", sizes=(256, 300, 1))
    for beta, r in out["reduction"].items():
        hi_c = out["tp"] * beta + out["fp"]
        full_c = out["n_dogs"] * beta + (300 - out["n_dogs"])
        assert r == 1 - hi_c / full_c
        assert out["replayed"][beta] == jreplay.DogReplay().cost_reduction(
            beta)
    assert out["tp"] + out["fn"] == out["n_dogs"]
    assert int(out["offload"].sum()) == out["tp"] + out["fp"]
