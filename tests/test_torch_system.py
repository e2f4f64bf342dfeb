"""``tests/test_system.py``'s five end-to-end cases on the port: the paper's
central claims on the synthetic reproductions of its three use cases, with
the tiers trained by the port's ``train_cnn`` (torch, on the CPU here), at
the reference's sizes (5,000 / 1,200 images, 2 / 4 epochs, batch 128).

Nothing here trains in JAX (the reference's fixture takes ~100 s of the
test budget).  The deterministic steps are held against the reference's
``core`` on the port's own logits: ``brute_force_theta`` gives the same
theta, and the data generators are the reference's bit for bit
(``tests/test_torch_cnn.py``).
"""
import numpy as np
import pytest
import torch

from repro.core.calibrate import brute_force_theta as jbrute_force_theta
from repro_torch.configs.base import HIConfig
from repro_torch.core.calibrate import brute_force_theta
from repro_torch.core.cascade import classifier_cascade
from repro_torch.core.confidence import confidence
from repro_torch.data import images, vibration as vib
from repro_torch.models import cnn
from repro_torch.serving.engine import disable_tf32
from repro_torch.training.cnn_trainer import (accuracy, predict_logits,
                                              train_cnn)


@pytest.fixture(scope="module")
def tiers():
    """Quickly-trained S/L CNNs on the CIFAR-10 stand-in (module-scoped),
    on a few intra-op threads (the workers share the machine); the
    caller's thread count is restored."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    disable_tf32()
    try:
        x_tr, y_tr = images.make_dataset(5000, seed=0, patch_amp=0.7)
        x_te, y_te = images.make_dataset(1200, seed=5, patch_amp=0.7)
        ps = train_cnn(cnn.SML_CIFAR, x_tr, y_tr, epochs=2, batch=128,
                       device="cpu")
        pl = train_cnn(cnn.LML_CIFAR, x_tr, y_tr, epochs=4, batch=128,
                       device="cpu")
        yield ps, pl, x_te, y_te
    finally:
        torch.set_num_threads(n)


def test_sml_worse_than_lml(tiers):
    ps, pl, x_te, y_te = tiers
    s_acc = accuracy(ps, cnn.SML_CIFAR, x_te, y_te)
    l_acc = accuracy(pl, cnn.LML_CIFAR, x_te, y_te)
    assert l_acc > s_acc + 0.03, (s_acc, l_acc)
    assert s_acc > 0.4          # better than chance by far


def test_confidence_correlates_with_correctness(tiers):
    """The property HI relies on (paper Fig. 6): high-p samples are right
    more often than low-p samples."""
    ps, _, x_te, y_te = tiers
    logits = predict_logits(ps, cnn.SML_CIFAR, x_te)
    conf = confidence(torch.as_tensor(logits)).numpy()
    ok = logits.argmax(-1) == y_te
    hi_mask = conf >= np.median(conf)
    assert ok[hi_mask].mean() > ok[~hi_mask].mean() + 0.1


def test_hi_beats_both_extremes_on_cost(tiers):
    """Paper Table 1 structure: with calibrated theta*, HI cost < full-offload
    cost and <= no-offload cost for mid-range beta; accuracy lands between.
    theta* is the reference's on the same confidences."""
    ps, pl, x_te, y_te = tiers
    beta = 0.5
    s_logits = predict_logits(ps, cnn.SML_CIFAR, x_te)
    l_logits = predict_logits(pl, cnn.LML_CIFAR, x_te)
    conf = confidence(torch.as_tensor(s_logits)).numpy()
    s_ok = s_logits.argmax(-1) == y_te
    l_ok = l_logits.argmax(-1) == y_te
    theta, cost = brute_force_theta(conf, s_ok, beta, l_correct=l_ok)
    jtheta, jcost = jbrute_force_theta(conf, s_ok, beta, l_correct=l_ok)
    assert float(theta) == float(jtheta) and float(cost) == float(jcost)

    hi = HIConfig(theta=float(theta), capacity_factor=1.0)
    casc = classifier_cascade(
        lambda p, x: cnn.apply_cnn(p, cnn.SML_CIFAR, x),
        lambda p, x: cnn.apply_cnn(p, cnn.LML_CIFAR, x), hi)
    with torch.no_grad():
        out = casc.infer(ps, pl, torch.as_tensor(x_te))
    pred = out["pred"].numpy()
    served = out["served_remote"].numpy()
    n = len(y_te)

    hi_wrong = (pred != y_te)
    hi_cost = served.sum() * beta + hi_wrong.sum()
    full_cost = n * beta + (~l_ok).sum()
    local_cost = (~s_ok).sum()
    assert hi_cost < full_cost, (hi_cost, full_cost)
    assert hi_cost <= local_cost + 1e-9, (hi_cost, local_cost)

    hi_acc = (pred == y_te).mean()
    assert s_ok.mean() - 0.02 <= hi_acc <= l_ok.mean() + 0.02
    assert 0.0 < served.mean() < 1.0          # a genuine cascade


def _balanced_binary(x, y, seed=0):
    """Oversample the positive class to 50% (the filter must be trained
    recall-oriented; with a 10% prior the tiny net collapses to majority)."""
    b = images.binary_labels(y)
    pos = np.flatnonzero(b == 1)
    neg = np.flatnonzero(b == 0)
    rng = np.random.default_rng(seed)
    pos_up = rng.choice(pos, size=len(neg), replace=True)
    idx = rng.permutation(np.concatenate([pos_up, neg]))
    return x[idx], b[idx]


def test_binary_filter_use_case(tiers):
    """§5 structure: relevance filter keeps most dogs, drops most non-dogs."""
    _, _, x_te, y_te = tiers
    x_tr, y_tr = images.make_dataset(2500, seed=1, patch_amp=0.7)
    xb, bb = _balanced_binary(x_tr, y_tr)
    pb = train_cnn(cnn.SML_BINARY, xb, bb, epochs=2, device="cpu")
    p = 1 / (1 + np.exp(-predict_logits(pb, cnn.SML_BINARY, x_te)[:, 0]))
    offload = p >= 0.5
    dogs = images.binary_labels(y_te) == 1
    recall = (offload & dogs).sum() / max(dogs.sum(), 1)
    offload_frac = offload.mean()
    assert recall > 0.6, (recall, offload_frac)
    assert offload_frac < 0.6          # most irrelevant images stay local


def test_reb_end_to_end():
    """§3: threshold S-ML separates perfectly; HI saves ~all bandwidth when
    machines are mostly normal."""
    _, labels, means = vib.make_dataset(25, seed=11, normal_fraction=0.95)
    offload = vib.threshold_sml(means, 0.07)
    assert (offload == (labels != 0)).all()
    assert offload.mean() < 0.2
