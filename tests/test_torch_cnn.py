"""The port's CNNs (``repro_torch.models.cnn``), its copies of the synthetic
data generators, and the bridge's lists, against the reference.

``apply_cnn`` is compared at batch 4, on the same params in the reference's
layout, to 1e-5: both compute float32 convolutions and products whose sums
differ in order only.  The generators are numpy, seeded, and must give
the same arrays bit for bit.
"""
import jax
import numpy as np
import pytest
import torch

from repro.data import images as jimages
from repro.data import vibration as jvibration
from repro.models import cnn as jcnn
from repro_torch.bridge import params_from_numpy
from repro_torch.data import images, vibration
from repro_torch.models import cnn

LOGIT_TOL = 1e-5
CONFIGS = ("SML_CIFAR", "LML_CIFAR", "FAULT_CNN", "SML_BINARY")


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_shapes(v) for v in tree]
    return tuple(tree.shape)


@pytest.mark.parametrize("name", CONFIGS)
def test_apply_cnn_matches_the_reference(name):
    """Params in the reference's layout (drawn by the port's ``init_cnn``,
    handed to the reference as numpy, and back through the bridge)."""
    jcfg, tcfg = getattr(jcnn, name), getattr(cnn, name)
    assert jcfg.__dict__ == tcfg.__dict__
    gp = cnn.init_cnn(torch.Generator().manual_seed(CONFIGS.index(name)),
                      tcfg, device="cpu")
    jp = jax.tree.map(lambda t: t.numpy(), gp)
    # the reference's init: the same nesting, shapes and dtypes
    jshape = jax.eval_shape(lambda k: jcnn.init_cnn(k, jcfg),
                            jax.random.PRNGKey(0))
    assert _shapes(jshape) == _shapes(gp)
    assert jax.tree.structure(jshape) == jax.tree.structure(jp)
    tp = params_from_numpy(jp, device="cpu")
    x = np.random.default_rng(1).normal(
        size=(4,) + tuple(jcfg.in_shape)).astype(np.float32)
    want = np.asarray(jax.jit(lambda p, xx: jcnn.apply_cnn(p, jcfg, xx))(
        jp, x))
    got = cnn.apply_cnn(tp, tcfg, torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=LOGIT_TOL,
                               atol=LOGIT_TOL)
    assert cnn.num_params(tp) == jcnn.num_params(jp)
    assert cnn.model_size_mb(tp) == jcnn.model_size_mb(jp)
    # the reference's scales: normal / sqrt(fan_in), zero biases
    for leaf in jax.tree.leaves(gp):
        if leaf.ndim > 1:
            fan_in = int(np.prod(leaf.shape[:-1]))
            assert 0.8 < float(leaf.std()) * fan_in ** 0.5 < 1.2
        else:
            assert not leaf.any()


def test_init_cnn_is_seeded():
    a = cnn.init_cnn(torch.Generator().manual_seed(3), cnn.SML_CIFAR, "cpu")
    b = cnn.init_cnn(torch.Generator().manual_seed(3), cnn.SML_CIFAR, "cpu")
    assert torch.equal(a["head"]["w"], b["head"]["w"])
    assert torch.equal(a["convs"][0]["w"], b["convs"][0]["w"])


@pytest.mark.parametrize("seed", [0, 7])
def test_images_match_the_reference_bit_for_bit(seed):
    x, y = images.make_dataset(96, seed=seed)
    jx, jy = jimages.make_dataset(96, seed=seed)
    assert x.dtype == jx.dtype and y.dtype == jy.dtype
    np.testing.assert_array_equal(x, jx)
    np.testing.assert_array_equal(y, jy)
    np.testing.assert_array_equal(images.binary_labels(y),
                                  jimages.binary_labels(jy))


@pytest.mark.parametrize("seed", [0, 7])
def test_vibration_matches_the_reference_bit_for_bit(seed):
    got = vibration.make_dataset(2, seed=seed, normal_fraction=0.5)
    want = jvibration.make_dataset(2, seed=seed, normal_fraction=0.5)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(vibration.threshold_sml(got[2]),
                                  jvibration.threshold_sml(want[2]))
    assert vibration.bandwidth_required(100) == \
        jvibration.bandwidth_required(100)


def test_bridge_maps_lists_and_keeps_dtypes():
    import ml_dtypes
    tree = {"convs": [{"w": np.ones((3, 3, 1, 2), np.float32),
                       "b": np.zeros((2,), ml_dtypes.bfloat16)},
                      {"w": np.arange(4, dtype=np.int8)}],
            "head": {"w": np.full((2, 2), 3, np.int32)}}
    out = params_from_numpy(tree, device="cpu")
    assert isinstance(out["convs"], list) and len(out["convs"]) == 2
    assert out["convs"][0]["w"].dtype == torch.float32
    assert out["convs"][0]["b"].dtype == torch.bfloat16
    assert out["convs"][1]["w"].dtype == torch.int8
    assert out["head"]["w"].dtype == torch.int32
    np.testing.assert_array_equal(out["convs"][1]["w"].numpy(),
                                  np.arange(4))
