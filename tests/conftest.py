"""Shared fixtures.  NOTE: no unconditional XLA_FLAGS here — tests must see
the real 1-device CPU by default; only launch/dryrun.py forces 512 host
devices.

Opt-in multi-device CPU (mesh tests): setting ``REPRO_MULTI_DEVICE=1`` in the
environment forces 8 host devices BEFORE the first jax import, so data>1
serving meshes are constructible in plain CPU CI.  Tests that need it either
run in a subprocess that sets the variable themselves (the established
tests/test_tier_split.py pattern) or are launched under
``REPRO_MULTI_DEVICE=1 pytest -m multi_device``.
"""
import os

if os.environ.get("REPRO_MULTI_DEVICE") == "1":
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402  (XLA_FLAGS must be set before this import)
import numpy as np  # noqa: E402
import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "multi_device: needs >1 CPU devices (run under REPRO_MULTI_DEVICE=1)")
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card (tests/test_torch_cuda.py)")


def pytest_collection_modifyitems(config, items):
    if len(jax.devices()) > 1:
        return
    skip = pytest.mark.skip(
        reason="needs multiple devices: run under REPRO_MULTI_DEVICE=1")
    for item in items:
        if "multi_device" in item.keywords:
            item.add_marker(skip)


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


@pytest.fixture(scope="session")
def key():
    return jax.random.PRNGKey(0)
