"""Test configuration: CPU backend with 8 virtual devices.

The reference has no test suite at all (SURVEY §4); our strategy is
(a) per-stage unit tests on synthetic images with known structure,
(b) oracle parity tests against plain-numpy re-implementations
    (pano/oracles.py),
(c) quality gates on seeded scenes whose true geometry is known
    (pano/scenes.py),
(d) multi-device paths on a fake 8-device CPU mesh — the standard JAX
    answer to testing sharding without hardware.

Tests that need a GPU carry the `gpu` marker and take the `gpu_device`
fixture, which skips them unless JAX sees a GPU. Run them on a GPU machine
with the CPU default lifted:
    JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/

Env vars must be set before jax initializes, hence this top-level block.
"""

import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(1234)


@pytest.fixture
def gpu_device():
    """The first GPU; skips the test when JAX sees none (decided when the
    test runs, never at import, so every xdist worker collects the same
    tests)."""
    devices = jax.devices()
    if devices[0].platform != "gpu":
        pytest.skip(f"needs a GPU; JAX sees {devices[0].platform!r}")
    return devices[0]


@pytest.fixture
def cpu_as_accelerator(monkeypatch):
    """Run the accelerator impls (`gpu`, `sharded`) on the CPU devices:
    CPU tests of those code paths patch the one device-choice module."""
    from pano import device

    monkeypatch.setattr(device, "accelerators", lambda: jax.devices("cpu"))
    monkeypatch.setattr(device, "accelerator", lambda: jax.devices("cpu")[0])


def synthetic_pair(h=96, w=128, shift=32, seed=0):
    """A translated pair with rich texture: right = left shifted `shift` px.

    Ground-truth homography right->left is a pure translation by +shift in x.
    """
    r = np.random.default_rng(seed)
    base = r.integers(0, 256, (h, w + shift, 3), dtype=np.uint8)
    left = base[:, :w]
    right = base[:, shift:]
    return left.copy(), right.copy()


@pytest.fixture
def translated_pair():
    return synthetic_pair()
