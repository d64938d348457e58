"""Test harness: the CPU backend with 8 virtual devices, before JAX import.

Sharding correctness is tested on the virtual CPU mesh
(xla_force_host_platform_device_count).  JAX_PLATFORMS, when set, names
another backend: tests marked ``gpu`` run only where JAX finds an NVIDIA
GPU (``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/`` on the card)
and skip elsewhere.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if (os.environ["JAX_PLATFORMS"] == "cpu"
        and "xla_force_host_platform_device_count" not in flags):
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax
import numpy as np
import pytest


@pytest.fixture(autouse=True)
def _gpu_only(request):
    """Skip ``gpu``-marked tests unless JAX's backend is a GPU; decided
    per test, never at import, so every worker collects the same tests."""
    if (request.node.get_closest_marker("gpu")
            and jax.default_backend() != "gpu"):
        pytest.skip("needs an NVIDIA GPU (run on the card: "
                    "JAX_PLATFORMS=cuda python -m pytest -m gpu tests/)")


@pytest.fixture
def rng():
    return np.random.default_rng(12345)


REFERENCE = "/root/reference"


def reference_available() -> bool:
    return os.path.isdir(REFERENCE)


requires_reference = pytest.mark.skipif(
    not reference_available(), reason="reference tree not mounted")
