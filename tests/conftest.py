"""Test configuration: run everything on a virtual 8-device CPU mesh.

This is the "multi-node without a cluster" mechanism (SURVEY.md §4): sharding
tests exercise real collectives over 8 XLA host devices. Must run before any
JAX backend client is created.
"""

import os

os.environ["XLA_FLAGS"] = (
    "--xla_force_host_platform_device_count=8 " + os.environ.get("XLA_FLAGS", "")
)

import jax
import pytest

# Tests are hermetic and run on the CPU even on a GPU host. Tests that need
# the card are marked `gpu` and take the `gpu` fixture, which skips unless
# JAX sees a GPU; on the card run them with
#   JAX_PLATFORMS=cuda,cpu python -m pytest tests/ -m gpu
jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS") or "cpu")


@pytest.fixture
def gpu():
    """The first GPU device; skips the test when JAX sees none."""
    try:
        return jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("needs a CUDA GPU (compiled Pallas kernel); "
                    "chip_smoke.py runs this check on the card")
