"""Test harness configuration (SURVEY.md §5).

Tests run on the CPU unless ``JAX_PLATFORMS`` says otherwise, with 8 forced
host devices so mesh/collective code paths (shard_map, psum, ppermute)
execute as on a multi-card host (SURVEY.md §5.4).  Tests marked ``gpu``
need a card; on a GPU machine run them with

    JAX_PLATFORMS=cuda,cpu python -m pytest tests/ -m gpu

Everywhere else the ``gpu_device`` fixture skips them.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

if not os.environ.get("JAX_PLATFORMS"):
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)

import pytest  # noqa: E402


@pytest.fixture
def gpu_device():
    """JAX's default device; skips the test unless it is a GPU."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU; JAX's default device is {dev.platform}")
    return dev
