"""Test configuration: simulate an 8-device CPU mesh so data-parallel
sharding logic (psum merges, shard_map specs) is exercised without
several GPUs.  Must run before jax initializes a backend."""

import os

# force CPU even where a GPU is present: unit tests must be hermetic and
# exercise the virtual multi-device mesh; naming cpu here is also what
# lets the device engines run on JAX's CPU backend (utils/device.py)
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(0xBEEF)
