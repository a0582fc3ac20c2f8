"""Test config: the tests run on JAX's CPU backend with 8 virtual devices,
so the sharded device paths run without an accelerator (chip_smoke.py runs
them on the GPU). The platform is pinned through jax.config before any
backend use, which is also how the device engine's guard sees that the CPU
was asked for explicitly.
"""

import os

# probe results must not leak between the CPU-pinned test config and real
# device runs (the cache keys on env, and tests override via jax.config)
os.environ["HIPHASE_PROBE_CACHE"] = "0"

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)

import pathlib

import pytest

REFERENCE_TEST_DATA = pathlib.Path("/root/reference/test_data")


@pytest.fixture(scope="session")
def ref_test_data():
    return REFERENCE_TEST_DATA
