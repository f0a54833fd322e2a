"""Test harness configuration.

Runs the whole suite on a virtual 8-device CPU mesh with float64 enabled -
the "distributed without a cluster" mechanism (SURVEY.md section 4): the same
mesh/sharding code paths that run on a multi-GPU host execute here on host
CPU devices, and float64 matches the precision regime the upstream accuracy
numbers were recorded in. No test needs a GPU; ``python chip_smoke.py`` is
the run on the card.

Must run before anything imports jax, hence environment variables at module
import time.
"""

import os

# Force the CPU both in the environment and via jax.config below (the config
# wins over whatever platform the environment names).
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import pytest  # noqa: E402


@pytest.fixture(scope="session")
def eight_devices():
    devs = jax.devices()
    assert len(devs) >= 8, f"expected >=8 virtual CPU devices, got {len(devs)}"
    return devs[:8]
