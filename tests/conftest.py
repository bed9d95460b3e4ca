"""Test configuration: run on a virtual 8-device CPU mesh.

Multi-device logic is validated without accelerators via
xla_force_host_platform_device_count (SURVEY.md §4 item 6: the reference
tests Flight client+server in one process; we test mesh collectives on
virtual devices the same way). Env must be set before jax imports.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
)
os.environ.setdefault("JAX_ENABLE_X64", "1")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(42)
