"""Test configuration: run the suite on a virtual 8-device CPU mesh.

Multi-device sharding paths are validated without accelerators by forcing
the host platform to expose 8 devices (the standard JAX substitute for a
distributed test rig).  Tests that need a GPU carry the ``gpu`` marker and
skip inside a fixture; ``python chip_smoke.py`` runs their phases on the
card.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402
import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a GPU; skipped (in a fixture) elsewhere")


@pytest.fixture
def key():
    return jax.random.PRNGKey(42)


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """Cap the suite's peak memory: 300+ tests accumulate gigabytes of
    compiled executables, and XLA's CPU compiler has been observed to
    segfault (intermittently, always late in the suite) when compiling
    large shard_map programs under that pressure.  Compilation caching
    still applies within each test module."""
    yield
    jax.clear_caches()
