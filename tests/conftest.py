"""Test configuration: run everything on a virtual 8-device CPU mesh.

Must set platform/XLA flags before JAX initializes a backend.
"""

import os

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + " --xla_force_host_platform_device_count=8"
)
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import pytest  # noqa: E402

REF_SCENES = "/root/reference/scenes"


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skipped without one")


@pytest.fixture(scope="session")
def ref_scenes():
    if not os.path.isdir(REF_SCENES):
        pytest.skip("reference scenes not available")
    return REF_SCENES
