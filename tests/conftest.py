"""Test configuration: force JAX onto CPU with 8 virtual devices so the
multi-device sharding paths run everywhere (SURVEY.md section 4.3).

jax.config.update after import wins over a JAX_PLATFORMS setting in the
environment, making the tests hermetic.  Tests that need a GPU carry the
``gpu`` marker and skip here; ``IMSAME_TEST_GPU=1 pytest -m gpu`` runs
them on a machine with one (the ``on_gpu`` fixture)."""

import os

import pytest

ON_GPU_RUN = os.environ.get("IMSAME_TEST_GPU") == "1"

if not ON_GPU_RUN:
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()
    os.environ.pop("JAX_PLATFORMS", None)

import jax  # noqa: E402

if not ON_GPU_RUN:
    jax.config.update("jax_platforms", "cpu")


@pytest.fixture
def on_gpu():
    """Skip unless JAX's default backend is a GPU (see the module doc)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU: IMSAME_TEST_GPU=1 pytest -m gpu")
