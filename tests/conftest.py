"""Test env: the JAX CPU backend with 8 virtual devices, so mesh and
sharding tests run without accelerator hardware.

``BIALIGN_TEST_PLATFORM=cuda`` selects the GPU instead, for the tests
marked ``gpu`` (``python -m pytest -m gpu tests/`` on a GPU machine);
those take the :func:`gpu` fixture, which skips them on any other
platform when the test runs.
"""

import os

import pytest

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()
_platform = os.environ.get("BIALIGN_TEST_PLATFORM", "cpu")
os.environ["JAX_PLATFORMS"] = _platform

import jax

jax.config.update("jax_platforms", _platform)


@pytest.fixture
def gpu():
    """The default JAX device when it is a GPU; skips the test
    otherwise."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip("needs an NVIDIA GPU (BIALIGN_TEST_PLATFORM=cuda "
                    "python -m pytest -m gpu tests/ on a GPU machine)")
    return dev
