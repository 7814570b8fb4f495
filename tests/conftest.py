"""Test harness setup.

The suite runs on the CPU with 8 virtual devices, so multi-device tests
get an 8-device mesh; the platform is chosen here, before any backend
starts.  A session started inside a process that has already opened a
device (``chip_smoke.py``'s gpu-tests phase, on the card) keeps it.

Tests that need the card carry the ``gpu`` marker and take the ``gpu``
fixture, which skips them on any other platform.  Run them with
``python chip_smoke.py`` on a GPU host.
"""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
from jax._src import xla_bridge  # noqa: E402

if not xla_bridge.backends_are_initialized():
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=8")
    jax.config.update("jax_platforms", "cpu")


@pytest.fixture
def gpu():
    """The first device, when it is a GPU; otherwise skip the test."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU (found {dev.platform}); run "
                    "`python chip_smoke.py` on the card")
    return dev
