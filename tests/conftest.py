"""Test configuration: CPU-pinned JAX with an 8-device virtual mesh.

The suite runs on the host CPU whatever accelerator the machine has:
multi-device paths (sharded voxelization / render) run against
xla_force_host_platform_device_count=8, and the brick_dda traversal
kernel runs in the Pallas interpreter.  Tests that need the GPU itself
carry the `gpu` marker and skip here; chip_smoke.py covers that path on
the card.
"""
import os
import sys

import pytest

os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
assert jax.default_backend() == "cpu"

from voxelray_tpu.ops.pallas import brick_dda  # noqa: E402
from voxelray_tpu.utils.cache import enable_compile_cache  # noqa: E402

brick_dda.INTERPRET = True
enable_compile_cache()


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA GPU; skipped on other backends")


@pytest.fixture(autouse=True)
def _skip_without_gpu(request):
    if request.node.get_closest_marker("gpu") is not None \
            and jax.default_backend() != "gpu":
        pytest.skip("needs a CUDA GPU (run chip_smoke.py on the card)")
