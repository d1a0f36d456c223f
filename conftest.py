"""Root conftest.

Host tests run on a virtual 8-device CPU mesh (the tier-1 command sets
JAX_PLATFORMS=cpu), so the multi-device code paths are exercised without a
card. Tests marked `gpu` compare the device path with the oracle on the
card: they run with `python -m pytest tests -m gpu` on a machine with an
NVIDIA GPU and skip elsewhere.
"""

import os

import pytest

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()


@pytest.fixture(autouse=True)
def _gpu_marker(request):
    """Skip a `gpu`-marked test when JAX's default device is not a GPU."""
    if request.node.get_closest_marker("gpu") is None:
        return
    import jax

    platform = jax.devices()[0].platform
    if platform != "gpu":
        pytest.skip(f"needs an NVIDIA GPU; JAX's default platform is {platform}")
