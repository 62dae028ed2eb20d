"""Test configuration: run JAX on a virtual 8-device CPU mesh.

Multi-device shardings are validated on host CPU devices
(``xla_force_host_platform_device_count``).  Tests marked ``chip`` need
a GPU: they skip on the CPU and run on a card with
``JAX_PLATFORMS=cuda python -m pytest -m chip tests/``.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import pathlib

import pytest

FIXTURES = pathlib.Path(__file__).parent / "fixtures"


@pytest.fixture(scope="session")
def fixtures_dir() -> pathlib.Path:
    return FIXTURES


@pytest.fixture(autouse=True)
def _chip_gate(request):
    """Skip ``chip``-marked tests unless JAX's device is a GPU."""
    if request.node.get_closest_marker("chip") is None:
        return
    import jax

    platform = jax.devices()[0].platform
    if platform != "gpu":
        pytest.skip(f"needs a GPU; JAX's device platform is {platform}")
