"""Test harness config.

The CPU suite runs with ``JAX_PLATFORMS=cpu`` on a virtual 8-device CPU
mesh, so multi-device sharding is exercised without a GPU.  Tests that
need the card carry the ``gpu`` marker and skip on the CPU; on a machine
with a GPU they run with ``python -m pytest -m gpu tests/``, and
``python chip_smoke.py`` (``--four`` on four cards) checks the main path
end to end there.
"""

import os

import pytest

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: long randomized sweeps (always run; marker is informational)"
    )
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU; skips when JAX sees none"
    )


@pytest.fixture
def gpu_device():
    """JAX's first GPU device; skips the test when there is none.  Decided
    here, at run time, so every worker collects the same tests."""
    import jax

    try:
        return jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("no GPU visible to JAX")

