"""Test config: force an 8-device CPU mesh (SURVEY.md §4 distributed strategy).

Tests run on CPU for determinism and to emulate a multi-device mesh via
``--xla_force_host_platform_device_count=8``. Tests marked ``gpu`` need an
NVIDIA GPU; the ``gpu`` fixture skips them here. Run them on a GPU machine
with ``JAX_PLATFORMS=cuda,cpu python -m pytest tests/ -m gpu -p no:xdist``.
"""

import os

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8")

import jax  # noqa: E402

# The GPU tests (-m gpu) run where JAX_PLATFORMS names cuda; everything else
# runs on the CPU.
if "cuda" not in os.environ.get("JAX_PLATFORMS", ""):
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_default_matmul_precision", "highest")


import pytest  # noqa: E402


@pytest.fixture
def gpu():
    """The first GPU device; skips the test where JAX has none. Decided at
    run time, never at import, so every worker collects the same tests."""
    try:
        return jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("needs an NVIDIA GPU (JAX found none)")
