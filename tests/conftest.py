"""Test configuration: CPU with 8 virtual devices unless told otherwise.

Multi-chip sharding paths are validated on a virtual CPU mesh (the standard
JAX substitute for multi-device testing without hardware).  Tests that
need a GPU are marked ``gpu`` and take the ``gpu`` fixture, which skips
them elsewhere; on the card run ``JAX_PLATFORMS=cuda python -m pytest
tests/ -m gpu``.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from shimmer_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

# The golden/oracle scenes cost about a minute each to compile cold.
enable_compile_cache()


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def gpu():
    """Skip unless JAX's default backend is a GPU (tests marked ``gpu``)."""
    import jax

    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU: run on the card with -m gpu")
