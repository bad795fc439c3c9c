"""Test config.

On the CPU (the default suite, run with JAX_PLATFORMS=cpu) the host
platform is split into 8 virtual devices so the sharding paths run
without several cards. Tests marked ``gpu`` need an NVIDIA GPU (the
CUDA aligner has no interpret mode); they take the ``gpu`` fixture,
which skips them anywhere else.
"""

import os

import pytest

flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

# JAX's persistent compilation cache sporadically segfaulted on the CPU
# backend mid-suite while deserializing an entry (exit 139, only with
# full-suite state); CPU compiles are seconds, so tests run without it.
jax.config.update("jax_enable_compilation_cache", False)


@pytest.fixture
def gpu():
    """Skip unless JAX's first device is a GPU (decided at run time,
    never at import, so every worker collects the same tests)."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs an NVIDIA GPU; JAX's device is {dev.platform}")
    return dev
