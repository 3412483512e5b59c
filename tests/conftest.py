"""Test configuration: a virtual 8-device CPU platform by default.

The tests check numerics and multi-device sharding on the CPU; the mesh
tests need eight devices. ``JAX_PLATFORMS`` picks other platforms when it
is set (``JAX_PLATFORMS=cuda,cpu`` runs the ``gpu``-marked tests on an
NVIDIA GPU with the CPU beside it as the reference device); unset, it is
``cpu``. The platform list goes into jax.config before any backend
initialises, so a JAX plugin installed in the environment cannot take the
default device away from it.
"""

import os

_PLATFORMS = os.environ.get("JAX_PLATFORMS") or "cpu"
os.environ["JAX_PLATFORMS"] = _PLATFORMS
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

jax.config.update("jax_platforms", _PLATFORMS)
jax.config.update("jax_num_cpu_devices", 8)

import subprocess

import numpy as np
import pytest

# Build the optional native loader so its parity tests run instead of
# skipping. Best-effort: environments without a toolchain still run the
# numpy path.
_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "..", "native")
try:
    subprocess.run(
        ["make", "-C", _NATIVE_DIR, "-s"], check=False, timeout=120,
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
    )
except (OSError, subprocess.TimeoutExpired):
    pass


@pytest.fixture
def rng():
    return np.random.default_rng(0)
