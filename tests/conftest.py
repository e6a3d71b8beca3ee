"""Test config: run JAX on a virtual 8-device CPU mesh.

Must set env vars before jax is imported anywhere. ``JAX_PLATFORMS=cuda``
keeps the card for the ``gpu``-marked tests (``pytest -m gpu``); every other
run is pinned to the CPU.
"""

import os

import pytest

_ON_CARD = os.environ.get("JAX_PLATFORMS") in ("cuda", "gpu")
if not _ON_CARD:
    os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()

import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# XLA CPU's default matmul precision is reduced (~bf16-level error); force full
# fp32 accumulation so numerics tests compare against numpy exactly.
import jax  # noqa: E402

jax.config.update("jax_default_matmul_precision", "highest")
# jax 0.9's CPU backend ignores --xla_force_host_platform_device_count; the
# supported switch is the config option:
jax.config.update("jax_num_cpu_devices", 8)


@pytest.fixture
def gpu_device():
    """The first GPU; skips the test where JAX finds none."""
    gpus = [d for d in jax.devices() if d.platform == "gpu"]
    if not gpus:
        pytest.skip("needs a GPU: run `JAX_PLATFORMS=cuda pytest -m gpu` on the card")
    return gpus[0]
