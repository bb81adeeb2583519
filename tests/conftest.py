"""Test configuration.

The suite runs on the CPU with 8 virtual devices, so that the multi-device
sharding paths run without accelerator hardware. Both settings must be in
place before JAX is imported, hence the top of conftest. Tests that need
the GPU carry the ``gpu`` marker and skip here; ``python chip_smoke.py``
runs the same paths on the card.
"""

from __future__ import annotations

import os

os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()

import pytest  # noqa: E402

from hydrus_video_deduplicator_tpu import device  # noqa: E402

# XLA-CPU compiles are slow; keep them in the persistent cache (the CLI
# subprocess tests find the same directory by the same rule)
device.enable_compile_cache(min_compile_secs=0.5)
import jax  # noqa: E402

jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)


@pytest.fixture
def on_gpu():
    """Skip unless JAX's default device is a GPU (decided at run time,
    never at collection, so every xdist worker collects the same tests)."""
    import jax

    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU")


@pytest.fixture(scope="session")
def rng():
    import numpy as np

    return np.random.default_rng(1234)
