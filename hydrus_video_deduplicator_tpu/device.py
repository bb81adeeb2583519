"""Platform decisions, in one place.

Every choice that depends on the accelerator reads this module: which
stage-A existence kernel and which score kernel the search engine runs,
whether it takes the fixed-shape segment route, the device hash batch,
row blocks per search tile, and the device memory plan. Two platforms are
known: ``gpu`` (NVIDIA, through JAX's CUDA plugin) and ``cpu`` (the test
suite's virtual devices and CPU-only hosts). Any other platform raises
:class:`UnsupportedPlatform` rather than inheriting a guess.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from pathlib import Path

#: the checkout this package runs from; the persistent compile cache lives
#: at <checkout>/.jax_cache unless JAX_COMPILATION_CACHE_DIR names another
CHECKOUT = Path(__file__).resolve().parent.parent
COMPILE_CACHE_ENV = "JAX_COMPILATION_CACHE_DIR"


class UnsupportedPlatform(RuntimeError):
    """The default JAX device is neither a GPU nor the CPU."""


@dataclass(frozen=True)
class Capabilities:
    platform: str
    #: frames per device hash batch (models/vpdq.py)
    hash_batch: int
    #: the auto hash backend may pick the device (stage 1)
    device_hashing: bool
    #: the engine takes the fixed-shape segment route by itself once the
    #: sweep clears its work threshold (on the CPU only when forced)
    segment_route: bool
    #: stage-A existence kernel of the pruned route: "triton" (Pallas
    #: through Triton, one launch over the whole column corpus) or "xla"
    #: (ops/similarity_segments.make_exists_mask_kernel_xla)
    exists_kernel: str
    #: segment-route row blocks per dispatch
    row_blocks_per_tile: int


_CAPS = {
    "gpu": Capabilities(
        platform="gpu",
        hash_batch=512,
        device_hashing=True,
        segment_route=True,
        exists_kernel="triton",
        row_blocks_per_tile=2,
    ),
    "cpu": Capabilities(
        platform="cpu",
        hash_batch=16,
        device_hashing=False,
        segment_route=False,
        exists_kernel="xla",
        row_blocks_per_tile=2,
    ),
}


def default_device():
    import jax

    return jax.devices()[0]


def platform(device=None) -> str:
    """"gpu" or "cpu" for ``device`` (default: JAX's first device)."""
    p = (device if device is not None else default_device()).platform
    if p not in _CAPS:
        raise UnsupportedPlatform(f"no capability entry for platform {p!r}")
    return p


def is_gpu(device=None) -> bool:
    return platform(device) == "gpu"


def capabilities(device=None) -> Capabilities:
    return _CAPS[platform(device)]


@dataclass(frozen=True)
class MemoryPlan:
    """Device-memory budgets of the segment route, per device (columns are
    replicated on every device of a mesh, so each plans against its own
    memory)."""

    #: column residency + in-flight drain masks must fit this
    seg_target_bytes: int
    #: above this the column corpus stays bit-packed on the device and
    #: each sweep step expands its own tile to ±1 rows
    col_pm1_bytes: int
    #: cap on in-flight sweep mask results
    drain_bytes: int


#: the CPU plan: the budgets the engine has always used off the
#: accelerator (a host's RAM is not measured here)
CPU_PLAN = MemoryPlan(
    seg_target_bytes=12_500_000_000,
    col_pm1_bytes=9_000_000_000,
    drain_bytes=8_192_000_000,
)

#: GPU budgets as fractions of the memory JAX may allocate on the device
#: (``memory_stats()["bytes_limit"]``), in the CPU plan's proportions,
#: leaving the rest to row-tile workspaces, staging remnants and XLA
#: scratch
SEG_TARGET_FRACTION = 0.78
COL_PM1_FRACTION = 0.56
DRAIN_FRACTION = 0.5


def memory_plan(devices=None) -> MemoryPlan:
    """Plan for ``devices`` (default: JAX's first device). Under a mesh
    pass its devices: the smallest per-device limit sets the plan."""
    devices = list(devices) if devices is not None else [default_device()]
    plat = {platform(d) for d in devices}
    if plat == {"cpu"}:
        return CPU_PLAN
    if plat != {"gpu"}:
        raise UnsupportedPlatform(f"mixed platforms {sorted(plat)}")
    limits = []
    for d in devices:
        stats = d.memory_stats() or {}
        if "bytes_limit" not in stats:
            raise UnsupportedPlatform(f"{d} reports no bytes_limit")
        limits.append(int(stats["bytes_limit"]))
    limit = min(limits)
    return MemoryPlan(
        seg_target_bytes=int(limit * SEG_TARGET_FRACTION),
        col_pm1_bytes=int(limit * COL_PM1_FRACTION),
        drain_bytes=int(limit * DRAIN_FRACTION),
    )


def compile_cache_dir(environ=None) -> str:
    """Where the persistent compile cache lives: JAX_COMPILATION_CACHE_DIR
    when set, else the fixed <checkout>/.jax_cache (the path is part of
    the cache key, so it must not move between runs)."""
    environ = os.environ if environ is None else environ
    return environ.get(COMPILE_CACHE_ENV) or str(CHECKOUT / ".jax_cache")


def enable_compile_cache(min_compile_secs: float = 1.0) -> str:
    """Point JAX's persistent compile cache at :func:`compile_cache_dir`."""
    import jax

    path = compile_cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", min_compile_secs)
    return path
