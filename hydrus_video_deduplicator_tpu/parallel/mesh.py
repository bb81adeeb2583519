"""Mesh helpers for multi-device execution.

The framework's parallelism is data-parallel over videos/frames (hashing)
and row-sharded over the pair matrix (search): both shard a leading batch
axis over a 1-D mesh of every visible device. The cards of one host reach
each other all to all at the same rate, so the mesh follows the algorithm
alone; the only collective is XLA's replication of the column side,
inserted from the shardings.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = [
    "Mesh",
    "batch_spec",
    "build_mesh",
    "device_count",
    "replicated",
    "row_sharding",
    "shard_map",
]


def shard_map(f, *, mesh, in_specs, out_specs):
    """jax.shard_map without the replication check: outputs here are
    row-sharded, never replicated."""
    return jax.shard_map(
        f, mesh=mesh, in_specs=in_specs, out_specs=out_specs, check_vma=False
    )


def device_count() -> int:
    return len(jax.devices())


def build_mesh(n_devices: int | None = None, axis_name: str = "d") -> Mesh:
    """1-D mesh over the first n devices (default: all)."""
    devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (axis_name,))


def batch_spec(mesh: Mesh) -> P:
    """PartitionSpec sharding the leading axis over the mesh."""
    return P(mesh.axis_names[0])


def row_sharding(mesh: Mesh) -> NamedSharding:
    """Shard the leading axis across the whole mesh."""
    return NamedSharding(mesh, batch_spec(mesh))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
