"""Multi-device sharding tests on the virtual 8-device CPU mesh."""

from __future__ import annotations

import numpy as np
import pytest


@pytest.fixture(scope="module")
def mesh():
    import jax

    from hydrus_video_deduplicator_tpu.parallel.mesh import build_mesh

    if len(jax.devices()) < 2:
        pytest.skip("needs a multi-device mesh (virtual CPU devices)")
    return build_mesh()


def _corpus(rng, n):
    counts = rng.integers(0, 6, n)
    vids = [rng.integers(0, 256, (c, 32), dtype=np.uint8).tobytes() for c in counts]
    vids[5] = vids[2]  # dup
    return vids


def test_sharded_engine_matches_local(mesh, rng):
    from hydrus_video_deduplicator_tpu.parallel.engine import TpuSearchEngine

    vids = _corpus(rng, 40)
    local = TpuSearchEngine(tile_rows=16, tile_cols=16)
    sharded = TpuSearchEngine(tile_rows=16, tile_cols=16, mesh=mesh)
    pairs_local = sorted(local.find_pairs(vids, vids, 75))
    pairs_sharded = sorted(sharded.find_pairs(vids, vids, 75))
    assert pairs_local == pairs_sharded
    assert pairs_local  # the planted dup must appear


def test_sharded_tile_matches_local_tile(mesh, rng):
    import jax.numpy as jnp

    from hydrus_video_deduplicator_tpu.parallel.engine import (
        _tile_similarity,
        sharded_tile_similarity,
    )

    n = mesh.devices.size
    pa = 4
    rows = 4 * n
    packed = rng.integers(0, 2**32, (rows, pa, 8), dtype=np.uint64).astype(np.uint32)
    counts = rng.integers(0, pa + 1, (rows,)).astype(np.int32)
    sharded = np.asarray(
        sharded_tile_similarity(mesh, packed, counts, packed, counts, pa, pa)
    )
    local = np.asarray(
        _tile_similarity(
            jnp.asarray(packed), jnp.asarray(counts), jnp.asarray(packed), jnp.asarray(counts), pa, pa
        )
    )
    assert np.array_equal(sharded, local)


def test_graft_entry_dryrun(mesh):
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).parents[2]))
    import __graft_entry__ as graft

    graft.dryrun_multichip(mesh.devices.size)


def test_mesh_hashing_matches_single_device(mesh, rng):
    """Data-parallel hashing over the mesh: identical hashes to no-mesh."""
    from hydrus_video_deduplicator_tpu.models.vpdq import TpuVideoHasher

    frames = np.repeat(
        np.repeat(rng.integers(0, 256, (3, 8, 64, 64, 3), dtype=np.uint8), 8, 2), 8, 3
    )
    items = [(i, _frames_to_y4m(frames[i])) for i in range(3)]

    plain = TpuVideoHasher(batch_size=8).hash_videos(items)
    sharded = TpuVideoHasher(batch_size=8, mesh=mesh).hash_videos(items)
    assert sharded[0].phash is not None
    # mesh batch size rounds up to a device multiple
    assert TpuVideoHasher(batch_size=9, mesh=mesh).batch_size % mesh.devices.size == 0
    for a, b in zip(plain, sharded):
        assert (a.error is None) == (b.error is None)
        if a.phash is not None:
            assert a.phash == b.phash and str(a.phash) == str(b.phash)


def test_pad_target_bucket_ladder(mesh):
    """Partial flushes pad to the {MIN_BUCKET..batch_size} power-of-two
    ladder, not the full compiled batch (padding travels H2D — a 32-frame
    flush must not ship a 94%-zeros full batch), and with a mesh the
    bucket rounds up to a device multiple."""
    from hydrus_video_deduplicator_tpu.models import vpdq as mv

    h = mv.TpuVideoHasher(batch_size=512)
    assert h._pad_target(1) == mv.MIN_BUCKET
    assert h._pad_target(mv.MIN_BUCKET) == mv.MIN_BUCKET
    assert h._pad_target(mv.MIN_BUCKET + 1) == 2 * mv.MIN_BUCKET
    assert h._pad_target(200) == 256
    assert h._pad_target(512) == 512
    # never exceeds the compiled batch, never shrinks below n
    for n in range(1, 513):
        t = h._pad_target(n)
        assert n <= t <= 512
    small = mv.TpuVideoHasher(batch_size=16)
    assert small._pad_target(3) == 16  # CPU batch below MIN_BUCKET: capped
    meshed = mv.TpuVideoHasher(batch_size=512, mesh=mesh)
    for n in (1, 33, 200):
        assert meshed._pad_target(n) % mesh.devices.size == 0


def _frames_to_y4m(frames: np.ndarray) -> bytes:
    """Tiny C444 y4m encoder (full-range passthrough luma trick not needed —
    hashes only must be equal across the two hashers, not golden)."""
    n, h, w, _ = frames.shape
    out = [f"YUV4MPEG2 W{w} H{h} F1:1 C444\n".encode()]
    for f in frames:
        r = f[:, :, 0].astype(np.int32)
        g = f[:, :, 1].astype(np.int32)
        b = f[:, :, 2].astype(np.int32)
        y = np.clip((299 * r + 587 * g + 114 * b + 500) // 1000, 0, 255)
        u = np.clip(((b - y) * 564 + 500) // 1000 + 128, 0, 255)
        v = np.clip(((r - y) * 713 + 500) // 1000 + 128, 0, 255)
        out.append(b"FRAME\n")
        out.append(y.astype(np.uint8).tobytes())
        out.append(u.astype(np.uint8).tobytes())
        out.append(v.astype(np.uint8).tobytes())
    return b"".join(out)


def test_build_mesh_auto_single_slice_is_1d():
    """The orchestrator's mesh is 1-D over every visible device: the cards
    of one host reach each other all to all, so no topology axis."""
    import jax

    from hydrus_video_deduplicator_tpu.parallel.mesh import build_mesh

    m = build_mesh()
    assert m.devices.size == len(jax.devices())
    assert len(m.axis_names) == 1


def test_orchestrator_builds_mesh_by_default(mesh):
    """With >1 visible device the production orchestrator hands both
    device paths a mesh."""
    from hydrus_video_deduplicator_tpu.dedup import HydrusVideoDeduplicator

    built = HydrusVideoDeduplicator._device_mesh()
    assert built is not None
    assert built.devices.size == mesh.devices.size


def test_hasher_device_failure_releases_decode_workers(rng):
    """A device/hash exception mid-run must propagate AND unblock decode
    workers stuck on the bounded frame queue (no thread/memory leak)."""
    import threading
    import time as _time

    from hydrus_video_deduplicator_tpu.models import vpdq as mvpdq

    frames = np.repeat(
        np.repeat(rng.integers(0, 256, (16, 8, 64, 64, 3), dtype=np.uint8), 8, 2), 8, 3
    )
    items = [(i, _frames_to_y4m(frames[i])) for i in range(16)]

    hasher = mvpdq.TpuVideoHasher(batch_size=4, decode_workers=4)

    calls = {"n": 0}

    def exploding(batch):
        calls["n"] += 1
        raise RuntimeError("device fell over")

    hasher._hash_batch = exploding
    before = threading.active_count()
    import pytest as _pytest

    with _pytest.raises(RuntimeError, match="device fell over"):
        hasher.hash_videos(items)
    # workers must exit promptly instead of blocking on the full queue
    deadline = _time.time() + 10
    while threading.active_count() > before and _time.time() < deadline:
        _time.sleep(0.05)
    assert threading.active_count() <= before, "decode workers leaked"
    assert calls["n"] == 1


def test_wide_row_tiles_match_default(rng, monkeypatch):
    """HVD_ROW_BLOCKS_PER_TILE (row blocks per sweep dispatch) must not
    change results: padding blocks hold only zero rows, which can never
    Hamming-match."""
    from hydrus_video_deduplicator_tpu.parallel.engine import TpuSearchEngine

    vids = _corpus(rng, 60)
    base = TpuSearchEngine(force_segments=True).find_pairs(vids, vids, 75)
    monkeypatch.setenv("HVD_ROW_BLOCKS_PER_TILE", "8")
    wide = TpuSearchEngine(force_segments=True).find_pairs(vids, vids, 75)
    assert sorted(base) == sorted(wide)
    wide_pruned = TpuSearchEngine(force_segments=True).find_pairs_pruned(
        vids, vids, 75
    )
    assert sorted(base) == sorted(wide_pruned)
