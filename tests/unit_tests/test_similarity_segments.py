"""Fixed-shape segment route: packing, twin math, engine equivalence."""

from __future__ import annotations

import numpy as np
import pytest

from hydrus_video_deduplicator_tpu.ops import similarity_segments as seg
from hydrus_video_deduplicator_tpu.parallel.engine import TpuSearchEngine


def _ragged_corpus(rng, n, planted=True):
    vids = []
    for i in range(n):
        nf = int(rng.choice([1, 2, 3, 5, 8, 9, 13, 30, 100]))
        vids.append(rng.integers(0, 256, (nf, 32), dtype=np.uint8).tobytes())
    if planted:
        vids[4] = vids[1]  # dup within segment range
        vids[10] = b""  # empty hash
        # a >SEG_MAX video plus its duplicate (bucketed leftover route)
        big = rng.integers(0, 256, (seg.SEG_MAX_FRAMES + 100, 32), dtype=np.uint8).tobytes()
        vids[20] = big
        vids[21] = big
        # cross-group: a short video equal to the big one's prefix segment
        vids[30] = big[: 8 * 32]
    return vids


def test_pack_blocks_shapes_and_maps(rng):
    items = [(i, rng.integers(0, 256, (1 + i % 7, 32), dtype=np.uint8).tobytes()) for i in range(50)]
    blocks = seg.pack_blocks(items, seg.ROW_FRAMES, seg.ROW_SLOTS)
    assert blocks
    seen = []
    for b in blocks:
        assert b.packed.shape == (seg.ROW_FRAMES, seg.LANES)
        assert b.slot_ids.shape == (seg.ROW_FRAMES,)
        # every real slot owns exactly its count of frame rows
        for s in range(seg.ROW_SLOTS):
            if b.slot_map[s] >= 0:
                assert (b.slot_ids == s).sum() == b.counts[s, 0]
                seen.append(int(b.slot_map[s]))
    assert sorted(seen) == [i for i, _ in items]
    # the device expansion of a slot's frame rows is that video's pm1 rows
    i0, blob0 = items[0]
    pm1 = np.asarray(
        seg.unpack_blocks_pm1(blocks[0].packed, blocks[0].slot_ids)
    )
    rows = pm1[: len(blob0) // 32]
    assert np.array_equal(rows, seg.blob_to_pm1(blob0))
    # padding rows expand to exact zeros (they must never match)
    assert not pm1[blocks[0].slot_ids < 0].any()


def test_unpack_blocks_stacked_matches_host(rng):
    """Device expansion of stacked packed tiles (tile-at-a-time lax.map)
    equals the host ±1 unpack row for row, with padding rows exact zero."""
    import jax.numpy as jnp

    from hydrus_video_deduplicator_tpu.ops.similarity import unpack_pm1_host

    items = [
        (i, rng.integers(0, 256, (1 + i % 9, 32), dtype=np.uint8).tobytes())
        for i in range(40)
    ]
    blocks = seg.pack_blocks(items, seg.CHUNK_FRAMES, seg.CHUNK_SLOTS)
    n = 4  # includes at least one all-padding tile
    pk, sl, _, _ = seg.stack_blocks(blocks, n, seg.CHUNK_FRAMES, seg.CHUNK_SLOTS)
    pk_t = pk.reshape(n, seg.CHUNK_FRAMES, seg.LANES)
    sl_t = sl.reshape(n, seg.CHUNK_FRAMES)
    got = np.asarray(seg.unpack_blocks_pm1_stacked(jnp.asarray(pk_t), jnp.asarray(sl_t)))
    want = unpack_pm1_host(pk_t, None).reshape(n, seg.CHUNK_FRAMES, 256).copy()
    want[sl_t < 0] = 0
    assert np.array_equal(got, want)
    assert not got[-1].any()  # padding tile is all zeros


def test_segments_twin_matches_bucketed_engine(rng):
    """Segment route (XLA twin on CPU) == bucketed route, pair for pair,
    on a ragged corpus with dups, an empty hash, and >SEG_MAX videos."""
    vids = _ragged_corpus(rng, 120)
    seg_eng = TpuSearchEngine(force_segments=True)
    bucket_eng = TpuSearchEngine(force_segments=False)
    got = sorted(seg_eng.find_pairs(vids, vids, 75))
    want = sorted(bucket_eng.find_pairs(vids, vids, 75))
    assert got == want
    pairs = {(a, b) for a, b, _ in got if a != b}
    assert (1, 4) in pairs and (20, 21) in pairs  # planted dups survive


def test_segments_route_with_mesh(mesh, rng):
    vids = _ragged_corpus(rng, 80)
    local = TpuSearchEngine(force_segments=True)
    sharded = TpuSearchEngine(force_segments=True, mesh=mesh)
    assert sorted(local.find_pairs(vids, vids, 75)) == sorted(
        sharded.find_pairs(vids, vids, 75)
    )


def test_segments_progress_runs_to_completion(rng):
    vids = _ragged_corpus(rng, 60)
    events = []
    eng = TpuSearchEngine(force_segments=True)
    eng.find_pairs(vids, vids, 75, progress=lambda d, t: events.append((d, t)))
    assert events and events[-1][0] == events[-1][1]


@pytest.fixture()
def mesh():
    import jax

    from hydrus_video_deduplicator_tpu.parallel.mesh import build_mesh

    if len(jax.devices()) < 2:
        pytest.skip("needs a multi-device mesh")
    return build_mesh()


def test_scan_sweep_dense_hits(rng):
    """Many identical videos produce a dense hit bitmask (exercising the
    drain's bulk-fetch branch); the scan route still matches the bucketed
    tile route exactly, including all 625 mutual pairs."""
    from hydrus_video_deduplicator_tpu.parallel.engine import TpuSearchEngine

    base = rng.integers(0, 256, (3, 32), dtype=np.uint8).tobytes()
    vids = [base] * 25 + [
        rng.integers(0, 256, (int(c), 32), dtype=np.uint8).tobytes()
        for c in rng.integers(1, 6, 15)
    ]  # 25 identical videos -> 625 mutual hits

    want = sorted(TpuSearchEngine(force_segments=False).find_pairs(vids, vids, 75))
    got = sorted(TpuSearchEngine(force_segments=True).find_pairs(vids, vids, 75))
    assert len(got) >= 625
    assert got == want


def test_drain_sparse_and_dense_paths_agree(rng, monkeypatch):
    """The drain's sparse (device word compaction) and dense (bitmask
    fetch) hit-extraction paths produce identical pair sets — dense is
    forced by emptying the sparse word budgets."""
    from hydrus_video_deduplicator_tpu.parallel import engine as eng

    vids = [
        rng.integers(0, 256, (int(c), 32), dtype=np.uint8).tobytes()
        for c in rng.integers(1, 9, 60)
    ]
    vids[7] = vids[3]
    base = rng.integers(0, 256, (2, 32), dtype=np.uint8).tobytes()
    vids[20:30] = [base] * 10  # a dense clump of mutual hits

    sparse = sorted(
        eng.TpuSearchEngine(force_segments=True).find_pairs(vids, vids, 75)
    )
    sparse_pruned = sorted(
        eng.TpuSearchEngine().find_pairs_pruned(vids, vids, 75)
    )
    monkeypatch.setattr(eng, "_SPARSE_DRAIN_BUDGETS", (1,))
    dense = sorted(
        eng.TpuSearchEngine(force_segments=True).find_pairs(vids, vids, 75)
    )
    dense_pruned = sorted(
        eng.TpuSearchEngine().find_pairs_pruned(vids, vids, 75)
    )
    assert sparse == dense
    assert sparse_pruned == dense_pruned == sparse
