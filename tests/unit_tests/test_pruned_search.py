"""Exact scene-representative pruned search: reps, filter, verify, engine.

The pruned route must return pair sets IDENTICAL to
the brute-force engine at every threshold — the prune is a bound, not a
heuristic. These tests pin:

  * the clustering invariant (every frame within radius of its leader,
    native == numpy semantics);
  * the existence kernel against a direct oracle at the inflated
    tolerance, including the exact triangle-bound boundary (79 fires,
    80 does not, at radius cap 24);
  * batched pair verification against native matchHashBytes;
  * end-to-end pruned == unpruned pair sets over scene-structured,
    random (worst-case: no compression), subset-clip, duplicate-frame,
    empty, and long-video (complement path) corpora, with and without
    col_limit, single-device and mesh-sharded.
"""

from __future__ import annotations

import numpy as np
import pytest

from hydrus_video_deduplicator_tpu import native
from hydrus_video_deduplicator_tpu.ops import reps as reps_mod
from hydrus_video_deduplicator_tpu.vpdq import python_ref


def _flip(rng, frame: np.ndarray, k: int, avoid: set | None = None) -> np.ndarray:
    """Copy with exactly k fresh bit flips (positions disjoint from avoid)."""
    out = frame.copy()
    pool = [p for p in range(256) if avoid is None or p not in avoid]
    pos = rng.choice(pool, size=k, replace=False)
    for p in pos:
        out[p // 8] ^= np.uint8(1 << (p % 8))
        if avoid is not None:
            avoid.add(int(p))
    return out


def _scene_video(rng, n_scenes: int, frames_per_scene: int, drift: int = 3) -> np.ndarray:
    frames = []
    for _ in range(n_scenes):
        cur = rng.integers(0, 256, 32, dtype=np.uint8)
        for _t in range(frames_per_scene):
            cur = _flip(rng, cur, drift)
            frames.append(cur)
    return np.stack(frames)


def _reencode(rng, v: np.ndarray, noise: int = 8) -> np.ndarray:
    return np.stack([_flip(rng, f, noise) for f in v])


def _mixed_corpus(rng, long_video: bool = False) -> list[bytes]:
    vids = [
        _scene_video(rng, int(rng.integers(1, 4)), int(rng.integers(2, 6)))
        for _ in range(25)
    ]
    # pure-random videos: singleton leaders, zero compression (worst case)
    vids += [rng.integers(0, 256, (int(c), 32), dtype=np.uint8) for c in (1, 7, 13)]
    vids.append(_reencode(rng, vids[3]))  # re-encode duplicate
    vids.append(_reencode(rng, vids[7])[:3])  # subset clip
    dup_frame = rng.integers(0, 256, 32, dtype=np.uint8)
    vids.append(np.stack([dup_frame] * 9))  # duplicate-frame-heavy
    vids.append(np.stack([dup_frame] * 2))
    vids.append(np.zeros((0, 32), dtype=np.uint8))  # empty hash
    if long_video:
        # > SEG_MAX_FRAMES: exercises the unpruned complement sweeps
        long = _scene_video(rng, 60, 10)
        assert len(long) > 512
        vids.append(long)
        vids.append(_reencode(rng, long))
    return [v.tobytes() for v in vids]


# ---------------------------------------------------------------------------
# Clustering
# ---------------------------------------------------------------------------


def test_cluster_invariant_and_native_numpy_parity(rng):
    cap = 24
    for _ in range(5):
        v = _scene_video(rng, int(rng.integers(1, 5)), int(rng.integers(1, 9)), drift=5)
        idx_np = reps_mod._cluster_one_numpy(v, cap)
        # every frame within cap of SOME leader (its own cluster's leader)
        d = python_ref.hamming_matrix(v, v[idx_np])
        assert d.min(axis=1).max() <= cap
        if native.is_available():
            leaders, counts = native.cluster_reps_batch(
                v, np.asarray([0, len(v)], dtype=np.int64), cap
            )
            assert np.array_equal(leaders, idx_np)
            assert counts[0] == len(idx_np)


def test_cluster_batch_threaded_equals_serial(rng, monkeypatch):
    """hvd_cluster_reps_batch fans videos over a thread pool; output must
    be bit-identical for any thread count (per-video independence +
    deterministic serial compaction)."""
    if not native.is_available():
        pytest.skip("native lib unavailable")
    cap = 24
    counts = rng.integers(1, 40, 500)
    offsets = np.zeros(501, dtype=np.int64)
    np.cumsum(counts, out=offsets[1:])
    frames = rng.integers(0, 256, (int(offsets[-1]), 32), dtype=np.uint8)
    for v in range(0, 500, 3):  # compressible videos
        f0, f1 = int(offsets[v]), int(offsets[v + 1])
        frames[f0:f1] = frames[f0]
    monkeypatch.setenv("HVD_CLUSTER_THREADS", "1")
    l1, c1 = native.cluster_reps_batch(frames, offsets, cap)
    monkeypatch.setenv("HVD_CLUSTER_THREADS", "7")
    l7, c7 = native.cluster_reps_batch(frames, offsets, cap)
    assert np.array_equal(l1, l7)
    assert np.array_equal(c1, c7)


def test_extract_reps_shapes(rng):
    v = _scene_video(rng, 2, 6)
    blobs = [v.tobytes(), b"", v[:1].tobytes()]
    rep_blobs = reps_mod.extract_reps(blobs)
    assert len(rep_blobs) == 3
    assert rep_blobs[1] == b""
    assert rep_blobs[2] == v[:1].tobytes()
    assert 1 <= len(rep_blobs[0]) // 32 <= len(v)
    # reps are a subset of the video's frames
    frames = {f.tobytes() for f in v}
    for i in range(0, len(rep_blobs[0]), 32):
        assert rep_blobs[0][i : i + 32] in frames


def test_batch_matches_per_video(rng):
    caps = [16, 24, 32]
    vids = [_scene_video(rng, 2, 4), _scene_video(rng, 1, 7)]
    frames = np.concatenate(vids)
    offsets = np.asarray([0, len(vids[0]), len(frames)], dtype=np.int64)
    for cap in caps:
        rep_frames, rep_offsets = reps_mod.extract_reps_arrays(frames, offsets, cap)
        for v_i, v in enumerate(vids):
            idx = reps_mod._cluster_one_numpy(v, cap)
            got = rep_frames[rep_offsets[v_i] : rep_offsets[v_i + 1]]
            assert np.array_equal(got, v[idx])


# ---------------------------------------------------------------------------
# Existence kernel (XLA twin — the Triton kernel is checked against it in
# test_exists_triton.py)
# ---------------------------------------------------------------------------


def _pack_for_seg(items, frames_per_block, slots_per_block):
    from hydrus_video_deduplicator_tpu.ops import similarity_segments as seg

    blocks = seg.pack_blocks(items, frames_per_block, slots_per_block)
    return seg.stack_blocks(blocks, len(blocks), frames_per_block, slots_per_block)


def test_exists_kernel_matches_oracle(rng):
    import jax.numpy as jnp

    from hydrus_video_deduplicator_tpu.ops import similarity_segments as seg

    tol = 79
    exists = seg.make_exists_kernel_xla(tol)
    vids = [rng.integers(0, 256, (int(c), 32), dtype=np.uint8) for c in
            rng.integers(1, 9, 12)]
    # plant a near pair right at the tolerance
    vids[5] = np.concatenate([_flip(rng, vids[2][0], tol)[None], vids[5]])
    items = [(i, v.tobytes()) for i, v in enumerate(vids)]
    packed, slot_ids, counts, smap = _pack_for_seg(items, seg.ROW_FRAMES, seg.ROW_SLOTS)
    a_pm1 = seg.unpack_blocks_pm1(jnp.asarray(packed), jnp.asarray(slot_ids))
    packed_c, slot_c, counts_c, smap_c = _pack_for_seg(
        items, seg.CHUNK_FRAMES, seg.CHUNK_SLOTS
    )
    # stack col chunks into one step group of N_SPLIT
    n_chunks = len(packed_c) // seg.CHUNK_FRAMES
    need = seg.N_SPLIT * seg.TILE_COL_STEPS
    reps_needed = need  # pad chunk stack to a whole tile
    pc = np.zeros((reps_needed * seg.CHUNK_FRAMES, 8), dtype=np.uint32)
    sc = np.full((reps_needed * seg.CHUNK_FRAMES,), -1, dtype=np.int32)
    cc = np.zeros((reps_needed * seg.CHUNK_SLOTS, 1), dtype=np.int32)
    sm = np.full((reps_needed * seg.CHUNK_SLOTS,), -1, dtype=np.int64)
    pc[: len(packed_c)] = packed_c
    sc[: len(slot_c)] = slot_c
    cc[: len(counts_c)] = counts_c
    sm[: len(smap_c)] = smap_c
    b_pm1 = seg.unpack_blocks_pm1(jnp.asarray(pc), jnp.asarray(sc))
    got = np.asarray(
        exists(a_pm1, jnp.asarray(slot_ids), jnp.asarray(counts),
               b_pm1, jnp.asarray(sc), jnp.asarray(cc))
    )
    # oracle: per (row video, col video), count of row frames whose min
    # distance to the col video is <= tol
    for rs, ri in enumerate(smap):
        if ri < 0:
            continue
        for cs, ci in enumerate(sm):
            if ci < 0:
                continue
            d = python_ref.hamming_matrix(vids[ri], vids[ci])
            expect = int((d.min(axis=1) <= tol).sum())
            assert got[rs, cs] == expect, (ri, ci, got[rs, cs], expect)


def test_exists_mask_kernel_matches_exists(rng):
    """The mask-epilogue variant's packed bits equal (exists >= 1) in the
    engine drain's exact little-endian word layout."""
    import jax.numpy as jnp

    from hydrus_video_deduplicator_tpu.ops import similarity_segments as seg

    items = [
        (i, rng.integers(0, 256, int(c) * 32, dtype=np.uint8).tobytes())
        for i, c in enumerate(rng.integers(1, 20, 40))
    ]
    rb = seg.pack_blocks(items, seg.ROW_FRAMES, seg.ROW_SLOTS)
    rp, ri, rc, _ = seg.stack_blocks(
        rb, seg.TILE_ROW_BLOCKS, seg.ROW_FRAMES, seg.ROW_SLOTS
    )
    cb = seg.pack_blocks(items, seg.CHUNK_FRAMES, seg.CHUNK_SLOTS)
    cpt, cit, cct, _ = seg.stack_blocks(
        cb, seg.TILE_COL_STEPS * seg.N_SPLIT, seg.CHUNK_FRAMES, seg.CHUNK_SLOTS
    )
    rf = seg.unpack_blocks_pm1(jnp.asarray(rp), jnp.asarray(ri))
    cf = seg.unpack_blocks_pm1(jnp.asarray(cpt), jnp.asarray(cit))
    args = (rf, jnp.asarray(ri), jnp.asarray(rc), cf, jnp.asarray(cit), jnp.asarray(cct))
    ex = np.asarray(seg.make_exists_kernel_xla(79)(*args))
    mk = np.asarray(seg.make_exists_mask_kernel_xla(79)(*args))
    # row-packed layout: bit b of word [w, c] = row slot w*32+b
    b3 = np.unpackbits(
        mk.view(np.uint8).reshape(mk.shape[0], mk.shape[1], 4),
        axis=2,
        bitorder="little",
    )
    bits = np.moveaxis(b3, 2, 1).reshape(mk.shape[0] * 32, mk.shape[1])
    assert np.array_equal(bits.astype(bool), ex >= 1)


def test_triangle_bound_boundary(rng):
    """Leaders at max radius + frames at max tolerance: the candidate's
    leader distance is exactly 31 + 2*24 = 79 and must survive; one bit
    past must not (constructed with disjoint flip positions so Hamming
    distances add exactly)."""
    from hydrus_video_deduplicator_tpu.parallel.engine import TpuSearchEngine

    used: set = set()
    c_a = rng.integers(0, 256, 32, dtype=np.uint8)
    a = _flip(rng, c_a, 24, used)  # d(c_a, a) = 24
    b = _flip(rng, a, 31, used)  # d(a, b) = 31
    c_b = _flip(rng, b, 24, used)  # d(b, c_b) = 24 -> d(c_a, c_b) = 79
    video_a = np.stack([c_a, a])
    video_b = np.stack([c_b, b])
    blobs = [video_a.tobytes(), video_b.tobytes()]
    eng = TpuSearchEngine(force_segments=True)
    got = sorted(eng.find_pairs_pruned(blobs, blobs, 1))
    ref = sorted(TpuSearchEngine(force_segments=True).find_pairs(blobs, blobs, 1))
    assert got == ref
    assert (0, 1, 50) in got  # one of two frames matches -> 50


# ---------------------------------------------------------------------------
# Pair verification
# ---------------------------------------------------------------------------


def test_pair_verify_matches_native(rng):
    from hydrus_video_deduplicator_tpu.ops import pair_verify
    from hydrus_video_deduplicator_tpu.vpdq import matchHashBytes

    blobs = _mixed_corpus(rng)
    nonempty = [i for i, b in enumerate(blobs) if 0 < len(b) // 32 <= 512]
    pairs = [
        (i, j)
        for i in nonempty
        for j in rng.choice(nonempty, size=4, replace=False)
    ]
    got = {(i, j): s for i, j, s in pair_verify.verify_pairs(pairs, blobs, blobs, 1)}
    for i, j in pairs:
        expect = int(matchHashBytes(blobs[i], blobs[j]))
        assert got.get((i, j), 0) == expect, (i, j)


def test_pair_verify_drain_group_invariant(rng, monkeypatch):
    """Results are independent of the drain group size (the grouped
    device fetch must split pair metadata back exactly at every group
    boundary, including the final partial group)."""
    from hydrus_video_deduplicator_tpu.ops import pair_verify

    blobs = _mixed_corpus(rng)
    nonempty = [i for i, b in enumerate(blobs) if 0 < len(b) // 32 <= 512]
    pairs = [
        (i, j)
        for i in nonempty
        for j in rng.choice(nonempty, size=3, replace=False)
    ]
    # small per-chunk budget -> many chunks -> several groups at size 2
    monkeypatch.setattr(pair_verify, "pairs_per_chunk", lambda pad: 8)
    monkeypatch.setenv("HVD_VERIFY_DRAIN_GROUP", "2")
    grouped = sorted(pair_verify.verify_pairs(pairs, blobs, blobs, 1))
    monkeypatch.setenv("HVD_VERIFY_DRAIN_GROUP", "1")
    per_chunk = sorted(pair_verify.verify_pairs(pairs, blobs, blobs, 1))
    assert grouped == per_chunk


def test_pair_verify_rejects_below_min(rng):
    from hydrus_video_deduplicator_tpu.ops import pair_verify

    a = rng.integers(0, 256, (4, 32), dtype=np.uint8)
    b = rng.integers(0, 256, (4, 32), dtype=np.uint8)
    out = pair_verify.verify_pairs([(0, 1)], [a.tobytes(), b.tobytes()],
                                   [a.tobytes(), b.tobytes()], 1)
    assert out == []  # random videos don't match


# ---------------------------------------------------------------------------
# End-to-end equality with the brute-force engine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("min_sim", [1, 30, 75, 100])
def test_pruned_equals_unpruned(rng, min_sim):
    from hydrus_video_deduplicator_tpu.parallel.engine import TpuSearchEngine

    blobs = _mixed_corpus(rng)
    ref = sorted(TpuSearchEngine(force_segments=True).find_pairs(blobs, blobs, min_sim))
    got = sorted(
        TpuSearchEngine(force_segments=True).find_pairs_pruned(blobs, blobs, min_sim)
    )
    assert got == ref
    if min_sim == 1:
        assert ref  # planted duplicates must appear


def test_pruned_exact_with_tiny_drain_hbm_budget(rng):
    """The drain shrinks its group to fit the memory plan's drain budget
    (10M-scale masks are ~1 GB each); group_n=1 must stay exact — covers
    the G=1 extract trace, partial groups, and the per-mask top-k gather."""
    import dataclasses

    from hydrus_video_deduplicator_tpu.parallel.engine import TpuSearchEngine

    blobs = _mixed_corpus(rng)
    ref = sorted(TpuSearchEngine(force_segments=True).find_pairs(blobs, blobs, 60))
    eng = TpuSearchEngine(force_segments=True)
    # force group_n == 1
    eng.memory = dataclasses.replace(eng.memory, drain_bytes=1_000_000)
    got = sorted(eng.find_pairs_pruned(blobs, blobs, 60))
    assert got == ref


def test_pruned_equals_unpruned_with_long_videos(rng):
    from hydrus_video_deduplicator_tpu.parallel.engine import TpuSearchEngine

    blobs = _mixed_corpus(rng, long_video=True)
    ref = sorted(TpuSearchEngine(force_segments=True).find_pairs(blobs, blobs, 50))
    got = sorted(
        TpuSearchEngine(force_segments=True).find_pairs_pruned(blobs, blobs, 50)
    )
    assert got == ref
    long_idx = len(blobs) - 2
    assert any(long_idx in (i, j) for i, j, _ in ref)  # long dup pair found


def test_pruned_col_limit_and_state_reuse(rng):
    """Chunked triangle sweep: two row chunks sharing col_state, cols
    ordered so col_limit sweeps the growing prefix — the stage-4 pattern."""
    from hydrus_video_deduplicator_tpu.parallel.engine import TpuSearchEngine

    blobs = _mixed_corpus(rng)
    n = len(blobs)
    half = n // 2
    ref_eng = TpuSearchEngine(force_segments=True)
    state_ref: dict = {}
    ref = sorted(
        ref_eng.find_pairs(blobs[:half], blobs, 20, col_state=state_ref, col_limit=half)
        + ref_eng.find_pairs(blobs[half:], blobs, 20, col_state=state_ref, col_limit=n)
    )
    got_eng = TpuSearchEngine(force_segments=True)
    state: dict = {}
    got_a = got_eng.find_pairs_pruned(
        blobs[:half], blobs, 20, col_state=state, col_limit=half
    )
    got_b = got_eng.find_pairs_pruned(
        blobs[half:], blobs, 20, col_state=state, col_limit=n
    )
    assert "rep_cols" in state["prune"]  # col reps computed once
    got = sorted(got_a + got_b)
    # rebase: ref row indices are chunk-local in both calls; same for got
    assert got == ref


def test_pruned_db_cols_verify_reuses_row_span(rng, monkeypatch):
    """DB-backed columns (iter_many duck type) + rows_at: verify-stage
    column blobs inside the chunk's own row span must be the in-memory
    row objects themselves (identity), NOT refetched through iter_many —
    the r05 production-overhead fix: at 1M scale nearly every candidate
    is a self/near-diagonal pair, so refetching turned each chunk's
    verify into a ~100k-blob random-read storm against a multi-GB DB.
    Out-of-span candidates must still be served, and the pair set must
    equal the plain-list path's exactly."""
    from hydrus_video_deduplicator_tpu.ops import pair_verify
    from hydrus_video_deduplicator_tpu.parallel.engine import TpuSearchEngine

    blobs = _mixed_corpus(rng)
    n = len(blobs)
    half = n // 2

    class SpyColumn:
        """DbBlobColumn duck type over an in-memory list.

        Serves FRESH bytes copies like the real SQLite-backed column does
        — so the identity assertion below actually discriminates between
        'reused the chunk row object' and 'refetched through the DB'."""

        def __init__(self, items):
            self._items = items
            self.blob_n_frames = [len(b) // 32 for b in items]

        def __len__(self):
            return len(self._items)

        def __getitem__(self, i):
            return bytes(bytearray(self._items[int(i)]))

        def iter_many(self, indices):
            return (
                (int(i), bytes(bytearray(self._items[int(i)]))) for i in indices
            )

    rows = blobs[half:]
    # reference FIRST, before the spy is installed — the spy must capture
    # exactly one call (the DB-backed one), or the plain-list reference
    # call would overwrite the capture with a mapping where identity
    # holds trivially (list slices share objects)
    ref = sorted(
        TpuSearchEngine(force_segments=True).find_pairs_pruned(
            rows, blobs, 20, col_state={}, col_limit=n, rows_at=half
        )
    )

    captured: dict = {}
    real_verify = pair_verify.verify_pairs

    def spy_verify(pairs, row_blob, col_blob, min_sim, progress=None):
        assert "pairs" not in captured, "verify called more than once"
        captured["pairs"] = list(pairs)
        captured["row_blob"] = row_blob
        captured["col_blob"] = col_blob
        return real_verify(pairs, row_blob, col_blob, min_sim, progress)

    monkeypatch.setattr(pair_verify, "verify_pairs", spy_verify)

    eng = TpuSearchEngine(force_segments=True)
    got = sorted(
        eng.find_pairs_pruned(
            rows, SpyColumn(blobs), 20, col_state={}, col_limit=n, rows_at=half
        )
    )
    assert got == ref and got  # exactness vs the plain-list path

    cand = captured["pairs"]
    in_span = [(i, j) for i, j in cand if half <= j < n]
    out_span = [(i, j) for i, j in cand if j < half]
    # the corpus plants both kinds: self-pairs (in-span) and the
    # cross-half re-encode/subset-clip pairs (out-of-span)
    assert in_span and out_span
    for i, j in in_span:
        # object identity, not just equality: proves the blob was reused
        # from the chunk rows rather than refetched
        assert captured["col_blob"][j] is captured["row_blob"][j - half]
    for _, j in out_span:
        assert captured["col_blob"][j] == blobs[j]


def test_pruned_radius_cap_cache_invalidation(rng):
    """Reps cached at one radius_cap must NOT serve a sweep at a smaller
    cap: the smaller cap's tolerance (31 + 2*cap) no longer covers the
    larger clustering radius, so the triangle bound breaks and true pairs
    vanish silently. The boundary construction makes the
    miss deterministic: leader distance exactly 79 = tol(24) > tol(8)."""
    from hydrus_video_deduplicator_tpu.parallel.engine import TpuSearchEngine

    used: set = set()
    c_a = rng.integers(0, 256, 32, dtype=np.uint8)
    a = _flip(rng, c_a, 24, used)  # d(c_a, a) = 24: one leader at cap 24
    b = _flip(rng, a, 31, used)  # the true frame match
    c_b = _flip(rng, b, 24, used)  # d(c_a, c_b) = 79 exactly
    blobs = [np.stack([c_a, a]).tobytes(), np.stack([c_b, b]).tobytes()]
    eng = TpuSearchEngine(force_segments=True)
    state: dict = {}
    ref = sorted(
        eng.find_pairs_pruned(blobs, blobs, 1, col_state=state, radius_cap=24)
    )
    assert (0, 1, 50) in ref
    # same state, smaller cap: the cached cap-24 reps must be rebuilt
    got = sorted(
        eng.find_pairs_pruned(blobs, blobs, 1, col_state=state, radius_cap=8)
    )
    assert got == ref
    assert state["prune"]["rep_cols_radius_cap"] == 8


def test_prefilter_auto_policy(rng):
    """auto prunes scene corpora (compressible) and declines random
    few-scene-structure corpora; forced modes override; state is seeded."""
    from types import SimpleNamespace

    from hydrus_video_deduplicator_tpu.dedup import HydrusVideoDeduplicator

    pick = HydrusVideoDeduplicator._pick_search_prefilter
    compressible = [
        _scene_video(rng, 2, 24, drift=2).tobytes() for _ in range(6)
    ]
    incompressible = [
        rng.integers(0, 256, (8, 32), dtype=np.uint8).tobytes() for _ in range(6)
    ]
    ns = SimpleNamespace(
        search_prefilter="auto",
        PREFILTER_MAX_REP_FRACTION=HydrusVideoDeduplicator.PREFILTER_MAX_REP_FRACTION,
    )
    state: dict = {}
    assert pick(ns, compressible, state) is True
    assert state["prune"]["rep_cols"]  # col reps seeded for the engine
    assert pick(ns, incompressible, {}) is False
    ns.search_prefilter = "none"
    assert pick(ns, compressible, {}) is False
    ns.search_prefilter = "reps"
    assert pick(ns, incompressible, {}) is True


def test_packed_cols_mode_matches(rng, monkeypatch):
    """Forcing the 10M-scale packed-column mode (columns stay bit-packed
    on the device, per-step device expansion) must not change any result."""
    import dataclasses

    from hydrus_video_deduplicator_tpu import device
    from hydrus_video_deduplicator_tpu.parallel.engine import TpuSearchEngine

    blobs = _mixed_corpus(rng)
    ref = sorted(TpuSearchEngine(force_segments=True).find_pairs(blobs, blobs, 20))
    monkeypatch.setattr(
        device, "CPU_PLAN", dataclasses.replace(device.CPU_PLAN, col_pm1_bytes=0)
    )
    packed = sorted(TpuSearchEngine(force_segments=True).find_pairs(blobs, blobs, 20))
    pruned = sorted(
        TpuSearchEngine(force_segments=True).find_pairs_pruned(blobs, blobs, 20)
    )
    assert packed == ref
    assert pruned == ref


@pytest.mark.parametrize(
    "backend,platform,n_files,want",
    [
        ("native", "gpu", 10_000, "native"),
        ("tpu", "cpu", 1, "tpu"),
        ("auto", "gpu", 63, "native"),  # below TPU_HASH_MIN_BATCH
        ("auto", "gpu", 64, "tpu"),
        ("auto", "cpu", 10_000, "native"),
    ],
)
def test_hash_backend_auto_policy(monkeypatch, backend, platform, n_files, want):
    """auto takes the device path with a big batch on a platform that
    hashes on the device (a GPU), with no probe of the link; explicit
    backends are taken as given."""
    from types import SimpleNamespace

    import jax

    from hydrus_video_deduplicator_tpu.dedup import HydrusVideoDeduplicator as D

    assert D.TPU_HASH_MIN_BATCH == 64
    monkeypatch.setattr(jax, "devices", lambda: [SimpleNamespace(platform=platform)])
    ns = SimpleNamespace(hash_backend=backend, TPU_HASH_MIN_BATCH=D.TPU_HASH_MIN_BATCH)
    assert D._pick_hash_backend(ns, n_files) == want


def test_pruned_sharded_matches_local(rng):
    import jax

    from hydrus_video_deduplicator_tpu.parallel.engine import TpuSearchEngine
    from hydrus_video_deduplicator_tpu.parallel.mesh import build_mesh

    if len(jax.devices()) < 2:
        pytest.skip("needs a multi-device mesh (virtual CPU devices)")
    mesh = build_mesh()
    blobs = _mixed_corpus(rng)
    local = sorted(
        TpuSearchEngine(force_segments=True).find_pairs_pruned(blobs, blobs, 40)
    )
    sharded = sorted(
        TpuSearchEngine(force_segments=True, mesh=mesh).find_pairs_pruned(
            blobs, blobs, 40
        )
    )
    assert local == sharded
