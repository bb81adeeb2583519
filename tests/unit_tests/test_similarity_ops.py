"""Device similarity primitives vs the native/numpy oracle."""

from __future__ import annotations

import numpy as np
import pytest

from hydrus_video_deduplicator_tpu import native
from hydrus_video_deduplicator_tpu.ops import similarity as sim
from hydrus_video_deduplicator_tpu.vpdq import python_ref

pytestmark = pytest.mark.skipif(not native.is_available(), reason="native lib not built")


def test_packed_roundtrip(rng):
    blob = rng.integers(0, 256, (7 * 32,), dtype=np.uint8).tobytes()
    assert sim.packed_to_blobs(sim.blobs_to_packed(blob)) == blob


def test_hamming_tiles_match_oracle(rng):
    import jax.numpy as jnp

    a = rng.integers(0, 256, (13, 32), dtype=np.uint8)
    b = rng.integers(0, 256, (17, 32), dtype=np.uint8)
    pa, pb = jnp.asarray(a.view(np.uint32)), jnp.asarray(b.view(np.uint32))
    ref = python_ref.hamming_matrix(a, b)
    assert np.array_equal(np.asarray(sim.hamming_tile_packed(pa, pb)), ref)
    assert np.array_equal(np.asarray(sim.hamming_tile_popcount(pa, pb)), ref)
    assert np.array_equal(native.hamming_matrix(a.tobytes(), b.tobytes()), ref)


def _random_corpus(rng, n_vids, max_frames=6, with_pairs=True):
    counts = rng.integers(0, max_frames, n_vids).astype(np.int32)
    vids = [rng.integers(0, 256, (c, 32), dtype=np.uint8) for c in counts]
    if with_pairs and len(vids) > 4 and counts[1] > 0:
        near = vids[1].copy()
        near[0, 0] ^= 0b101  # flip 2 bits of the first frame
        vids[4] = near
        counts[4] = counts[1]
    return vids, counts


def test_video_similarity_matches_native(rng):
    import jax.numpy as jnp

    vids, counts = _random_corpus(rng, 10)
    ids, frames = [], []
    for i, v in enumerate(vids):
        for f in v:
            ids.append(i)
            frames.append(f)
    frames = np.asarray(frames, dtype=np.uint8).reshape(-1, 32)
    ids = np.asarray(ids, dtype=np.int32)
    packed = jnp.asarray(frames.view(np.uint32))
    ham = sim.hamming_tile_packed(packed, packed)
    S = np.asarray(
        sim.video_pair_similarity(
            ham,
            jnp.asarray(ids),
            jnp.asarray(ids),
            jnp.asarray(counts),
            jnp.asarray(counts),
            len(vids),
            len(vids),
        )
    )
    for i in range(len(vids)):
        for j in range(len(vids)):
            ref = int(native.match_hash_bytes(vids[i].tobytes(), vids[j].tobytes(), 31))
            assert S[i, j] == ref, (i, j, S[i, j], ref)
    # distance mapping
    d = np.asarray(sim.int_similarity_to_distance(S))
    assert d.min() >= 1 and d.max() <= 101


def test_empty_videos_never_match(rng):
    import jax.numpy as jnp

    counts = np.asarray([0, 3, 0], np.int32)
    frames = rng.integers(0, 256, (3, 32), dtype=np.uint8)
    ids = np.asarray([1, 1, 1], np.int32)
    packed = jnp.asarray(frames.view(np.uint32))
    ham = sim.hamming_tile_packed(packed, packed)
    S = np.asarray(
        sim.video_pair_similarity(
            ham, jnp.asarray(ids), jnp.asarray(ids), jnp.asarray(counts), jnp.asarray(counts), 3, 3
        )
    )
    assert S[0].max() == 0 and S[:, 0].max() == 0 and S[2].max() == 0
    assert S[1, 1] == 100


def test_engine_long_videos_and_mixed_buckets(rng):
    """Videos longer than MAX_BUCKET frames are compared exactly on the
    host (no truncation); tiles scale with bucket frame counts."""
    from hydrus_video_deduplicator_tpu.parallel import engine as eng

    long_frames = eng.MAX_BUCKET + 64
    # two long videos that are duplicates ONLY in their second halves
    # (entirely past the pre-fix truncation point would've missed them)
    n_shared = long_frames // 2 + 40
    tail = rng.integers(0, 256, (n_shared, 32), dtype=np.uint8)
    long_a = (
        rng.integers(0, 256, (long_frames - n_shared, 32), dtype=np.uint8).tobytes()
        + tail.tobytes()
    )
    long_b = (
        rng.integers(0, 256, (long_frames - n_shared, 32), dtype=np.uint8).tobytes()
        + tail.tobytes()
    )
    short = [rng.integers(0, 256, (3, 32), dtype=np.uint8).tobytes() for _ in range(5)]
    short.append(short[0])  # dup pair among the short ones
    vids = short + [long_a, long_b, b""]

    pairs = eng.TpuSearchEngine(tile_rows=4, tile_cols=4).find_pairs(vids, vids, 1)
    got = {(a, b) for a, b, s in pairs if a != b}
    ref = set()
    for i, x in enumerate(vids):
        for j, y in enumerate(vids):
            if i != j and int(native.match_hash_bytes(x, y, 31)) >= 1:
                ref.add((i, j))
    assert got == ref
    assert (6, 7) in got  # the tail-duplicate long pair was found


def test_engine_property_matches_oracle_hypothesis():
    """Property test: for arbitrary small corpora (ragged lengths, empties,
    near-duplicates), both engine routes return exactly the pair set the
    native matchHashBytes oracle computes by brute force."""
    import numpy as np
    from hypothesis import given, settings, strategies as st

    from hydrus_video_deduplicator_tpu.parallel.engine import TpuSearchEngine
    from hydrus_video_deduplicator_tpu.vpdq import matchHashBytes

    @st.composite
    def corpus(draw):
        rng = np.random.default_rng(draw(st.integers(0, 2**31)))
        n = draw(st.integers(2, 14))
        vids = []
        for _ in range(n):
            kind = draw(st.integers(0, 3))
            if kind == 0:
                vids.append(b"")  # empty hash
            elif kind == 1 and vids:  # exact duplicate of an earlier video
                vids.append(vids[draw(st.integers(0, len(vids) - 1))])
            elif kind == 2 and any(vids):  # near-duplicate: flip a few bits
                src = next((v for v in reversed(vids) if v), None)
                if src is None:
                    vids.append(b"")
                    continue
                arr = bytearray(src)
                for _ in range(draw(st.integers(0, 6))):
                    arr[draw(st.integers(0, len(arr) - 1))] ^= 1 << draw(st.integers(0, 7))
                vids.append(bytes(arr))
            else:
                nf = draw(st.integers(1, 9))
                vids.append(rng.integers(0, 256, (nf, 32), dtype=np.uint8).tobytes())
        return vids

    @settings(max_examples=25, deadline=None)
    @given(corpus(), st.integers(1, 100))
    def check(vids, min_sim):
        expected = sorted(
            (i, j, int(matchHashBytes(a, b)))
            for i, a in enumerate(vids)
            for j, b in enumerate(vids)
            if a and b and int(matchHashBytes(a, b)) >= min_sim
        )
        for force in (False, True):
            eng = TpuSearchEngine(tile_rows=4, tile_cols=4, force_segments=force)
            got = sorted(eng.find_pairs(vids, vids, min_sim))
            assert got == expected, (force, min_sim)

    check()


def test_similarity_block_xla_matches_tile_similarity(rng):
    """The bucketed ±1 block program (ops/similarity.py) equals the packed
    XLA tile the engine's bucketed route runs."""
    import jax.numpy as jnp

    from hydrus_video_deduplicator_tpu.ops.similarity import (
        similarity_block_xla,
        unpack_pm1_host,
    )
    from hydrus_video_deduplicator_tpu.parallel.engine import _tile_similarity

    pa, pb = 4, 8
    ra, cb = 6, 5
    pk_a = rng.integers(0, 2**32, (ra, pa, 8), dtype=np.uint64).astype(np.uint32)
    pk_b = rng.integers(0, 2**32, (cb, pb, 8), dtype=np.uint64).astype(np.uint32)
    pk_b[1, :pa] = pk_a[2]  # a shared prefix: a partial match
    pk_b[3, :pa] = pk_a[0]
    pk_b[3, pa:] = pk_a[0]
    ca = rng.integers(1, pa + 1, ra).astype(np.int32)
    ca[0] = ca[2] = pa
    cb_n = rng.integers(1, pb + 1, cb).astype(np.int32)
    cb_n[1], cb_n[3] = pa, pb
    got = np.asarray(
        similarity_block_xla(
            jnp.asarray(unpack_pm1_host(pk_a, ca)), jnp.asarray(ca[:, None]),
            jnp.asarray(unpack_pm1_host(pk_b, cb_n)), jnp.asarray(cb_n[:, None]),
            pa, pb,
        )
    )
    want = np.asarray(_tile_similarity(pk_a, ca, pk_b, cb_n, pa, pb))
    assert np.array_equal(got, want)
    assert got[2, 1] == 100 and got[0, 3] == 100
