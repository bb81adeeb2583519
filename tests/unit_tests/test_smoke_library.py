"""The synthetic libraries of chip_smoke.py and their oracles, on the CPU."""

from __future__ import annotations

import numpy as np
import pytest

from ..scene_library import (
    brute_force_pairs,
    reencode,
    scene_library,
    y4m_library,
)


@pytest.fixture(scope="module")
def lib():
    return scene_library(200, seed=3)


def test_scene_library_profile(lib):
    again = scene_library(200, seed=3)
    assert lib.blobs == again.blobs and lib.planted == again.planted
    assert scene_library(200, seed=4).blobs != lib.blobs
    frames = np.asarray([len(b) // 32 for b in lib.blobs if b])
    assert frames.min() >= 1 and frames.max() <= 512
    assert 30 <= np.median(frames) <= 70  # lognormal around 48
    assert len(lib.planted) == 200 // 20 + 200 // 40
    assert len(lib.empty) == 2 and all(lib.blobs[e] == b"" for e in lib.empty)
    planted_ids = {i for p in lib.planted for i in p}
    assert not planted_ids & set(lib.empty)
    for a, b in lib.planted:
        assert a < b and len(lib.blobs[a]) == len(lib.blobs[b])


def test_reencode_flips_at_most_the_asked_bits():
    rng = np.random.default_rng(0)
    blob = rng.integers(0, 256, (20, 32), dtype=np.uint8).tobytes()
    out = reencode(rng, blob, bits=8)
    diff = np.unpackbits(
        np.frombuffer(blob, np.uint8) ^ np.frombuffer(out, np.uint8)
    ).reshape(20, 256).sum(1)
    assert diff.max() <= 8 and diff.sum() > 0


def test_brute_force_oracle_is_the_planted_set(lib):
    """At the CLI threshold the brute-force pair set is exactly the planted
    re-encodes (unrelated scene videos sit ~12 sigma apart)."""
    from hydrus_video_deduplicator_tpu.vpdq import matchHashBytes

    got = brute_force_pairs(lib.blobs, 50, workers=4)
    assert got == set(lib.planted)
    assert all(int(matchHashBytes(lib.blobs[a], lib.blobs[b])) == 100 for a, b in got)
    # a lower bar admits nothing new either; threshold 100 keeps them all
    assert brute_force_pairs(lib.blobs, 100, workers=2) == got


def test_engine_pruned_route_matches_the_oracle(lib):
    from hydrus_video_deduplicator_tpu.parallel.engine import TpuSearchEngine

    hits = TpuSearchEngine(force_segments=True).find_pairs_pruned(lib.blobs, lib.blobs, 50)
    pairs = {(min(i, j), max(i, j)) for i, j, _ in hits if i != j}
    assert pairs == brute_force_pairs(lib.blobs, 50, workers=4)


def test_smoke_library_phase_through_deduplicate(lib):
    """chip_smoke's phase-4 run on the CPU: the queue load, deduplicate()
    and the re-run, against the brute-force oracle."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).parents[2]))
    import chip_smoke

    marked, reported, rerun, prefilter = chip_smoke.run_library(lib.blobs, "cpu", "test")
    assert marked == brute_force_pairs(lib.blobs, chip_smoke.min_similarity(), workers=4)
    assert reported == len(marked)
    assert rerun == 0
    assert prefilter == [True]


def test_y4m_library_decodes_and_hashes():
    from hydrus_video_deduplicator_tpu.decode import extract_frames
    from hydrus_video_deduplicator_tpu.hashing import compute_phash

    videos, pairs = y4m_library(12, seed=1)
    assert pairs == [(9, 10)]
    assert compute_phash(videos[0]).bytes == b""  # constant colour: empty
    frames = list(extract_frames(videos[1]))
    assert frames and frames[0].shape == (512, 512, 3)
    a, b = (compute_phash(videos[i]).bytes for i in pairs[0])
    assert a and b and len(a) == len(b)
