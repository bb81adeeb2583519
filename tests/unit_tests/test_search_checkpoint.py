"""Per-chunk checkpointing of the batched device search (stage 4).

The reference marks each file's search-cache entry as it is searched, so
an interrupt loses at most one file of work. The all-pairs engine searches
in SEARCH_CHECKPOINT_ROWS chunks and commits each chunk's cache entries
after its pairs are marked — an interrupt loses at most one chunk. These
tests drive the real orchestrator against the live fake Hydrus: abort
between chunks, assert the committed partial state, resume, and assert the
end state matches the uninterrupted tree backend.
"""

from __future__ import annotations

import uuid

import numpy as np
import pytest

from hydrus_video_deduplicator_tpu.client import HVDClient
from hydrus_video_deduplicator_tpu.db import DedupeDB
from hydrus_video_deduplicator_tpu.dedup import HydrusVideoDeduplicator

from ..fake_hydrus import (
    CORPUS_EXPECTED_PAIRS as EXPECTED_PAIRS,
    DEFAULT_ACCESS_KEY,
    FakeHydrus,
    corpus_file_store,
)


@pytest.fixture()
def fake_server():
    server = FakeHydrus(corpus_file_store())
    server.start()
    yield server
    server.stop()


def _make_deduper(server, tmp_path, **kwargs):
    DedupeDB.set_db_dir(tmp_path / uuid.uuid4().hex)
    DedupeDB.create_db()
    db = DedupeDB.DedupeDb(DedupeDB.get_db_dir(), DedupeDB.get_db_name())
    db.init_connection()
    client = HVDClient(None, server.url, DEFAULT_ACCESS_KEY, None)
    return db, HydrusVideoDeduplicator(db, client, **kwargs)


def _searched_count(db):
    return db.execute(
        "SELECT COUNT(*) FROM shape_search_cache WHERE searched_distance IS NOT NULL"
    ).fetchone()[0]


def test_interrupt_between_chunks_checkpoints(fake_server, tmp_path, monkeypatch):
    monkeypatch.setattr(HydrusVideoDeduplicator, "SEARCH_CHECKPOINT_ROWS", 5)
    db, deduper = _make_deduper(fake_server, tmp_path, search_backend="tpu")

    # stages 1-3: hash everything, build the queue/tree state
    all_hashes = list(deduper.client.get_video_hashes(deduper.search_tags))
    db.begin_transaction()
    with db.conn:
        deduper.add_perceptual_hashes_to_db(all_hashes)
        deduper.process_phashed_file_queue()

    n_files = db.execute("SELECT COUNT(*) FROM shape_search_cache").fetchone()[0]
    assert n_files > 10  # several 5-row chunks

    # skip fires at the second chunk boundary: the cache rows only appear
    # after chunk 1 fully completes (search + marking + cache UPDATE), so
    # chunk 1 runs to its commit and chunk 2 never starts
    def skip_after_first_chunk() -> bool:
        return _searched_count(db) >= 5

    deduper.should_skip_step_fn = skip_after_first_chunk
    db.begin_transaction()
    with db.conn:
        deduper.find_potential_duplicates()
        # durability: a SECOND connection (which can only see committed
        # data) observes the chunk's cache entries while the orchestrator
        # connection's transaction is still open
        import sqlite3

        other = sqlite3.connect(DedupeDB.get_db_file_path())
        committed = other.execute(
            "SELECT COUNT(*) FROM shape_search_cache"
            " WHERE searched_distance IS NOT NULL"
        ).fetchone()[0]
        other.close()
        assert committed == 5

    searched = _searched_count(db)
    assert searched == 5  # exactly the first chunk was committed
    partial_rel = len(fake_server.relationships)

    # resume without the skip: only the remaining files are searched and
    # the end state matches a full run
    deduper.should_skip_step_fn = None
    remaining = db.execute(
        "SELECT COUNT(*) FROM shape_search_cache WHERE searched_distance IS NULL"
    ).fetchone()[0]
    assert remaining == n_files - 5
    db.begin_transaction()
    with db.conn:
        deduper.find_potential_duplicates()
    assert _searched_count(db) == n_files
    assert len(fake_server.relationships) == EXPECTED_PAIRS
    assert partial_rel <= EXPECTED_PAIRS


def test_chunked_run_matches_unchunked(fake_server, tmp_path, monkeypatch):
    """Tiny chunks produce the identical relationship set and search cache
    as one big batch."""
    monkeypatch.setattr(HydrusVideoDeduplicator, "SEARCH_CHECKPOINT_ROWS", 3)
    db, deduper = _make_deduper(fake_server, tmp_path, search_backend="tpu")
    all_hashes = list(deduper.client.get_video_hashes(deduper.search_tags))
    db.begin_transaction()
    with db.conn:
        deduper.add_perceptual_hashes_to_db(all_hashes)
        deduper.process_phashed_file_queue()
        deduper.find_potential_duplicates()
    assert len(fake_server.relationships) == EXPECTED_PAIRS
    n_files = db.execute("SELECT COUNT(*) FROM shape_search_cache").fetchone()[0]
    assert _searched_count(db) == n_files


def _random_corpus(rng, with_long=False):
    n = int(rng.integers(10, 60))
    vids = []
    for _ in range(n):
        c = int(rng.choice([0, 1, 2, 5, 9, 17]))
        vids.append(rng.integers(0, 256, (c, 32), dtype=np.uint8).tobytes())
    if n >= 6:
        vids[5] = vids[2]  # planted dup
    if with_long:
        vids[0] = rng.integers(0, 256, (1025, 32), dtype=np.uint8).tobytes()
    return vids


@pytest.mark.parametrize("force_segments", [False, True])
def test_col_limit_property(rng, force_segments):
    """Property: find_pairs(col_limit=L) returns exactly the full-sweep hits
    whose corpus index is < L, on both engine routes, including the host
    long-video path."""
    from hydrus_video_deduplicator_tpu.parallel.engine import TpuSearchEngine

    for trial in range(4):
        vids = _random_corpus(rng, with_long=(trial == 0))
        n = len(vids)
        eng = TpuSearchEngine(
            tile_rows=8, tile_cols=8, force_segments=force_segments
        )
        full = eng.find_pairs(vids, vids, 75)
        for limit in {1, n // 3, n // 2, n}:
            want = sorted(h for h in full if h[1] < limit)
            got = sorted(eng.find_pairs(vids, vids, 75, col_limit=limit))
            assert got == want, f"trial {trial} limit {limit}"


@pytest.mark.parametrize("force_segments", [False, True])
def test_triangle_schedule_property(rng, force_segments):
    """Property: the stage-4 triangle schedule (chunks in corpus order, each
    chunk limited to the corpus prefix ending at its own end, one shared
    col_state) finds every unordered pair: same-chunk pairs in both
    directions, cross-chunk pairs exactly once (later row, earlier column),
    self-matches once — i.e. the square sweep minus one copy of each
    cross-chunk pair."""
    from hydrus_video_deduplicator_tpu.parallel.engine import TpuSearchEngine

    for trial in range(4):
        vids = _random_corpus(rng, with_long=(trial == 0))
        n = len(vids)
        eng = TpuSearchEngine(
            tile_rows=8, tile_cols=8, force_segments=force_segments
        )
        square = eng.find_pairs(vids, vids, 75)

        col_state: dict = {}
        got = []
        bounds = []
        k0 = 0
        while k0 < n:
            step = int(rng.integers(1, max(2, n // 3)))
            k1 = min(n, k0 + step)
            bounds.append((k0, k1))
            hits = eng.find_pairs(
                vids[k0:k1], vids, 75, col_state=col_state, col_limit=k1
            )
            got.extend((r + k0, c, s) for r, c, s in hits)
            k0 = k1

        def chunk_of(i):
            return next(k for k, (a, b) in enumerate(bounds) if a <= i < b)

        want = [
            (r, c, s)
            for r, c, s in square
            if r == c or chunk_of(r) == chunk_of(c) or r > c
        ]
        assert sorted(got) == sorted(want), f"trial {trial}"


def test_chunked_find_pairs_property(rng):
    """Property: for random corpora (mixed frame counts incl. empty and
    long videos) and random chunk splits, the union of per-chunk hits with
    a shared col_state equals the single-batch hit set exactly."""
    from hydrus_video_deduplicator_tpu.parallel.engine import TpuSearchEngine

    for trial in range(5):
        n = int(rng.integers(10, 60))
        vids = []
        for _ in range(n):
            c = int(rng.choice([0, 1, 2, 5, 9, 17]))
            vids.append(rng.integers(0, 256, (c, 32), dtype=np.uint8).tobytes())
        if n >= 6:
            vids[5] = vids[2]  # planted dup
        if trial == 0:  # one host-path long video (> MAX_BUCKET frames)
            vids[0] = rng.integers(0, 256, (1025, 32), dtype=np.uint8).tobytes()

        eng = TpuSearchEngine(tile_rows=8, tile_cols=8)
        want = sorted(eng.find_pairs(vids, vids, 75))

        col_state: dict = {}
        got = []
        k0 = 0
        while k0 < n:
            step = int(rng.integers(1, n))
            chunk = vids[k0 : k0 + step]
            hits = eng.find_pairs(chunk, vids, 75, col_state=col_state)
            got.extend((r + k0, c, s) for r, c, s in hits)
            k0 += step
        assert sorted(got) == want, f"trial {trial}"
