"""10M-file Hydrus LIBRARY rehearsal through the PRODUCTION pipeline.

Prior 10M evidence drove the engine directly (artifacts/delta_10m.py) or
stage 2 alone (artifacts/db_scale_1m.py). This driver runs the real
orchestrator end to end at library scale — the exact code path a user's
`python -m hydrus_video_deduplicator_tpu` invocation takes — against a
live stateful fake Hydrus server (tests/fake_hydrus.py over HTTP):

  phase 1  seed 10M corpus rows into phashed_file_queue (simulated
           stage-1 output; blobs are 8-frame random hashes, the
           delta_10m corpus model) and drain them through the PRODUCTION
           `process_phashed_file_queue` + `run_maintenance` — stage 2/3
           at 10M rows in one invocation (db_scale_1m proved 1M).
  phase 2  mark the corpus searched (`shape_search_cache`), the state a
           fully-processed library is in.
  phase 3  queue N_NEW new files — N_PLANT of them near-duplicates of
           corpus files (1 bit flipped per frame => similarity 100) —
           and run `HydrusVideoDeduplicator.deduplicate(skip_hashing=
           True)`: production stage 2 drains the delta, production
           stage 4 (the `_find_potential_duplicates_tpu` triangle /
           shape_search_cache contract, dedup.py) sweeps new x 10.1M
           with DbBlobColumn streaming, and every found pair is POSTed
           to the fake server through the vendored hydrus_api client.
  verify   the server's relationship set is EXACTLY the planted pairs
           (8-frame random 256-bit hashes have ~0 spurious-match mass at
           similarity >= 75), the search cache is fully marked, and a
           re-invocation of deduplicate() finds nothing new (the
           incremental contract at 10M).

Reference anchor: the reference's equivalent path is dedup.py:346-514
(hashing loop -> queue processing -> per-file tree search); its own test
rig never exceeds ~120 files (tests/unit_tests/test_dedup.py), so this
rehearsal is evidence the re-design actually holds at the 10M-library
scale the reference only aspires to.

Usage: python artifacts/library_10m_rehearsal.py [n_corpus] [n_new]
"""

from __future__ import annotations

import os
import resource
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

N_CORPUS = int(sys.argv[1]) if len(sys.argv) > 1 else 10_000_000
N_NEW = int(sys.argv[2]) if len(sys.argv) > 2 else 100_000
FRAMES = 8
N_PLANT = min(1_000, N_NEW)
PLANT_STRIDE = max(1, N_CORPUS // (N_PLANT + 1))
THRESHOLD = 75.0


def log(msg):
    rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
    print(f"[{time.strftime('%H:%M:%S')}] (rss {rss:.1f}G) {msg}", flush=True)


def corpus_hash(i: int) -> str:
    return f"{i:016x}" + "00" * 24


def new_hash(k: int) -> str:
    return f"{k:016x}" + "ff" + "00" * 23


def fill_corpus_queue(db) -> dict[int, bytes]:
    """Queue N_CORPUS synthetic stage-1 rows; returns the plant targets'
    blobs (corpus index -> phash bytes) captured during generation."""
    rng = np.random.default_rng(7)
    plant_targets = {k * PLANT_STRIDE for k in range(N_PLANT)}
    saved: dict[int, bytes] = {}
    t0 = time.time()
    B = 100_000
    for i0 in range(0, N_CORPUS, B):
        b = min(B, N_CORPUS - i0)
        raw = rng.integers(0, 256, (b, FRAMES * 32), dtype=np.uint8)
        rows = []
        for k in range(b):
            i = i0 + k
            blob = raw[k].tobytes()
            if i in plant_targets:
                saved[i] = blob
            rows.append((corpus_hash(i), blob))
        db.conn.executemany(
            "INSERT OR REPLACE INTO phashed_file_queue (file_hash, phash) VALUES (?, ?)",
            rows,
        )
        if (i0 // B) % 10 == 9:
            db.commit()
    db.commit()
    log(f"corpus queue filled: {N_CORPUS} rows in {time.time() - t0:.1f}s")
    return saved


def fill_new_queue(db, saved: dict[int, bytes]) -> set[tuple[str, str]]:
    """Queue N_NEW rows; row k < N_PLANT re-encodes corpus k*PLANT_STRIDE
    (one bit flipped per frame => frame distance 1 <= 31 => sim 100)."""
    rng = np.random.default_rng(11)
    expected: set[tuple[str, str]] = set()
    rows = []
    for k in range(N_NEW):
        if k < N_PLANT:
            tgt = k * PLANT_STRIDE
            arr = np.frombuffer(saved[tgt], dtype=np.uint8).copy()
            arr = arr.reshape(FRAMES, 32)
            arr[:, k % 32] ^= np.uint8(1 << (k % 8))
            blob = arr.tobytes()
            pair = tuple(sorted((new_hash(k), corpus_hash(tgt))))
            expected.add(pair)
        else:
            blob = rng.integers(0, 256, FRAMES * 32, dtype=np.uint8).tobytes()
        rows.append((new_hash(k), blob))
    db.conn.executemany(
        "INSERT OR REPLACE INTO phashed_file_queue (file_hash, phash) VALUES (?, ?)",
        rows,
    )
    db.commit()
    log(f"new queue filled: {N_NEW} rows ({N_PLANT} plants)")
    return expected


def main():
    # A 10M-file library's UNIQUE-index working set is ~0.4 GB per 1M files
    # (random-order file hashes + 256-byte phash blobs); the default 256 MiB
    # page cache thrashes at this scale (measured decline in
    # Size the cache like a real 10M-library
    # deployment would — the knob exists for exactly this.
    os.environ.setdefault("HVD_SQLITE_CACHE_MB", "4096")
    import jax

    from hydrus_video_deduplicator_tpu import device

    device.enable_compile_cache()
    log(f"device: {jax.devices()[0]}; corpus={N_CORPUS} new={N_NEW}")

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tests"))
    from fake_hydrus import DEFAULT_ACCESS_KEY, FakeHydrus

    import hydrus_video_deduplicator_tpu.db.DedupeDB as DedupeDB
    from hydrus_video_deduplicator_tpu import dedup as dd
    from hydrus_video_deduplicator_tpu.client import HVDClient
    from hydrus_video_deduplicator_tpu.db import vptree

    workdir = os.environ.get("HVD_REHEARSAL_DIR") or tempfile.mkdtemp(prefix="hvd_rehearsal_")
    os.makedirs(workdir, exist_ok=True)
    DedupeDB.set_db_dir(workdir)
    if not os.path.exists(os.path.join(workdir, DedupeDB.get_db_name())):
        DedupeDB.create_db()
    db = DedupeDB.DedupeDb(DedupeDB.get_db_dir(), DedupeDB.get_db_name())
    db.init_connection()

    server = FakeHydrus({})
    server.start()
    client = HVDClient(None, server.url, DEFAULT_ACCESS_KEY, None)

    search_threshold = vptree.fix_vpdq_similarity(THRESHOLD)

    # --- phase 1: stage 2/3 at 10M through the production drain ---------
    saved = fill_corpus_queue(db)
    deduper = dd.HydrusVideoDeduplicator(db, client=client, search_backend="tpu")
    deduper.threshold = THRESHOLD
    t0 = time.time()
    db.begin_transaction()
    with db.conn:
        deduper.process_phashed_file_queue()
    t_stage2 = time.time() - t0
    t0 = time.time()
    db.begin_transaction()
    with db.conn:
        deduper.run_maintenance()
    t_maint = time.time() - t0
    nfiles = db.execute("SELECT count(*) FROM files").fetchone()[0]
    left = db.execute("SELECT count(*) FROM phashed_file_queue").fetchone()[0]
    log(
        f"PHASE1: production stage 2 drained {N_CORPUS} rows in {t_stage2:.1f}s "
        f"({N_CORPUS / t_stage2:.0f} rows/s), maintenance {t_maint:.1f}s; "
        f"files={nfiles} queue_left={left}"
    )
    assert left == 0 and nfiles == N_CORPUS, (left, nfiles)
    sz = os.path.getsize(os.path.join(workdir, DedupeDB.get_db_name())) / 1e9
    log(f"DB size {sz:.2f}G")

    # --- phase 2: the fully-processed-library state ----------------------
    t0 = time.time()
    db.conn.execute(
        "UPDATE shape_search_cache SET searched_distance = ?", (search_threshold,)
    )
    db.commit()
    log(f"PHASE2: corpus marked searched in {time.time() - t0:.1f}s")

    # --- phase 3: the 100k delta through deduplicate() -------------------
    expected = fill_new_queue(db, saved)
    t0 = time.time()
    pairs = deduper.deduplicate(skip_hashing=True)
    t_delta = time.time() - t0
    log(
        f"PHASE3: deduplicate(skip_hashing=True) at {N_NEW}x{N_CORPUS + N_NEW}: "
        f"{pairs} pairs in {t_delta:.1f}s"
    )

    got = {tuple(sorted(p)) for p in server.relationships}
    missing = expected - got
    extras = got - expected
    unsearched = db.execute(
        "SELECT count(*) FROM shape_search_cache WHERE searched_distance IS NULL"
        " OR searched_distance < ?",
        (search_threshold,),
    ).fetchone()[0]
    log(
        f"verify: marked {len(got)} pairs; missing {len(missing)}, extras "
        f"{len(extras)}; unsearched rows left {unsearched}"
    )
    assert not missing and not extras and unsearched == 0, (
        len(missing),
        len(extras),
        unsearched,
    )

    # --- incremental contract: a re-run finds nothing new ----------------
    t0 = time.time()
    pairs2 = deduper.deduplicate(skip_hashing=True)
    log(f"re-run: {pairs2} pairs in {time.time() - t0:.1f}s (expected 0)")
    assert pairs2 == 0, pairs2

    # reference accounting quirk preserved: a new-vs-already-searched pair
    # is one directional event and the total halves (tree route above),
    # so 1000 planted pairs report as 500 — the MARKED set is the real
    # contract and is asserted exact.
    assert pairs == N_PLANT // 2, pairs
    log(
        f"SUMMARY: stage2 {t_stage2:.1f}s, maintenance {t_maint:.1f}s, "
        f"delta-dedupe {t_delta:.1f}s, reported pair count {pairs} "
        f"(events//2, reference semantics), marked pairs {len(got)} "
        f"(= {N_PLANT} planted), CORRECTNESS: exact"
    )
    server.stop()
    db.close()


if __name__ == "__main__":
    main()
