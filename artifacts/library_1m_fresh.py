"""FRESH-library production rehearsal at the realistic scene profile.

library_10m_rehearsal.py measures production stage 2 at 10M plus a 100k
DELTA against an already-processed library (8-frame blobs). This driver
measures the other headline shape: a library of N videos at the
**mean-71 ragged scene profile** (sweep_scenes' generative model — the
exact seed-7 corpus every sweep_scenes_1m_*.log measured, plants,
subset clips and empty hashes included) that has NEVER been searched,
taken end to end through the production orchestrator:

  stage 2   `process_phashed_file_queue` binds all N rows into the
            reference schema,
  stage 3   `run_maintenance`,
  stage 4   `deduplicate(skip_hashing=True)` sweeps the full fresh
            triangle (every row unsearched; the searched-first prefix
            ordering of dedup._find_potential_duplicates_tpu makes each
            chunk's comparison set a corpus prefix) with DbBlobColumn
            streaming the column corpus from SQLite, and POSTs every
            found pair to a live fake Hydrus HTTP server through the
            vendored client.

Verification is exact: the server's relationship set must equal the
planted pair set (computed up front with matchHashBytes at the same
min_sim stage 4 derives from --threshold 75), the search cache must be
fully marked, and an immediate re-run must find nothing new.

This is the production-path counterpart of the engine-level
sweep_scenes 1M runs: the same
corpus and the same exactness bar, but through the real user
invocation path — stage 2, checkpointing, pair marking and all.

Reference anchor: the reference's fresh-library path is its
dedup.py:433-514 per-file VP-tree loop; its own rig never exceeds ~120
files (tests/unit_tests/test_dedup.py).

Usage:  python artifacts/library_1m_fresh.py [n]    # default 1,000,000
Smoke:  python artifacts/library_1m_fresh.py 3000   # fine on CPU mesh
"""

from __future__ import annotations

import os
import resource
import sys
import tempfile
import time

ART = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(ART))
sys.path.insert(0, ART)

import numpy as np

N = int(sys.argv[1]) if len(sys.argv) > 1 else 1_000_000

# sweep_scenes reads its corpus parameters from argv at import time;
# pin them so build_corpus(seed 7) is the exact measured sweep corpus.
_argv, sys.argv = sys.argv, ["sweep_scenes", str(N), "131072", "pruned"]
import sweep_scenes as ss  # noqa: E402

sys.argv = _argv

THRESHOLD = 75.0


def log(msg):
    rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
    print(f"[{time.strftime('%H:%M:%S')}] (rss {rss:.1f}G) {msg}", flush=True)


def file_hash(i: int) -> str:
    return f"{i:016x}" + "00" * 24


def main():
    os.environ.setdefault("HVD_SQLITE_CACHE_MB", "1024")
    import jax

    from hydrus_video_deduplicator_tpu import device

    device.enable_compile_cache()
    log(f"device: {jax.devices()[0]}; FRESH library N={N}")

    sys.path.insert(0, os.path.join(os.path.dirname(ART), "tests"))
    from fake_hydrus import DEFAULT_ACCESS_KEY, FakeHydrus

    import hydrus_video_deduplicator_tpu.db.DedupeDB as DedupeDB
    from hydrus_video_deduplicator_tpu import dedup as dd
    from hydrus_video_deduplicator_tpu.client import HVDClient
    from hydrus_video_deduplicator_tpu.db import vptree

    search_threshold = vptree.fix_vpdq_similarity(THRESHOLD)
    min_sim = max(1, 101 - search_threshold)
    assert min_sim == ss.MIN_SIM, (min_sim, ss.MIN_SIM)

    # --- corpus: the seed-7 scene-model library --------------------------
    blobs, expected, n_empty = ss.build_corpus(np.random.default_rng(7))
    expected_undirected = {(a, b) for (a, b) in expected if a < b}

    workdir = os.environ.get("HVD_FRESH_DIR") or tempfile.mkdtemp(prefix="hvd_fresh_")
    os.makedirs(workdir, exist_ok=True)
    DedupeDB.set_db_dir(workdir)
    if not os.path.exists(os.path.join(workdir, DedupeDB.get_db_name())):
        DedupeDB.create_db()
    db = DedupeDB.DedupeDb(DedupeDB.get_db_dir(), DedupeDB.get_db_name())
    db.init_connection()

    server = FakeHydrus({})
    server.start()
    client = HVDClient(None, server.url, DEFAULT_ACCESS_KEY, None)

    # --- queue all N rows (simulated stage-1 output) ----------------------
    t0 = time.time()
    B = 50_000
    for i0 in range(0, N, B):
        db.conn.executemany(
            "INSERT OR REPLACE INTO phashed_file_queue (file_hash, phash) VALUES (?, ?)",
            [(file_hash(i), blobs[i]) for i in range(i0, min(i0 + B, N))],
        )
    db.commit()
    log(f"queue filled: {N} rows in {time.time() - t0:.1f}s")
    del blobs  # stage 4 must stream blobs from SQLite, not this list

    deduper = dd.HydrusVideoDeduplicator(db, client=client, search_backend="tpu")
    deduper.threshold = THRESHOLD

    # --- stage 2/3 through the production drain ---------------------------
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
        f"STAGE2: drained {N} rows in {t_stage2:.1f}s ({N / t_stage2:.0f} rows/s), "
        f"maintenance {t_maint:.1f}s; files={nfiles} queue_left={left}"
    )
    assert left == 0 and nfiles == N, (left, nfiles)
    sz = os.path.getsize(os.path.join(workdir, DedupeDB.get_db_name())) / 1e9
    log(f"DB size {sz:.2f}G")

    # --- stage 4: the fresh full triangle through deduplicate() -----------
    t0 = time.time()
    pairs = deduper.deduplicate(skip_hashing=True)
    t_search = time.time() - t0
    log(f"STAGE4: fresh deduplicate() at {N}x{N}: reported {pairs} pairs in {t_search:.1f}s")

    got_hashes = {tuple(sorted(p)) for p in server.relationships}
    idx = {file_hash(i): i for i in range(N)}
    got = {tuple(sorted((idx[a], idx[b]))) for a, b in got_hashes}
    missing = expected_undirected - got
    extras = got - expected_undirected
    unsearched = db.execute(
        "SELECT count(*) FROM shape_search_cache WHERE searched_distance IS NULL"
        " OR searched_distance < ?",
        (search_threshold,),
    ).fetchone()[0]
    log(
        f"verify: marked {len(got)} pairs (expected {len(expected_undirected)}); "
        f"missing {len(missing)}, extras {len(extras)}; unsearched left {unsearched}"
    )
    assert not missing and not extras and unsearched == 0, (
        sorted(missing)[:5],
        sorted(extras)[:5],
        unsearched,
    )

    # --- incremental contract ---------------------------------------------
    t0 = time.time()
    pairs2 = deduper.deduplicate(skip_hashing=True)
    log(f"re-run: {pairs2} pairs in {time.time() - t0:.1f}s (expected 0)")
    assert pairs2 == 0, pairs2

    log(
        f"SUMMARY: fresh {N}-video library (scene profile, {n_empty} empty): "
        f"stage2 {t_stage2:.1f}s, maintenance {t_maint:.1f}s, search+mark "
        f"{t_search:.1f}s ({len(got)} pairs marked, exact), total "
        f"{t_stage2 + t_maint + t_search:.1f}s on {jax.devices()[0].device_kind}. "
        f"CORRECTNESS: exact"
    )
    server.stop()
    db.close()


if __name__ == "__main__":
    main()
