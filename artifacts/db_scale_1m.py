"""MEASURED 1M-row stage-2/3 DB machinery.

Stage 2 (`dedup.process_phashed_file_queue`, dedup.py:599-642) drains the
phashed_file_queue into the files/phash/map tables row by row — 4 SQL
statements per row plus the tree-descent decision. On the device search route
the per-insert VP-tree descent is DEFERRED (build_tree=False;
`_reconcile_tree` reconciles on demand if the tree path is ever chosen),
so stage 2 must stay linear-SQLite-bound at corpus scale. This driver
proves it at 1M rows and measures the tree path's insert rate for honest
comparison.

What it does:
  1. synthesizes 1M (file_hash, 8-frame phash) rows straight into
     phashed_file_queue (simulating stage-1 output), executemany-batched;
  2. runs the production `process_phashed_file_queue` (device deferral route)
     + `run_maintenance` at 1M rows — wall, rows/s, RSS delta, DB size;
  3. re-runs stage 2 on a fresh DB at TREE_N rows with build_tree=True
     (the reference's per-insert descent, db/vptree.py) and reports the
     measured insert rate + its 1M projection.

Reference anchor: the loop this scales is the reference's
`dedup.py:253-294` (add_to_phashed_files_queue -> queue processing) and
its per-insert `vptree.add_leaf` descent.

Usage: python artifacts/db_scale_1m.py [n_rows] [tree_rows]
"""

from __future__ import annotations

import os
import resource
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

N = int(sys.argv[1]) if len(sys.argv) > 1 else 1_000_000
TREE_N = int(sys.argv[2]) if len(sys.argv) > 2 else 100_000
FRAMES = 8


def log(msg):
    rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
    print(f"[{time.strftime('%H:%M:%S')}] (rss {rss:.1f}G) {msg}", flush=True)


def fill_queue(db, n, seed=5):
    rng = np.random.default_rng(seed)
    t0 = time.time()
    B = 50_000
    for i0 in range(0, n, B):
        b = min(B, n - i0)
        raw = rng.integers(0, 256, (b, FRAMES * 32), dtype=np.uint8)
        rows = [
            (f"{i0 + k:08x}" + "00" * 28, raw[k].tobytes()) for k in range(b)
        ]
        db.conn.executemany(
            "INSERT OR REPLACE INTO phashed_file_queue (file_hash, phash) VALUES (?, ?)",
            rows,
        )
    db.commit()
    log(f"queue filled: {n} rows in {time.time()-t0:.1f}s")


def stage23(db, backend, label):
    from hydrus_video_deduplicator_tpu import dedup as dd

    deduper = dd.HydrusVideoDeduplicator(db, client=None, search_backend=backend)
    deduper.threshold = 75.0
    n = db.execute("SELECT count(*) FROM phashed_file_queue").fetchone()[0]
    r0 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
    t0 = time.time()
    db.begin_transaction()
    with db.conn:
        deduper.process_phashed_file_queue()
    t_q = time.time() - t0
    t0 = time.time()
    db.begin_transaction()
    with db.conn:
        deduper.run_maintenance()
    t_m = time.time() - t0
    r1 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
    left = db.execute("SELECT count(*) FROM phashed_file_queue").fetchone()[0]
    nfiles = db.execute("SELECT count(*) FROM files").fetchone()[0]
    nmap = db.execute(
        "SELECT count(*) FROM shape_perceptual_hash_map"
    ).fetchone()[0]
    log(
        f"[{label}] stage2 {n} rows in {t_q:.1f}s ({n / max(t_q, 1e-9):.0f} rows/s), "
        f"maintenance {t_m:.1f}s; queue left {left}, files {nfiles}, map {nmap}; "
        f"RSS delta {r1 - r0:.2f}G"
    )
    assert left == 0 and nfiles == n and nmap == n, (left, nfiles, nmap)
    return t_q


def per_row_ladder(DedupeDB, sizes):
    """The pre-round-3 per-row stage-2 loop, replicated directly (add_file
    + add_perceptual_hash + associate(build_tree=False) + queue DELETE),
    at a ladder of sizes. Without the hash_id index on
    shape_perceptual_hash_map this collapses quadratically (960 rows/s at
    20k -> ~200 rows/s at 1M, a 14-hour stage 2 — the run this driver
    replaced was stopped at 80+ min); with it the rate stays flat."""
    for n in sizes:
        with tempfile.TemporaryDirectory() as dbdir:
            DedupeDB.set_db_dir(dbdir)
            DedupeDB.create_db()
            db = DedupeDB.DedupeDb(DedupeDB.get_db_dir(), DedupeDB.get_db_name())
            db.init_connection()
            fill_queue(db, n, seed=9)
            t0 = time.time()
            db.begin_transaction()
            with db.conn:
                for file_hash, phash in db.execute(
                    "SELECT file_hash, phash FROM phashed_file_queue"
                ).fetchall():
                    db.add_file(file_hash)
                    db.add_perceptual_hash(phash)
                    db.associate_file_with_perceptual_hash(
                        file_hash, phash, build_tree=False
                    )
                    db.execute(
                        "DELETE FROM phashed_file_queue WHERE file_hash = :f",
                        {"f": file_hash},
                    )
            db.commit()
            dt = time.time() - t0
            log(f"[per-row {n}] {dt:.1f}s ({n / dt:.0f} rows/s)")
            db.close()


def main():
    import hydrus_video_deduplicator_tpu.db.DedupeDB as DedupeDB

    # --- per-row loop rate ladder (flat now that the map is indexed) ---
    per_row_ladder(DedupeDB, [25_000, 100_000, 400_000])

    # --- 1M rows, production device route (set-based batched drain) ---
    with tempfile.TemporaryDirectory() as dbdir:
        DedupeDB.set_db_dir(dbdir)
        DedupeDB.create_db()
        db = DedupeDB.DedupeDb(DedupeDB.get_db_dir(), DedupeDB.get_db_name())
        db.init_connection()
        fill_queue(db, N)
        t_q = stage23(db, "tpu", f"device-route {N}")
        sz = os.path.getsize(os.path.join(dbdir, DedupeDB.get_db_name())) / 1e9
        log(f"[device-route {N}] DB size {sz:.2f}G")
        db.close()

    # --- TREE_N rows, per-insert descent (reference semantics) ---
    with tempfile.TemporaryDirectory() as dbdir:
        DedupeDB.set_db_dir(dbdir)
        DedupeDB.create_db()
        db = DedupeDB.DedupeDb(DedupeDB.get_db_dir(), DedupeDB.get_db_name())
        db.init_connection()
        fill_queue(db, TREE_N, seed=6)
        t_tree = stage23(db, "tree", f"tree-route {TREE_N}")
        db.close()
    log(
        f"SUMMARY: batched route {N} rows {t_q:.1f}s; per-insert tree route "
        f"{TREE_N} rows {t_tree:.1f}s -> 1M projection ~{t_tree * N / TREE_N / 60:.0f} min"
    )


if __name__ == "__main__":
    main()
