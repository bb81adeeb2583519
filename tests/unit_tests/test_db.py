"""DB layer tests (mirrors reference tests/unit_tests/test_db.py) plus
VP-tree behavior tests against brute-force ground truth."""

from __future__ import annotations

import sqlite3
import uuid
from pathlib import Path
from tempfile import TemporaryDirectory

import numpy as np
import pytest

from hydrus_video_deduplicator_tpu.db import DedupeDB, vptree
from hydrus_video_deduplicator_tpu.vpdq import matchHashBytes


def somedbdir():
    return str(uuid.uuid4().hex)


def test_set_get_db_dir():
    with TemporaryDirectory() as tmp:
        d = Path(tmp) / somedbdir()
        DedupeDB.set_db_dir(d)
        assert DedupeDB.get_db_dir() == d
        assert DedupeDB.get_db_file_path() == d / "videohashes.sqlite"


def test_create_db_schema():
    with TemporaryDirectory() as tmp:
        DedupeDB.set_db_dir(Path(tmp) / somedbdir())
        DedupeDB.create_db()
        path = DedupeDB.get_db_file_path()
        assert path.is_file()

        con = sqlite3.connect(path)
        cur = con.cursor()
        tables = {r[0] for r in cur.execute("SELECT name FROM sqlite_master WHERE type='table'")}
        assert tables == {
            "version",
            "files",
            "phashed_file_queue",
            "shape_maintenance_branch_regen",
            "shape_perceptual_hash_map",
            "shape_perceptual_hashes",
            "shape_search_cache",
            "shape_vptree",
        }
        expected_columns = {
            "files": ["hash_id", "file_hash"],
            "phashed_file_queue": ["file_hash", "phash"],
            "shape_maintenance_branch_regen": ["phash_id"],
            "shape_perceptual_hash_map": ["phash_id", "hash_id"],
            "shape_perceptual_hashes": ["phash_id", "phash"],
            "shape_search_cache": ["hash_id", "searched_distance"],
            "shape_vptree": [
                "phash_id",
                "parent_id",
                "radius",
                "inner_id",
                "inner_population",
                "outer_id",
                "outer_population",
            ],
        }
        for table, cols in expected_columns.items():
            rows = cur.execute(f"SELECT {', '.join(cols)} FROM {table}").fetchall()
            assert rows == []
        version = cur.execute("SELECT version FROM version").fetchall()
        assert version == [(DedupeDB.DB_VERSION,)]
        con.close()


def test_version_roundtrip_and_semver():
    with TemporaryDirectory() as tmp:
        DedupeDB.set_db_dir(Path(tmp) / somedbdir())
        DedupeDB.create_db()
        db = DedupeDB.DedupeDb(DedupeDB.get_db_dir(), DedupeDB.get_db_name())
        db.init_connection()
        db.set_version("1.2.3")
        assert db.get_version() == "1.2.3"
        db.close()

    sv = DedupeDB.SemanticVersion
    assert sv("0.1.0") < sv("0.2.0")
    assert sv("1.0.10") < sv("1.1.0")
    assert sv("1.0.0") >= sv("0.0.100")
    assert sv("0.0.0") == sv("0.0.0")
    with pytest.raises(DedupeDB.DedupeDbException):
        sv("1.2")
    with pytest.raises(DedupeDB.DedupeDbException):
        sv("a.b.c")


def test_downgrade_refused():
    with TemporaryDirectory() as tmp:
        DedupeDB.set_db_dir(Path(tmp) / somedbdir())
        DedupeDB.create_db()
        db = DedupeDB.DedupeDb(DedupeDB.get_db_dir(), DedupeDB.get_db_name())
        db.init_connection()
        db.set_version("99.0.0")
        db.commit()
        with pytest.raises(DedupeDB.DedupeDbException):
            db.upgrade_db()
        db.close()


def test_migration_0_10_0_hash_conversion():
    """Old JSON 'phash,quality,frame' triples -> packed bytes, byte order
    reversed, quality < 31 dropped (reference DedupeDB.py:525-577)."""
    import json

    with TemporaryDirectory() as tmp:
        DedupeDB.set_db_dir(Path(tmp) / somedbdir())
        DedupeDB.create_db()
        db = DedupeDB.DedupeDb(DedupeDB.get_db_dir(), DedupeDB.get_db_name())
        db.init_connection()
        db.set_version("0.7.0")
        h1 = bytes(range(32))
        h2 = bytes(range(32, 64))
        old = json.dumps([f"{h1[::-1].hex()},80,0", f"{h2[::-1].hex()},30,1"])
        db.execute(
            "REPLACE INTO phashed_file_queue (file_hash, phash) VALUES ('f1', :p)", {"p": old}
        )
        db.commit()
        assert db.upgrade_db()
        (phash,) = db.execute(
            "SELECT phash FROM phashed_file_queue WHERE file_hash='f1'"
        ).fetchone()
        assert phash == h1  # quality-30 frame dropped, byte order restored
        assert db.get_version() == DedupeDB.DB_VERSION
        db.close()


@pytest.fixture
def fresh_db(tmp_path):
    DedupeDB.set_db_dir(tmp_path / somedbdir())
    DedupeDB.create_db()
    db = DedupeDB.DedupeDb(DedupeDB.get_db_dir(), DedupeDB.get_db_name())
    db.init_connection()
    yield db
    db.close()


def _insert_corpus(db, vids: dict[str, bytes]):
    for file_hash, phash in vids.items():
        db.add_to_phashed_files_queue(file_hash, phash)
    # drain the queue like the orchestrator does
    for file_hash, phash in db.execute(
        "SELECT file_hash, phash FROM phashed_file_queue"
    ).fetchall():
        db.add_file(file_hash)
        db.add_perceptual_hash(phash)
        db.associate_file_with_perceptual_hash(file_hash, phash)
        db.execute(
            "DELETE FROM phashed_file_queue WHERE file_hash = ?", (file_hash,)
        )


def _random_corpus(n=40, seed=7) -> dict[str, bytes]:
    rng = np.random.default_rng(seed)
    vids = {}
    base = rng.integers(0, 256, (n, 2, 32), dtype=np.uint8)
    for i in range(n):
        frames = base[i]
        if i % 5 == 0 and i > 0:
            # near-duplicate of a previous video: few bits flipped
            frames = base[i - 1].copy()
            frames[0, 0] ^= 0b11
        vids[f"file{i:03d}"] = frames.tobytes()
    return vids


def test_vptree_search_matches_bruteforce(fresh_db):
    db = fresh_db
    vids = _random_corpus()
    _insert_corpus(db, vids)
    tree = vptree.VpTreeManager(db)
    threshold = vptree.fix_vpdq_similarity(75.0)

    # ground truth by brute force over all stored pairs
    items = list(vids.items())
    for file_hash, phash in items:
        hash_id = db.get_hash_id(file_hash)
        got = {h for h, d in tree.search_file(hash_id, threshold)}
        expected = {
            db.get_hash_id(other)
            for other, other_phash in items
            if vptree.fix_vpdq_similarity(matchHashBytes(phash, other_phash, 31)) <= threshold
        }
        expected.add(hash_id)  # search_file always includes self
        assert got == expected, f"{file_hash}: tree {got} vs brute {expected}"


def test_vptree_maintenance_and_regenerate(fresh_db):
    db = fresh_db
    vids = _random_corpus(n=60, seed=11)
    _insert_corpus(db, vids)
    tree = vptree.VpTreeManager(db)
    tree.maintain_tree()  # drains any flagged branches
    assert (
        db.execute("SELECT COUNT(*) FROM shape_maintenance_branch_regen").fetchone()[0] == 0
    )
    # full regenerate keeps search results identical
    threshold = vptree.fix_vpdq_similarity(75.0)
    some_file = next(iter(vids))
    hash_id = db.get_hash_id(some_file)
    before = set(tree.search_file(hash_id, threshold))
    tree.regenerate_tree()
    tree2 = vptree.VpTreeManager(db)
    after = set(tree2.search_file(hash_id, threshold))
    assert before == after


def test_clear_search_tree_requeues(fresh_db):
    db = fresh_db
    vids = _random_corpus(n=10, seed=3)
    _insert_corpus(db, vids)
    assert db.execute("SELECT COUNT(*) FROM phashed_file_queue").fetchone()[0] == 0
    db.clear_search_tree()
    assert db.execute("SELECT COUNT(*) FROM shape_vptree").fetchone()[0] == 0
    assert db.execute("SELECT COUNT(*) FROM phashed_file_queue").fetchone()[0] == len(vids)
    assert db.get_num_phashed_files() == len(vids)  # queue counts as phashed


def test_identical_phashes_share_id(fresh_db):
    db = fresh_db
    phash = bytes(range(32))
    _insert_corpus(db, {"a": phash, "b": phash})
    assert (
        db.execute("SELECT COUNT(*) FROM shape_perceptual_hashes").fetchone()[0] == 1
    )
    tree = vptree.VpTreeManager(db)
    ha, hb = db.get_hash_id("a"), db.get_hash_id("b")
    got = {h for h, d in tree.search_file(ha, vptree.fix_vpdq_similarity(75.0))}
    assert got == {ha, hb}


def test_migration_0_6_0_sqlitedict():
    """A reference-era 0.6.0 database (SqliteDict pickle 'videos' table, no
    version table) migrates all the way to the current version
    (reference DedupeDB.py:461-523 then 525-577)."""
    import json
    import pickle
    import sqlite3 as sq

    with TemporaryDirectory() as tmp:
        DedupeDB.set_db_dir(Path(tmp) / somedbdir())
        DedupeDB.get_db_dir().mkdir(parents=True)
        path = DedupeDB.get_db_file_path()
        con = sq.connect(path)
        con.execute("CREATE TABLE videos (key TEXT PRIMARY KEY, value BLOB)")
        h1 = bytes(range(32))
        old_json = json.dumps([f"{h1[::-1].hex()},90,0"])
        record = {"perceptual_hash": old_json, "farthest_search_index": 3}
        con.execute(
            "INSERT INTO videos (key, value) VALUES (?, ?)",
            ("aa" * 32, pickle.dumps(record)),
        )
        con.commit()
        con.close()

        db = DedupeDB.DedupeDb(DedupeDB.get_db_dir(), DedupeDB.get_db_name())
        db.init_connection()
        assert db.get_version() == "0.6.0"  # no version table yet
        assert db.upgrade_db()
        db.commit()
        assert db.get_version() == DedupeDB.DB_VERSION
        rows = db.execute("SELECT file_hash, phash FROM phashed_file_queue").fetchall()
        assert rows == [("aa" * 32, h1)]
        db.close()


def test_batched_queue_drain_equals_per_row(tmp_path):
    """DedupeDB.drain_phashed_queue_batch (the set-based stage-2 fast
    path for the deferred-descent route) must leave the exact same DB
    state as the per-row loop: same files, phash find-or-insert sharing,
    map rebinding on re-hash, search-cache resets, and an empty queue."""

    def mk(n):
        DedupeDB.set_db_dir(tmp_path / somedbdir())
        DedupeDB.create_db()
        db = DedupeDB.DedupeDb(DedupeDB.get_db_dir(), DedupeDB.get_db_name())
        db.init_connection()
        return db

    def fill(db):
        # 60 files; files 10..19 share 5 phashes pairwise (dup content);
        # file 0 is a RE-HASH: pre-bound to an old phash, queued with new
        rng = np.random.default_rng(7)  # same corpus for both DBs
        phashes = [rng.integers(0, 256, 64, dtype=np.uint8).tobytes() for _ in range(55)]
        old = rng.integers(0, 256, 64, dtype=np.uint8).tobytes()
        db.add_file("f0")
        db.add_perceptual_hash(old)
        db.associate_file_with_perceptual_hash("f0", old, build_tree=False)
        db.execute(
            "UPDATE shape_search_cache SET searched_distance = 31"
        )  # pretend searched
        for k in range(60):
            p = phashes[k % 5 + 10] if 10 <= k < 20 else phashes[k % 55]
            db.add_to_phashed_files_queue(f"f{k}", p)
        db.commit()

    def snapshot(db):
        """Natural-key state (hash_id/phash_id assignment order is an
        internal autoincrement detail, not part of the contract)."""
        out = {}
        for t, q in (
            ("files", "SELECT file_hash FROM files"),
            ("shape_perceptual_hashes", "SELECT phash FROM shape_perceptual_hashes"),
            (
                "shape_perceptual_hash_map",
                "SELECT f.file_hash, p.phash FROM shape_perceptual_hash_map m"
                " JOIN files f ON f.hash_id = m.hash_id"
                " JOIN shape_perceptual_hashes p ON p.phash_id = m.phash_id",
            ),
            (
                "shape_search_cache",
                "SELECT f.file_hash, c.searched_distance FROM shape_search_cache c"
                " JOIN files f ON f.hash_id = c.hash_id",
            ),
            ("phashed_file_queue", "SELECT file_hash, phash FROM phashed_file_queue"),
        ):
            out[t] = sorted(
                tuple(bytes(c) if isinstance(c, memoryview) else c for c in r)
                for r in db.execute(q).fetchall()
            )
        return out

    db_a = mk(0)
    fill(db_a)
    for file_hash, phash in db_a.execute(
        "SELECT file_hash, phash FROM phashed_file_queue"
    ).fetchall():
        db_a.add_file(file_hash)
        db_a.add_perceptual_hash(phash)
        db_a.associate_file_with_perceptual_hash(file_hash, phash, build_tree=False)
        db_a.execute(
            "DELETE FROM phashed_file_queue WHERE file_hash = :f AND phash = :p",
            {"f": file_hash, "p": phash},
        )
    db_a.commit()
    snap_a = snapshot(db_a)
    db_a.close()

    db_b = mk(1)
    fill(db_b)
    drained = 0
    while True:
        n = db_b.drain_phashed_queue_batch(17)  # force partial batches
        if n == 0:
            break
        drained += n
        db_b.commit()
    snap_b = snapshot(db_b)
    db_b.close()

    assert drained == 60
    assert snap_a == snap_b
    assert snap_a["phashed_file_queue"] == []


def test_db_blob_column_matches_fetchall(fresh_db):
    """DbBlobColumn (the streaming corpus view bounding stage-4 host RAM)
    must serve exactly the blobs a whole-corpus fetchall would, for random
    access, batched iteration, and frame-count metadata."""
    from hydrus_video_deduplicator_tpu.db.blobs import DbBlobColumn, fetch_blobs

    rng = np.random.default_rng(5)
    vids = {
        f"{k:064x}": rng.integers(0, 256, (int(c), 32), dtype=np.uint8).tobytes()
        for k, c in enumerate(rng.integers(1, 7, 40))
    }
    _insert_corpus(fresh_db, vids)
    rows = fresh_db.execute(
        "SELECT m.hash_id, p.phash FROM shape_perceptual_hash_map m"
        " JOIN shape_perceptual_hashes p ON p.phash_id = m.phash_id"
    ).fetchall()
    ids = np.asarray([r[0] for r in rows], dtype=np.int64)
    blobs = [bytes(r[1]) for r in rows]
    # reversed order exercises order preservation
    order = np.arange(len(ids))[::-1].copy()
    col = DbBlobColumn(
        fresh_db, ids[order], np.asarray([len(b) // 32 for b in blobs])[order]
    )
    assert len(col) == len(ids)
    assert [col[i] for i in range(len(col))] == [blobs[j] for j in order]
    got = list(col.iter_many(np.arange(len(col))))
    assert got == [(i, blobs[j]) for i, j in enumerate(order)]
    assert (col.blob_n_frames == [len(blobs[j]) // 32 for j in order]).all()
    assert fetch_blobs(fresh_db, ids[:3].tolist()) == blobs[:3]


def test_plan_chunks_matches_pack_blocks():
    """plan_chunks (metadata-only packing plan of the streaming column
    staging) must place every video exactly where pack_blocks does."""
    from hydrus_video_deduplicator_tpu.ops import similarity_segments as seg

    rng = np.random.default_rng(6)
    for trial in range(5):
        counts = rng.integers(1, 513, int(rng.integers(1, 200)))
        items = [
            (int(i), bytes(32 * int(c))) for i, c in enumerate(counts)
        ]
        blocks = seg.pack_blocks(items, seg.CHUNK_FRAMES, seg.CHUNK_SLOTS)
        chunk_id, slot_id, frame_off, n_chunks = seg.plan_chunks(
            counts, seg.CHUNK_FRAMES, seg.CHUNK_SLOTS
        )
        assert n_chunks == len(blocks)
        for k in range(len(counts)):
            blk = blocks[chunk_id[k]]
            assert blk.slot_map[slot_id[k]] == k
            assert blk.counts[slot_id[k], 0] == counts[k]
            assert (blk.slot_ids[frame_off[k] : frame_off[k] + counts[k]]
                    == slot_id[k]).all()


def test_connection_pragmas_tuned(fresh_db, monkeypatch, tmp_path):
    """init_connection sets the page-cache/temp-store/synchronous pragmas
    (library-scale ingest thrashes SQLite's ~2 MiB default cache — measured
    2x drain slowdown at 1M rows) and
    HVD_SQLITE_CACHE_MB tunes the cache. Per-connection only: the database
    FILE stays byte-compatible with reference-created ones."""
    # fresh_db was created before this test could scrub the env, so open a
    # clean default-cache connection here (drivers export HVD_SQLITE_CACHE_MB
    # themselves — an ambient value must not fail this test, ADVICE r4 #2).
    monkeypatch.delenv("HVD_SQLITE_CACHE_MB", raising=False)
    monkeypatch.delenv("HVD_SQLITE_SYNC", raising=False)
    db0 = DedupeDB.DedupeDb(DedupeDB.get_db_dir(), DedupeDB.get_db_name())
    db0.init_connection()
    (cache,) = db0.execute("PRAGMA cache_size").fetchone()
    assert cache == -(256 * 1024)
    (temp_store,) = db0.execute("PRAGMA temp_store").fetchone()
    assert temp_store == 2  # MEMORY
    (sync,) = db0.execute("PRAGMA synchronous").fetchone()
    assert sync == 1  # NORMAL
    db0.close()

    monkeypatch.setenv("HVD_SQLITE_CACHE_MB", "64")
    db2 = DedupeDB.DedupeDb(DedupeDB.get_db_dir(), DedupeDB.get_db_name())
    db2.init_connection()
    (cache2,) = db2.execute("PRAGMA cache_size").fetchone()
    db2.close()
    assert cache2 == -(64 * 1024)
