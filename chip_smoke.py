#!/usr/bin/env python3
"""On-card smoke test: the production dedup path on an NVIDIA GPU.

Runs, in one process, from --seed:

1. Device: JAX on CUDA only (JAX_PLATFORMS=cuda, so a CUDA plugin that
   fails to start is an error, not a quiet move to the CPU); prints the
   devices and the card's name and power limit.
2. Kernel parity at production widths: the Triton stage-A existence
   kernel against its plain-XLA reference at the engine's block shapes
   (exact, tolerance 0), and the device PDQ hash against the numpy oracle
   and the native C++ hasher on ~2,000 512x512 frames (bit-identical words
   and qualities).
3. Stage 1 through ``deduplicate()``: the in-process fake Hydrus server
   serves y4m videos made from the seed; hashing runs on the device; every
   stored hash must equal the native hasher's hash of the same file.
4. Stages 2-4 at library scale: --videos scene-profile videos (default
   100,000, ~7.1 M frame hashes) go into ``phashed_file_queue`` and
   ``deduplicate(skip_hashing=True)`` runs the pruned route; every planted
   pair must be marked, every marked pair must clear the threshold by
   native matchHashBytes, a 2,000-video sub-library must equal a
   brute-force sweep, and an immediate re-run must mark nothing.

With --four-cards it runs only phases 3-4, once on a mesh of every visible
card and once on one card, in the same process, and requires identical
hashes and pair sets.

Any failed phase raises: the script exits non-zero and prints no result.
The last line of a passing run is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.

Usage:  python chip_smoke.py [--seed N] [--videos N] [--four-cards]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

#: the CLI's default threshold and the similarity it implies
THRESHOLD = 50.0
#: videos in the brute-force-checked sub-library
SUB_LIBRARY = 2000
#: y4m videos served in phase 3
STAGE1_VIDEOS = 240


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    """`name, power limit` of every card, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    return "; ".join(line.strip() for line in out.splitlines())


class StageClock:
    """Wall time of each orchestrator stage, taken by wrapping the
    deduper's own stage methods."""

    STAGES = {
        "add_perceptual_hashes_to_db": "stage 1 hash",
        "process_phashed_file_queue": "stage 2 bind",
        "run_maintenance": "stage 3 maintenance",
        "find_potential_duplicates": "stage 4 search+mark",
    }

    def __init__(self, deduper):
        self.times: dict[str, float] = {}
        self.prefilter: list[bool] = []
        for name, label in self.STAGES.items():
            self._wrap(deduper, name, label)
        pick = deduper._pick_search_prefilter

        def pick_recorded(*a, **k):
            use = pick(*a, **k)
            self.prefilter.append(use)
            return use

        deduper._pick_search_prefilter = pick_recorded

    def _wrap(self, obj, name, label):
        fn = getattr(obj, name)

        def timed(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                self.times[label] = self.times.get(label, 0.0) + time.perf_counter() - t0

        setattr(obj, name, timed)

    def report(self, what: str, card: str) -> None:
        parts = ", ".join(f"{k} {v:.2f} s" for k, v in self.times.items())
        log(f"[smoke times] {what} (this smoke's own wall times; card {card}): {parts}")


def file_hash(i: int) -> str:
    return f"{i:016x}" + "00" * 24


def open_db(workdir: str):
    from hydrus_video_deduplicator_tpu.db import DedupeDB

    DedupeDB.set_db_dir(Path(workdir))
    DedupeDB.create_db()
    db = DedupeDB.DedupeDb(DedupeDB.get_db_dir(), DedupeDB.get_db_name())
    db.init_connection()
    return db


def min_similarity() -> int:
    from hydrus_video_deduplicator_tpu.db import vptree

    return max(1, 101 - vptree.fix_vpdq_similarity(THRESHOLD))


# ---------------------------------------------------------------------------
# phase 2: kernel parity
# ---------------------------------------------------------------------------


def phase_kernels(seed: int) -> None:
    import jax.numpy as jnp
    import numpy as np

    from hydrus_video_deduplicator_tpu.ops import reps
    from hydrus_video_deduplicator_tpu.ops import similarity_segments as seg
    from tests.scene_library import scene_library

    lib = scene_library(3000, seed)
    items = [(i, b) for i, b in enumerate(lib.blobs) if b and len(b) // 32 <= seg.SEG_MAX_FRAMES]
    row_blocks = seg.pack_blocks(items, seg.ROW_FRAMES, seg.ROW_SLOTS)[: seg.TILE_ROW_BLOCKS]
    rp, rs, _, _ = seg.stack_blocks(row_blocks, seg.TILE_ROW_BLOCKS, seg.ROW_FRAMES, seg.ROW_SLOTS)
    col_blocks = seg.pack_blocks(items, seg.CHUNK_FRAMES, seg.CHUNK_SLOTS)
    n_steps = 8 * seg.TILE_COL_STEPS  # 8 engine column tiles, 131,072 frames
    n_chunks = n_steps * seg.N_SPLIT
    cp, cs, _, _ = seg.stack_blocks(col_blocks[:n_chunks], n_chunks, seg.CHUNK_FRAMES, seg.CHUNK_SLOTS)
    a = seg.unpack_blocks_pm1(jnp.asarray(rp), jnp.asarray(rs))
    b = seg.unpack_blocks_pm1(jnp.asarray(cp), jnp.asarray(cs))
    sa, sb = jnp.asarray(rs), jnp.asarray(cs)
    valid = np.ones(n_steps, np.int32)
    valid[3::7] = 0  # some skipped column steps
    tile_f = seg.TILE_COL_STEPS * seg.STEP_FRAMES
    for tol in (31, reps.prune_tolerance()):
        got = np.asarray(seg.make_exists_mask_sweep_triton(tol)(a, sa, b, sb, jnp.asarray(valid)))
        ref_fn = seg.make_exists_mask_kernel_xla(tol)
        ref = np.concatenate(
            [
                np.asarray(ref_fn(a, sa, None, b[t * tile_f : (t + 1) * tile_f], sb[t * tile_f : (t + 1) * tile_f], None))
                for t in range(n_steps // seg.TILE_COL_STEPS)
            ],
            axis=1,
        )
        ref = ref.reshape(ref.shape[0], n_steps, seg.STEP_SLOTS) * valid[None, :, None].astype(np.uint32)
        ref = ref.reshape(got.shape)
        bits = int(np.unpackbits(ref.view(np.uint8)).sum())
        assert np.array_equal(got, ref), f"Triton existence kernel != XLA reference at tol {tol}"
        log(f"[phase 2] Triton existence kernel == XLA reference at tol {tol}: "
            f"rows {a.shape[0]} x cols {b.shape[0]} frames, {bits} hit bits, "
            f"{int((valid == 0).sum())} skipped steps")

    # the same kernel inside the engine: pruned search, Triton vs XLA
    from hydrus_video_deduplicator_tpu.parallel.engine import TpuSearchEngine

    corpus = lib.blobs[:3000]
    runs = {}
    for kind in ("triton", "xla"):
        eng = TpuSearchEngine(force_segments=True, exists_kernel=kind)
        runs[kind] = sorted(eng.find_pairs_pruned(corpus, corpus, min_similarity()))
    assert runs["triton"] == runs["xla"], "pruned search differs between Triton and XLA stage A"
    log(f"[phase 2] engine pruned search, Triton == XLA stage A: {len(runs['xla'])} hits over 3000 videos")


def pdq_parity_frames(seed: int):
    import numpy as np

    from hydrus_video_deduplicator_tpu.decode import extract_frames

    rng = np.random.default_rng(seed)
    parts = [rng.integers(0, 256, (2048, 512, 512, 3), dtype=np.uint8)]
    corpus = []
    for path in sorted((ROOT / "tests" / "corpus" / "videos").rglob("*.y4m")):
        corpus.extend(extract_frames(path.read_bytes()))
    parts.append(np.stack(corpus))
    levels = np.arange(0, 256, 4, dtype=np.uint8)
    parts.append(np.broadcast_to(levels[:, None, None, None], (len(levels), 512, 512, 3)).copy())
    near = np.broadcast_to(levels[:, None, None, None], (len(levels), 512, 512, 3)).copy()
    spots = rng.random(near.shape[:3]) < 0.001
    near[spots] = np.clip(near[spots].astype(np.int16) + 1, 0, 255).astype(np.uint8)
    parts.append(near)
    x = np.linspace(0, 255, 512)
    grad = np.stack([np.roll(np.add.outer(x, x) / 2, 7 * i, 0) for i in range(64)])
    parts.append(np.repeat(grad[..., None], 3, -1).astype(np.uint8))
    names = ["random", "corpus y4m", "constant", "near-constant", "gradient"]
    return np.concatenate(parts), [(n, len(p)) for n, p in zip(names, parts)]


def phase_pdq(seed: int) -> None:
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from hydrus_video_deduplicator_tpu import native
    from hydrus_video_deduplicator_tpu.models import pdq as mpdq
    from hydrus_video_deduplicator_tpu.vpdq import python_ref

    frames, groups = pdq_parity_frames(seed)
    n = len(frames)
    t0 = time.perf_counter()
    words, quals = [], []
    for i in range(0, n, 512):
        w, q = mpdq.pdq_hash_batch_jit(frames[i : i + 512])
        words.append(np.asarray(w))
        quals.append(np.asarray(q))
    dev_h = mpdq.words_to_blobs(np.concatenate(words))
    dev_q = [int(q) for q in np.concatenate(quals)]
    t_dev = time.perf_counter() - t0

    def nat(i):
        return native.pdq_hash_frame(frames[i].tobytes(), 512, 512)

    def ref(i):
        return python_ref.pdq_hash_frame(frames[i])

    with ThreadPoolExecutor(max_workers=os.cpu_count() or 4) as ex:
        nat_out = list(ex.map(nat, range(n)))
        ref_out = list(ex.map(ref, range(n)))
    for i in range(n):
        assert (dev_h[i], dev_q[i]) == nat_out[i], f"device PDQ != native hasher at frame {i}"
        assert (dev_h[i], dev_q[i]) == ref_out[i], f"device PDQ != numpy oracle at frame {i}"
    log(f"[phase 2] device PDQ bit-identical to the numpy oracle and the native hasher "
        f"on {n} frames ({', '.join(f'{k} {v}' for k, v in groups)}; device pass incl. "
        f"compile {t_dev:.2f} s)")


# ---------------------------------------------------------------------------
# phase 3: stage 1 through deduplicate()
# ---------------------------------------------------------------------------


def run_stage1(seed: int, card: str, label: str) -> tuple[dict, set, dict]:
    """Serve the seed's y4m videos, hash them on the device through
    deduplicate(); returns ({file hash: stored phash}, marked pairs,
    {file hash: video})."""
    import hashlib

    from hydrus_video_deduplicator_tpu import dedup as dd
    from hydrus_video_deduplicator_tpu.client import HVDClient
    from tests.fake_hydrus import DEFAULT_ACCESS_KEY, FakeHydrus
    from tests.scene_library import y4m_library

    videos, _pairs = y4m_library(STAGE1_VIDEOS, seed)
    files = {hashlib.sha256(v).hexdigest(): v for v in videos}
    with tempfile.TemporaryDirectory() as workdir:
        db = open_db(workdir)
        server = FakeHydrus(files)
        server.start()
        try:
            client = HVDClient(None, server.url, DEFAULT_ACCESS_KEY, None)
            deduper = dd.HydrusVideoDeduplicator(
                db, client, hash_backend="tpu", search_backend="tpu", job_count=-1
            )
            deduper.threshold = THRESHOLD
            clock = StageClock(deduper)
            deduper.deduplicate(skip_hashing=False)
            clock.report(f"phase 3 {label}, {len(files)} y4m videos", card)
            stored = dict(
                db.execute(
                    "SELECT f.file_hash, p.phash FROM files f"
                    " JOIN shape_perceptual_hash_map m ON m.hash_id = f.hash_id"
                    " JOIN shape_perceptual_hashes p ON p.phash_id = m.phash_id"
                ).fetchall()
            )
            marked = {tuple(sorted(p)) for p in server.relationships}
        finally:
            server.stop()
            db.close()
    return {str(k): bytes(v) for k, v in stored.items()}, marked, files


def phase_stage1(seed: int, card: str, label: str = "one card"):
    from hydrus_video_deduplicator_tpu.hashing import compute_phash
    from tests.scene_library import brute_force_pairs

    stored, marked, files = run_stage1(seed, card, label)
    assert set(stored) == set(files), f"{len(files) - len(stored)} files have no stored hash"
    for h, video in files.items():
        want = compute_phash(video).bytes
        assert stored[h] == want, f"device hash of {h[:12]} != native hasher"
    keys = sorted(stored)
    want_pairs = {
        tuple(sorted((keys[a], keys[b])))
        for a, b in brute_force_pairs([stored[k] for k in keys], min_similarity())
    }
    assert marked == want_pairs, f"stage-1 library pairs {len(marked)} != brute force {len(want_pairs)}"
    empty = sum(1 for v in stored.values() if not v)
    log(f"[phase 3] {label}: {len(stored)} device hashes byte-equal to the native hasher "
        f"({empty} empty); {len(marked)} pairs marked == brute force")
    return stored, marked


# ---------------------------------------------------------------------------
# phase 4: stages 2-4 at library scale
# ---------------------------------------------------------------------------


def run_library(blobs: list[bytes], card: str, label: str):
    """Queue the blobs as stage-1 output and run deduplicate(skip_hashing=
    True); returns (marked index pairs, reported count, re-run count,
    prefilter decisions)."""
    from hydrus_video_deduplicator_tpu import dedup as dd
    from hydrus_video_deduplicator_tpu.client import HVDClient
    from tests.fake_hydrus import DEFAULT_ACCESS_KEY, FakeHydrus

    n = len(blobs)
    with tempfile.TemporaryDirectory() as workdir:
        db = open_db(workdir)
        server = FakeHydrus({})
        server.start()
        try:
            t0 = time.perf_counter()
            for i0 in range(0, n, 50_000):
                db.conn.executemany(
                    "INSERT OR REPLACE INTO phashed_file_queue (file_hash, phash) VALUES (?, ?)",
                    [(file_hash(i), blobs[i]) for i in range(i0, min(i0 + 50_000, n))],
                )
            db.commit()
            t_queue = time.perf_counter() - t0
            client = HVDClient(None, server.url, DEFAULT_ACCESS_KEY, None)
            deduper = dd.HydrusVideoDeduplicator(
                db, client, search_backend="tpu", search_prefilter="auto"
            )
            deduper.threshold = THRESHOLD
            clock = StageClock(deduper)
            reported = deduper.deduplicate(skip_hashing=True)
            clock.times = {"queue load": t_queue, **clock.times}
            clock.report(f"phase 4 {label}, {n} videos", card)
            rerun = deduper.deduplicate(skip_hashing=True)
            index = {file_hash(i): i for i in range(n)}
            marked = {tuple(sorted((index[a], index[b]))) for a, b in server.relationships}
        finally:
            server.stop()
            db.close()
    return marked, reported, rerun, clock.prefilter


def phase_library(seed: int, n_videos: int, card: str, label: str = "one card"):
    from hydrus_video_deduplicator_tpu.vpdq import matchHashBytes
    from tests.scene_library import brute_force_pairs, scene_library

    t0 = time.perf_counter()
    lib = scene_library(n_videos, seed)
    n_frames = sum(len(b) for b in lib.blobs) // 32
    log(f"[phase 4] library: {n_videos} videos, {n_frames} frame hashes, "
        f"{len(lib.planted)} planted pairs, {len(lib.empty)} empty (made in "
        f"{time.perf_counter() - t0:.1f} s)")
    min_sim = min_similarity()

    marked, reported, rerun, prefilter = run_library(lib.blobs, card, label)
    assert prefilter and all(prefilter), "stage 4 did not take the pruned route"
    missing = set(lib.planted) - marked
    assert not missing, f"{len(missing)} planted pairs not marked, e.g. {sorted(missing)[:3]}"
    weak = [(a, b) for a, b in marked if int(matchHashBytes(lib.blobs[a], lib.blobs[b])) < min_sim]
    assert not weak, f"{len(weak)} marked pairs under the threshold, e.g. {weak[:3]}"
    assert rerun == 0, f"re-run marked {rerun} pairs"
    log(f"[phase 4] {label}: {len(marked)} pairs marked (reported {reported}); all "
        f"{len(lib.planted)} planted pairs among them; every marked pair >= {min_sim} by "
        f"native matchHashBytes; re-run marked 0")

    sub = lib.blobs[:SUB_LIBRARY]
    sub_marked, _, sub_rerun, sub_prefilter = run_library(sub, card, f"{label}, sub-library")
    want = brute_force_pairs(sub, min_sim, workers=os.cpu_count() or 8)
    assert sub_marked == want, (
        f"sub-library pairs != brute force: {len(sub_marked - want)} extra, "
        f"{len(want - sub_marked)} missing"
    )
    assert sub_rerun == 0
    log(f"[phase 4] {label}: {SUB_LIBRARY}-video sub-library pair set == brute-force "
        f"matchHashBytes sweep ({len(want)} pairs; pruned route {sub_prefilter})")
    return marked, sub_marked


def phase_four_cards(seed: int, n_videos: int, card: str, n_devices: int) -> None:
    """Phases 3-4 on a mesh of every card, then on one card; hashes and
    pair sets must be identical."""
    from hydrus_video_deduplicator_tpu.dedup import HydrusVideoDeduplicator

    mesh_label = f"{n_devices}-card mesh"
    mesh_run = (
        phase_stage1(seed, card, mesh_label),
        phase_library(seed, n_videos, card, mesh_label),
    )
    meshed = HydrusVideoDeduplicator._device_mesh
    HydrusVideoDeduplicator._device_mesh = staticmethod(lambda: None)
    try:
        one_run = (
            phase_stage1(seed, card, "one card"),
            phase_library(seed, n_videos, card, "one card"),
        )
    finally:
        HydrusVideoDeduplicator._device_mesh = meshed
    assert mesh_run[0][0] == one_run[0][0], "stage-1 hashes differ between the mesh and one card"
    assert mesh_run[0][1] == one_run[0][1], "stage-1 pairs differ between the mesh and one card"
    assert mesh_run[1] == one_run[1], "library pair sets differ between the mesh and one card"
    log(f"[four cards] {mesh_label} == one card: {len(mesh_run[0][0])} hashes, "
        f"{len(mesh_run[0][1])} stage-1 pairs, {len(mesh_run[1][0])} library and "
        f"{len(mesh_run[1][1])} sub-library pairs identical")


# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--videos", type=int, default=100_000, help="phase-4 library size")
    ap.add_argument("--four-cards", action="store_true",
                    help="run phases 3-4 on a mesh of every card and on one card, and compare")
    args = ap.parse_args(argv)

    # before JAX starts: CUDA only, and the pure-numpy y4m decoder for
    # every backend (the native libav decoder needs FFmpeg dev libraries)
    os.environ["JAX_PLATFORMS"] = "cuda"
    os.environ["HVD_DECODE_BACKEND"] = "legacy"
    os.environ.setdefault("HVD_DEBUG_TIMING", "1")
    sys.path.insert(0, str(ROOT))

    import jax

    from hydrus_video_deduplicator_tpu import device

    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise SystemExit(f"no GPU: JAX found {devices}")
    cache = device.enable_compile_cache()
    card = card_line()
    log(f"[phase 1] devices: {devices}")
    log(f"[phase 1] card: {card}")
    log(f"[phase 1] compile cache: {cache}")

    if args.four_cards:
        if len(devices) < 2:
            raise SystemExit(f"--four-cards needs several cards, JAX found {len(devices)}")
        phase_four_cards(args.seed, args.videos, card, len(devices))
    else:
        t0 = time.perf_counter()
        phase_kernels(args.seed)
        phase_pdq(args.seed)
        log(f"[smoke times] phase 2 (card {card}): {time.perf_counter() - t0:.2f} s")
        phase_stage1(args.seed, card)
        phase_library(args.seed, args.videos, card)

    print(json.dumps({
        "ok": True,
        "device": {
            "platform": devices[0].platform,
            "kind": devices[0].device_kind,
            "count": len(devices),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
