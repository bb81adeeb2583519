"""End-to-end `dedup videos/min` (the BASELINE.json headline metric).

Fake-Hydrus-fed stage 1->4 run over >= 10k synthetic REAL-CODEC videos
(mpeg4, encoded by the native libav encoder — the same code path the
decode parity tests use), measuring the full production pipeline the way
a user runs it: HTTP fetch from the (in-process) Hydrus API, decode,
perceptual hash, queue/tree bookkeeping, exact duplicate search, and
marking pairs back over HTTP. Reports wall time per stage and one
BENCH-style JSON line.

Corpus: N/2 unique scenes x 2 encodings each (the second is a re-encode
at a different bitrate) -> N videos, N/2 expected duplicate pairs. Each
video is VID_SECONDS at VID_FPS (decode cost ~VID_SECONDS*VID_FPS frames;
1 fps sampling hashes VID_SECONDS frames per video).

Usage: python artifacts/bench_e2e.py [N] [hash_backend] [search_backend]
Defaults: 10000 auto auto. The generated store is cached at
/tmp/hvd_e2e_store_<N>.npz across runs (generation costs minutes).

Stage 1 on the device moves each 512x512 frame (786 KB) from host to
device; the decode pool scales with the host's cores. Both bound the
device hash path, so read stage 1 beside the host's core count.
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tests"))

import numpy as np

N = int(sys.argv[1]) if len(sys.argv) > 1 else 10_000
HASH_BACKEND = sys.argv[2] if len(sys.argv) > 2 else "auto"
SEARCH_BACKEND = sys.argv[3] if len(sys.argv) > 3 else "auto"

VID_SECONDS = 2
VID_FPS = 4
VID_DIM = 128


def log(msg):
    print(f"[{time.strftime('%H:%M:%S')}] {msg}", flush=True)


def build_store():
    """N mpeg4 videos as an in-memory {sha256: bytes} store (cached)."""
    cache = f"/tmp/hvd_e2e_store_{N}.npz"
    if os.path.exists(cache):
        z = np.load(cache, allow_pickle=True)
        store = dict(zip(z["hashes"].tolist(), [bytes(b) for b in z["blobs"]]))
        log(f"loaded cached store: {len(store)} videos")
        return store

    import tempfile

    from make_corpus import scene_frames
    from fake_hydrus import sha256_hex

    from hydrus_video_deduplicator_tpu.native import decode as nd

    store: dict[str, bytes] = {}
    t0 = time.time()
    n_frames = VID_SECONDS * VID_FPS
    with tempfile.TemporaryDirectory() as td:
        for s in range(N // 2):
            frames = scene_frames(1000 + s, n_frames, VID_DIM, VID_DIM)
            for enc, quality_seed in ((0, None), (1, 7)):
                if enc == 1:
                    # re-encode: mild noise, same content
                    r = np.random.default_rng(quality_seed * 100000 + s)
                    frames_v = [
                        np.clip(
                            f.astype(np.int16) + r.integers(-6, 6, f.shape), 0, 255
                        ).astype(np.uint8)
                        for f in frames
                    ]
                else:
                    frames_v = frames
                path = os.path.join(td, f"v_{s}_{enc}.avi")
                nd.encode_video(path, "mpeg4", frames_v, VID_FPS, 1)
                blob = open(path, "rb").read()
                os.unlink(path)
                store[sha256_hex(blob)] = blob
            if (s + 1) % 500 == 0:
                log(f"  generated {2 * (s + 1)}/{N} videos ({time.time()-t0:.0f}s)")
    np.savez(
        cache,
        hashes=np.asarray(list(store.keys())),
        blobs=np.asarray([np.frombuffer(b, dtype=np.uint8) for b in store.values()], dtype=object),
    )
    log(f"store built: {len(store)} videos, "
        f"{sum(map(len, store.values())) / 1e6:.0f} MB in {time.time()-t0:.0f}s")
    return store


def main():
    import jax

    from hydrus_video_deduplicator_tpu import device

    device.enable_compile_cache()
    store = build_store()

    from fake_hydrus import DEFAULT_ACCESS_KEY, FakeHydrus

    import hydrus_video_deduplicator_tpu.db.DedupeDB as DedupeDB
    from hydrus_video_deduplicator_tpu import dedup as dd
    from hydrus_video_deduplicator_tpu.client import create_client

    server = FakeHydrus(store)
    server.start()
    try:
        import tempfile

        with tempfile.TemporaryDirectory() as dbdir:
            DedupeDB.set_db_dir(dbdir)
            DedupeDB.create_db()
            db = DedupeDB.DedupeDb(DedupeDB.get_db_dir(), DedupeDB.get_db_name())
            db.init_connection()
            client = create_client([], server.url, DEFAULT_ACCESS_KEY, None)

            stage_t: dict[str, float] = {}

            def progress(p):
                name = type(p.progress if hasattr(p, "progress") else p).__name__
                stage_t.setdefault(name, time.time())

            deduper = dd.HydrusVideoDeduplicator(
                db,
                client=client,
                update_progress_callback=progress,
                search_backend=SEARCH_BACKEND,
                hash_backend=HASH_BACKEND,
            )
            deduper.threshold = 75.0
            t0 = time.time()
            deduper.deduplicate(skip_hashing=False)
            wall = time.time() - t0
            db.close()

        order = [
            ("HashingProgress", "stage1 hash"),
            ("BuildingSearchTreeProgress", "stage2+3 tree"),
            ("SearchingForDuplicatesProgress", "stage4 search"),
            ("DoneProgress", "done"),
        ]
        marks = [(label, stage_t[k]) for k, label in order if k in stage_t]
        log("stage breakdown:")
        if marks:
            log(f"  pre-stage1 setup (t0 -> first HashingProgress): {marks[0][1] - t0:.1f}s")
        for (label, t_a), (_, t_b) in zip(marks, marks[1:]):
            log(f"  {label}: {t_b - t_a:.1f}s")
        if marks:
            log(f"  post-DoneProgress: {t0 + wall - marks[-1][1]:.1f}s")
        pairs = len(server.relationships)
        vpm = N / (wall / 60.0)
        log(
            f"E2E: {N} videos stage1->4 in {wall:.1f}s "
            f"({vpm:.0f} videos/min, {pairs} pairs marked, "
            f"hash={HASH_BACKEND} search={SEARCH_BACKEND}, nproc={os.cpu_count()})"
        )
        print(
            json.dumps(
                {
                    "metric": "dedup_videos_per_min_e2e",
                    "value": round(vpm, 1),
                    "unit": "videos/min",
                    "n_videos": N,
                    "wall_s": round(wall, 1),
                    "pairs": pairs,
                    "hash_backend": HASH_BACKEND,
                    "search_backend": SEARCH_BACKEND,
                }
            ),
            flush=True,
        )
        assert pairs == N // 2, (pairs, N // 2)
        log("pair-count CORRECT")
    finally:
        server.stop()


if __name__ == "__main__":
    main()
