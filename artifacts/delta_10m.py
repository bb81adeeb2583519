"""MEASURED 10M-hash incremental (delta) search on one chip
(BASELINE.json configs[3]; VERDICT r2 item 5).

The incremental scenario: a library with 10M already-hashed videos gets
N_NEW new ones; stage 4 must compare ONLY (new x corpus-prefix) — the
shape_search_cache contract — with the column side indexed, packed, and
uploaded ONCE across row chunks (col_state). At this scale the column
corpus's ±1 rows (~20 GB) may exceed the device memory plan, so the
engine's packed-column mode keeps them bit-packed on the device (2.5 GB)
and expands each scan step's tile there (device.MemoryPlan.col_pm1_bytes).

Corpus model: 8-frame random hashes (the round-2 bench corpus model —
delta cost is linear in corpus frames x new frames, so frame profile
just scales wall time; reps are not used: random frames do not
compress, and the auto prefilter correctly declines). Planted: every
new row k < N_PLANT is a re-encode of corpus video k*101.

Reports wall, peak RSS (the one-time 10M column-side packing/staging is
corpus-proportional host memory — measured ~20 GB over the 5.8 GB blob
corpus on the r3 run — while per-chunk row work stays tile-bounded);
checks every planted pair found at its exact similarity, zero extras,
zero wrong similarities.

Usage: python artifacts/delta_10m.py [n_corpus] [n_new] [chunk]
"""

from __future__ import annotations

import os
import resource
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

N_CORPUS = int(sys.argv[1]) if len(sys.argv) > 1 else 10_000_000
N_NEW = int(sys.argv[2]) if len(sys.argv) > 2 else 100_000
CHUNK = int(sys.argv[3]) if len(sys.argv) > 3 else 50_000
FRAMES = 8
N_PLANT = 1_000



def log(msg):
    rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
    print(f"[{time.strftime('%H:%M:%S')}] (rss {rss:.1f}G) {msg}", flush=True)


def main():
    import jax

    from hydrus_video_deduplicator_tpu import device

    device.enable_compile_cache()
    log(f"device: {jax.devices()[0]}; corpus={N_CORPUS} new={N_NEW} chunk={CHUNK}")

    from hydrus_video_deduplicator_tpu.parallel.engine import TpuSearchEngine
    from hydrus_video_deduplicator_tpu.vpdq import matchHashBytes

    rng = np.random.default_rng(11)
    t0 = time.time()
    raw = rng.integers(0, 256, (N_CORPUS, FRAMES * 32), dtype=np.uint8)
    corpus = [row.tobytes() for row in raw]
    del raw
    log(f"corpus synthesized in {time.time()-t0:.0f}s")

    new_raw = rng.integers(0, 256, (N_NEW, FRAMES * 32), dtype=np.uint8)
    new = [row.tobytes() for row in new_raw]
    del new_raw
    expected = {}
    n_plant = min(N_PLANT, N_NEW // 2, N_CORPUS // 101)
    for k in range(n_plant):
        src = bytearray(corpus[k * 101])
        for f in rng.integers(0, len(src), size=3 * FRAMES):
            src[int(f)] ^= 1 << int(rng.integers(0, 8))
        new[k] = bytes(src)
        s = int(matchHashBytes(new[k], corpus[k * 101]))
        assert s >= 75, s
        expected[(k, k * 101)] = s

    # delta sweep: rows = new videos, cols = corpus + new (new videos must
    # also pair among themselves — the stage-4 prefix schedule)
    all_blobs = corpus + new
    eng = TpuSearchEngine(segment_min_work=0)
    col_state: dict = {}
    got = {}
    extras = []
    rss_before = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
    t_s = time.time()
    n_chunks = (N_NEW + CHUNK - 1) // CHUNK
    for ci, i0 in enumerate(range(0, N_NEW, CHUNK), start=1):
        chunk = new[i0 : i0 + CHUNK]
        t_c = time.time()
        hits = eng.find_pairs(
            chunk,
            all_blobs,
            75,
            col_state=col_state,
            col_limit=N_CORPUS + min(i0 + CHUNK, N_NEW),
        )
        for i, j, s in hits:
            gi = i + i0
            if j == N_CORPUS + gi:
                got[("self", gi)] = s
            elif (gi, j) in expected:
                got[(gi, j)] = s
            else:
                extras.append((gi, j, s))
        log(f"chunk {ci}/{n_chunks}: {len(hits)} hits {time.time()-t_c:.1f}s "
            f"(cum {time.time()-t_s:.1f}s)")
    wall = time.time() - t_s
    rss_after = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
    self_hits = sum(1 for k in got if k[0] == "self")
    planted = sum(1 for k in got if k[0] != "self")
    wrong = [k for k, s in got.items() if k[0] != "self" and s != expected[k]]
    cmp_pairs = N_NEW * (N_CORPUS + N_NEW / 2)
    log(
        f"DONE: delta {N_NEW} x {N_CORPUS + N_NEW} ({cmp_pairs:.3g} video "
        f"pairs, {cmp_pairs * FRAMES * FRAMES:.3g} frame pairs) in {wall:.1f}s"
        f" on {jax.devices()[0].device_kind}"
    )
    log(
        f"self {self_hits}/{N_NEW}; planted {planted}/{n_plant}; extras "
        f"{len(extras)}; wrong {len(wrong)}; sweep RSS delta "
        f"{rss_after - rss_before:.2f}G"
    )
    assert self_hits == N_NEW and planted == n_plant
    assert not extras and not wrong
    log("CORRECTNESS: exact")


if __name__ == "__main__":
    main()
