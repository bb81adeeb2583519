"""1M x 1M exact all-pairs sweep on one device (not a projection).

Synthesizes 1,000,000 8-frame VPDQ hashes (random 256-bit frame hashes,
~8 s clips at 1 fps — the 8-frame corpus model) with 1,000 planted
near-duplicate pairs, then runs the production engine path exactly the way
dedup stage 4 drives it: row chunks through TpuSearchEngine.find_pairs with
ONE shared col_state (column side packed/unpacked/uploaded once,
device-resident across chunks; one scan-sweep dispatch per row tile).

Checks: every planted pair found in both directions at its exact integer
similarity, every self-match found, zero other hits (random 256-bit frames
collide within tolerance 31 with p ~ 1e-36).

Usage: python artifacts/sweep_1m.py [n_videos] [chunk_rows] [square|triangle]
Writes a log line summary to stdout; run it with a generous timeout.

triangle mode drives the col_limit prefix schedule exactly like dedup
stage 4 (each chunk compares against the corpus prefix ending at itself):
same-chunk pairs are found in both directions, cross-chunk pairs once,
at ~half the square's device work.
"""

from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

N = int(sys.argv[1]) if len(sys.argv) > 1 else 1_000_000
CHUNK = int(sys.argv[2]) if len(sys.argv) > 2 else 131_072
MODE = sys.argv[3] if len(sys.argv) > 3 else "square"
#: "uniform" = FRAMES frames per video; "mixed" = 1..64-frame ragged corpus
#: (avg ~12; exercises the greedy packer + membership one-hots at scale)
#: plus N_EMPTY empty hashes (must match nothing, incl. themselves)
LENGTHS = sys.argv[4] if len(sys.argv) > 4 else "uniform"
FRAMES = 8
N_PLANT = 1_000  # adjacent pairs (always same-chunk)
N_PLANT_FAR = 500  # pairs (k, k + N//2): always cross-chunk for CHUNK < N/2
N_EMPTY = 100


def log(msg):
    print(f"[{time.strftime('%H:%M:%S')}] {msg}", flush=True)


def main():
    import jax

    from hydrus_video_deduplicator_tpu import device

    device.enable_compile_cache()
    log(f"device: {jax.devices()[0]}")

    from hydrus_video_deduplicator_tpu.parallel.engine import TpuSearchEngine
    from hydrus_video_deduplicator_tpu.vpdq import matchHashBytes

    rng = np.random.default_rng(42)
    t0 = time.time()
    if LENGTHS == "uniform":
        raw = rng.integers(0, 256, (N, FRAMES * 32), dtype=np.uint8)
        blobs = [row.tobytes() for row in raw]
        n_empty = 0
    else:  # mixed: ragged 1..64-frame videos + some empty hashes
        counts = rng.integers(1, 65, N)
        flat = rng.integers(0, 256, (int(counts.sum()) * 32,), dtype=np.uint8)
        offs = np.concatenate([[0], np.cumsum(counts * 32)])
        fb = flat.tobytes()
        blobs = [fb[offs[i] : offs[i + 1]] for i in range(N)]
        empties = rng.choice(
            np.arange(3 * N_PLANT, N - N // 2), size=N_EMPTY, replace=False
        )
        for e in empties:
            blobs[int(e)] = b""
        n_empty = N_EMPTY

    def plant(a, b):
        src = bytearray(blobs[a])
        nf = len(src) // 32
        flips = rng.integers(0, len(src), size=max(1, 3 * nf))
        for f in flips:
            src[int(f)] ^= 1 << int(rng.integers(0, 8))
        blobs[b] = bytes(src)

    # near-duplicates: adjacent pairs (2k, 2k+1) — always same-chunk — plus
    # far pairs (k, k + N//2) — always cross-chunk at these chunk sizes
    pairs = [(2 * k, 2 * k + 1) for k in range(N_PLANT)]
    far = [(2 * N_PLANT + k, 2 * N_PLANT + k + N // 2) for k in range(N_PLANT_FAR)]
    for a, b in pairs + far:
        plant(a, b)
    expected = {}
    for a, b in pairs + far:
        s = int(matchHashBytes(blobs[a], blobs[b]))
        assert s >= 75, s
        expected[(a, b)] = s
        expected[(b, a)] = s
    total_frames = sum(len(b) // 32 for b in blobs)
    log(f"corpus: {N} videos ({LENGTHS}, {total_frames} frames, "
        f"{n_empty} empty), {N_PLANT} near + {N_PLANT_FAR} far planted "
        f"pairs (synth {time.time()-t0:.1f}s)")

    eng = TpuSearchEngine(segment_min_work=0)
    col_state: dict = {}
    hits_self = 0
    hits_planted = 0
    extras = []
    wrong_sim = []
    t_start = time.time()
    done_chunks = 0
    n_chunks = (N + CHUNK - 1) // CHUNK
    for i0 in range(0, N, CHUNK):
        chunk = blobs[i0 : i0 + CHUNK]
        t_c = time.time()
        limit = min(i0 + CHUNK, N) if MODE == "triangle" else None
        hits = eng.find_pairs(chunk, blobs, 75, col_state=col_state, col_limit=limit)
        done_chunks += 1
        for i, j, s in hits:
            gi = i + i0
            if gi == j:
                hits_self += 1
                if s != 100:
                    wrong_sim.append((gi, j, s))
            elif (gi, j) in expected:
                hits_planted += 1
                if s != expected[(gi, j)]:
                    wrong_sim.append((gi, j, s))
            else:
                extras.append((gi, j, s))
        log(f"chunk {done_chunks}/{n_chunks}: {len(hits)} hits, "
            f"{time.time()-t_c:.1f}s (cum {time.time()-t_start:.1f}s)")
    wall = time.time() - t_start
    pairs = N * N if MODE == "square" else N * N // 2
    # expected planted-hit events: same-chunk pairs arrive in both
    # directions in either mode; cross-chunk pairs arrive once under
    # triangle (later row vs earlier column), twice under square
    same_chunk = sum(1 for a, b in expected if a < b and a // CHUNK == b // CHUNK)
    cross_chunk = sum(1 for a, b in expected if a < b and a // CHUNK != b // CHUNK)
    want_planted = 2 * same_chunk + (cross_chunk if MODE == "triangle" else 2 * cross_chunk)
    log(f"DONE [{MODE}]: {N}x{N} -> {pairs:.3g} compared pairs in {wall:.1f}s "
        f"wall ({pairs/wall:.3g} pairs/s end-to-end on {jax.devices()[0].device_kind})")
    want_self = N - n_empty  # empty hashes match nothing, incl. themselves
    log(f"self-matches {hits_self}/{want_self}; planted hit events "
        f"{hits_planted}/{want_planted}; false positives {len(extras)}; "
        f"wrong similarity {len(wrong_sim)}")
    assert hits_self == want_self and hits_planted == want_planted
    assert not extras and not wrong_sim
    log("CORRECTNESS: exact")


if __name__ == "__main__":
    main()
