"""Realistic-corpus exact sweep on one device.

Search cost is quadratic in frames per video, so this script measures the exact
scene-representative PRUNED route (engine.find_pairs_pruned) on a
realistic frames profile — ragged 1..512 frames, mean >= 64 — and
cross-checks exactness against the brute-force engine at sizes where
brute force is still runnable.

## Corpus generative model (the "honest frames-profile" contract)

Real 1 fps VPDQ sampling produces, per video, runs of similar frames
(shots) separated by cuts. The synthetic model, all parameters printed
with every run:

  * frame count  ~ LogNormal(ln 48, 0.9) clipped to [1, 512]
    (mean ~72, median ~48 — the 60-600 "realistic corpus" band's low
    end; empirical mean printed);
  * shots: geometric with mean SHOT_MEAN = 6 seconds (film-typical cut
    rate at 1 fps), anchor = uniform random 256-bit hash per shot;
  * within-shot drift: frame at position t of its shot differs from the
    anchor by ~Binomial(256, min(0.012 t, 0.08)) bits — linear camera
    drift saturating at ~20 bits (a settling shot). The saturation keeps
    typical shots to 1-2 scene leaders at radius cap 24, which is the
    realism assumption the pruned route's win rests on; the profile
    table in sweep_scenes_summary.md varies it.
  * planted duplicates: re-encodes (every frame XOR ~8 random bits) as
    adjacent pairs (same chunk), far pairs (cross chunk), and subset
    clips (contiguous half of the source, re-encoded);
  * N_EMPTY empty hashes (all-low-quality videos; must match nothing).

Cross-video frame distances concentrate at 128 +- 10 bits, so non-planted
matches are ~12 sigma out: the exact expected hit set is (self-matches +
planted pairs), verified exhaustively, and the prune-stage candidate
count is reported against it (false candidates cost verification work,
never correctness).

Usage:
  python artifacts/sweep_scenes.py N CHUNK pruned|brute|both [radius_cap]

"both" runs brute force first, then the pruned route, and asserts the
two hit sets are IDENTICAL (use at N <= ~100k; brute needs the whole
column corpus device-resident — ~16 GB pm1 rows at 1M mean-64 frames,
which is precisely why the pruned route exists).

Run via nohup with a generous window.
"""

from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

N = int(sys.argv[1]) if len(sys.argv) > 1 else 1_000_000
CHUNK = int(sys.argv[2]) if len(sys.argv) > 2 else 131_072
MODE = sys.argv[3] if len(sys.argv) > 3 else "pruned"
RADIUS_CAP = int(sys.argv[4]) if len(sys.argv) > 4 else 24

from tests.scene_library import DRIFT_RATE, DRIFT_SAT, SHOT_MEAN  # noqa: E402
REENC_BITS = 8  # re-encode noise bits per frame
N_PLANT = 1_000  # adjacent re-encode pairs (same chunk)
N_PLANT_FAR = 500  # (k, k + N//2) re-encode pairs (cross chunk)
N_CLIP = 300  # subset-clip pairs (adjacent)
N_EMPTY = 100
MIN_SIM = 75

#: median of the lognormal frames-per-video model (mean-71 profile at the
#: default 48; HVD_SWEEP_MEDIAN=84 gives the mean-120 profile row of
#: sweep_scenes_summary.md's scaling table)
MEDIAN_FRAMES = float(os.environ.get("HVD_SWEEP_MEDIAN", "48"))



def log(msg):
    print(f"[{time.strftime('%H:%M:%S')}] {msg}", flush=True)


def gen_corpus(rng):
    """Vectorized scene-model corpus -> (frames [F,32] u8, offsets [N+1])
    (tests/scene_library.scene_frames: the same RNG call sequence, so seed
    7 reproduces every corpus this script has measured)."""
    from tests.scene_library import scene_frames

    return scene_frames(rng, N, MEDIAN_FRAMES, log=log)


def build_corpus(rng, min_sim: int = MIN_SIM):
    """Scene-model corpus with plants: (blobs, expected, n_empty).

    `expected` maps (a, b) AND (b, a) video-index pairs to the exact
    integer similarity for every planted pair scoring >= min_sim. The
    RNG call sequence is identical to the pre-refactor inline code, so
    seed 7 reproduces every measured corpus in sweep_scenes_*.log.
    (Also reused by library_1m_fresh.py — the fresh-library production
    rehearsal — so both drivers agree on the generative model.)
    """
    from hydrus_video_deduplicator_tpu.vpdq import matchHashBytes

    t0 = time.time()
    frames, offsets = gen_corpus(rng)
    blobs = [
        frames[offsets[i] : offsets[i + 1]].tobytes() for i in range(N)
    ]
    del frames

    def reencode(src: bytes) -> bytes:
        arr = np.frombuffer(src, dtype=np.uint8).reshape(-1, 32).copy()
        nf = arr.shape[0]
        pos = rng.integers(0, 256, (nf, REENC_BITS))
        for f in range(nf):  # planted pairs only — not corpus-scale
            for pbit in pos[f]:
                arr[f, pbit // 8] ^= np.uint8(1 << (pbit % 8))
        return arr.tobytes()

    n_plant = min(N_PLANT, N // 20)
    n_far = min(N_PLANT_FAR, N // 40)
    n_clip = min(N_CLIP, N // 40)
    n_empty = min(N_EMPTY, N // 50)
    plant_pairs = [(2 * kk, 2 * kk + 1) for kk in range(n_plant)]
    far0 = 2 * n_plant
    plant_pairs += [(far0 + kk, far0 + kk + N // 2) for kk in range(n_far)]
    clip0 = far0 + n_far
    clip_pairs = [(clip0 + 2 * kk, clip0 + 2 * kk + 1) for kk in range(n_clip)]
    for a, b in plant_pairs:
        blobs[b] = reencode(blobs[a])
    for a, b in clip_pairs:
        half = (len(blobs[a]) // 32 + 1) // 2 * 32
        blobs[b] = reencode(blobs[a][:half])
    empties = rng.choice(np.arange(clip0 + 2 * n_clip, N - N // 2 - 1),
                         size=n_empty, replace=False)
    for e in empties:
        blobs[int(e)] = b""
    expected = {}
    for a, b in plant_pairs + clip_pairs:
        s = int(matchHashBytes(blobs[a], blobs[b]))
        if s >= min_sim:
            expected[(a, b)] = s
            expected[(b, a)] = s
    log(
        f"corpus built in {time.time()-t0:.1f}s; planted pairs >= {min_sim}: "
        f"{len(expected) // 2}/{len(plant_pairs) + len(clip_pairs)}"
    )
    return blobs, expected, n_empty


def main():
    import jax

    from hydrus_video_deduplicator_tpu import device

    device.enable_compile_cache()
    log(f"device: {jax.devices()[0]}; N={N} chunk={CHUNK} mode={MODE} cap={RADIUS_CAP}")
    log(
        f"model: shots geom({SHOT_MEAN}), drift {DRIFT_RATE}/pos sat {DRIFT_SAT}, "
        f"reenc {REENC_BITS}b, plants {N_PLANT}+{N_PLANT_FAR}far+{N_CLIP}clip, "
        f"{N_EMPTY} empty"
    )

    from hydrus_video_deduplicator_tpu.ops import reps as reps_mod
    from hydrus_video_deduplicator_tpu.parallel.engine import TpuSearchEngine

    blobs, expected, n_empty = build_corpus(np.random.default_rng(7))

    # rep statistics (the quantity stage-A cost is quadratic in)
    t_r = time.time()
    rep_blobs = reps_mod.extract_reps(blobs, RADIUS_CAP)
    total_frames = sum(len(b) // 32 for b in blobs)
    total_reps = sum(len(b) // 32 for b in rep_blobs)
    log(
        f"reps: {total_reps} of {total_frames} frames "
        f"({total_reps / total_frames:.3f} ratio, "
        f"{(total_frames / total_reps) ** 2:.1f}x quadratic win) "
        f"in {time.time()-t_r:.1f}s host clustering"
    )
    del rep_blobs

    def run(kind: str):
        eng = TpuSearchEngine(segment_min_work=0)
        fn = eng.find_pairs_pruned if kind == "pruned" else eng.find_pairs
        col_state: dict = {}
        got = {}
        extras = []
        t_s = time.time()
        n_chunks = (N + CHUNK - 1) // CHUNK
        for ci, i0 in enumerate(range(0, N, CHUNK), start=1):
            chunk = blobs[i0 : i0 + CHUNK]
            t_c = time.time()
            kw = {"col_state": col_state, "col_limit": min(i0 + CHUNK, N)}
            if kind == "pruned":
                kw["radius_cap"] = RADIUS_CAP
            hits = fn(chunk, blobs, MIN_SIM, **kw)
            for i, j, s in hits:
                gi = i + i0
                if gi == j:
                    got[(gi, j)] = s
                elif (gi, j) in expected:
                    got[(gi, j)] = s
                else:
                    extras.append((gi, j, s))
            log(
                f"[{kind}] chunk {ci}/{n_chunks}: {len(hits)} hits "
                f"{time.time()-t_c:.1f}s (cum {time.time()-t_s:.1f}s)"
            )
        wall = time.time() - t_s
        return got, extras, wall

    def check(kind, got, extras, wall):
        self_hits = sum(1 for (a, b) in got if a == b)
        want_self = N - n_empty
        planted_events = sum(1 for (a, b) in got if a != b)
        same_chunk = sum(
            1 for a, b in expected if a < b and a // CHUNK == b // CHUNK
        )
        cross_chunk = sum(
            1 for a, b in expected if a < b and a // CHUNK != b // CHUNK
        )
        want_planted = 2 * same_chunk + cross_chunk  # triangle schedule
        wrong = [
            (a, b, s) for (a, b), s in got.items() if a != b and s != expected[(a, b)]
        ]
        fp = total_frames * total_frames // 2
        log(
            f"DONE [{kind}]: {N}x{N} triangle (mean {total_frames / N:.1f} "
            f"frames, {fp:.3g} frame pairs) in {wall:.1f}s wall on "
            f"{jax.devices()[0].device_kind}"
        )
        log(
            f"[{kind}] self {self_hits}/{want_self}; planted events "
            f"{planted_events}/{want_planted}; extras {len(extras)}; "
            f"wrong sim {len(wrong)}"
        )
        assert self_hits == want_self, (self_hits, want_self)
        assert planted_events == want_planted, (planted_events, want_planted)
        assert not extras and not wrong, (extras[:5], wrong[:5])
        log(f"[{kind}] CORRECTNESS: exact")
        return got

    results = {}
    kinds = ["brute", "pruned"] if MODE == "both" else [MODE]
    for kind in kinds:
        got, extras, wall = run(kind)
        results[kind] = check(kind, got, extras, wall)
    if MODE == "both":
        assert results["brute"] == results["pruned"], "hit sets differ!"
        log("PRUNED == BRUTE: identical hit sets")


if __name__ == "__main__":
    main()
