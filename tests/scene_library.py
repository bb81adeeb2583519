"""Synthetic Hydrus libraries: the scene-profile hash corpus, its
brute-force oracle, and small y4m videos.

Used by the tests, by ``chip_smoke.py`` and by the scripts under
``artifacts/``. Everything is made from a seed.

Scene profile (no public source; the frames-per-video and shot model of
``artifacts/sweep_scenes.py``):

  * frames per video ~ LogNormal(ln 48, 0.9) clipped to [1, 512] (median
    48, mean ~71 at 1 frame per second);
  * shots: geometric with a mean of 6 frames, each anchored on a uniform
    random 256-bit hash;
  * within-shot drift: frame t of a shot differs from its anchor in about
    Binomial(256, min(0.012 t, 0.08)) bits;
  * planted near-duplicates: re-encodes (every frame XORed with up to
    REENC_BITS random bits), as adjacent pairs (2k, 2k+1) and far pairs
    (k, k + n // 2); a few empty hashes (videos whose frames all fell
    under the quality floor).

Cross-video frame distances concentrate at 128 +- 8 bits, so unplanted
matches are ~12 sigma out: at the CLI threshold the expected pair set is
the planted set.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

SHOT_MEAN = 6
DRIFT_RATE = 0.012
DRIFT_SAT = 0.08
REENC_BITS = 8
MEDIAN_FRAMES = 48.0
#: frames per generation slab (bounds the RNG temporaries)
GEN_CHUNK = 2_000_000


def scene_frames(rng, n: int, median: float = MEDIAN_FRAMES, log=None):
    """Scene-model frames of n videos: (frames [F, 32] u8, offsets [n+1])."""
    counts = np.clip(
        np.rint(np.exp(rng.normal(np.log(median), 0.9, n))), 1, 512
    ).astype(np.int64)
    offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(counts, out=offsets[1:])
    f_total = int(offsets[-1])
    if log is not None:
        log(
            f"frame profile: mean {counts.mean():.1f}, median {np.median(counts):.0f}, "
            f"p90 {np.percentile(counts, 90):.0f}, max {counts.max()}, total {f_total}"
        )

    # per-frame shot structure: new-shot flags -> shot ids -> position in shot
    new_shot = rng.random(f_total) < (1.0 / SHOT_MEAN)
    new_shot[offsets[:-1]] = True  # first frame of each video starts a shot
    shot_id = np.cumsum(new_shot) - 1
    n_shots = int(shot_id[-1]) + 1
    shot_start = np.zeros(n_shots, dtype=np.int64)
    shot_start[shot_id[new_shot]] = np.nonzero(new_shot)[0]
    pos = np.arange(f_total, dtype=np.int64) - shot_start[shot_id]

    anchors = rng.integers(0, 256, (n_shots, 32), dtype=np.uint8)
    # drift probability per frame, quantized to AND-depth k: p = 2^-k
    p = np.minimum(DRIFT_RATE * pos, DRIFT_SAT)
    with np.errstate(divide="ignore"):
        k = np.where(p > 0, np.rint(-np.log2(np.maximum(p, 1e-9))), 99).astype(np.int8)
    k = np.clip(k, 3, 99)  # p <= 1/8 always; k=99 -> no drift (exact anchor)

    frames = np.empty((f_total, 32), dtype=np.uint8)
    for s0 in range(0, f_total, GEN_CHUNK):
        s1 = min(s0 + GEN_CHUNK, f_total)
        sl = slice(s0, s1)
        fa = anchors[shot_id[sl]]
        drift = np.zeros((s1 - s0, 32), dtype=np.uint8)
        kk = k[sl]
        active = kk < 99
        if active.any():
            depth = int(kk[active].max())
            mask = rng.integers(0, 256, (int(active.sum()), 32), dtype=np.uint8)
            for d in range(2, depth + 1):
                deeper = kk[active] >= d
                mask[deeper] &= rng.integers(
                    0, 256, (int(deeper.sum()), 32), dtype=np.uint8
                )
            drift[active] = mask
        frames[sl] = fa ^ drift
    return frames, offsets


def reencode(rng, blob: bytes, bits: int = REENC_BITS) -> bytes:
    """Every frame of ``blob`` with up to ``bits`` random bits flipped."""
    arr = np.frombuffer(blob, dtype=np.uint8).reshape(-1, 32).copy()
    pos = rng.integers(0, 256, (arr.shape[0], bits))
    rows = np.repeat(np.arange(arr.shape[0]), bits)
    flips = np.zeros_like(arr)
    np.bitwise_xor.at(
        flips, (rows, pos.ravel() // 8), (1 << (pos.ravel() % 8)).astype(np.uint8)
    )
    return (arr ^ flips).tobytes()


@dataclass
class Library:
    blobs: list[bytes]
    #: planted near-duplicate pairs (a, b), a < b
    planted: list[tuple[int, int]]
    empty: list[int]


def scene_library(n: int, seed: int, n_adjacent: int | None = None,
                  n_far: int | None = None, n_empty: int | None = None) -> Library:
    """n videos of the scene profile with planted re-encode pairs."""
    rng = np.random.default_rng(seed)
    frames, offsets = scene_frames(rng, n)
    blobs = [frames[offsets[i] : offsets[i + 1]].tobytes() for i in range(n)]
    del frames
    n_adjacent = min(1000, n // 20) if n_adjacent is None else n_adjacent
    n_far = min(500, n // 40) if n_far is None else n_far
    n_empty = min(100, n // 100) if n_empty is None else n_empty
    planted = [(2 * k, 2 * k + 1) for k in range(n_adjacent)]
    far0 = 2 * n_adjacent
    planted += [(far0 + k, far0 + k + n // 2) for k in range(n_far)]
    for a, b in planted:
        blobs[b] = reencode(rng, blobs[a])
    used = {i for pair in planted for i in pair}
    free = np.asarray([i for i in range(n) if i not in used], dtype=np.int64)
    empty = sorted(int(e) for e in rng.choice(free, size=n_empty, replace=False))
    for e in empty:
        blobs[e] = b""
    return Library(blobs, planted, empty)


def brute_force_pairs(blobs: list[bytes], min_sim: int, workers: int = 8) -> set[tuple[int, int]]:
    """Every pair (a, b), a < b, whose native matchHashBytes similarity
    (truncated to an integer, as the engine reports it) is >= min_sim.
    Shares no code with the search engine."""
    from concurrent.futures import ThreadPoolExecutor

    from hydrus_video_deduplicator_tpu.vpdq import matchHashBytes

    nonempty = [i for i, b in enumerate(blobs) if b]

    def row(k: int) -> list[tuple[int, int]]:
        a = nonempty[k]
        return [
            (a, b)
            for b in nonempty[k + 1 :]
            if int(matchHashBytes(blobs[a], blobs[b])) >= min_sim
        ]

    out: set[tuple[int, int]] = set()
    with ThreadPoolExecutor(max_workers=workers) as ex:
        for hits in ex.map(row, range(len(nonempty))):
            out.update(hits)
    return out


def y4m_video(frames_rgb: np.ndarray, fps: int = 1) -> bytes:
    """[n, h, w, 3] u8 frames -> a C444 y4m stream (BT.601 full range, the
    inverse of the repo's y4m decoder up to rounding)."""
    n, h, w, _ = frames_rgb.shape
    out = [f"YUV4MPEG2 W{w} H{h} F{fps}:1 Ip A1:1 C444\n".encode()]
    for f in frames_rgb:
        r, g, b = (f[:, :, c].astype(np.int32) for c in range(3))
        y = np.clip((299 * r + 587 * g + 114 * b + 500) // 1000, 0, 255)
        u = np.clip(((b - y) * 564 + 500) // 1000 + 128, 0, 255)
        v = np.clip(((r - y) * 713 + 500) // 1000 + 128, 0, 255)
        out.append(b"FRAME\n")
        for plane in (y, u, v):
            out.append(plane.astype(np.uint8).tobytes())
    return b"".join(out)


def y4m_library(n: int, seed: int, w: int = 64, h: int = 48) -> tuple[list[bytes], list[tuple[int, int]]]:
    """n small y4m videos (3..12 one-second frames of blocky shots); every
    tenth video is a re-noised copy of the one before it, and video 0 is a
    constant colour (every frame under the quality floor: empty hash).
    Returns (videos, near-duplicate index pairs)."""
    rng = np.random.default_rng(seed)
    videos: list[bytes] = []
    pairs: list[tuple[int, int]] = []
    prev = None
    for i in range(n):
        if i == 0:
            frames = np.full((4, h, w, 3), 77, np.uint8)
        elif i % 10 == 0 and prev is not None:
            noise = rng.integers(-2, 3, prev.shape)
            frames = np.clip(prev.astype(np.int16) + noise, 0, 255).astype(np.uint8)
            pairs.append((i - 1, i))
        else:
            nf = int(rng.integers(3, 13))
            shots = rng.integers(0, 256, (nf // 3 + 1, h // 8, w // 8, 3), dtype=np.uint8)
            frames = np.repeat(np.repeat(shots, 8, 1), 8, 2)[np.arange(nf) // 3]
            frames = np.clip(
                frames.astype(np.int16) + rng.integers(-3, 4, frames.shape), 0, 255
            ).astype(np.uint8)
        prev = frames
        videos.append(y4m_video(frames))
    return videos, pairs
