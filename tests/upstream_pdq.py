"""Upstream-order PDQ oracle (test-only).

A literal re-expression of Meta ThreatExchange PDQ's arithmetic ORDER —
float luma, sequential running-window box sums with true divides, torben
median — as opposed to the framework's exact-by-construction spec
(hydrus_video_deduplicator_tpu/vpdq/pdq_math.py), which reassociates the
box sums into a fixed pairwise tree and replaces divides with shared f32
reciprocal multiplies so the CPU and the device agree bitwise.

Purpose: measure the hash-bit divergence those reassociations introduce
(tests/unit_tests/test_pdq_upstream_fidelity.py). The reference's own
cross-environment contract is "hashes within similarity >= 99"
(/root/reference/tests/unit_tests/test_vpdqpy.py:116-128); the divergence
measured here is far inside that.

Algorithm structure (per upstream pdq/cpp/hashing/pdqhashing.cpp as
summarized in SURVEY.md §2.1/N1):
  1. luma[i] = 0.299f*R + 0.587f*G + 0.114f*B           (float, 0..255)
  2. two reps of (box along rows, box along cols), window =
     computeJaroszFilterWindowSize(512, 64) = ceil(512/128) = 4, each box
     pass a 4-phase running-sum loop with ``sum / currentWindowSize``
     float divides
  3. decimate at floor((i + 0.5) * 512 / 64)
  4. quality: gradientSum of trunc((u - v) * 100 / 255) over vertical and
     horizontal neighbors of the 64x64 buffer; quality = min(sum/90, 100)
  5. DCT: out16 = D @ buf64 @ D^T, ascending-k sequential accumulation
  6. median of the 256 DCT values via torben; bit = value > median
"""

from __future__ import annotations

import numpy as np

FRAME_DIM = 512
BUF_DIM = 64
DCT_DIM = 16

LUMA_R = np.float32(0.299)
LUMA_G = np.float32(0.587)
LUMA_B = np.float32(0.114)


def compute_jarosz_filter_window_size(old_dim: int, new_dim: int = BUF_DIM) -> int:
    return (old_dim + 2 * new_dim - 1) // (2 * new_dim)


def luma_f32(rgb: np.ndarray) -> np.ndarray:
    r = rgb[:, :, 0].astype(np.float32)
    g = rgb[:, :, 1].astype(np.float32)
    b = rgb[:, :, 2].astype(np.float32)
    return (LUMA_R * r + LUMA_G * g) + LUMA_B * b


def box_pass_sequential(x: np.ndarray, window: int) -> np.ndarray:
    """Upstream box1DFloat along axis 1, vectorized over the independent
    lines in axis 0 (each element's arithmetic sequence is unchanged)."""
    n = x.shape[1]
    half = (window + 2) // 2
    out = np.empty_like(x)
    s = np.zeros(x.shape[0], dtype=np.float32)
    cur = 0
    li = ri = oi = 0
    for _ in range(half - 1):  # phase 1: accumulate, no writes
        s = s + x[:, ri]
        cur += 1
        ri += 1
    for _ in range(window - half + 1):  # phase 2: growing window
        s = s + x[:, ri]
        cur += 1
        out[:, oi] = s / np.float32(cur)
        ri += 1
        oi += 1
    for _ in range(n - window):  # phase 3: full window, running add/sub
        s = s + x[:, ri]
        s = s - x[:, li]
        out[:, oi] = s / np.float32(window)
        li += 1
        ri += 1
        oi += 1
    for _ in range(half - 1):  # phase 4: shrinking window
        s = s - x[:, li]
        cur -= 1
        out[:, oi] = s / np.float32(cur)
        li += 1
        oi += 1
    return out


def jarosz_filter(luma: np.ndarray, nreps: int = 2) -> np.ndarray:
    h, w = luma.shape
    wr = compute_jarosz_filter_window_size(w)
    wc = compute_jarosz_filter_window_size(h)
    x = luma
    for _ in range(nreps):
        x = box_pass_sequential(x, wr)  # along each row
        x = box_pass_sequential(x.T, wc).T  # along each column
    return x


def decimate(buf: np.ndarray) -> np.ndarray:
    h, w = buf.shape
    ri = ((2 * np.arange(BUF_DIM) + 1) * h) // (2 * BUF_DIM)
    ci = ((2 * np.arange(BUF_DIM) + 1) * w) // (2 * BUF_DIM)
    return buf[np.ix_(ri, ci)]


def quality(buf64: np.ndarray) -> int:
    """Upstream order: trunc(((u - v) * 100) / 255) per neighbor pair."""
    hundred = np.float32(100.0)
    d255 = np.float32(255.0)
    dv = ((buf64[:-1, :] - buf64[1:, :]) * hundred) / d255
    dh = ((buf64[:, :-1] - buf64[:, 1:]) * hundred) / d255
    gs = int(np.abs(np.trunc(dv).astype(np.int64)).sum()) + int(
        np.abs(np.trunc(dh).astype(np.int64)).sum()
    )
    return min(gs // 90, 100)


def dct_matrix() -> np.ndarray:
    i = np.arange(1, DCT_DIM + 1, dtype=np.float64)[:, None]
    j = np.arange(BUF_DIM, dtype=np.float64)[None, :]
    d = np.sqrt(np.float64(2.0) / BUF_DIM) * np.cos(
        (np.pi / 2.0 / BUF_DIM) * i * (2.0 * j + 1.0)
    )
    return d.astype(np.float32)


_D = dct_matrix()


def dct16(buf64: np.ndarray) -> np.ndarray:
    """Ascending-k sequential accumulation, as in upstream's triple loops."""
    tmp = np.zeros((DCT_DIM, BUF_DIM), dtype=np.float32)
    for k in range(BUF_DIM):
        tmp = tmp + _D[:, k][:, None] * buf64[k, :][None, :]
    out = np.zeros((DCT_DIM, DCT_DIM), dtype=np.float32)
    for k in range(BUF_DIM):
        out = out + tmp[:, k][:, None] * _D[:, k][None, :]
    return out


def torben(m: np.ndarray) -> float:
    """Literal torben median (upstream pdq torben.cpp)."""
    v = m.reshape(-1)
    n = v.size
    mn = np.float32(v.min())
    mx = np.float32(v.max())
    while True:
        guess = np.float32((mn + mx) / np.float32(2.0))
        less = int((v < guess).sum())
        greater = int((v > guess).sum())
        lt = v[v < guess]
        gt = v[v > guess]
        maxltguess = np.float32(lt.max()) if lt.size else mn
        mingtguess = np.float32(gt.min()) if gt.size else mx
        if less <= (n + 1) // 2 and greater <= (n + 1) // 2:
            break
        elif less > greater:
            mx = maxltguess
        else:
            mn = mingtguess
    if less >= (n + 1) // 2:
        return float(maxltguess)
    elif less + int((v == guess).sum()) >= (n + 1) // 2:
        return float(guess)
    return float(mingtguess)


def pdq_hash_frame_upstream(rgb512: np.ndarray) -> tuple[bytes, int]:
    """(32-byte canonical hash, quality) in upstream arithmetic order."""
    from hydrus_video_deduplicator_tpu.vpdq import pdq_math as pm

    lum = luma_f32(rgb512)
    filt = jarosz_filter(lum)
    buf64 = decimate(filt)
    q = quality(buf64)
    d = dct16(buf64)
    med = np.float32(torben(d))
    bits = d > med
    return pm.pack_bits_to_hash(bits), q
