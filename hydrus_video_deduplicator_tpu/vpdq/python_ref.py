"""Pure-numpy PDQ/VPDQ reference implementation (the slow oracle).

Implements the exact-by-construction PDQ spec in :mod:`.pdq_math` with
explicit fixed-order f32 arithmetic. Every other implementation (C++ native,
JAX XLA) is tested for bit-identity against this module.

numpy is safe for this purpose because each element-wise op here is a single
IEEE-754 f32 operation applied in an explicit order (no reductions that could
be re-associated internally).

Reference behavior: /root/reference/src/hydrusvideodeduplicator/vpdqpy/vpdqpy.py
(the caller pre-scales frames to 512x512 rgb24) and the hvdaccelerators native
API contract documented in SURVEY.md §2.1.
"""

from __future__ import annotations

import numpy as np

from . import pdq_math as pm


def luma_milli_f32(rgb: np.ndarray) -> np.ndarray:
    """[H,W,3] uint8 -> [H,W] f32 luma scaled x1000 (exact integer -> f32)."""
    assert rgb.dtype == np.uint8 and rgb.ndim == 3 and rgb.shape[2] == 3
    r = rgb[:, :, 0].astype(np.int32)
    g = rgb[:, :, 1].astype(np.int32)
    b = rgb[:, :, 2].astype(np.int32)
    milli = pm.LUMA_R * r + pm.LUMA_G * g + pm.LUMA_B * b
    return milli.astype(np.float32)


def _shift(x: np.ndarray, k: int, axis: int) -> np.ndarray:
    """out[i] = x[i+k] along axis (k may be negative); exact 0.0 out of range."""
    n = x.shape[axis]
    out = np.zeros_like(x)
    if k >= 0:
        src, dst = slice(k, n), slice(0, n - k)
    else:
        src, dst = slice(0, n + k), slice(-k, n)
    if axis == 0:
        out[dst, :] = x[src, :]
    else:
        out[:, dst] = x[:, src]
    return out


def _box_pass(x: np.ndarray, axis: int) -> np.ndarray:
    """One window-4 box pass along ``axis`` of a 2D f32 array.

    The spec's pairwise-tree order (pdq_math module docstring): left pair
    a2, right pair b2, their sum, then multiply by the per-position f32
    reciprocal of the live window count.
    """
    n = x.shape[axis]
    assert pm.WINDOW == 4, "pairwise-tree spec is defined for window 4"
    a2 = x + _shift(x, -1, axis)  # x[i-1] + x[i], left-clipped
    b2 = _shift(x, 1, axis) + _shift(x, 2, axis)  # x[i+1] + x[i+2], right-clipped
    s4 = a2 + b2  # sum x[i-1..i+2]
    recips = pm.box_recips(n).astype(np.float32)
    if axis == 0:
        return s4 * recips[:, None]
    return s4 * recips[None, :]


def jarosz_filter(luma: np.ndarray) -> np.ndarray:
    """Two reps of the window-4 box filter on [512,512] f32.

    "rows pass" = filtering along each row (axis 1), matching upstream PDQ's
    boxAlongRowsFloat; "cols pass" filters along axis 0. Rep 1 is (rows,
    cols); rep 2 is (cols, rows) — see the pass-order note in pdq_math:
    the swap is a pure f32 rounding reorder that allows a
    decimation-restricted rep 2.
    """
    x = _box_pass(luma, axis=1)
    x = _box_pass(x, axis=0)
    x = _box_pass(x, axis=0)
    x = _box_pass(x, axis=1)
    return x


def decimate(buf512: np.ndarray) -> np.ndarray:
    """[512,512] -> [64,64] gather at (8i+4, 8j+4)."""
    idx = pm.DECIMATE_IDX
    return buf512[np.ix_(idx, idx)]


def quality(buf64: np.ndarray) -> int:
    """Gradient-based quality metric on the decimated buffer (x1000 scale)."""
    qs = pm.QUALITY_SCALE
    # vertical diffs: rows i and i+1, all columns
    dv = (buf64[:-1, :] - buf64[1:, :]) * qs
    # horizontal diffs: cols j and j+1, all rows
    dh = (buf64[:, :-1] - buf64[:, 1:]) * qs
    gradient_sum = int(np.abs(np.trunc(dv).astype(np.int32)).sum()) + int(
        np.abs(np.trunc(dh).astype(np.int32)).sum()
    )
    return min(gradient_sum // pm.QUALITY_DENOM, pm.QUALITY_MAX)


def dct16(buf64: np.ndarray) -> np.ndarray:
    """out16 = D @ buf64 @ D^T via fixed-order k=0..63 mul-then-add chains."""
    d = pm.DCT_MATRIX  # [16, 64] f32
    tmp = np.zeros((pm.DCT_DIM, pm.BUF_DIM), dtype=np.float32)  # D @ buf
    for k in range(pm.BUF_DIM):
        tmp = tmp + d[:, k][:, None] * buf64[k, :][None, :]
    out = np.zeros((pm.DCT_DIM, pm.DCT_DIM), dtype=np.float32)  # tmp @ D^T
    for k in range(pm.BUF_DIM):
        out = out + tmp[:, k][:, None] * d[:, k][None, :]
    return out


def threshold_and_pack(dct: np.ndarray) -> bytes:
    """median = 128th-smallest (== upstream torben for n=256); bit = v > median."""
    flat = dct.reshape(-1)
    median = np.sort(flat, kind="stable")[flat.size // 2 - 1]
    bits = dct > median
    return pm.pack_bits_to_hash(bits)


def pdq_hash_frame(rgb512: np.ndarray) -> tuple[bytes, int]:
    """Full PDQ of one pre-scaled [512,512,3] uint8 frame -> (32-byte hash, quality)."""
    assert rgb512.shape == (pm.FRAME_DIM, pm.FRAME_DIM, 3)
    luma = luma_milli_f32(rgb512)
    filt = jarosz_filter(luma)
    buf64 = decimate(filt)
    q = quality(buf64)
    h = threshold_and_pack(dct16(buf64))
    return h, q


def vpdq_hash_frames(frames: list[np.ndarray]) -> bytes:
    """VPDQ of a sampled frame sequence: concat of per-frame PDQ hashes with
    quality >= QUALITY_MIN_KEEP, in frame order. May legitimately be empty."""
    out = bytearray()
    for frame in frames:
        h, q = pdq_hash_frame(frame)
        if q >= pm.QUALITY_MIN_KEEP:
            out += h
    return bytes(out)


# ---------------------------------------------------------------------------
# Similarity (reference semantics: SURVEY.md §2.1 matchHash / matchHashBytes)
# ---------------------------------------------------------------------------


def _split_frames(blob: bytes) -> np.ndarray:
    """32N-byte blob -> [N, 32] uint8 array of frame hashes."""
    if len(blob) % pm.BYTES_PER_HASH != 0:
        raise ValueError(f"hash blob length {len(blob)} not a multiple of {pm.BYTES_PER_HASH}")
    return np.frombuffer(blob, dtype=np.uint8).reshape(-1, pm.BYTES_PER_HASH)


_POPCOUNT8 = np.array([bin(i).count("1") for i in range(256)], dtype=np.int32)


def hamming_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """[Na,32] x [Nb,32] uint8 -> [Na,Nb] int32 Hamming distances."""
    x = a[:, None, :] ^ b[None, :, :]
    return _POPCOUNT8[x].sum(axis=2)


def match_hash_bytes(a: bytes, b: bytes, tolerance: int = pm.DEFAULT_DISTANCE_TOLERANCE) -> float:
    """VPDQ similarity in [0, 100] over two packed hash blobs.

    similarity = 100 * min(matched_a / len_a, matched_b / len_b) where a frame
    "matches" when its min Hamming distance to any frame of the other video is
    <= tolerance. Symmetric ("both directions must match", the single-float
    collapse of upstream vpdq's matchTwoHashBrute q/t percentages). Either
    blob empty -> 0.0 (an all-low-quality video matches nothing, including
    itself — reference: db/DedupeDB.py:555-558).
    """
    if len(a) == 0 or len(b) == 0:
        return 0.0
    fa = _split_frames(a)
    fb = _split_frames(b)
    d = hamming_matrix(fa, fb)
    matched = d <= tolerance
    ma = int(matched.any(axis=1).sum())
    mb = int(matched.any(axis=0).sum())
    pct_a = np.float64(100.0) * ma / fa.shape[0]
    pct_b = np.float64(100.0) * mb / fb.shape[0]
    return float(np.float32(min(pct_a, pct_b)))
