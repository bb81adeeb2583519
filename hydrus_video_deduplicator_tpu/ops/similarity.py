"""Bit-packed VPDQ similarity primitives for the device.

This is the device replacement for the reference's per-pair native
``matchHash`` AND for its VP-tree search at corpus scale (SURVEY.md §7 step
5): instead of a metric-tree descent doing O(depth) sequential 256-bit
comparisons per insert/query, we compute exact all-pairs similarity as tiled
int8 matrix products over the whole corpus.

Representations
---------------
- canonical blob: 32 bytes/frame (storage format, db + matchHashBytes).
- device packed:  [F, 8] uint32 lanes (bit b of frame f = packed[f, b//32]
  >> (b%32) — little-endian within the 256-bit row, derived from the blob's
  big-endian word order; the mapping is internal-only and round-trips).
- matmul form:    [F, 256] int8 in {-1, +1}. For rows a, b:
  dot(a, b) = 256 - 2 * hamming(a, b), so an int8 [Fa,256]x[256,Fb] matmul
  (int32 accumulation) yields all pairwise Hamming distances. Zero rows
  (padding) dot to 0 with everything, i.e. Hamming 128: they never match.

Video-level similarity (reference semantics, SURVEY.md §2.1):
  sim(A, B) = 100 * min(|{i: min_j d(ai,bj) <= tol}| / |A|,
                        |{j: min_i d(ai,bj) <= tol}| / |B|)
computed here in exact integer arithmetic: int_sim = min(100*ma // fa,
100*mb // fb), which equals trunc(float sim) for all practical frame counts.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..vpdq import pdq_math as pm

LANES = pm.BYTES_PER_HASH // 4  # 8 uint32 lanes per 256-bit hash
BITS = 8 * pm.BYTES_PER_HASH  # 256
TOL = pm.DEFAULT_DISTANCE_TOLERANCE
MATCH_DOT = BITS - 2 * TOL  # dot >= this  <=>  hamming <= TOL


# ---------------------------------------------------------------------------
# Host-side packing
# ---------------------------------------------------------------------------


def blobs_to_packed(blob: bytes) -> np.ndarray:
    """Packed hash blob (32N bytes) -> [N, 8] uint32 device representation."""
    arr = np.frombuffer(blob, dtype=np.uint8).reshape(-1, pm.BYTES_PER_HASH)
    return arr.view(np.uint32)  # little-endian u32 lanes of the byte rows


def packed_to_blobs(packed: np.ndarray) -> bytes:
    """Inverse of blobs_to_packed."""
    return np.ascontiguousarray(packed.astype(np.uint32)).view(np.uint8).tobytes()


def unpack_pm1_host(packed: np.ndarray, counts: np.ndarray | None = None) -> np.ndarray:
    """[V, P, 8] uint32 -> [V*P, 256] int8 ±1; padded frames become zero rows.

    counts: [V] true frame counts (frames at or past the count are zeroed).
    When None, every row is treated as real.

    Bit order: bit j of little-endian u32 lane l is hash bit l*32 + j, i.e.
    bit (b % 8) of blob byte (b // 8) — exactly np.unpackbits little order
    on the raw bytes (C-speed; a u32 shift-broadcast formulation is a host
    bottleneck at 1M-video scale).
    """
    v, p, _lanes = packed.shape
    u8 = np.ascontiguousarray(packed).view(np.uint8).reshape(v * p, BITS // 8)
    bits = np.unpackbits(u8, axis=1, bitorder="little")
    # 0/1 -> -1/+1 without an astype copy: uint8 wraps 0*2-1 to 255 == -1
    bits *= 2
    bits -= 1
    pm1 = bits.view(np.int8)
    if counts is not None:
        invalid = np.arange(p)[None, :] >= np.asarray(counts, np.int64)[:, None]
        pm1.reshape(v, p, BITS)[invalid] = 0
    return pm1


# ---------------------------------------------------------------------------
# Device primitives
# ---------------------------------------------------------------------------


def unpack_pm1(packed_u32: jnp.ndarray) -> jnp.ndarray:
    """[F, 8] uint32 -> [F, 256] int8 in {-1, +1} (bit set -> +1)."""
    shifts = jnp.arange(32, dtype=jnp.uint32)
    bits = (packed_u32[:, :, None] >> shifts[None, None, :]) & jnp.uint32(1)
    bits = bits.reshape(packed_u32.shape[0], BITS)
    return (bits.astype(jnp.int8) << 1) - jnp.int8(1)


def hamming_tile(a_pm1: jnp.ndarray, b_pm1: jnp.ndarray) -> jnp.ndarray:
    """[Fa, 256] x [Fb, 256] int8 ±1 -> [Fa, Fb] int32 Hamming distances.

    dot = 256 - 2d  =>  d = (256 - dot) >> 1. An int8 matrix product with
    int32 accumulation (exact).
    """
    dot = jax.lax.dot_general(
        a_pm1,
        b_pm1,
        dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.int32,
    )
    return (BITS - dot) >> 1


def hamming_tile_packed(a_packed: jnp.ndarray, b_packed: jnp.ndarray) -> jnp.ndarray:
    """Hamming distances straight from packed form (unpack fused on device)."""
    return hamming_tile(unpack_pm1(a_packed), unpack_pm1(b_packed))


def hamming_tile_popcount(a_packed: jnp.ndarray, b_packed: jnp.ndarray) -> jnp.ndarray:
    """Elementwise alternative: XOR + population_count. Exact; useful for small tiles
    where the ±1 unpack outweighs the matmul win."""
    x = a_packed[:, None, :] ^ b_packed[None, :, :]
    return jax.lax.population_count(x).sum(axis=2).astype(jnp.int32)


def video_pair_similarity(  # noqa: C901 - reference implementation
    # NOTE: this flat-layout aggregation is the readable REFERENCE
    # implementation of the video-level match-fraction semantics, used by
    # tests as a second oracle. The production paths implement the same
    # formula on bucketed layouts (parallel/engine._tile_similarity,
    # similarity_block_xla) and packed segments
    # (ops/similarity_segments.py); change them together.
    ham: jnp.ndarray,
    a_video_ids: jnp.ndarray,
    b_video_ids: jnp.ndarray,
    a_frame_counts: jnp.ndarray,
    b_frame_counts: jnp.ndarray,
    num_a: int,
    num_b: int,
    tolerance: int = pm.DEFAULT_DISTANCE_TOLERANCE,
) -> jnp.ndarray:
    """Aggregate a frame-level Hamming tile into video-level integer similarity.

    Args:
      ham: [Fa, Fb] frame Hamming distances (padded frames must carry a
        video id of num_a / num_b, i.e. an out-of-range bucket).
      a_video_ids / b_video_ids: [Fa] / [Fb] int32 video index per frame.
      a_frame_counts / b_frame_counts: [num_a] / [num_b] int32 true frame
        counts (0 for empty/padding videos).
      num_a / num_b: static video counts.

    Returns:
      [num_a, num_b] int32 similarity in [0, 100] (0 where either side empty).
    """
    matched = (ham <= tolerance).astype(jnp.int32)  # [Fa, Fb]

    # matched_ab[fa, vb] = does frame fa match any frame of video vb?
    onehot_b = (b_video_ids[:, None] == jnp.arange(num_b)[None, :]).astype(jnp.int32)
    frame_hits_b = (matched @ onehot_b) > 0  # [Fa, num_b]
    onehot_a = (a_video_ids[:, None] == jnp.arange(num_a)[None, :]).astype(jnp.int32)
    ma = onehot_a.T @ frame_hits_b.astype(jnp.int32)  # [num_a, num_b] matched-a counts

    frame_hits_a = (onehot_a.T @ matched) > 0  # [num_a, Fb]
    mb = frame_hits_a.astype(jnp.int32) @ onehot_b  # [num_a, num_b] matched-b counts

    fa = jnp.maximum(a_frame_counts, 1)[:, None]
    fb = jnp.maximum(b_frame_counts, 1)[None, :]
    sim_a = (100 * ma) // fa
    sim_b = (100 * mb) // fb
    sim = jnp.minimum(sim_a, sim_b)
    nonempty = (a_frame_counts[:, None] > 0) & (b_frame_counts[None, :] > 0)
    return jnp.where(nonempty, sim, 0)


@functools.partial(jax.jit, static_argnames=("pa", "pb"))
def similarity_block_xla(
    a_pm1: jnp.ndarray,  # [Ra*pa, 256] int8 (zero rows for pad)
    fa: jnp.ndarray,  # [Ra, 1] int32
    b_pm1: jnp.ndarray,  # [Cb*pb, 256] int8
    fb: jnp.ndarray,  # [Cb, 1] int32
    pa: int,
    pb: int,
) -> jnp.ndarray:
    """Integer video similarity [Ra, Cb] over ±1/0 frame rows of videos
    padded to pa / pb frames (zero rows past each count)."""
    ra = fa.shape[0]
    cb = fb.shape[0]
    dot = jax.lax.dot_general(
        a_pm1, b_pm1, (((1,), (1,)), ((), ())), preferred_element_type=jnp.int32
    )
    m = (dot >= MATCH_DOT).reshape(ra, pa, cb, pb)
    ma = m.any(axis=3).sum(axis=1, dtype=jnp.int32)  # [Ra, Cb]
    mb = m.any(axis=1).sum(axis=2, dtype=jnp.int32)  # [Ra, Cb]
    fa_div = jnp.maximum(fa, 1)  # [Ra, 1]
    fb_div = jnp.maximum(fb.T, 1)  # [1, Cb]
    return jnp.minimum((100 * ma) // fa_div, (100 * mb) // fb_div)


def int_similarity_to_distance(sim: jnp.ndarray) -> jnp.ndarray:
    """Reference distance mapping: (100 - int(similarity)) + 1 in [1, 101]
    (reference db/vptree.py:22-31)."""
    return (100 - sim) + 1
