"""Batched PDQ frame hashing as a pure JAX (XLA) program.

Implements the exact-by-construction PDQ spec (vpdq/pdq_math.py) with the
same fixed op ordering as the numpy oracle and the C++ native path (built
with -ffp-contract=off). The resulting 256-bit hashes are bit-identical to
the oracles on every backend: each f32 product that feeds an addition
passes through :func:`_guard`, which keeps the compiler from contracting
the pair into a fused multiply-add (see its docstring). See the oracle
(vpdq/python_ref.py) for the authoritative step-by-step description.

The pipeline is jittable and shardable: the batch axis is embarrassingly
parallel, so sharding the leading axis over a mesh data-parallelizes hashing
across chips with zero collectives.

Reference behavior: /root/reference/src/hydrusvideodeduplicator/vpdqpy/vpdqpy.py
(fed 512x512 rgb24 frames) and SURVEY.md §2.1 (native hasher contract).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..vpdq import pdq_math as pm

# Constants materialized once (f32 bit patterns shared with C++/numpy).
_RECIPS = np.asarray(pm.box_recips(pm.FRAME_DIM), dtype=np.float32)  # [512]
_DCT = np.asarray(pm.DCT_MATRIX, dtype=np.float32)  # [16, 64]
_QS = np.float32(pm.QUALITY_SCALE)
#: k-group width per DCT scan step (divides BUF_DIM; see _dct16).
_UNROLL = 8


def _shift(x: jnp.ndarray, k: int, axis: int) -> jnp.ndarray:
    """k > 0: out[i] = x[i+k] (zero past the end); k < 0: out[i] = x[i+k]
    (zero before the start). Exact zero padding."""
    n = x.shape[axis]
    pad = [(0, 0)] * x.ndim
    if k >= 0:
        sl = jax.lax.slice_in_dim(x, k, n, axis=axis)
        pad[axis] = (0, k)
    else:
        sl = jax.lax.slice_in_dim(x, 0, n + k, axis=axis)
        pad[axis] = (-k, 0)
    return jnp.pad(sl, pad)


def _guard(product: jnp.ndarray, zero: jnp.ndarray) -> jnp.ndarray:
    """``product`` unchanged, out of reach of FMA contraction.

    XLA's CPU and GPU code generators let LLVM contract an f32 multiply
    whose result feeds an add into one fused multiply-add, which rounds
    once instead of twice and breaks bit parity with the oracles. ORing
    the product's bits with ``zero`` — a runtime int32 0 the compiler
    cannot see through — puts an integer op between the multiply and
    every add that consumes it, so no backend can fuse the pair. The cost
    is one integer op per product. ``zero`` must be an argument of the
    jitted program: a Python or NumPy 0 closed over becomes a constant,
    and the compiler folds the guard away.
    """
    bits = jax.lax.bitcast_convert_type(product, jnp.int32) | zero
    return jax.lax.bitcast_convert_type(bits, jnp.float32)


def _box_pass(x: jnp.ndarray, axis: int, zero: jnp.ndarray) -> jnp.ndarray:
    """One window-4 box pass along ``axis`` (last two axes are the frame).

    The spec's pairwise-tree order (vpdq/pdq_math.py): left pair a2, right
    pair b2, their sum, then the per-position reciprocal multiply. Mirrors
    python_ref._box_pass op for op.
    """
    n = x.shape[axis]
    a2 = x + _shift(x, -1, axis)  # x[i-1] + x[i], left-clipped
    b2 = _shift(x, 1, axis) + _shift(x, 2, axis)  # x[i+1] + x[i+2], right-clipped
    s4 = a2 + b2  # sum x[i-1..i+2]
    shape = [1] * x.ndim
    shape[axis] = n
    return _guard(s4 * jnp.asarray(_RECIPS).reshape(shape), zero)


def _luma(frames_u8: jnp.ndarray) -> jnp.ndarray:
    """[B, 512, 512, 3] uint8 -> [B, 512, 512] f32 luma x1000 (exact)."""
    f = frames_u8.astype(jnp.int32)
    milli = pm.LUMA_R * f[..., 0] + pm.LUMA_G * f[..., 1] + pm.LUMA_B * f[..., 2]
    return milli.astype(jnp.float32)


def _filter_and_decimate(luma: jnp.ndarray, zero: jnp.ndarray) -> jnp.ndarray:
    """[B, 512, 512] f32 -> [B, 64, 64] f32 (box passes + gather).

    Pass order (rows, cols, cols, rows) — see pdq_math's pass-order note.
    """
    x = _box_pass(luma, 2, zero)  # rep 1: along each row
    x = _box_pass(x, 1, zero)  # rep 1: along each column
    x = _box_pass(x, 1, zero)  # rep 2: columns first
    x = _box_pass(x, 2, zero)  # rep 2: rows second
    # decimate at (8i+4, 8j+4)
    return x[:, pm.DECIMATE_OFF :: pm.DECIMATE_STRIDE, pm.DECIMATE_OFF :: pm.DECIMATE_STRIDE]


def _quality(buf64: jnp.ndarray) -> jnp.ndarray:
    """[B, 64, 64] f32 -> [B] int32 gradient quality (trunc-to-int matches C)."""
    dv = (buf64[:, :-1, :] - buf64[:, 1:, :]) * _QS
    dh = (buf64[:, :, :-1] - buf64[:, :, 1:]) * _QS
    gs = jnp.abs(dv.astype(jnp.int32)).sum(axis=(1, 2)) + jnp.abs(
        dh.astype(jnp.int32)
    ).sum(axis=(1, 2))
    return jnp.minimum(gs // pm.QUALITY_DENOM, pm.QUALITY_MAX)


def _dct16(buf64: jnp.ndarray, zero: jnp.ndarray) -> jnp.ndarray:
    """[B, 64, 64] f32 -> [B, 16, 16] f32 via fixed-order k mul/add chains.

    Deliberately NOT a matmul: a library reduction order would break bit
    parity with the sequential-k oracle. The chains are expressed as
    lax.scan so no backend can re-recognize them as reassociable dots
    (XLA-CPU rewrites an unrolled 64-term mul/add chain into a dot with a
    different accumulation order), and every product is guarded against
    FMA contraction (_guard). The arrays are tiny (1/64th of the filter
    stage), so the 64-step sequential loop is not a bottleneck.
    """
    batch = buf64.shape[0]
    d = jnp.asarray(_DCT)
    # k is consumed in groups of _UNROLL per scan step: the products within
    # a group are independent, and the group's adds run in the same strict
    # k-ascending order as a 1-per-step scan — bit-identical accumulation
    # with 1/_UNROLL the scan-loop overhead. Groups stay inside a scan so
    # XLA cannot re-recognize the whole chain as a reassociable dot.
    u = _UNROLL

    def step1(tmp, xs):
        dk, bk = xs  # [u, 16], [u, B, 64]
        for i in range(u):
            tmp = tmp + _guard(dk[i][None, :, None] * bk[i][:, None, :], zero)
        return tmp, None

    tmp0 = jnp.zeros((batch, pm.DCT_DIM, pm.BUF_DIM), jnp.float32)
    dg = d.T.reshape(pm.BUF_DIM // u, u, pm.DCT_DIM)
    bg = jnp.moveaxis(buf64, 1, 0).reshape(pm.BUF_DIM // u, u, batch, pm.BUF_DIM)
    tmp, _ = jax.lax.scan(step1, tmp0, (dg, bg))

    def step2(out, xs):
        dk, tk = xs  # [u, 16], [u, B, 16]
        for i in range(u):
            out = out + _guard(tk[i][:, :, None] * dk[i][None, None, :], zero)
        return out, None

    out0 = jnp.zeros((batch, pm.DCT_DIM, pm.DCT_DIM), jnp.float32)
    tg = jnp.moveaxis(tmp, 2, 0).reshape(pm.BUF_DIM // u, u, batch, pm.DCT_DIM)
    out, _ = jax.lax.scan(step2, out0, (dg, tg))
    return out


def _threshold_pack(dct: jnp.ndarray) -> jnp.ndarray:
    """[B, 16, 16] f32 -> [B, 16] int32 words (w[i] bit j = dct[i,j] > median)."""
    flat = dct.reshape(dct.shape[0], -1)
    median = jnp.sort(flat, axis=1)[:, flat.shape[1] // 2 - 1]
    bits = dct > median[:, None, None]
    weights = (1 << jnp.arange(pm.DCT_DIM, dtype=jnp.int32))[None, None, :]
    return jnp.sum(bits.astype(jnp.int32) * weights, axis=2)


#: the runtime zero of _guard: it must reach the program as an argument
#: (a constant would be folded away, and the contraction with it)
ZERO = np.int32(0)


def pdq_hash_batch(
    frames_u8: jnp.ndarray, zero: jnp.ndarray
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Hash a batch of pre-scaled frames.

    Args:
      frames_u8: [B, 512, 512, 3] uint8 rgb24.
      zero: int32 scalar 0 passed at run time (:data:`ZERO`; see _guard).

    Returns:
      (words, quality): [B, 16] int32 hash words (w0..w15, 16 low bits
      significant) and [B] int32 quality. Convert words to canonical 32-byte
      blobs with :func:`words_to_blobs`.
    """
    luma = _luma(frames_u8)
    buf64 = _filter_and_decimate(luma, zero)
    q = _quality(buf64)
    words = _threshold_pack(_dct16(buf64, zero))
    return words, q


_pdq_hash_batch_jit = jax.jit(pdq_hash_batch)


def pdq_hash_batch_jit(frames_u8) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Jitted :func:`pdq_hash_batch` with the runtime zero supplied."""
    return _pdq_hash_batch_jit(frames_u8, ZERO)


# ---------------------------------------------------------------------------
# Host-side packing between device words and canonical 32-byte blobs
# ---------------------------------------------------------------------------


def words_to_blobs(words: np.ndarray) -> list[bytes]:
    """[B, 16] int/uint words -> list of canonical 32-byte PDQ blobs."""
    w = np.asarray(words, dtype=np.uint16)  # [B, 16], w0..w15
    be = w[:, ::-1].astype(">u2")  # w15..w0, big-endian each
    return [row.tobytes() for row in be]


def blobs_to_words(blobs: list[bytes]) -> np.ndarray:
    """Inverse of words_to_blobs: canonical blobs -> [B, 16] uint16 (w0..w15)."""
    out = np.zeros((len(blobs), pm.DCT_DIM), dtype=np.uint16)
    for i, blob in enumerate(blobs):
        assert len(blob) == pm.BYTES_PER_HASH
        out[i] = np.frombuffer(blob, dtype=">u2")[::-1]
    return out
