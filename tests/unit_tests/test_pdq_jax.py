"""Bit-exactness of the JAX hash path vs the C++/numpy oracles.

The XLA path is strictly bit-identical to both oracles on every backend
(models/pdq._guard keeps f32 products out of FMA contraction); these tests
hold the CPU to that, and chip_smoke.py holds the GPU to it.
"""

from __future__ import annotations

import numpy as np
import pytest

from hydrus_video_deduplicator_tpu import native
from hydrus_video_deduplicator_tpu.models import pdq as mpdq
from hydrus_video_deduplicator_tpu.vpdq import python_ref

pytestmark = pytest.mark.skipif(not native.is_available(), reason="native lib not built")


def _batches(rng):
    noise = rng.integers(0, 256, (4, 512, 512, 3), dtype=np.uint8)
    x = np.linspace(0, 255, 512)
    base = np.add.outer(x, x) / 2
    smooth = np.stack(
        [np.stack([np.roll(base, 11 * i, axis=0)] * 3, -1) for i in range(4)]
    ).astype(np.uint8)
    const = np.full((2, 512, 512, 3), 90, np.uint8)
    return {"noise": noise, "smooth": smooth, "const": const}


def _native_ref(batch):
    hashes, quals = [], []
    for f in batch:
        h, q = native.pdq_hash_frame(f.tobytes(), 512, 512)
        hashes.append(h)
        quals.append(q)
    return hashes, quals


def _hamming(a: bytes, b: bytes) -> int:
    return bin(int.from_bytes(a, "big") ^ int.from_bytes(b, "big")).count("1")


def test_xla_path_bitexact(rng):
    """Hashes and qualities identical to the native hasher, degenerate
    (constant) frames included."""
    for name, batch in _batches(rng).items():
        words, q = mpdq.pdq_hash_batch_jit(batch)
        blobs = mpdq.words_to_blobs(np.asarray(words))
        ref_h, ref_q = _native_ref(batch)
        assert blobs == ref_h, f"{name}: hash mismatch"
        assert list(np.asarray(q)) == ref_q, f"{name}: quality mismatch"


def test_xla_intermediates_bitexact(rng):
    """f32 bit-identity of the filtered buffer and the DCT output."""
    import jax
    import jax.numpy as jnp

    f = rng.integers(0, 256, (1, 512, 512, 3), dtype=np.uint8)
    luma = mpdq._luma(jnp.asarray(f))
    buf64 = np.asarray(jax.jit(mpdq._filter_and_decimate)(luma, mpdq.ZERO))[0]
    dct = np.asarray(jax.jit(mpdq._dct16)(jnp.asarray(buf64[None]), mpdq.ZERO))[0]
    _, _, buf64_c, dct_c = native.pdq_hash_frame_debug(f[0].tobytes(), 512, 512)
    assert np.array_equal(buf64, buf64_c)
    assert np.array_equal(dct, dct_c)


def test_guard_blocks_fma_contraction():
    """Without the runtime zero, XLA-CPU contracts the filter's multiplies
    into the next pass's adds and the buffer drifts from the oracle; with
    it the buffer is exact — the guard, not luck, makes the path exact."""
    import jax
    import jax.numpy as jnp

    f = np.random.default_rng(0).integers(0, 256, (1, 512, 512, 3), dtype=np.uint8)
    luma = mpdq._luma(jnp.asarray(f))
    folded = np.asarray(
        jax.jit(lambda x: mpdq._filter_and_decimate(x, jnp.int32(0)))(luma)
    )[0]
    guarded = np.asarray(jax.jit(mpdq._filter_and_decimate)(luma, mpdq.ZERO))[0]
    _, _, buf64_c, _ = native.pdq_hash_frame_debug(f[0].tobytes(), 512, 512)
    assert np.array_equal(guarded, buf64_c)
    assert not np.array_equal(folded, buf64_c)


def test_words_blobs_roundtrip(rng):
    words = rng.integers(0, 1 << 16, (6, 16)).astype(np.uint16)
    blobs = mpdq.words_to_blobs(words)
    back = mpdq.blobs_to_words(blobs)
    assert np.array_equal(back, words)


def test_xla_path_agrees_with_oracle_python(rng):
    """Close the triangle: XLA vs pure-numpy oracle directly."""
    f = rng.integers(0, 256, (2, 512, 512, 3), dtype=np.uint8)
    words, q = mpdq.pdq_hash_batch_jit(f)
    blobs = mpdq.words_to_blobs(np.asarray(words))
    for i in range(2):
        h_np, q_np = python_ref.pdq_hash_frame(f[i])
        assert blobs[i] == h_np
        assert int(q[i]) == q_np
