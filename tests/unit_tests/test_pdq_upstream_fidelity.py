"""Quantified PDQ fidelity vs upstream arithmetic order.

The framework's PDQ spec (vpdq/pdq_math.py) deliberately reassociates
upstream PDQ's box-filter sums (fixed pairwise tree instead of a running
add/subtract window) and replaces true divides with shared f32 reciprocal
multiplies, so that CPU (C++/numpy) and the device (XLA) produce
bit-identical hashes. This test measures what those reassociations cost
against a literal upstream-order oracle (tests/upstream_pdq.py):

  * per-frame hash Hamming divergence over corpus frames, random noise,
    and structured gradients/blobs — asserted to stay tiny (<= 4 bits of
    256) and reported for the record;
  * per-frame quality divergence (<= 1 point);
  * torben median == 128th-smallest for n=256 (the spec's equivalence
    claim, checked on real DCT outputs).

The reference's own environmental-drift contract is "similarity >= 99"
(/root/reference/tests/unit_tests/test_vpdqpy.py:116-128), i.e. up to
2.56 hash bits of drift per frame pair on average — the reassociation
divergence measured here is well inside it.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np
import pytest

from hydrus_video_deduplicator_tpu.decode import extract_frames
from hydrus_video_deduplicator_tpu.vpdq import pdq_math as pm, python_ref as ref

from .. import upstream_pdq as up

CORPUS = Path(__file__).parents[1] / "corpus" / "videos"

#: number of random/structured synthetic frames (raise via env for a deeper
#: sweep, e.g. HVD_FIDELITY_FRAMES=1000)
N_SYNTH = int(os.environ.get("HVD_FIDELITY_FRAMES", "48"))


def _hamming(a: bytes, b: bytes) -> int:
    return bin(int.from_bytes(a, "big") ^ int.from_bytes(b, "big")).count("1")


def _synth_frames(n: int) -> list[np.ndarray]:
    rng = np.random.default_rng(1234)
    frames = []
    for i in range(n):
        kind = i % 4
        if kind == 0:  # blocky noise (natural-image-ish spectrum)
            f = np.repeat(np.repeat(rng.integers(0, 256, (64, 64, 3), dtype=np.uint8), 8, 0), 8, 1)
        elif kind == 1:  # pixel noise
            f = rng.integers(0, 256, (512, 512, 3), dtype=np.uint8)
        elif kind == 2:  # smooth gradient + blob
            x = np.linspace(0, 255, 512, dtype=np.float32)
            g = (x[None, :] + x[:, None]) / 2
            cx, cy = rng.integers(100, 400, 2)
            yy, xx = np.mgrid[0:512, 0:512]
            blob = 120 * np.exp(-((xx - cx) ** 2 + (yy - cy) ** 2) / (2 * 60.0**2))
            f = np.clip(g + blob, 0, 255).astype(np.uint8)[..., None].repeat(3, 2)
        else:  # bands
            period = int(rng.integers(8, 64))
            row = ((np.arange(512) // period) % 2 * 200 + 20).astype(np.uint8)
            f = np.broadcast_to(row[None, :, None], (512, 512, 3)).copy()
            f[::3] = f[::3] // 2
        frames.append(np.ascontiguousarray(f))
    return frames


def _corpus_frames(max_per_video: int = 2) -> list[np.ndarray]:
    frames = []
    for d in ("scene_a", "scene_b"):
        for vid in sorted((CORPUS / d).glob("*")):
            for i, f in enumerate(extract_frames(vid)):
                if i >= max_per_video:
                    break
                frames.append(f)
    return frames


def test_upstream_fidelity_measured():
    frames = _corpus_frames() + _synth_frames(N_SYNTH)
    assert len(frames) >= 48
    max_bits = 0
    total_bits = 0
    max_q = 0
    worst = None
    for idx, f in enumerate(frames):
        h_ref, q_ref = ref.pdq_hash_frame(f)
        h_up, q_up = up.pdq_hash_frame_upstream(f)
        bits = _hamming(h_ref, h_up)
        total_bits += bits
        if bits > max_bits:
            max_bits, worst = bits, idx
        max_q = max(max_q, abs(q_ref - q_up))
    mean_bits = total_bits / len(frames)
    print(
        f"\nupstream-order divergence over {len(frames)} frames: "
        f"max {max_bits} bits (frame {worst}), mean {mean_bits:.3f} bits, "
        f"max quality delta {max_q}"
    )
    # contract: far below the reference's own >= 99-similarity tolerance
    assert max_bits <= 4, f"reassociation drift too large: {max_bits} bits"
    assert max_q <= 1


def test_torben_equals_128th_smallest():
    rng = np.random.default_rng(5)
    # real DCT outputs plus adversarial cases (ties, negatives)
    cases = []
    for f in _synth_frames(8):
        lum = up.luma_f32(f)
        cases.append(up.dct16(up.decimate(up.jarosz_filter(lum))))
    cases.append(np.zeros((16, 16), np.float32))
    tied = rng.integers(-3, 4, (16, 16)).astype(np.float32)
    cases.append(tied)
    for d in cases:
        med = up.torben(d)
        expected = np.sort(d.reshape(-1), kind="stable")[d.size // 2 - 1]
        assert med == float(expected), (med, float(expected))


def test_window_matches_upstream_formula():
    # upstream computeJaroszFilterWindowSize(512, 64) == 4; the framework's
    # WINDOW constant must agree (round-1 regression: it was ceil(512/64)=8)
    assert up.compute_jarosz_filter_window_size(512, 64) == 4
    assert pm.WINDOW == 4
    assert (pm.OFF_L, pm.OFF_R) == (1, 2)
    # upstream's own comment: 1024x1024 -> window 8 (= 16/2)
    assert up.compute_jarosz_filter_window_size(1024, 64) == 8
