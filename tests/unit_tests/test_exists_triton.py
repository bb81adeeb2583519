"""The stage-A existence kernel written for the GPU (Pallas through Triton).

On the CPU the kernel runs in Pallas interpret mode and must equal its
plain-XLA reference word for word; the engine routes that launch it must
give the XLA route's pair sets. The compiled kernel is checked on the card
by the ``gpu`` test below and by ``chip_smoke.py``.
"""

from __future__ import annotations

import functools

import numpy as np
import pytest

from hydrus_video_deduplicator_tpu.ops import reps
from hydrus_video_deduplicator_tpu.ops import similarity_segments as seg


def _operands(rng, n_steps: int, tol: int, case: str):
    """Row block pair + n_steps column steps of ±1 rows with hits planted
    at exactly the tolerance, one-hot slot ids as the packer makes them."""
    rb = seg.TILE_ROW_BLOCKS
    ra = rb * seg.ROW_FRAMES
    cb = n_steps * seg.STEP_FRAMES
    a = rng.choice(np.array([-1, 1], np.int8), (ra, seg.BITS))
    b = rng.choice(np.array([-1, 1], np.int8), (cb, seg.BITS))
    sa = np.tile((np.arange(seg.ROW_FRAMES) // 8).astype(np.int32), rb)
    sb = np.tile(((np.arange(seg.CHUNK_FRAMES) // 8) % seg.CHUNK_SLOTS).astype(np.int32), cb // seg.CHUNK_FRAMES)
    for k in range(0, min(ra, cb), 53):
        j = (k * 7) % cb
        b[j] = a[k]
        flip = rng.choice(seg.BITS, tol + (k % 3 == 0), replace=False)  # tol: hit, tol+1: miss
        b[j, flip] *= -1
    if case == "padding":
        sa[rng.random(ra) < 0.2] = -1
        sb[rng.random(cb) < 0.2] = -1
    if case == "partial-word":
        # the last row block holds 40 slots: its second mask word is partial
        sa[seg.ROW_FRAMES + 40 * 8 :] = -1
    a[sa < 0] = 0
    b[sb < 0] = 0
    valid = np.ones(n_steps, np.int32)
    if case == "invalid-step":
        valid[1] = 0
    return a, sa, b, sb, valid


@pytest.mark.parametrize(
    "tol,case",
    [
        (31, "dense"),
        (reps.prune_tolerance(), "dense"),
        (reps.prune_tolerance(), "padding"),
        (reps.prune_tolerance(), "invalid-step"),
        (31, "partial-word"),
    ],
)
def test_triton_kernel_matches_xla_reference(rng, tol, case):
    n_steps = 3
    a, sa, b, sb, valid = _operands(rng, n_steps, tol, case)
    got = np.asarray(
        seg.make_exists_mask_sweep_triton(tol, interpret=True)(a, sa, b, sb, valid)
    )
    ref = np.array(seg.make_exists_mask_kernel_xla(tol)(a, sa, None, b, sb, None))
    ref = ref.reshape(ref.shape[0], n_steps, seg.STEP_SLOTS)
    ref[:, valid == 0] = 0
    ref = ref.reshape(got.shape)
    assert got.dtype == np.uint32
    assert got.shape == (seg.TILE_ROW_BLOCKS * seg.MASK_WORDS, n_steps * seg.STEP_SLOTS)
    assert np.array_equal(got, ref)
    assert ref.any()  # the planted at-tolerance pairs hit
    if case == "partial-word":
        # slots 40..255 of the second block hold no frames: no bit set
        words = got[seg.MASK_WORDS : 2 * seg.MASK_WORDS]
        assert not (words[1] >> np.uint32(8)).any() and not words[2:].any()


def test_per_tile_adapter_is_the_sweep_with_every_step_valid(rng):
    tol = reps.prune_tolerance()
    a, sa, b, sb, _ = _operands(rng, 2, tol, "dense")
    kernel = seg.make_exists_mask_kernel_triton(tol, interpret=True)
    got = np.asarray(kernel(a, sa, None, b, sb, None))
    ref = np.asarray(seg.make_exists_mask_kernel_xla(tol)(a, sa, None, b, sb, None))
    assert np.array_equal(got, ref)
    assert seg.exists_mask_kernel(tol, "xla") is seg.make_exists_mask_kernel_xla(tol)
    with pytest.raises(ValueError):
        seg.exists_mask_kernel(tol, "mosaic")


@pytest.fixture
def interpreted_triton(monkeypatch):
    """Route the engine's Triton launches through Pallas interpret mode."""
    orig = seg.make_exists_mask_sweep_triton

    @functools.lru_cache(maxsize=8)
    def interp(tol, *args, **kw):
        return orig(tol, *args, **{**kw, "interpret": True})

    monkeypatch.setattr(seg, "make_exists_mask_sweep_triton", interp)
    from hydrus_video_deduplicator_tpu.parallel import engine

    engine._onecall_sweep_fn.cache_clear()
    engine._sharded_onecall_sweep_fn.cache_clear()
    yield
    engine._onecall_sweep_fn.cache_clear()
    engine._sharded_onecall_sweep_fn.cache_clear()


def _library(n=300):
    from ..scene_library import scene_library

    return scene_library(n, seed=5).blobs


@pytest.mark.parametrize("mode", ["one-launch", "mesh", "packed-columns"])
def test_engine_triton_route_matches_xla_route(interpreted_triton, monkeypatch, mode):
    import dataclasses

    import jax

    from hydrus_video_deduplicator_tpu import device
    from hydrus_video_deduplicator_tpu.parallel.engine import TpuSearchEngine
    from hydrus_video_deduplicator_tpu.parallel.mesh import build_mesh

    blobs = _library()
    ref = sorted(TpuSearchEngine(force_segments=True).find_pairs_pruned(blobs, blobs, 50))
    mesh = None
    if mode == "mesh":
        if len(jax.devices()) < 2:
            pytest.skip("needs a multi-device mesh (virtual CPU devices)")
        mesh = build_mesh(4)
    if mode == "packed-columns":
        monkeypatch.setattr(
            device, "CPU_PLAN", dataclasses.replace(device.CPU_PLAN, col_pm1_bytes=0)
        )
    eng = TpuSearchEngine(force_segments=True, exists_kernel="triton", mesh=mesh)
    got = sorted(eng.find_pairs_pruned(blobs, blobs, 50))
    assert got == ref
    assert len(ref) > len(blobs) // 2  # self-matches + planted pairs


def test_exists_triton_compiled_on_gpu(on_gpu, rng):
    """The compiled kernel (no interpret mode) equals the XLA reference at
    production block shapes."""
    tol = reps.prune_tolerance()
    a, sa, b, sb, valid = _operands(rng, 16, tol, "invalid-step")
    got = np.asarray(seg.make_exists_mask_sweep_triton(tol)(a, sa, b, sb, valid))
    ref = np.array(seg.make_exists_mask_kernel_xla(tol)(a, sa, None, b, sb, None))
    ref = ref.reshape(ref.shape[0], 16, seg.STEP_SLOTS)
    ref[:, valid == 0] = 0
    assert np.array_equal(got, ref.reshape(got.shape))
