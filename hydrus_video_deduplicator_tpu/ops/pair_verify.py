"""Batched exact verification of candidate video pairs.

Stage 2 of the pruned search route (parallel/engine.py): stage 1 sweeps
scene representatives (ops/reps.py) and emits candidate video pairs; this
module computes the EXACT reference similarity — min of the two
directional match fractions at tolerance 31, identical to native
``matchHashBytes`` (reference contract: /root/reference/src/
hydrusvideodeduplicator/vpdqpy/vpdqpy.py:49-56) — for each candidate
pair, without touching the non-candidate (row x col) space the dense
tiles would.

Device shape: pairs bucket by padded frame count (powers of two,
32..512) and each bucket runs as ONE batched int8 contraction
[P, F, 256] x [P, F, 256] -> [P, F, F] — the batch dimension rides the
pairs, so utilization is F_a*F_b/F_pad^2 per pair (>= 25% within a
bucket) instead of the ~1/slots a dense slot-tile readout would give.
Frames travel to the device BIT-PACKED ([P, F, 8] u32, 8x less H2D) and
expand to ±1 rows on device; padding rows are exact zeros and can never
match. A fixed number of pairs per dispatch (P of the bucket) keeps one
compiled executable per bucket.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..vpdq import pdq_math as pm
from . import similarity as ops_sim
from .similarity import BITS, MATCH_DOT

BYTES = pm.BYTES_PER_HASH
LANES = BITS // 32
TOL = pm.DEFAULT_DISTANCE_TOLERANCE

#: frame-count buckets (videos pad up to the next bucket; callers route
#: videos longer than the last bucket to the host path)
PADS = (32, 64, 128, 256, 512)
MAX_PAD = PADS[-1]

#: per-dispatch [P, F, F] int32 budget (8 MB) -> pairs per chunk
def pairs_per_chunk(pad: int) -> int:
    return max(8, (1 << 21) // (pad * pad))


@functools.partial(jax.jit, static_argnames=("pad",))
def _verify_chunk(a_packed, a_cnt, b_packed, b_cnt, pad: int):
    """Exact per-pair similarity for one bucket chunk.

    a_packed/b_packed: [P, pad, 8] uint32 bit-packed frames (zero rows
    past each video's count); a_cnt/b_cnt: [P] int32 true frame counts
    (0 = empty/padding pair). Returns [P] int32 similarity — identical to
    int(matchHashBytes(a, b, 31)) by the same min-of-fractions math as
    the dense tiles (engine._tile_similarity).
    """
    p = a_packed.shape[0]
    a = ops_sim.unpack_pm1(a_packed.reshape(p * pad, LANES)).reshape(p, pad, BITS)
    b = ops_sim.unpack_pm1(b_packed.reshape(p * pad, LANES)).reshape(p, pad, BITS)
    va = jnp.arange(pad)[None, :] < a_cnt[:, None]  # [P, pad]
    vb = jnp.arange(pad)[None, :] < b_cnt[:, None]
    a = jnp.where(va[:, :, None], a, jnp.int8(0))
    b = jnp.where(vb[:, :, None], b, jnp.int8(0))
    dot = jax.lax.dot_general(
        a, b, (((2,), (2,)), ((0,), (0,))), preferred_element_type=jnp.int32
    )  # [P, pad, pad]
    matched = dot >= MATCH_DOT  # zero rows dot at 0 < MATCH_DOT: never match
    ma = matched.any(axis=2).sum(axis=1, dtype=jnp.int32)  # [P]
    mb = matched.any(axis=1).sum(axis=1, dtype=jnp.int32)
    fa = jnp.maximum(a_cnt, 1)
    fb = jnp.maximum(b_cnt, 1)
    sim = jnp.minimum((100 * ma) // fa, (100 * mb) // fb)
    return jnp.where((a_cnt > 0) & (b_cnt > 0), sim, 0)


def _bucket_of(n_frames: int) -> int:
    for p in PADS:
        if n_frames <= p:
            return p
    raise ValueError(f"video of {n_frames} frames exceeds pair-verify MAX_PAD")


def verify_pairs(
    pairs: "list[tuple[int, int]]",
    row_blob,
    col_blob,
    min_sim: int,
    progress=None,
) -> "list[tuple[int, int, int]]":
    """Exact similarities for candidate (row_index, col_index) pairs.

    row_blob/col_blob: mappings index -> packed hash blob. Returns the
    (i, j, sim) triples with sim >= min_sim, in no particular order.
    Pairs whose either side is empty or longer than MAX_PAD frames must
    not be passed here (the engine routes those to the host path).
    """
    import os as _os
    import sys as _sys
    import time as _time

    _debug = _os.environ.get("HVD_DEBUG_TIMING")
    _acc = {"bucket": 0.0, "pack": 0.0, "dispatch": 0.0, "drain": 0.0, "n": 0}
    _t = _time.time()
    out: list[tuple[int, int, int]] = []
    buckets: dict[int, list[tuple[int, int, int, int]]] = {}
    for i, j in pairs:
        a = row_blob[i]
        b = col_blob[j]
        if a == b:
            # identical blobs (self-pairs at corpus scale, exact dup files)
            # are always similarity 100 — skip the device round trip.
            # CPython short-circuits identical bytes objects, so the 1M
            # self-candidates of a corpus sweep cost O(1) each.
            out.append((i, j, 100))
            continue
        na = len(a) // BYTES
        nb = len(b) // BYTES
        assert na > 0 and nb > 0, (i, j)
        buckets.setdefault(_bucket_of(max(na, nb)), []).append((i, j, na, nb))
    _acc["bucket"] = _time.time() - _t
    done = 0
    total = len(pairs)
    # drain in GROUPS: chunks within a bucket share shape [P], so a group
    # stacks to one [G, P] device array and comes back in one transfer;
    # the stacked result is tiny (<= 128 KB) and the group bound keeps the
    # undrained input queue to ~GROUP * 2 MB of device memory.
    group_n = int(_os.environ.get("HVD_VERIFY_DRAIN_GROUP", "64"))
    for pad, items in sorted(buckets.items()):
        p_chunk = pairs_per_chunk(pad)
        inflight: list[tuple[list, object]] = []

        def drain_group(entries):
            nonlocal done
            if not entries:
                return
            _td = _time.time()
            sims_all = np.asarray(jnp.stack([s for _, s in entries]))
            _acc["drain"] += _time.time() - _td
            for (meta, _), sims in zip(entries, sims_all):
                done += len(meta)
                for (i, j), s in zip(meta, sims[: len(meta)]):
                    if s >= min_sim:
                        out.append((i, j, int(s)))
            if progress is not None:
                progress(done, total)

        for k0 in range(0, len(items), p_chunk):
            chunk = items[k0 : k0 + p_chunk]
            _t = _time.time()
            a_packed = np.zeros((p_chunk, pad, LANES), dtype=np.uint32)
            b_packed = np.zeros((p_chunk, pad, LANES), dtype=np.uint32)
            a_cnt = np.zeros(p_chunk, dtype=np.int32)
            b_cnt = np.zeros(p_chunk, dtype=np.int32)
            for k, (i, j, na, nb) in enumerate(chunk):
                a_packed[k, :na] = ops_sim.blobs_to_packed(row_blob[i])
                b_packed[k, :nb] = ops_sim.blobs_to_packed(col_blob[j])
                a_cnt[k] = na
                b_cnt[k] = nb
            _acc["pack"] += _time.time() - _t
            _t = _time.time()
            sims_dev = _verify_chunk(
                jnp.asarray(a_packed), jnp.asarray(a_cnt),
                jnp.asarray(b_packed), jnp.asarray(b_cnt), pad,
            )
            _acc["dispatch"] += _time.time() - _t
            _acc["n"] += 1
            inflight.append(([(i, j) for i, j, _, _ in chunk], sims_dev))
            if len(inflight) >= group_n:
                drain_group(inflight)
                inflight = []
        drain_group(inflight)
    if _debug:
        print(
            "[verify-timing] bucket {bucket:.1f}s pack {pack:.1f}s dispatch "
            "{dispatch:.1f}s drain {drain:.1f}s over {n} device chunks".format(
                **_acc
            ),
            file=_sys.stderr,
            flush=True,
        )
    return out
