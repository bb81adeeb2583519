"""Fixed-shape ("segment") similarity kernels.

A bucketed kernel would specialize on each (pa, pb) frame-count bucket pair
— a mixed-length corpus compiles up to ~121 programs and pads every video
to a power of two. These kernels fix every shape once and move the
raggedness into DATA:

  * videos pack greedily into fixed FRAME blocks (no power-of-two padding:
    a 9-frame video occupies 9 frame rows);
  * the frame->video-slot membership one-hots are built on the device from
    compact slot ids shipped by the packer;
  * the math: int8 ±1 dot (dot >= 256 - 2*tol <=> Hamming <= tol), one
    compare for the match matrix, one-hot matrix products for the per-video
    reductions, min of the directional match fractions.

One shape => ONE compile ever, and ~0 padding waste on realistic corpora.
Constraint: a video must fit inside one column chunk (SEG_MAX_FRAMES
frames); longer videos take the bucketed or host paths.

Layout (all fixed):
  rows: blocks of [ROW_FRAMES, 256] frames / ROW_SLOTS slots
  cols: steps of N_SPLIT chunks x [CHUNK_FRAMES, 256] frames / CHUNK_SLOTS
        chunk-local slots
  out:  [row slots, col slots] (score kernel) or row-packed bitmask words
        [row slots / 32, col slots] (existence kernels)
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

from . import similarity as ops_sim
from .similarity import BITS, MATCH_DOT, unpack_pm1_host

#: uint32 lanes per packed 256-bit frame hash
LANES = BITS // 32

#: row block: frames x video slots
ROW_FRAMES = 2048
ROW_SLOTS = 256
#: column chunk: frames x local video slots; N_SPLIT chunks per step
CHUNK_FRAMES = 512
CHUNK_SLOTS = 64
N_SPLIT = 4
STEP_FRAMES = N_SPLIT * CHUNK_FRAMES  # 2048
STEP_SLOTS = N_SPLIT * CHUNK_SLOTS  # 256

#: videos longer than one column chunk cannot take this route
SEG_MAX_FRAMES = CHUNK_FRAMES

#: column steps per engine column tile and default row blocks per dispatch
TILE_ROW_BLOCKS = 2  # 4096 frames / 512 slots
TILE_COL_STEPS = 8  # 16384 frames / 2048 slots

#: mask words per row block: bit b of word w covers row slot w*32+b
MASK_WORDS = ROW_SLOTS // 32


def _onehot_from_slots(slot_ids: jnp.ndarray, n_slots: int) -> jnp.ndarray:
    """Block-local membership one-hot built ON DEVICE from compact slot ids
    (-1 = padding, matches no slot). Shipping dense one-hots from the host
    costs ~128x more transfer than the id vector."""
    return (slot_ids[:, None] == jnp.arange(n_slots, dtype=jnp.int32)[None, :]).astype(
        jnp.int8
    )


@jax.jit
def similarity_segments_xla(a_pm1, slot_a, fa, b_pm1, slot_b, fb):
    """Slot-level similarity for packed segment tiles (plain XLA).

    a_pm1 [RA_F, 256] i8, slot_a [RA_F] i32 block-local slot ids (-1 pad),
    fa [RA_S, 1] i32 with RA_F a multiple of ROW_FRAMES
    (RA_S = RA_F//ROW_FRAMES*ROW_SLOTS); b_pm1 [CB_F, 256], slot_b [CB_F]
    chunk-local ids, fb [CB_S, 1] with CB_F a multiple of STEP_FRAMES.
    Returns [RA_S, CB_S] int32 similarities.
    """
    oa = _onehot_from_slots(slot_a, ROW_SLOTS)
    ob = _onehot_from_slots(slot_b, CHUNK_SLOTS)
    ra_f = a_pm1.shape[0]
    cb_f = b_pm1.shape[0]
    n_row_blocks = ra_f // ROW_FRAMES
    n_chunks = cb_f // CHUNK_FRAMES
    fa_div = jnp.maximum(fa, 1)  # [RA_S, 1]
    row_outs = []
    for i in range(n_row_blocks):
        a = a_pm1[i * ROW_FRAMES : (i + 1) * ROW_FRAMES]
        oha = oa[i * ROW_FRAMES : (i + 1) * ROW_FRAMES]
        chunk_outs = []
        for c in range(n_chunks):
            b = b_pm1[c * CHUNK_FRAMES : (c + 1) * CHUNK_FRAMES]
            ohb = ob[c * CHUNK_FRAMES : (c + 1) * CHUNK_FRAMES]
            dot = jax.lax.dot_general(
                a, b, (((1,), (1,)), ((), ())), preferred_element_type=jnp.int32
            )
            m = (dot >= MATCH_DOT).astype(jnp.int32)
            cnt_b = m @ ohb.astype(jnp.int32)
            hits_b = (cnt_b > 0).astype(jnp.int32)
            ma = oha.astype(jnp.int32).T @ hits_b
            cnt_a = oha.astype(jnp.int32).T @ m
            hits_a = (cnt_a > 0).astype(jnp.int32)
            mb = hits_a @ ohb.astype(jnp.int32)
            chunk_outs.append((ma, mb, c))
        row_fa = fa_div[i * ROW_SLOTS : (i + 1) * ROW_SLOTS]
        sims = []
        for ma, mb, c in chunk_outs:
            fb_div = jnp.maximum(fb[c * CHUNK_SLOTS : (c + 1) * CHUNK_SLOTS], 1).T
            sims.append(jnp.minimum((100 * ma) // row_fa, (100 * mb) // fb_div))
        row_outs.append(jnp.concatenate(sims, axis=1))
    return jnp.concatenate(row_outs, axis=0)


# ---------------------------------------------------------------------------
# Existence ("prune") kernels — the candidate filter of the pruned route
# ---------------------------------------------------------------------------
#
# Same packing/layout as the score kernel, but (a) the Hamming tolerance
# is a parameter (the pruned route sweeps scene representatives at the
# inflated tolerance TOL + 2*RADIUS_CAP — ops/reps.py), and (b) the output
# says only whether SOME row-slot frame matches SOME col-slot frame
# (<=> the video pair survives the exact prune bound), as row-packed bit
# words: bit b of word [w, c] = row slot w*32+b, column slot c.


@functools.lru_cache(maxsize=8)
def make_exists_kernel_xla(tolerance: int):
    """Per-slot-pair count of row frames matching the col slot (plain
    XLA; >= 1 <=> the pair exists). Signature-compatible with the score
    kernel (fa/fb accepted and ignored) so the engine's sweep drives
    either."""
    match_dot = BITS - 2 * tolerance

    @jax.jit
    def exists(a_pm1, slot_a, fa, b_pm1, slot_b, fb):
        del fa, fb
        oa = _onehot_from_slots(slot_a, ROW_SLOTS)
        ob = _onehot_from_slots(slot_b, CHUNK_SLOTS)
        ra_f = a_pm1.shape[0]
        cb_f = b_pm1.shape[0]
        n_row_blocks = ra_f // ROW_FRAMES
        n_chunks = cb_f // CHUNK_FRAMES
        row_outs = []
        for i in range(n_row_blocks):
            a = a_pm1[i * ROW_FRAMES : (i + 1) * ROW_FRAMES]
            oha = oa[i * ROW_FRAMES : (i + 1) * ROW_FRAMES]
            outs = []
            for c in range(n_chunks):
                b = b_pm1[c * CHUNK_FRAMES : (c + 1) * CHUNK_FRAMES]
                ohb = ob[c * CHUNK_FRAMES : (c + 1) * CHUNK_FRAMES]
                dot = jax.lax.dot_general(
                    a, b, (((1,), (1,)), ((), ())), preferred_element_type=jnp.int32
                )
                m = (dot >= match_dot).astype(jnp.int32)
                hits_b = (m @ ohb.astype(jnp.int32) > 0).astype(jnp.int32)
                outs.append(oha.astype(jnp.int32).T @ hits_b)
            row_outs.append(jnp.concatenate(outs, axis=1))
        return jnp.concatenate(row_outs, axis=0)

    return exists


@functools.lru_cache(maxsize=8)
def make_exists_mask_kernel_xla(tolerance: int):
    """Plain-XLA existence kernel emitting row-packed hit bitmasks
    [n_row_blocks * MASK_WORDS, CB_S] uint32 — the reference for the
    Triton kernel below."""
    exists = make_exists_kernel_xla(tolerance)

    @jax.jit
    def exists_mask(a_pm1, slot_a, fa, b_pm1, slot_b, fb):
        ma = exists(a_pm1, slot_a, fa, b_pm1, slot_b, fb)  # [RA_S, CB_S]
        hit = (ma >= 1).astype(jnp.uint32)
        pow2 = jnp.uint32(1) << jnp.arange(32, dtype=jnp.uint32)
        # rows pack in groups of 32: [RA_S/32, 32, CB_S] -> weighted sum
        return (hit.reshape(-1, 32, hit.shape[1]) * pow2[None, :, None]).sum(
            1, dtype=jnp.uint32
        )

    return exists_mask


#: Triton existence kernel tiling: each program owns one (column chunk,
#: row block) pair; it walks the chunk's 512 frames in sub-tiles of
#: EXISTS_COL_TILE and, for each, the block's 2048 row frames in sub-tiles
#: of EXISTS_ROW_TILE, so the [rows, cols] int32 products stay in
#: registers and the column sub-tile stays resident while the row
#: sub-tiles stream past it. Chosen on the H100 among six tilings
#: (PERF.md); the row loop inside the column loop keeps shared
#: memory under the 227 KB a program may use.
EXISTS_ROW_TILE = 64
EXISTS_COL_TILE = 128
EXISTS_NUM_WARPS = 4
EXISTS_NUM_STAGES = 2


def _exists_mask_triton_body(match_dot, valid_ref, a_ref, sa_ref, b_ref, sb_ref, out_ref):
    """One (column chunk, row block) program of the existence sweep.

    For a column sub-tile and a row sub-tile: hits[f, cs] = some frame of
    chunk slot cs among the sub-tile's columns lies within tolerance of
    row frame f (an int8 match matrix times the membership one-hot); the
    block's [ROW_SLOTS, CHUNK_SLOTS] counts accumulate the transposed row
    one-hot times those hits. Counts only need to reach 1, so summing over
    column sub-tiles is the OR the mask wants. Nothing of the [2048, 512]
    product leaves the program; it writes 8 words per column slot. A
    column step whose valid flag is 0 runs no iterations and writes
    zeros."""
    row_tile, col_tile = EXISTS_ROW_TILE, EXISTS_COL_TILE
    c = pl.program_id(0)
    n_iter = valid_ref[c // N_SPLIT] * (ROW_FRAMES // row_tile)
    col_iota = jax.lax.broadcasted_iota(jnp.int32, (col_tile, CHUNK_SLOTS), 1)
    row_iota = jax.lax.broadcasted_iota(jnp.int32, (ROW_SLOTS, row_tile), 0)
    acc = jnp.zeros((ROW_SLOTS, CHUNK_SLOTS), jnp.int32)
    for q in range(CHUNK_FRAMES // col_tile):
        b = b_ref[pl.ds(q * col_tile, col_tile), :]
        ohb = (sb_ref[pl.ds(q * col_tile, col_tile)][:, None] == col_iota).astype(jnp.int8)

        def body(r, acc, b=b, ohb=ohb):
            a = a_ref[pl.ds(r * row_tile, row_tile), :]
            oha_t = (row_iota == sa_ref[pl.ds(r * row_tile, row_tile)][None, :]).astype(
                jnp.int8
            )
            m = (pl.dot(a, b, trans_b=True) >= match_dot).astype(jnp.int8)
            hits = (pl.dot(m, ohb) > 0).astype(jnp.int8)
            return acc + pl.dot(oha_t, hits)

        acc = jax.lax.fori_loop(0, n_iter, body, acc)
    # pack in int32: the words' bits are disjoint, so the wrapping int32
    # sum IS the bitwise OR; the wrapper bitcasts to uint32
    bit = jax.lax.broadcasted_iota(jnp.int32, (ROW_SLOTS, CHUNK_SLOTS), 0) % 32
    hit = (acc > 0).astype(jnp.int32)
    out_ref[...] = jnp.sum((hit << bit).reshape(MASK_WORDS, 32, CHUNK_SLOTS), axis=1)


@functools.lru_cache(maxsize=16)
def make_exists_mask_sweep_triton(tolerance: int, interpret: bool = False):
    """Existence sweep of a row tile against a whole column corpus as ONE
    Pallas launch through Triton (GPU; ``interpret=True`` runs it on the
    CPU for tests).

    sweep(a_pm1 [RA_F, 256] i8, slot_a [RA_F] i32, b_pm1 [CB_F, 256] i8,
    slot_b [CB_F] i32, valid [CB_F // STEP_FRAMES] i32) -> row-packed masks
    [RA_F // ROW_FRAMES * MASK_WORDS, CB_F // STEP_FRAMES * STEP_SLOTS] u32,
    equal to make_exists_mask_kernel_xla on every valid step and zero on
    the others."""
    match_dot = BITS - 2 * tolerance
    kernel = functools.partial(_exists_mask_triton_body, match_dot)

    @jax.jit
    def sweep(a_pm1, slot_a, b_pm1, slot_b, valid):
        ra_f = a_pm1.shape[0]
        cb_f = b_pm1.shape[0]
        assert ra_f % ROW_FRAMES == 0 and cb_f % STEP_FRAMES == 0, (ra_f, cb_f)
        n_blocks = ra_f // ROW_FRAMES
        n_chunks = cb_f // CHUNK_FRAMES
        # Triton blocks are powers of two: pad the flags (the padding is
        # never read — chunk c reads flag c // N_SPLIT)
        n_flags = pl.next_power_of_2(valid.shape[0])
        valid = jnp.pad(valid.astype(jnp.int32), (0, n_flags - valid.shape[0]))
        words = pl.pallas_call(
            kernel,
            grid=(n_chunks, n_blocks),
            in_specs=[
                pl.BlockSpec((n_flags,), lambda c, i: (0,)),
                pl.BlockSpec((ROW_FRAMES, BITS), lambda c, i: (i, 0)),
                pl.BlockSpec((ROW_FRAMES,), lambda c, i: (i,)),
                pl.BlockSpec((CHUNK_FRAMES, BITS), lambda c, i: (c, 0)),
                pl.BlockSpec((CHUNK_FRAMES,), lambda c, i: (c,)),
            ],
            out_specs=pl.BlockSpec((MASK_WORDS, CHUNK_SLOTS), lambda c, i: (i, c)),
            out_shape=jax.ShapeDtypeStruct(
                (n_blocks * MASK_WORDS, n_chunks * CHUNK_SLOTS), jnp.int32
            ),
            compiler_params=pl_triton.CompilerParams(
                num_warps=EXISTS_NUM_WARPS, num_stages=EXISTS_NUM_STAGES
            ),
            interpret=interpret,
            name="seg_exists_mask",
        )(valid, a_pm1, slot_a, b_pm1, slot_b)
        return jax.lax.bitcast_convert_type(words, jnp.uint32)

    return sweep


@functools.lru_cache(maxsize=8)
def make_exists_mask_kernel_triton(tolerance: int, interpret: bool = False):
    """The Triton sweep behind the per-tile kernel signature (every step
    valid), for the engine's scan route over bit-packed columns."""
    sweep = make_exists_mask_sweep_triton(tolerance, interpret=interpret)

    def exists_mask(a_pm1, slot_a, fa, b_pm1, slot_b, fb):
        del fa, fb
        n_steps = b_pm1.shape[0] // STEP_FRAMES
        return sweep(a_pm1, slot_a, b_pm1, slot_b, jnp.ones((n_steps,), jnp.int32))

    return exists_mask


def exists_mask_kernel(tolerance: int, kind: str):
    """Per-tile existence kernel by name ("xla" | "triton")."""
    if kind == "triton":
        return make_exists_mask_kernel_triton(tolerance)
    if kind == "xla":
        return make_exists_mask_kernel_xla(tolerance)
    raise ValueError(f"unknown existence kernel {kind!r}")


# ---------------------------------------------------------------------------
# Host-side greedy packer
# ---------------------------------------------------------------------------


@dataclass
class PackedBlock:
    """One fixed-shape block of packed videos.

    Frames stay BIT-PACKED (8 uint32 lanes = 32 bytes/frame) until they
    reach the device: shipping ±1 int8 rows costs 8x the transfer, and
    H2D — not unpacking — is the practical bottleneck of corpus-scale
    sweeps. unpack_blocks_pm1 expands to the kernel's ±1 layout on device
    (padding rows zeroed via the slot ids).
    """

    packed: np.ndarray  # [frames, 8] uint32 (zero rows past content)
    slot_ids: np.ndarray  # [frames] int32 block-local slot id, -1 padding
    counts: np.ndarray  # [slots, 1] int32 (0 for empty slots)
    slot_map: np.ndarray  # [slots] int64 corpus index, -1 for empty slots


def blob_to_pm1(blob: bytes) -> np.ndarray:
    """Packed 32N-byte hash blob -> [N, 256] ±1 int8 rows (kernel layout)."""
    n = len(blob) // 32
    packed = ops_sim.blobs_to_packed(blob).reshape(1, n, 8)
    return unpack_pm1_host(packed, np.asarray([n]))


def plan_chunks(
    counts: np.ndarray, frames_per_block: int, slots_per_block: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """Next-fit packing plan from frame counts alone (no blob bytes).

    Returns (chunk_id [n] int64, slot_id [n] int32, frame_off [n] int64,
    n_chunks) with boundaries identical to pack_blocks: a chunk closes
    when the next video exceeds its remaining frames or slots. Separating
    the plan (metadata) from the fill (bytes) lets corpus-scale callers
    stream blobs through a bounded staging buffer instead of holding the
    packed corpus on the host. The loop is plain Python (~0.7 s per
    million videos) — run once per sweep via col_state.
    """
    n = len(counts)
    chunk_id = np.empty(n, dtype=np.int64)
    slot_id = np.empty(n, dtype=np.int32)
    frame_off = np.empty(n, dtype=np.int64)
    c = 0
    used_f = 0
    used_s = 0
    for k in range(n):
        nf = int(counts[k])
        assert 1 <= nf <= frames_per_block, (k, nf)
        if used_s and (used_f + nf > frames_per_block or used_s >= slots_per_block):
            c += 1
            used_f = 0
            used_s = 0
        chunk_id[k] = c
        slot_id[k] = used_s
        frame_off[k] = used_f
        used_f += nf
        used_s += 1
    return chunk_id, slot_id, frame_off, (c + 1 if n else 0)


def pack_blocks(
    items: "list[tuple[int, bytes]]", frames_per_block: int, slots_per_block: int
) -> list[PackedBlock]:
    """Greedy next-fit packing of (corpus_index, blob) into fixed blocks.

    Every video must have 1..frames_per_block frames (callers route longer
    videos elsewhere). Items are packed in order; a block closes when the
    next video exceeds its remaining frames or slots (a closed block is
    never revisited — callers that want dense blocks should present items
    roughly sorted by length, as the engine does). Frames stay bit-packed
    (see PackedBlock) — the whole host side of a 1M-video corpus is
    ~260 MB instead of ~2.1 GB of ±1 rows.
    """
    # pass 1: slot/block assignment (pure integer bookkeeping)
    plans: list[list[tuple[int, int]]] = []  # per block: [(corpus idx, n), ...]
    cur: list[tuple[int, int]] = []
    cur_frames = 0
    for idx, blob in items:
        n = len(blob) // 32
        assert 1 <= n <= frames_per_block, (idx, n)
        if cur and (cur_frames + n > frames_per_block or len(cur) >= slots_per_block):
            plans.append(cur)
            cur, cur_frames = [], 0
        cur.append((idx, n))
        cur_frames += n
    if cur:
        plans.append(cur)

    # pass 2: per-block assembly (frames are independent 32-byte units, so
    # a block's blobs concatenate directly into the packed array)
    blob_of = dict(items)
    blocks: list[PackedBlock] = []
    for plan in plans:
        packed = np.zeros((frames_per_block, LANES), dtype=np.uint32)
        slot_ids = np.full((frames_per_block,), -1, dtype=np.int32)
        counts = np.zeros((slots_per_block, 1), dtype=np.int32)
        slot_map = np.full((slots_per_block,), -1, dtype=np.int64)
        n_block = sum(n for _, n in plan)
        packed[:n_block] = ops_sim.blobs_to_packed(
            b"".join(blob_of[idx] for idx, _ in plan)
        )
        f = 0
        for s, (idx, n) in enumerate(plan):
            slot_ids[f : f + n] = s
            counts[s, 0] = n
            slot_map[s] = idx
            f += n
        blocks.append(PackedBlock(packed, slot_ids, counts, slot_map))
    return blocks


def stack_blocks(blocks: list[PackedBlock], n_blocks: int, frames: int, slots: int):
    """Stack (and pad with empty blocks) into tile arrays.

    Returns (packed [n_blocks*frames, 8] u32, slot_ids [n_blocks*frames],
    counts [n_blocks*slots, 1], slot_map [n_blocks*slots]). slot_ids stay
    block-local: the kernel's one-hot blocks are per-block anyway. Frames
    are bit-packed — expand on device with unpack_blocks_pm1.
    """
    assert len(blocks) <= n_blocks
    packed = np.zeros((n_blocks * frames, LANES), dtype=np.uint32)
    slot_ids = np.full((n_blocks * frames,), -1, dtype=np.int32)
    counts = np.zeros((n_blocks * slots, 1), dtype=np.int32)
    slot_map = np.full((n_blocks * slots,), -1, dtype=np.int64)
    for k, blk in enumerate(blocks):
        packed[k * frames : (k + 1) * frames] = blk.packed
        slot_ids[k * frames : (k + 1) * frames] = blk.slot_ids
        counts[k * slots : (k + 1) * slots] = blk.counts
        slot_map[k * slots : (k + 1) * slots] = blk.slot_map
    return packed, slot_ids, counts, slot_map


@jax.jit
def unpack_blocks_pm1(packed: jnp.ndarray, slot_ids: jnp.ndarray) -> jnp.ndarray:
    """Device expand of stacked packed frames to the kernel's ±1 layout.

    packed [..., F, 8] uint32, slot_ids [..., F] int32 -> [..., F, 256]
    int8 in {-1, 0, +1}: hash bit set -> +1, clear -> -1, padding rows
    (slot id -1, incl. whole padding tiles) -> exact zero rows so they can
    never Hamming-match. Bit order identical to unpack_pm1_host.
    """
    shape = packed.shape
    pm1 = ops_sim.unpack_pm1(packed.reshape(-1, LANES)).reshape(*shape[:-1], BITS)
    return jnp.where((slot_ids >= 0)[..., None], pm1, jnp.int8(0))


@jax.jit
def unpack_blocks_pm1_stacked(packed: jnp.ndarray, slot_ids: jnp.ndarray) -> jnp.ndarray:
    """unpack_blocks_pm1 over stacked tiles [T, F, 8], one tile at a time.

    A whole-stack unpack materializes a u32 bit intermediate 4x the int8
    output (~8.6 GB at 1M videos); lax.map bounds the temps to
    one tile (~17 MB) while producing the same [T, F, 256] result.
    """
    return jax.lax.map(lambda a: unpack_blocks_pm1(a[0], a[1]), (packed, slot_ids))
