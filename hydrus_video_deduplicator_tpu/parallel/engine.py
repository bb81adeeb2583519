"""Device all-pairs VPDQ similarity search engine.

This replaces both the reference's per-pair native ``matchHash`` and its
VP-tree search (SURVEY.md §7 step 5) with exact, corpus-scale similarity.
Frame Hamming distances come from one int8 matrix product over ±1 rows
(dot = 256 - 2d); per-pair integer similarity is the min of the two
directional match fractions — the exact semantics of native matchHash,
including empty-hash and padding handling. Two device routes:

1. **Segment route** (default on the GPU, ops/similarity_segments.py):
   videos up to 512 frames pack greedily into fixed-shape frame blocks with
   membership one-hots as data — ONE compiled program for every length and
   no power-of-two padding.
2. **Bucketed route** (CPU + 513..1024-frame videos): videos bucketed by
   frame count (padded to the next power of two) so every computation has
   static shapes; one XLA tile program per bucket pair.

Longer videos are compared exactly on the host (threaded native
matchHashBytes). On the segment route the whole column side is device-
resident and each row tile is ONE dispatch: lax.scan runs the kernel over
every column tile and compacts hits on device (count + first-K triples),
so the host round-trips per row tile, not per tile pair. The bucketed
route streams tiles with bounded in-flight results and a device-side
hit-count gate; hits come back as (row, col, sim) pairs either way.

Brute force is strictly more correct than the VP-tree (the tree assumes a
metric; VPDQ similarity is not one), so pair sets can only gain pairs the
tree would miss; tests compare both paths and flag differences.

Multi-device: rows are sharded over a 1-D mesh with shard_map; every
device computes its row slab against the (replicated) column block. No
collectives beyond that initial broadcast.
"""

from __future__ import annotations

import functools
from collections import deque
from dataclasses import dataclass, field

import jax
import jax.numpy as jnp
import numpy as np

from .. import device
from ..ops import similarity as ops_sim
from ..vpdq import pdq_math as pm

BYTES = pm.BYTES_PER_HASH
LANES = BYTES // 4
TOL = pm.DEFAULT_DISTANCE_TOLERANCE

#: Nominal row/column video tile sizes (videos per device step) for an
#: 8-frame bucket; actual tiles scale inversely with bucket frame count so
#: the materialized frame-pair block stays bounded (see _tile_videos).
TILE_ROWS = 128
TILE_COLS = 1024
#: Frame budgets per tile side: the XLA tile materializes a
#: [row_frames x col_frames] int32 Hamming block, so its size is bounded by
#: TILE_ROW_FRAMES * TILE_COL_FRAMES * 4 bytes (= 32 MB) for any bucket.
TILE_ROW_FRAMES = TILE_ROWS * 8
TILE_COL_FRAMES = TILE_COLS * 8
#: Videos longer than this many sampled frames (~17 min at 1 fps) skip the
#: bucketed device path and are compared exactly on the host (native
#: matchHashBytes) — no truncation, identical results to the tree path.
MAX_BUCKET = 1024


def _bucket_size(n_frames: int) -> int:
    p = 1
    while p < n_frames:
        p <<= 1
    return p


def _tile_videos(nominal: int, frame_budget: int, pad: int) -> int:
    """Videos per tile for a bucket of ``pad`` frames, at least 1."""
    return max(1, min(nominal, frame_budget // pad))


def iter_blob_items(src, indices):
    """(index, blob) stream over a blob source for the given indices.

    Sources that implement ``iter_many`` (DB-backed columns) stream in
    batches; plain sequences fall back to per-item indexing."""
    if hasattr(src, "iter_many"):
        return src.iter_many(indices)
    return ((int(i), src[int(i)]) for i in indices)


def blob_frame_counts(src) -> np.ndarray:
    """Per-video frame counts without holding blob bytes.

    DB-backed sources expose ``blob_n_frames`` (one LENGTH() scan, no blob
    fetch); plain sequences derive counts from the resident bytes."""
    if hasattr(src, "blob_n_frames"):
        return np.asarray(src.blob_n_frames, dtype=np.int64)
    return np.fromiter((len(b) // BYTES for b in src), dtype=np.int64, count=len(src))


#: next power of two for every legal bucketed frame count (1..MAX_BUCKET)
_POW2_TABLE = np.asarray(
    [_bucket_size(max(n, 1)) for n in range(MAX_BUCKET + 1)], dtype=np.int64
)


@dataclass
class _Bucket:
    pad: int
    video_idx: np.ndarray  # int64 corpus indices (ascending)
    counts: np.ndarray  # int32 frame counts, aligned with video_idx


class CorpusIndex:
    """Host-side index: corpus of packed video hashes, bucketed by length.

    Construction touches only per-video frame COUNTS (one metadata pass);
    a bucket's packed frame arrays materialize on demand in
    ``bucket_arrays`` — at 10M-video corpus scale the old eager per-video
    arrays alone held ~4.5 GB host RAM for buckets the segment route never
    reads. Videos with more than MAX_BUCKET frames are
    collected in ``long`` (with their blobs — rare) for exact host-side
    comparison instead of bucketing (no truncation).
    """

    def __init__(self, phashes):
        self.src = phashes
        self.n = len(phashes)
        self.n_frames = blob_frame_counts(phashes) if self.n else np.zeros(0, np.int64)
        self.buckets: dict[int, _Bucket] = {}
        bucketable = (self.n_frames > 0) & (self.n_frames <= MAX_BUCKET)
        pads = np.zeros(self.n, dtype=np.int64)
        pads[bucketable] = _POW2_TABLE[self.n_frames[bucketable]]
        for pad in np.unique(pads[bucketable]):
            sel = np.nonzero(pads == pad)[0].astype(np.int64)
            self.buckets[int(pad)] = _Bucket(
                int(pad), sel, self.n_frames[sel].astype(np.int32)
            )
        # long videos keep their blobs resident (host-side exact compare)
        self.long: list[tuple[int, bytes]] = list(
            iter_blob_items(phashes, np.nonzero(self.n_frames > MAX_BUCKET)[0])
        )

    def bucket_arrays(self, pad: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        b = self.buckets[pad]
        frames = np.zeros((len(b.video_idx), pad, LANES), dtype=np.uint32)
        for k, (_i, blob) in enumerate(iter_blob_items(self.src, b.video_idx)):
            n = len(blob) // BYTES
            frames[k, :n] = ops_sim.blobs_to_packed(blob)
        return b.video_idx, frames, b.counts


class SegColumns:
    """Column-side view of the segment-eligible corpus.

    Indices and frame counts are resolved up front (metadata only); blob
    bytes are STREAMED once by the staging fill (iter_items) and fetched
    individually at hit-emission time (lookup). Keeping blobs out of the
    view is what bounds host RAM at 10M-video column scale.
    """

    def __init__(self, indices: np.ndarray, counts: np.ndarray, src):
        self.indices = np.asarray(indices, dtype=np.int64)
        self.counts = np.asarray(counts, dtype=np.int32)
        self.src = src

    def __len__(self) -> int:
        return len(self.indices)

    def iter_items(self):
        return iter_blob_items(self.src, self.indices)

    def lookup(self, j: int) -> bytes:
        return self.src[j]


def seg_columns_from_pairs(pairs: "list[tuple[int, bytes]]") -> SegColumns:
    """SegColumns over a materialized [(corpus_idx, blob)] list (the pruned
    route's rep columns — reps are a small fraction of the corpus)."""
    by = {int(i): b for i, b in pairs}
    idx = np.fromiter((i for i, _ in pairs), dtype=np.int64, count=len(pairs))
    cnt = np.fromiter(
        (len(b) // BYTES for _, b in pairs), dtype=np.int32, count=len(pairs)
    )
    return SegColumns(idx, cnt, by)


@functools.partial(jax.jit, static_argnames=("pa", "pb"))
def _tile_similarity(
    rows_packed: jnp.ndarray,  # [TR, pa, 8] uint32
    rows_counts: jnp.ndarray,  # [TR] int32
    cols_packed: jnp.ndarray,  # [TC, pb, 8] uint32
    cols_counts: jnp.ndarray,  # [TC] int32
    pa: int,
    pb: int,
) -> jnp.ndarray:
    """Integer video-level similarity [TR, TC] for one tile pair."""
    tr = rows_packed.shape[0]
    tc = cols_packed.shape[0]
    a = ops_sim.unpack_pm1(rows_packed.reshape(tr * pa, LANES))  # [TR*pa, 256]
    b = ops_sim.unpack_pm1(cols_packed.reshape(tc * pb, LANES))
    ham = ops_sim.hamming_tile(a, b).reshape(tr, pa, tc, pb)

    va = (jnp.arange(pa)[None, :] < rows_counts[:, None])  # [TR, pa]
    vb = (jnp.arange(pb)[None, :] < cols_counts[:, None])  # [TC, pb]
    matched = (ham <= TOL) & va[:, :, None, None] & vb[None, None, :, :]

    # matched: [TR, pa, TC, pb]
    a_hit = matched.any(axis=3)  # [TR, pa, TC] — row frame matched anything
    b_hit = matched.any(axis=1)  # [TR, TC, pb] — col frame matched anything
    ma = a_hit.sum(axis=1, dtype=jnp.int32)  # [TR, TC]
    mb = b_hit.sum(axis=2, dtype=jnp.int32)  # [TR, TC]
    fa = jnp.maximum(rows_counts, 1)[:, None]
    fb = jnp.maximum(cols_counts, 1)[None, :]
    sim = jnp.minimum((100 * ma) // fa, (100 * mb) // fb)
    nonempty = (rows_counts[:, None] > 0) & (cols_counts[None, :] > 0)
    return jnp.where(nonempty, sim, 0)


@jax.jit
def _hit_count(sim: jnp.ndarray, min_sim: jnp.ndarray) -> jnp.ndarray:
    """Scalar number of entries >= min_sim (device-side result gate)."""
    return jnp.sum(sim >= min_sim, dtype=jnp.int32)


def _scan_sweep_body(
    rf, ri, rc, cf, ci, cc, valid, min_sim, kernel, cols_packed=False,
    mask_kernel=False,
):
    """lax.scan the segment kernel over stacked column tiles, compacting
    hits ON DEVICE: per column tile, the true hit count plus a bitmask of
    hit positions. Bits pack across ROW slots (bit b of word [w, c] = row
    slot w*32+b, column slot c) so the mask's minor dim is the 2048-wide
    column-slot axis. One dispatch covers every column tile for a row
    tile, so the host waits once per row tile, not per tile pair.

    valid [T] bool gates each column tile with a real branch (lax.cond):
    an invalid tile costs neither kernel nor bitmask work. Triangle-order
    sweeps (dedup stage 4) use it to skip column tiles holding only
    not-yet-searched videos — a fresh all-pairs run does half the square's
    device work.

    rf arrives BIT-PACKED ([F, 8] u32; 8x less H2D than ±1 rows) and is
    expanded on device once per row tile, inside this jitted sweep.

    mask_kernel: the kernel emits the ROW-packed hit bitmask itself
    (seg.make_exists_mask_kernel_*; bit b of word w = row slot w*32+b) —
    the scan body then only popcounts."""
    from ..ops import similarity_segments as seg

    rf = seg.unpack_blocks_pm1(rf, ri)
    pow2 = jnp.uint32(1) << jnp.arange(32, dtype=jnp.uint32)

    def step(carry, col):
        cft, cit, cct, v = col
        # cols_packed: the column side stays BIT-PACKED on the device (u32
        # lanes; 8x smaller) and expands to ±1 rows per scan step — the
        # mode that keeps 10M-video column corpora inside one device. The
        # expansion runs only inside the taken branch, so skipped tiles
        # (triangle/padding) cost nothing.
        cft_k = (lambda: seg.unpack_blocks_pm1(cft, cit)) if cols_packed else (lambda: cft)
        sim_shape = jax.eval_shape(
            lambda: kernel(rf, ri, rc, cft_k(), cit, cct)
        ).shape

        def on(_):
            out = kernel(rf, ri, rc, cft_k(), cit, cct)
            if mask_kernel:
                cnt = jnp.sum(jax.lax.population_count(out), dtype=jnp.int32)
                return cnt, out
            hit = out >= min_sim
            cnt = jnp.sum(hit, dtype=jnp.int32)
            # row-packed, matching the mask kernels' layout (bit b of word
            # [w, c] = row slot w*32+b): minor dim stays the 2048-wide
            # column axis, so the u32 mask tiles without lane padding
            packed = (
                hit.reshape(-1, 32, hit.shape[1]).astype(jnp.uint32)
                * pow2[None, :, None]
            ).sum(1, dtype=jnp.uint32)
            return cnt, packed

        def off(_):
            shape = (
                sim_shape
                if mask_kernel
                else (sim_shape[0] // 32, sim_shape[1])
            )
            return jnp.int32(0), jnp.zeros(shape, jnp.uint32)

        cnt, packed = jax.lax.cond(v, on, off, None)
        return carry, (cnt, packed)

    _, out = jax.lax.scan(step, 0, (cf, ci, cc, valid))
    return out  # cnts [T], masks [T, rows/32, cols] (row-packed words)


def _pack_row_blob(packed, slot_ids, cnt, n_blocks: int) -> np.ndarray:
    """Join one row tile's three operands into ONE u32 array [n_blocks, W].

    One host->device transfer per row tile instead of three (bit-packed
    frames, slot ids, per-slot counts); a 1M-video sweep dispatches
    thousands of row tiles.
    int32 operands travel as their u32 bit patterns (-1 == 0xFFFFFFFF) and
    are bitcast back on device by _split_row_blob. Axis 0 stays the block
    axis, so mesh row-sharding specs are unchanged.
    """
    return np.concatenate(
        [
            packed.reshape(n_blocks, -1),
            slot_ids.view(np.uint32).reshape(n_blocks, -1),
            np.ascontiguousarray(cnt).view(np.uint32).reshape(n_blocks, -1),
        ],
        axis=1,
    )


def _split_row_blob(rblob):
    """Device-side inverse of _pack_row_blob: [n_blocks, W] u32 -> the flat
    (rf [n*F, 8] u32, ri [n*F] i32, rc [n*S, 1] i32) the sweep bodies take.
    Pure slicing + bitcast — XLA fuses it into the consumers for free."""
    from ..ops import similarity_segments as seg

    nb = rblob.shape[0]
    fw = seg.ROW_FRAMES * LANES
    rf = rblob[:, :fw].reshape(nb * seg.ROW_FRAMES, LANES)
    ri = jax.lax.bitcast_convert_type(
        rblob[:, fw : fw + seg.ROW_FRAMES], jnp.int32
    ).reshape(nb * seg.ROW_FRAMES)
    rc = jax.lax.bitcast_convert_type(
        rblob[:, fw + seg.ROW_FRAMES :], jnp.int32
    ).reshape(nb * seg.ROW_SLOTS, 1)
    return rf, ri, rc


@functools.lru_cache(maxsize=16)
def _segment_sweep_fn(kernel, cols_packed=False, mask_kernel=False):
    """Jitted single-device scan sweep, cached per (kernel, col mode)."""

    @jax.jit
    def sweep(rblob, cf, ci, cc, valid, min_sim):
        rf, ri, rc = _split_row_blob(rblob)
        cnts, masks = _scan_sweep_body(
            rf, ri, rc, cf, ci, cc, valid, min_sim, kernel, cols_packed,
            mask_kernel,
        )
        return cnts[None], masks[None]  # device axis of 1

    return sweep


def _onecall_sweep_body(rf_packed, ri, cf, ci, valid, tolerance):
    """Whole-corpus existence sweep as ONE Triton launch per row tile
    (ops.similarity_segments.make_exists_mask_sweep_triton): every program
    takes one (column chunk, row block) pair and reads its step's valid
    flag itself, in place of the scan route's lax.scan + lax.cond over
    column tiles. Output is reshaped to the scan route's (cnts [T], masks
    [T, W, C]) contract so the drain path is shared."""
    from ..ops import similarity_segments as seg

    rf = seg.unpack_blocks_pm1(rf_packed, ri)
    n_tiles, tile_frames = cf.shape[0], cf.shape[1]
    steps_per_tile = tile_frames // seg.STEP_FRAMES
    cf_flat = cf.reshape(n_tiles * tile_frames, cf.shape[2])
    ci_flat = ci.reshape(-1)
    valid_steps = jnp.repeat(valid.astype(jnp.int32), steps_per_tile)
    sweep = seg.make_exists_mask_sweep_triton(tolerance)
    flat = sweep(rf, ri, cf_flat, ci_flat, valid_steps)  # [W, T*tile_slots]
    tile_slots = steps_per_tile * seg.STEP_SLOTS
    masks = flat.reshape(flat.shape[0], n_tiles, tile_slots).transpose(1, 0, 2)
    cnts = jnp.sum(
        jax.lax.population_count(masks), axis=(1, 2), dtype=jnp.int32
    )
    return cnts, masks


@functools.lru_cache(maxsize=32)
def _fused_group_extract_fn(k_top: int, budget: int):
    """Fused drain extraction for a GROUP of row-tile sweep results in ONE
    dispatch + ONE fetch: stack the group's per-tile hit counts, gather
    the kg = min(k_top, D*T) highest-count [A, B] tiles FROM EACH mask
    (leading-dim gather — never stacking or flattening the full masks,
    which at 10M-video column widths would materialize a ~16 GB HLO
    temp), and compact their nonzero uint32 words to (flat index, value)
    pairs with a static-size jnp.nonzero. Hits are ~1 per row video
    (self-matches) in production sweeps, so fetching dense [A, B] masks
    moves ~400x more bytes than the set bits need, and per-tile
    count+gather would cost two device round trips per tile.
    Everything the host needs rides back in one flat int32 vector:
    [G*D*T counts | G*kg tile ids (g-major) | budget word indices (-1
    pad) | budget word values]. The host falls back to dense mask
    fetches when any one mask has >kg nonzero tiles or the words
    overflow the budget — both visible in the counts section of the
    same fetch."""

    @jax.jit
    def f(cnts_list, masks_list):
        cnts = jnp.stack(cnts_list)  # [G, D, T] int32 (tiny)
        flat_cnts = cnts.reshape(-1)
        # Gather each tile's k_top highest-count [A, B] masks BEFORE any
        # flatten: stacking the G full masks and reshaping [G*D*T, A*B]
        # materializes an HLO temp of the whole group (~16 GB at a
        # 10M-video column corpus). A leading-dim gather copies only k_top
        # tiles per mask (~10 MB), never the masks themselves.
        sel_parts, idx_parts = [], []
        for g, m in enumerate(masks_list):
            d_, t_, a_, b_ = m.shape
            cg = cnts[g].reshape(-1)  # [D*T]
            kg = min(k_top, cg.shape[0])
            _, ti = jax.lax.top_k(cg, kg)
            sel_parts.append(m.reshape(d_ * t_, a_, b_)[ti])  # [kg, A, B]
            idx_parts.append(ti + g * d_ * t_)
        sel = jnp.concatenate(sel_parts)  # [G*kg, A, B]
        top_idx = jnp.concatenate(idx_parts)
        flat = sel.reshape(-1)
        (widx,) = jnp.nonzero(flat, size=budget, fill_value=-1)
        vals = jnp.where(widx >= 0, flat[jnp.maximum(widx, 0)], jnp.uint32(0))
        return jnp.concatenate(
            [
                flat_cnts,
                top_idx.astype(jnp.int32),
                widx.astype(jnp.int32),
                jax.lax.bitcast_convert_type(vals, jnp.int32),
            ]
        )

    return f


#: nonzero-word budgets for the sparse drain; above the last rung the
#: drain falls back to fetching the gathered tiles' dense masks
_SPARSE_DRAIN_BUDGETS = (4096, 32768)

#: tiles gathered per fused drain call (sticky ladder): a group of 8 row
#: tiles over a 1M corpus lands hits in ~24-40 column tiles (self-match
#: diagonal + duplicates), so 64 covers production groups; the 256 rung
#: absorbs clumped corpora before any dense fallback
_DRAIN_K_TOPS = (64, 256)


@functools.lru_cache(maxsize=16)
def _onecall_sweep_fn(tolerance: int):
    """Jitted single-device one-launch existence sweep (same interface as
    _segment_sweep_fn with a mask kernel; min_sim/counts unused — the
    existence kernel thresholds in its epilogue)."""

    @jax.jit
    def sweep(rblob, cf, ci, cc, valid, min_sim):
        rf, ri, _rc = _split_row_blob(rblob)
        cnts, masks = _onecall_sweep_body(rf, ri, cf, ci, valid, tolerance)
        return cnts[None], masks[None]

    return sweep


@functools.lru_cache(maxsize=16)
def _sharded_onecall_sweep_fn(mesh, tolerance: int):
    """Sharded one-launch sweep: rows sharded over the mesh, stacked
    column tiles replicated (same layout contract as
    _sharded_segment_sweep_fn)."""
    from jax.sharding import PartitionSpec as P

    from .mesh import shard_map

    axes = tuple(mesh.axis_names)
    rows = P(axes)

    def body(rblob, cf, ci, cc, valid, min_sim):
        rf, ri, _rc = _split_row_blob(rblob)
        cnts, masks = _onecall_sweep_body(rf, ri, cf, ci, valid, tolerance)
        return cnts[None], masks[None]

    return jax.jit(
        shard_map(
            body,
            mesh=mesh,
            in_specs=(rows, P(), P(), P(), P(), P()),
            out_specs=(rows, rows),
        )
    )


@functools.lru_cache(maxsize=16)
def _sharded_segment_sweep_fn(mesh, kernel, cols_packed=False, mask_kernel=False):
    """Sharded scan sweep: rows sharded over the whole mesh, stacked column
    tiles replicated; every device scans all column tiles against its row
    slab and compacts its own hit bitmask (rows are slab-local; the host
    rebases by the device's slab offset). Outputs gain a leading device
    axis."""
    from jax.sharding import PartitionSpec as P

    from .mesh import shard_map

    axes = tuple(mesh.axis_names)
    rows = P(axes)

    def body(rblob, cf, ci, cc, valid, min_sim):
        rf, ri, rc = _split_row_blob(rblob)
        cnts, masks = _scan_sweep_body(
            rf, ri, rc, cf, ci, cc, valid, min_sim, kernel, cols_packed,
            mask_kernel,
        )
        return cnts[None], masks[None]

    return jax.jit(
        shard_map(
            body,
            mesh=mesh,
            in_specs=(rows, P(), P(), P(), P(), P()),
            out_specs=(rows, rows),
        )
    )


@functools.lru_cache(maxsize=4)
def _col_fill_fn(mesh):
    """Donated in-place group update of the device-resident column staging
    (dynamic_update_slice at a TRACED tile offset, so one compile covers
    every group flush of a streaming column upload)."""

    def fill(buf, grp, t0):
        idx = (t0,) + (jnp.int32(0),) * (buf.ndim - 1)
        return jax.lax.dynamic_update_slice(buf, grp, idx)

    return jax.jit(fill, donate_argnums=0)


def _pad_rows(arr: np.ndarray, to: int) -> np.ndarray:
    if arr.shape[0] == to:
        return arr
    pad = [(0, to - arr.shape[0])] + [(0, 0)] * (arr.ndim - 1)
    return np.pad(arr, pad)


class TpuSearchEngine:
    """Exact all-pairs similarity search over packed VPDQ hashes on the
    default JAX device (platform choices: device.py). Results are identical
    across all routes.
    """

    #: take the segment route (where the platform does so by itself) only
    #: when the sweep has at least this many frame comparisons — below it
    #: the bucketed tiles finish before the segment program compiles
    SEGMENT_MIN_FRAME_COMPARISONS = 1_000_000_000

    def __init__(
        self,
        tile_rows: int = TILE_ROWS,
        tile_cols: int = TILE_COLS,
        mesh=None,
        segment_min_work: int | None = None,
        force_segments: bool | None = None,
        exists_kernel: str | None = None,
    ):
        """mesh: optional jax.sharding.Mesh (1-D). When given, tiles are
        row-sharded over the mesh with shard_map (each device computes its
        slab of the similarity matrix against replicated columns).

        segment_min_work: override SEGMENT_MIN_FRAME_COMPARISONS (frame
        comparisons below which the bucketed route is used).

        exists_kernel: stage-A existence kernel of the pruned route,
        "triton" or "xla"; default: the platform's choice (device.py)."""
        caps = device.capabilities()
        self.tile_rows = tile_rows
        self.tile_cols = tile_cols
        self.mesh = mesh
        self.segment_min_work = (
            self.SEGMENT_MIN_FRAME_COMPARISONS
            if segment_min_work is None
            else segment_min_work
        )
        if mesh is not None:
            n = mesh.devices.size
            self.tile_rows = ((tile_rows + n - 1) // n) * n
        #: tri-state: None = auto (the platform's segment_route + enough
        #: work), True/False = forced (tests force it on the CPU)
        self.force_segments = force_segments
        self._auto_segments = caps.segment_route
        self.exists_kernel = exists_kernel or caps.exists_kernel
        self.row_blocks_per_tile = caps.row_blocks_per_tile
        #: per-device memory budgets of the segment route
        self.memory = device.memory_plan(
            None if mesh is None else list(mesh.devices.flat)
        )
        self._progress_cb = None
        self._progress_done = 0
        self._progress_total = 0

    def _use_segments(self, rows: "CorpusIndex", cols: "CorpusIndex") -> bool:
        """Take the fixed-shape segment route when the seg-eligible part of
        the corpus clears the work threshold (one compile EVER and no
        power-of-two padding — ops/similarity_segments.py)."""
        if self.force_segments is not None:
            return self.force_segments
        if not self._auto_segments:
            return False
        from ..ops import similarity_segments as seg

        row_frames = sum(
            int(b.counts.sum()) for p, b in rows.buckets.items() if p <= seg.SEG_MAX_FRAMES
        )
        col_frames = sum(
            int(b.counts.sum()) for p, b in cols.buckets.items() if p <= seg.SEG_MAX_FRAMES
        )
        return row_frames * col_frames >= self.segment_min_work

    def find_pairs(
        self,
        row_phashes: list[bytes],
        all_phashes: list[bytes],
        min_int_similarity: int,
        progress=None,
        col_state: dict | None = None,
        col_limit: int | None = None,
    ) -> list[tuple[int, int, int]]:
        """All (row_index, all_index, int_similarity) with similarity >=
        min_int_similarity (must be >= 1: similarity 0 means "no match" in
        every backend). Row videos are compared against every corpus video
        (including each other); a row video is never paired with its own
        corpus slot (callers dedupe identical files at a higher level).
        Videos longer than MAX_BUCKET frames are compared exactly on the
        host.

        progress: optional callable(done_video_pairs, total_video_pairs),
        invoked as device tiles complete (corpus-scale sweeps run minutes;
        the caller surfaces this through the progress-callback protocol).

        col_state: optional dict carrying the column-side host index and
        device tiles across calls. Callers that sweep the SAME all_phashes
        with successive row chunks (stage 4's per-chunk checkpointing)
        pass one dict for the whole sweep so the corpus is indexed,
        unpacked, and uploaded once instead of once per chunk.

        col_limit: only report (and, on the device routes, largely only
        compute) hits whose corpus index is < col_limit. A chunked caller
        that orders all_phashes so already-compared videos come first can
        sweep the triangle instead of the square — column tiles holding
        only videos >= col_limit are skipped with a real device branch.
        """
        assert min_int_similarity >= 1, "minimum similarity must be >= 1"
        from ..ops import similarity_segments as seg

        state = col_state if col_state is not None else {}
        rows = CorpusIndex(row_phashes)
        cols = state.get("cols_index")
        if cols is None:
            cols = state["cols_index"] = CorpusIndex(all_phashes)
        total_pairs = 0
        for pa, rb in rows.buckets.items():
            for pb, cb in cols.buckets.items():
                n_cols = len(cb.video_idx)
                if col_limit is not None:
                    # video_idx is ascending (corpus iteration order)
                    n_cols = int(np.searchsorted(cb.video_idx, col_limit))
                total_pairs += len(rb.video_idx) * n_cols
        self._progress_done = 0
        self._progress_total = total_pairs
        self._progress_cb = progress
        out: list[tuple[int, int, int]] = []

        use_segments = self._use_segments(rows, cols)
        if use_segments:
            seg_rows = [
                (int(i), row_phashes[int(i)])
                for p, b in sorted(rows.buckets.items())
                if p <= seg.SEG_MAX_FRAMES
                for i in b.video_idx
            ]
            seg_pads = sorted(p for p in cols.buckets if p <= seg.SEG_MAX_FRAMES)
            seg_idx = (
                np.concatenate([cols.buckets[p].video_idx for p in seg_pads])
                if seg_pads
                else np.zeros(0, np.int64)
            )
            seg_cols = SegColumns(seg_idx, cols.n_frames[seg_idx], cols.src)
            out.extend(
                self._segment_route(
                    seg_rows, seg_cols, min_int_similarity, state, col_limit
                )
            )

        # column bucket arrays are stacked and device-placed ONCE per
        # (bucket, route) and reused across every row bucket — rebuilding
        # them per row bucket re-uploads the whole corpus per bucket pair.
        # They materialize lazily per bucket: segment-covered buckets (the
        # whole corpus, at scale) never pay the packed-array host RAM.
        col_arrays = state.setdefault("col_arrays", {})
        col_cache: dict = state.setdefault("col_cache", {})
        row_pm1_cache: dict = {}
        for pa, rb in rows.buckets.items():
            for pb, cb in cols.buckets.items():
                if (
                    use_segments
                    and pa <= seg.SEG_MAX_FRAMES
                    and pb <= seg.SEG_MAX_FRAMES
                ):
                    continue  # covered by the segment route
                r_idx, r_frames, r_counts = rows.bucket_arrays(pa)
                if pb not in col_arrays:
                    col_arrays[pb] = cols.bucket_arrays(pb)
                c_idx, c_frames, c_counts = col_arrays[pb]
                out.extend(
                    self._bucket_pair(
                        pa, r_idx, r_frames, r_counts,
                        pb, c_idx, c_frames, c_counts,
                        min_int_similarity,
                        col_cache=col_cache,
                        row_pm1_cache=row_pm1_cache,
                        col_limit=col_limit,
                    )
                )
        out.extend(
            self._long_video_pairs(
                rows, row_phashes, cols, all_phashes, min_int_similarity, col_limit
            )
        )
        return out

    def find_pairs_pruned(
        self,
        row_phashes: list[bytes],
        all_phashes: list[bytes],
        min_int_similarity: int,
        progress=None,
        col_state: dict | None = None,
        col_limit: int | None = None,
        radius_cap: int | None = None,
        rows_at: int | None = None,
    ) -> list[tuple[int, int, int]]:
        """find_pairs with the exact scene-representative prune.

        Identical result contract to find_pairs (tests assert pair-set
        equality); the difference is cost on realistic corpora: instead
        of comparing every frame pair of every video pair, stage 1 sweeps
        each video's scene representatives (ops/reps.py greedy leaders,
        radius <= radius_cap) at the inflated tolerance
        TOL + 2*radius_cap — by the triangle inequality a video pair with
        NO leader-pair match within that tolerance has similarity exactly
        0 and is skipped — and stage 2 computes the exact similarity of
        the surviving candidates only (ops/pair_verify.py batched int8
        contractions). Device work drops from (total frames)^2 to
        (total scene leaders)^2 + (candidate pairs x their frames^2).

        Videos longer than the segment limit take the same bucketed/host
        paths as find_pairs, unpruned (complement sweeps below).

        ``rows_at``: when the rows are exactly
        ``all_phashes[rows_at : rows_at + len(row_phashes)]`` (the
        checkpointed stage-4 triangle, where each chunk is a corpus
        suffix slice), pass their corpus position and the row-side scene
        representatives are LOOKED UP from the column rep cache instead
        of re-clustered — per-chunk row clustering otherwise re-does the
        whole corpus's host clustering over a checkpointed run.
        """
        assert min_int_similarity >= 1, "minimum similarity must be >= 1"
        import os as _os
        import time as _time

        from ..ops import pair_verify
        from ..ops import reps as reps_mod
        from ..ops import similarity_segments as seg

        _debug = _os.environ.get("HVD_DEBUG_TIMING")
        _t0 = _time.time()

        def _lap(label):
            nonlocal _t0
            if _debug:
                now = _time.time()
                print(f"[prune-timing] {label}: {now - _t0:.1f}s", flush=True)
                _t0 = now

        radius_cap = reps_mod.RADIUS_CAP if radius_cap is None else radius_cap
        state = col_state if col_state is not None else {}
        prune_state = state.setdefault("prune", {})

        row_counts = blob_frame_counts(row_phashes)
        col_counts = state.get("col_n_frames")
        if col_counts is None:
            col_counts = state["col_n_frames"] = blob_frame_counts(all_phashes)

        seg_row_idx = np.nonzero(
            (row_counts >= 1) & (row_counts <= seg.SEG_MAX_FRAMES)
        )[0]

        # The rep cache is only valid for the radius_cap it was built at:
        # sweeping at prune_tolerance(small_cap) against reps clustered at
        # a larger cap breaks the triangle-inequality bound and would
        # silently drop true pairs. Rebuild on mismatch.
        seg_cols = prune_state.get("rep_cols")
        if seg_cols is None or prune_state.get("rep_cols_radius_cap") != radius_cap:
            seg_col_idx = np.nonzero(
                (col_counts >= 1) & (col_counts <= seg.SEG_MAX_FRAMES)
            )[0]
            # cluster in slabs so only one slab of column blobs is ever
            # resident (the reps kept are a small fraction of the frames)
            col_reps: list[bytes] = []
            slab = 1 << 18
            for s0 in range(0, len(seg_col_idx), slab):
                sl = seg_col_idx[s0 : s0 + slab]
                col_reps.extend(
                    reps_mod.extract_reps(
                        [b for _, b in iter_blob_items(all_phashes, sl)],
                        radius_cap,
                    )
                )
            seg_cols = prune_state["rep_cols"] = list(
                zip(seg_col_idx.tolist(), col_reps)
            )
            prune_state["rep_cols_radius_cap"] = radius_cap
            # the packed device staging of the old reps is stale too
            prune_state.pop("seg_scan_cols", None)
            prune_state.pop("rep_lookup", None)
        _lap("col reps")

        if rows_at is not None:
            # rows == all_phashes[rows_at : rows_at + len(rows)]: reuse the
            # column rep cache (extract_reps clusters each video
            # independently, so the per-video reps are identical)
            rep_lookup = prune_state.get("rep_lookup")
            if rep_lookup is None:
                rep_lookup = prune_state["rep_lookup"] = dict(seg_cols)
            row_reps = [rep_lookup[rows_at + int(i)] for i in seg_row_idx]
        else:
            row_reps = reps_mod.extract_reps(
                [b for _, b in iter_blob_items(row_phashes, seg_row_idx)],
                radius_cap,
            )
        seg_rows = list(zip(seg_row_idx.tolist(), row_reps))
        _lap("row reps")

        tol_prune = reps_mod.prune_tolerance(radius_cap)
        # mask-emitting kernels: the hit bitmask packs in the kernel
        # epilogue, so the int32 existence counts never reach the host
        kernel = seg.exists_mask_kernel(tol_prune, self.exists_kernel)
        self._progress_done = 0
        self._progress_total = len(seg_rows) * len(seg_cols)
        self._progress_cb = progress
        candidates = self._segment_route(
            seg_rows, seg_columns_from_pairs(seg_cols), 1, prune_state,
            col_limit, kernel=kernel, with_sims=False, mask_rows=True,
            mask_tolerance=tol_prune,
        )
        _lap(f"stage-A sweep ({len(candidates)} candidates)")
        # SQLite-backed columns: fetch every candidate's column blob in
        # batched IN() probes up front — verify's per-candidate random
        # access costs one SELECT per miss otherwise (~1 per row at corpus
        # scale, since every video's self-pair is a candidate). Candidates
        # whose column index falls inside this chunk's own row span reuse
        # the in-memory row blobs instead (rows_at contract above: rows ==
        # all_phashes[rows_at : rows_at + len(rows)]) — at corpus scale
        # nearly every candidate is a self/near-diagonal pair, so this
        # turns the per-chunk 100k-blob random-read storm against a
        # multi-GB DB into a handful of off-diagonal IN() probes, and
        # makes verify's identical-blob self-pair shortcut an O(1)
        # object-identity hit.
        col_blobs_for_verify = all_phashes
        if hasattr(all_phashes, "iter_many") and candidates:
            need = sorted({j for _, j in candidates})
            local: dict[int, bytes] = {}
            if rows_at is not None:
                n_rows = len(row_phashes)
                in_span = [j for j in need if rows_at <= j < rows_at + n_rows]
                for j in in_span:
                    local[j] = row_phashes[j - rows_at]
                need = [j for j in need if not (rows_at <= j < rows_at + n_rows)]
            if need:
                local.update(all_phashes.iter_many(need))
            col_blobs_for_verify = local
            _lap(f"verify-blob fetch ({len(need)} off-span)")
        out = pair_verify.verify_pairs(
            candidates, row_phashes, col_blobs_for_verify, min_int_similarity
        )
        _lap(f"verify ({len(out)} hits)")

        # Complement sweeps (unpruned find_pairs with the seg-eligible
        # side emptied — empty blobs match nothing): long rows x every
        # col, then seg rows x long cols. No overlap, no double count.
        # Long videos are rare, so the masked column list is almost all
        # references to one b"" — blob bytes are fetched only for longs.
        long_rows = set(np.nonzero(row_counts > seg.SEG_MAX_FRAMES)[0].tolist())
        long_cols = set(np.nonzero(col_counts > seg.SEG_MAX_FRAMES)[0].tolist())
        if long_rows:
            masked = [
                row_phashes[i] if i in long_rows else b""
                for i in range(len(row_phashes))
            ]
            out.extend(
                self.find_pairs(
                    masked, all_phashes, min_int_similarity,
                    col_state=state.setdefault("prune_long_rows", {}),
                    col_limit=col_limit,
                )
            )
        if long_cols:
            masked_rows = [
                row_phashes[i]
                if (i not in long_rows and row_counts[i] >= 1)
                else b""
                for i in range(len(row_phashes))
            ]
            masked_cols = [
                all_phashes[j] if j in long_cols else b""
                for j in range(len(all_phashes))
            ]
            out.extend(
                self.find_pairs(
                    masked_rows, masked_cols, min_int_similarity,
                    col_state=state.setdefault("prune_long_cols", {}),
                    col_limit=col_limit,
                )
            )
        return out

    def _segment_route(
        self, seg_rows, seg_cols, min_sim, state=None, col_limit=None,
        kernel=None, with_sims=True, mask_rows=False, mask_tolerance=None,
    ):
        """Fixed-shape kernel route: greedy-packed frame blocks with
        membership one-hots as data (ops/similarity_segments.py). One
        compiled executable covers every video length <= SEG_MAX_FRAMES.

        The column side lives on the device as ONE stacked [T, ...] array
        set (reused across row tiles and, via col_state, across the
        checkpointed chunks of a sweep); each row tile is ONE dispatch
        that lax.scans the kernel over all T column tiles and compacts
        hits on device into position bitmasks (_scan_sweep_body). The
        host fetches a [T] count vector plus the nonzero tiles' bitmasks
        instead of one [rows, cols] result per tile pair, and recovers
        each hit's integer similarity with native matchHashBytes — by
        construction (and by property test) identical to the kernel's
        value."""
        from ..ops import similarity_segments as seg
        from ..vpdq import matchHashBytes

        if not seg_rows or not seg_cols:
            return []
        import os
        import time as _time

        _debug = os.environ.get("HVD_DEBUG_TIMING")
        _t0 = _time.time()

        def _lap(label):
            nonlocal _t0
            if _debug:
                now = _time.time()
                print(f"[seg-timing] {label}: {now - _t0:.1f}s", flush=True)
                _t0 = now
        if kernel is None:
            kernel = seg.similarity_segments_xla
        n_dev = self.mesh.devices.size if self.mesh is not None else 1
        # Row blocks per dispatch: every row tile costs one dispatch + one
        # drain fetch; padding blocks hold only zero rows (slot id -1) that
        # can never match. HVD_ROW_BLOCKS_PER_TILE overrides the platform's
        # default (device.py).
        base_blocks = (
            int(os.environ.get("HVD_ROW_BLOCKS_PER_TILE", "0"))
            or self.row_blocks_per_tile
        )
        row_blocks_per_tile = max(base_blocks, n_dev)
        row_blocks_per_tile = ((row_blocks_per_tile + n_dev - 1) // n_dev) * n_dev

        row_blocks = seg.pack_blocks(seg_rows, seg.ROW_FRAMES, seg.ROW_SLOTS)
        chunks_per_tile = seg.TILE_COL_STEPS * seg.N_SPLIT
        _lap("row pack")

        cols_stacked = None if state is None else state.get("seg_scan_cols")
        if cols_stacked is None:
            # tile count pads to an eighth-octave step with empty
            # (validity-skipped) tiles: the scan length bakes into the
            # compiled program, so without padding every distinct corpus
            # size costs a fresh XLA compile of the T-step scan. Full
            # power-of-two padding wastes up to ~2x of pm1 + mask device
            # memory on padding tiles (a 1M mean-120 corpus lands at
            # n_real=1347 -> 2048, +52%); an eighth-octave grid keeps waste
            # <= 12.5% at <= 8 compiled shapes per octave.
            #
            # The column corpus STREAMS to the device: the packing plan is
            # computed from frame counts alone (seg.plan_chunks), then the
            # blob stream fills a bounded host buffer of COL_FILL_GROUP
            # tiles (~16 MB) that is flushed into a device-resident padded
            # staging array with a donated dynamic_update_slice. Host RAM
            # stays one group regardless of corpus size — the old
            # whole-corpus padded staging held ~5 GB at 10M columns
            #.
            counts = seg_cols.counts
            chunk_id, slot_id, frame_off, n_chunks = seg.plan_chunks(
                counts, seg.CHUNK_FRAMES, seg.CHUNK_SLOTS
            )
            n_real = (n_chunks + chunks_per_tile - 1) // chunks_per_tile
            n_pad = 1
            while n_pad < n_real:
                n_pad <<= 1
            step = max(1, n_pad // 8)
            n_pad = ((n_real + step - 1) // step) * step
            tile_frames = chunks_per_tile * seg.CHUNK_FRAMES
            tile_slots = chunks_per_tile * seg.CHUNK_SLOTS
            # per-slot metadata (small): true counts + corpus-index map
            cnt_all = np.zeros((n_pad, tile_slots, 1), dtype=np.int32)
            smaps = np.full((n_pad, tile_slots), -1, dtype=np.int64)
            if len(counts):
                flat_slot = chunk_id * seg.CHUNK_SLOTS + slot_id
                cnt_all[flat_slot // tile_slots, flat_slot % tile_slots, 0] = counts
                smaps[flat_slot // tile_slots, flat_slot % tile_slots] = (
                    seg_cols.indices
                )
            _lap("col plan")
            pk_dev = self._device_fill((n_pad, tile_frames, LANES), jnp.uint32, 0)
            ids_dev = self._device_fill((n_pad, tile_frames), jnp.int32, -1)
            grp_n = min(n_pad, self.COL_FILL_GROUP)
            pk_grp = np.zeros((grp_n, tile_frames, LANES), dtype=np.uint32)
            ids_grp = np.full((grp_n, tile_frames), -1, dtype=np.int32)
            fill = _col_fill_fn(self.mesh)
            g0 = 0  # first tile of the in-progress group
            dirty = False

            def _flush(pk_dev, ids_dev):
                # device_put can be ZERO-COPY (CPU backend aliases the
                # numpy buffer), so the reused group buffers must be
                # snapshotted — zeroing them in place after an aliasing
                # put silently corrupts the staged tiles
                pk_dev = fill(pk_dev, self._put_cols(pk_grp.copy()), np.int32(g0))
                ids_dev = fill(ids_dev, self._put_cols(ids_grp.copy()), np.int32(g0))
                pk_grp[:] = 0
                ids_grp[:] = -1
                return pk_dev, ids_dev

            # chunk-batched fill: a chunk's videos are CONTIGUOUS (next
            # video's frame_off = previous end), so each chunk packs with
            # ONE blobs_to_packed over its joined bytes — a per-video pack
            # measured ~+25 s/1M videos of pure call overhead
            cur_chunk = -1
            cur_blobs: list[bytes] = []
            cur_slots: list[int] = []
            cur_lens: list[int] = []

            def _flush_chunk(pk_dev, ids_dev, dirty):
                nonlocal g0, cur_blobs, cur_slots, cur_lens
                if not cur_blobs:
                    return pk_dev, ids_dev, dirty
                t = cur_chunk // chunks_per_tile
                while t >= g0 + grp_n:
                    if dirty:
                        pk_dev, ids_dev = _flush(pk_dev, ids_dev)
                        dirty = False
                    g0 += grp_n
                row0 = (cur_chunk % chunks_per_tile) * seg.CHUNK_FRAMES
                n_fill = sum(cur_lens)
                pk_grp[t - g0, row0 : row0 + n_fill] = ops_sim.blobs_to_packed(
                    b"".join(cur_blobs)
                )
                ids_grp[t - g0, row0 : row0 + n_fill] = np.repeat(
                    np.asarray(cur_slots, dtype=np.int32),
                    np.asarray(cur_lens, dtype=np.int64),
                )
                cur_blobs, cur_slots, cur_lens = [], [], []
                return pk_dev, ids_dev, True

            for k, (_j, blob) in enumerate(seg_cols.iter_items()):
                c = int(chunk_id[k])
                if c != cur_chunk:
                    pk_dev, ids_dev, dirty = _flush_chunk(pk_dev, ids_dev, dirty)
                    cur_chunk = c
                cur_blobs.append(blob)
                cur_slots.append(int(slot_id[k]))
                cur_lens.append(int(counts[k]))
            pk_dev, ids_dev, dirty = _flush_chunk(pk_dev, ids_dev, dirty)
            if dirty:
                pk_dev, ids_dev = _flush(pk_dev, ids_dev)
            _lap("col stream+fill")
            # frames travel BIT-PACKED (8x less H2D). Default: expand to
            # the kernel's ±1 rows ON DEVICE, once — the pm1 expansion
            # stays resident across the whole sweep (and, via col_state,
            # across every chunk of a checkpointed stage-4 run). When the
            # expansion would not fit the memory plan (10M-video column
            # corpora are ~20 GB of ±1 rows), the columns stay packed on
            # the device (8x smaller) and each scan step expands its own
            # tile.
            pm1_bytes = n_pad * tile_frames * BYTES * 8
            # a sweep-result hit mask is [T, row_slots/32, tile_slots] u32;
            # the drain keeps >= 4 of them in flight (2 groups of >= 2), so
            # the pm1 expansion may only stay resident if columns + masks
            # together fit the planning target
            mask_bytes = (
                4 * n_pad * tile_slots * (row_blocks_per_tile * seg.ROW_SLOTS // 32)
            )
            cols_packed_mode = pm1_bytes > min(
                self.memory.col_pm1_bytes,
                self.memory.seg_target_bytes - 4 * mask_bytes,
            )
            if cols_packed_mode:
                cf_dev = pk_dev
                cols_resident_bytes = n_pad * tile_frames * BYTES
            else:
                cf_dev = seg.unpack_blocks_pm1_stacked(pk_dev, ids_dev)
                del pk_dev  # the packed staging's HBM is released
                cols_resident_bytes = pm1_bytes
            cols_stacked = (
                cf_dev,
                ids_dev,
                self._put_cols(cnt_all),
                smaps,
                int((smaps >= 0).sum()),
                cols_packed_mode,
                cols_resident_bytes,
            )
            if state is not None:
                state["seg_scan_cols"] = cols_stacked
            # let the column upload + device expansion finish before row
            # dispatches start, so the stage laps attribute it
            jax.block_until_ready(cols_stacked[:3])
            _lap("col upload synced")
        (
            cf,
            ci,
            cc,
            smaps,
            total_cols,
            cols_packed_mode,
            cols_resident_bytes,
        ) = cols_stacked
        n_tiles = len(smaps)
        # [T, slots] corpus-index lookup for the vectorized drain emit
        smaps_arr = np.asarray(smaps)

        # per-tile validity: a tile is scanned only if it holds at least
        # one video (below col_limit, when given) — skips both the
        # col_limit prefix restriction and the power-of-two padding tiles
        # with a device-side branch
        if col_limit is None:
            valid = jnp.asarray([bool((m >= 0).any()) for m in smaps])
        else:
            valid = jnp.asarray(
                [bool(((m >= 0) & (m < col_limit)).any()) for m in smaps]
            )
            total_cols = sum(int(((m >= 0) & (m < col_limit)).sum()) for m in smaps)

        # existence sweeps with the Triton kernel over ±1-expanded columns
        # take ONE launch per row tile over the whole column corpus
        # (_onecall_sweep_body) instead of a lax.scan of per-tile calls.
        # Packed-column (10M-scale) sweeps keep the scan route, which
        # expands each tile inside its step.
        use_onecall = (
            mask_rows
            and mask_tolerance is not None
            and not cols_packed_mode
            and self.exists_kernel == "triton"
        )
        if use_onecall:
            sweep = (
                _sharded_onecall_sweep_fn(self.mesh, mask_tolerance)
                if self.mesh is not None
                else _onecall_sweep_fn(mask_tolerance)
            )
        else:
            sweep = (
                _sharded_segment_sweep_fn(self.mesh, kernel, cols_packed_mode, mask_rows)
                if self.mesh is not None
                else _segment_sweep_fn(kernel, cols_packed_mode, mask_rows)
            )
        min_sim_dev = jnp.int32(min_sim)
        row_blob = dict(seg_rows)
        col_lookup = seg_cols.lookup

        out: list[tuple[int, int, int]] = []
        inflight: deque = deque()
        # drain-phase attribution (printed when HVD_DEBUG_TIMING is set):
        # fetch = fused extract dispatch+fetch (includes waiting out the
        # group's device work), host = bit unpack + hit decode
        _drain_acc = {"fetch": 0.0, "host": 0.0, "tiles": 0, "dense": 0}
        # sticky escalation across groups AND (via col_state) across the
        # checkpointed chunks of a stage-4 run: each escalation costs an
        # extra extract round trip + a fresh jit of the extract fn, so a
        # 64-chunk run re-paying it per chunk adds minutes
        if state is not None:
            budget_rung = state.setdefault("drain_budget_rung", [0])
            ktop_rung = state.setdefault("drain_ktop_rung", [0])
        else:
            budget_rung = [0]
            ktop_rung = [0]

        def _emit(group, g_arr, d_arr, t_arr, rows_l, cols_l, local_slots):
            rmaps = np.stack([g[0] for g in group])  # [G, D*local_slots]
            ia_arr = rmaps[g_arr, d_arr * local_slots + rows_l]
            ib_arr = smaps_arr[t_arr, cols_l]
            keep = (ia_arr >= 0) & (ib_arr >= 0)
            if col_limit is not None:
                keep &= ib_arr < col_limit
            if with_sims:
                for ia, ib in zip(
                    ia_arr[keep].tolist(), ib_arr[keep].tolist()
                ):
                    out.append(
                        (ia, ib, int(matchHashBytes(row_blob[ia], col_lookup(ib))))
                    )
            else:
                # prune mode: candidate (row, col) pairs only — similarity
                # comes from the exact verify stage, not per-hit host calls
                out.extend(zip(ia_arr[keep].tolist(), ib_arr[keep].tolist()))

        def drain_group(group):
            """Extract every hit of a group of row-tile sweep results with
            ONE fused dispatch + ONE fetch (_fused_group_extract_fn); the
            budget escalates stickily and overflows fall back to dense
            per-tile mask fetches."""
            _td = _time.time()
            cnts_list = tuple(g[2][0] for g in group)
            masks_list = tuple(g[2][1] for g in group)
            G = len(group)
            # every route's masks are row-packed: [D, T, A=rows/32, B=cols]
            D, T, A, B = masks_list[0].shape
            local_slots = A * 32
            n0 = G * D * T
            while True:
                budget = _SPARSE_DRAIN_BUDGETS[budget_rung[0]]
                # the extract gathers min(k_top, D*T) tiles PER mask
                # (g-major concatenation) — mirror that layout here
                kg = min(_DRAIN_K_TOPS[ktop_rung[0]], D * T)
                k_eff = G * kg
                vec = np.asarray(
                    _fused_group_extract_fn(
                        _DRAIN_K_TOPS[ktop_rung[0]], budget
                    )(cnts_list, masks_list)
                )
                cnts = vec[:n0].reshape(G, D, T)
                total_hits = int(cnts.sum())
                nz_g_max = int((cnts > 0).reshape(G, -1).sum(axis=1).max())
                # escalate and re-extract on overflow (masks are still on
                # device; one extra round trip, then sticky)
                if (
                    total_hits > budget
                    and budget_rung[0] + 1 < len(_SPARSE_DRAIN_BUDGETS)
                ):
                    budget_rung[0] += 1
                    continue
                if (
                    nz_g_max > kg
                    and kg < D * T
                    and ktop_rung[0] + 1 < len(_DRAIN_K_TOPS)
                ):
                    ktop_rung[0] += 1
                    continue
                break
            _drain_acc["fetch"] += _time.time() - _td
            _drain_acc["tiles"] += G
            if self._progress_cb is not None:
                self._progress_done += sum(g[1] for g in group) * total_cols
                self._progress_cb(self._progress_done, self._progress_total)
            if total_hits == 0:
                return
            _td = _time.time()
            if nz_g_max <= kg and total_hits <= budget:
                top_idx = vec[n0 : n0 + k_eff]
                widx = vec[n0 + k_eff : n0 + k_eff + budget]
                vals_i = vec[n0 + k_eff + budget :]
                keep_w = widx >= 0
                widx = widx[keep_w]
                vals = np.ascontiguousarray(vals_i[keep_w]).view(np.uint32)
                k_arr, rem = np.divmod(widx, A * B)
                a_arr, b_arr = np.divmod(rem, B)
                bitmat = np.unpackbits(
                    vals.view(np.uint8).reshape(-1, 4), axis=1, bitorder="little"
                )  # [M, 32]
                m_i, bit_i = np.nonzero(bitmat)
                rows_l = a_arr[m_i] * 32 + bit_i
                cols_l = b_arr[m_i]
                flat_tile = top_idx[k_arr[m_i]]
                g_arr, dt = np.divmod(flat_tile, D * T)
                d_arr, t_arr = np.divmod(dt, T)
            else:
                # dense fallback: fetch each nonzero tile's full bitmask
                _drain_acc["dense"] += 1
                parts = []
                for g, d, t in np.argwhere(cnts > 0):
                    m = np.ascontiguousarray(np.asarray(masks_list[g][d, t]))
                    # row-packed words [rows/32, col_slots]: bit b of word
                    # [w, c] = row slot w*32+b
                    b3 = np.unpackbits(
                        m.view(np.uint8).reshape(A, B, 4),
                        axis=2,
                        bitorder="little",
                    )  # [A, B, 32]
                    bits = np.moveaxis(b3, 2, 1).reshape(A * 32, B)
                    r_i, c_i = np.nonzero(bits)
                    parts.append((
                        np.full(len(r_i), g), np.full(len(r_i), d),
                        np.full(len(r_i), t), r_i, c_i,
                    ))
                g_arr = np.concatenate([p[0] for p in parts])
                d_arr = np.concatenate([p[1] for p in parts])
                t_arr = np.concatenate([p[2] for p in parts])
                rows_l = np.concatenate([p[3] for p in parts])
                cols_l = np.concatenate([p[4] for p in parts])
            _emit(group, g_arr, d_arr, t_arr, rows_l, cols_l, local_slots)
            _drain_acc["host"] += _time.time() - _td

        group_n = None  # resolved from the first sweep result's mask shape
        n_tile_laps = 0
        for i0 in range(0, len(row_blocks), row_blocks_per_tile):
            group = row_blocks[i0 : i0 + row_blocks_per_tile]
            packed, slot_ids, cnt, rmap = seg.stack_blocks(
                group, row_blocks_per_tile, seg.ROW_FRAMES, seg.ROW_SLOTS
            )
            rn = int((rmap >= 0).sum())
            # rows also travel bit-packed, and the tile's three operands
            # ride ONE concatenated u32 transfer (_pack_row_blob); the
            # sweep splits and expands them on device
            rblob_dev = self._put_rows(
                _pack_row_blob(packed, slot_ids, cnt, row_blocks_per_tile)
            )
            inflight.append((rmap, rn, sweep(rblob_dev, cf, ci, cc, valid, min_sim_dev)))
            if group_n is None:
                # bound in-flight mask memory: 2*group_n masks must fit
                # what the resident column corpus leaves of the planning
                # target (and never more than the plan's drain budget)
                msh = inflight[0][2][1].shape
                mask_mb = 4 * int(np.prod(msh)) / 1e6
                avail_mb = min(
                    self.memory.drain_bytes / 1e6,
                    (self.memory.seg_target_bytes - cols_resident_bytes) / 1e6,
                )
                group_n = max(
                    1,
                    min(
                        self.DRAIN_GROUP,
                        int(max(avail_mb, 0.0) / max(mask_mb, 1e-3)) // 2,
                    ),
                )
            if n_tile_laps < 8:
                _lap(f"row tile {i0 // row_blocks_per_tile} dispatched")
                n_tile_laps += 1
            # keep a full group computing while the previous group drains
            if len(inflight) >= 2 * group_n:
                drain_group([inflight.popleft() for _ in range(group_n)])
        while inflight:
            drain_group(
                [inflight.popleft() for _ in range(min(group_n, len(inflight)))]
            )
        _lap("row tiles + drain")
        if _debug:
            print(
                "[seg-timing] drain split: "
                f"fetch {_drain_acc['fetch']:.1f}s host {_drain_acc['host']:.1f}s "
                f"over {_drain_acc['tiles']} row tiles "
                f"({_drain_acc['dense']} dense-fallback groups)",
                flush=True,
            )
        return out

    def _long_video_pairs(self, rows, row_phashes, cols, all_phashes, min_sim, col_limit=None):
        """Exact host-side comparison for videos too long to bucket.

        Covers (long row x every col) and (every row x long col) without
        double-counting the (long row x long col) block. Runs on a thread
        pool (native matchHashBytes releases the GIL) and reports through
        the same progress callback as the device tiles — a long video
        costs a full corpus sweep, which would otherwise look like a hang.
        Under col_limit, corpus columns >= the limit are excluded (both as
        comparison targets and as flipped long-column jobs).
        """
        import os
        from concurrent.futures import ThreadPoolExecutor

        from ..vpdq import matchHashBytes

        out: list[tuple[int, int, int]] = []
        nonempty_cols = [
            (j, blob)
            for j, blob in enumerate(all_phashes)
            if len(blob) > 0 and (col_limit is None or j < col_limit)
        ]
        nonempty_rows = [
            (i, blob) for i, blob in enumerate(row_phashes) if len(blob) > 0
        ]
        long_row_set = {i for i, _ in rows.long}
        short_rows = [(i, blob) for i, blob in nonempty_rows if i not in long_row_set]
        # (index, blob, others, flipped): flipped jobs come from long corpus
        # columns and emit (row, col) with the long video as the column
        jobs = [(i, blob, nonempty_cols, False) for i, blob in rows.long]
        jobs += [
            (j, blob, short_rows, True)
            for j, blob in cols.long
            if col_limit is None or j < col_limit
        ]
        if not jobs:
            return out
        if self._progress_cb is not None:
            self._progress_total += sum(len(j[2]) for j in jobs)

        def one(job):
            idx, blob, others, flipped = job
            hits = []
            for k, other in others:
                sim = int(matchHashBytes(blob, other, TOL))
                if sim >= min_sim:
                    hits.append((k, idx, sim) if flipped else (idx, k, sim))
            return hits

        with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as ex:
            for job, hits in zip(jobs, ex.map(one, jobs)):
                out.extend(hits)
                if self._progress_cb is not None:
                    self._progress_done += len(job[2])
                    self._progress_cb(self._progress_done, self._progress_total)
        return out

    #: device tiles kept in flight before forcing a host transfer — jax
    #: dispatch is async, so the device computes tile k+1..k+N while the
    #: host extracts hits from tile k (bounded to cap HBM held by results)
    MAX_TILES_IN_FLIGHT = 4

    #: row tiles drained per fused extract call in the segment route; the
    #: route keeps 2x this many sweep results in flight (device memory held
    #: by mask results: 2 * DRAIN_GROUP * ~134 MB at 1M-video column
    #: width), shrunk to fit the memory plan's drain budget
    DRAIN_GROUP = 8

    #: column tiles per streaming-fill flush (host buffer ~16 MB; one
    #: donated device update per group — see _segment_route staging)
    COL_FILL_GROUP = 32

    def _collect_hits(self, out, cnt_dev, sim_dev, meta, r_idx, c_idx, min_sim, col_limit=None):
        i0, j0, ri_n, cj_n = meta
        if self._progress_cb is not None:
            cj_eff = cj_n
            if col_limit is not None:  # count only in-limit columns
                cj_eff = int(np.searchsorted(c_idx[j0 : j0 + cj_n], col_limit))
            self._progress_done += ri_n * cj_eff
            self._progress_cb(self._progress_done, self._progress_total)
        # device-side gate: most tiles of a real corpus contain no hits, so
        # fetch a 4-byte count instead of the full [tr, tc] int32 block
        if int(cnt_dev) == 0:
            return
        sim = np.asarray(sim_dev)
        hits = np.argwhere(sim >= min_sim)
        for a, b in hits:
            if a < ri_n and b < cj_n:
                cj = int(c_idx[j0 + b])
                if col_limit is not None and cj >= col_limit:
                    continue
                out.append((int(r_idx[i0 + a]), cj, int(sim[a, b])))

    def _put_rows(self, arr: np.ndarray):
        """Row-block array onto the device(s) once per row block."""
        if self.mesh is None:
            return jnp.asarray(arr)
        from jax.sharding import NamedSharding, PartitionSpec as P

        return jax.device_put(
            arr, NamedSharding(self.mesh, P(tuple(self.mesh.axis_names)))
        )

    def _put_cols(self, arr: np.ndarray):
        """Column-tile array onto the device(s) ONCE — column tiles are
        reused by every row block; re-uploading them per row block cost a
        measured ~5 GB of redundant H2D in a 32k-video sweep."""
        if self.mesh is None:
            return jnp.asarray(arr)
        from jax.sharding import NamedSharding, PartitionSpec as P

        return jax.device_put(arr, NamedSharding(self.mesh, P()))

    def _device_fill(self, shape, dtype, value):
        """Constant array allocated directly ON the device(s) — no host
        staging copy (a 10M-column padded staging is ~5 GB); replicated
        under a mesh."""
        if self.mesh is None:
            return jnp.full(shape, value, dtype)
        from jax.sharding import NamedSharding, PartitionSpec as P

        return jax.jit(
            lambda: jnp.full(shape, value, dtype),
            out_shardings=NamedSharding(self.mesh, P()),
        )()

    def _stream_tiles(self, row_blocks, col_tiles, compute, r_idx, c_idx, min_sim, col_limit=None):
        """Shared tile-streaming machinery for both engine routes: iterate
        (row block x column tile), keep MAX_TILES_IN_FLIGHT device results
        pending, drain through the hit-count gate.

        row_blocks: iterable of (i0, ri_n, row_args); col_tiles: list of
        (j0, cj_n, col_args); compute(row_args, col_args) -> device sim.
        Under col_limit, column tiles that start at or past the limit are
        skipped entirely (c_idx is ascending within a bucket); the boundary
        tile computes and is filtered in _collect_hits.
        """
        out = []
        inflight: deque = deque()
        min_sim_dev = jnp.int32(min_sim)
        for i0, ri_n, row_args in row_blocks:
            for j0, cj_n, col_args in col_tiles:
                if col_limit is not None and int(c_idx[j0]) >= col_limit:
                    continue
                sim_dev = compute(row_args, col_args)
                cnt = _hit_count(sim_dev, min_sim_dev)
                inflight.append((cnt, sim_dev, (i0, j0, ri_n, cj_n)))
                while len(inflight) >= self.MAX_TILES_IN_FLIGHT:
                    self._collect_hits(out, *inflight.popleft(), r_idx, c_idx, min_sim, col_limit)
        while inflight:
            self._collect_hits(out, *inflight.popleft(), r_idx, c_idx, min_sim, col_limit)
        return out

    def _bucket_pair(
        self, pa, r_idx, r_frames, r_counts, pb, c_idx, c_frames, c_counts, min_sim,
        col_cache=None, row_pm1_cache=None, col_limit=None,
    ):
        # scale tiles to the bucket frame counts so the materialized
        # frame-pair block stays bounded (~32 MB int32) for any bucket
        tr = _tile_videos(self.tile_rows, TILE_ROW_FRAMES, pa)
        tc = _tile_videos(self.tile_cols, TILE_COL_FRAMES, pb)
        if self.mesh is not None:
            n = self.mesh.devices.size
            tr = max(n, (tr // n) * n)
        # device col tiles depend only on pb; cache across row buckets
        cache_key = ("tile", pb)
        col_tiles = None if col_cache is None else col_cache.get(cache_key)
        if col_tiles is None:
            col_tiles = []
            for j0 in range(0, len(c_idx), tc):
                cj = slice(j0, min(j0 + tc, len(c_idx)))
                col_tiles.append((
                    j0,
                    cj.stop - cj.start,
                    (
                        self._put_cols(_pad_rows(c_frames[cj], tc)),
                        self._put_cols(_pad_rows(c_counts[cj], tc)),
                    ),
                ))
            if col_cache is not None:
                col_cache[cache_key] = col_tiles

        def row_blocks():
            for i0 in range(0, len(r_idx), tr):
                ri = slice(i0, min(i0 + tr, len(r_idx)))
                rf = self._put_rows(_pad_rows(r_frames[ri], tr))
                rc = self._put_rows(_pad_rows(r_counts[ri], tr))
                yield i0, ri.stop - ri.start, (rf, rc)

        def compute(row_args, col_args):
            rf, rc = row_args
            cf, cc = col_args
            if self.mesh is not None:
                return sharded_tile_similarity(self.mesh, rf, rc, cf, cc, pa, pb)
            return _tile_similarity(rf, rc, cf, cc, pa, pb)

        return self._stream_tiles(
            row_blocks(), col_tiles, compute, r_idx, c_idx, min_sim, col_limit
        )


# ---------------------------------------------------------------------------
# Sharded (multi-device) tile computation
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=64)
def _sharded_tile_fn(mesh, pa: int, pb: int):
    """Jitted shard_map wrapper for the XLA tile, cached per (mesh, pa, pb)
    — rebuilding the closure per tile would retrace in the hot loop."""
    from jax.sharding import PartitionSpec as P
    from .mesh import shard_map

    rows = P(tuple(mesh.axis_names))

    def slab(rp, rc, cp, cc):
        return _tile_similarity(rp, rc, cp, cc, pa, pb)

    return jax.jit(
        shard_map(
            slab,
            mesh=mesh,
            in_specs=(rows, rows, P(), P()),
            out_specs=rows,
        )
    )


def sharded_tile_similarity(mesh, rows_packed, rows_counts, cols_packed, cols_counts, pa, pb):
    """Row-sharded tile similarity over a 1-D mesh.

    rows_* are sharded on the leading axis (device slabs), cols_* are
    replicated; each device computes its slab of the similarity matrix.
    The result is sharded the same way as the rows. (device_put of an
    already correctly-placed array is a no-op, so callers may pre-place
    tiles that are reused across calls.)
    """
    from jax.sharding import NamedSharding, PartitionSpec as P

    rows = P(tuple(mesh.axis_names))
    rows_packed = jax.device_put(rows_packed, NamedSharding(mesh, rows))
    rows_counts = jax.device_put(rows_counts, NamedSharding(mesh, rows))
    cols_packed = jax.device_put(cols_packed, NamedSharding(mesh, P()))
    cols_counts = jax.device_put(cols_counts, NamedSharding(mesh, P()))
    return _sharded_tile_fn(mesh, pa, pb)(
        rows_packed, rows_counts, cols_packed, cols_counts
    )
