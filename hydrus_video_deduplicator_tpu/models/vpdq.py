"""Video-level device hashing: decode-parallel, device-batched VPDQ.

The reference hashes one video at a time through a CPU thread pool
(vpdqpy.py:104-119). On an accelerator the economics invert: the PDQ
program wants large batches, and decode (CPU) must run ahead of the
device. This module provides the device hashing pipeline:

    files -> [decode pool: N workers] -> frame batches [B, 512, 512, 3]
          -> XLA PDQ program (models/pdq.py) -> (hash words, quality)
          -> regroup by video, quality-filter, pack -> VpdqHash per file

Frames from many videos share device batches (ragged videos are flattened
into a frame stream with video ids), so the device stays busy regardless
of video length. Failure semantics match the reference: a video that fails
to decode yields a typed failure and never poisons the batch.
"""

from __future__ import annotations

import logging
import queue
import threading
from collections.abc import Callable, Iterable, Iterator
from dataclasses import dataclass

import numpy as np

from ..vpdq import VpdqHash
from ..vpdq import pdq_math as pm
from ..decode import extract_frames

log = logging.getLogger("vpdq-device")

#: smallest padded batch shape for partial flushes. Padding travels H2D
#: (786 KB/frame), so a partial final flush pads to the smallest
#: power-of-two bucket >= its real frame count instead of the full batch —
#: a 32-frame flush otherwise ships a 94%-zeros 403 MB batch. The ladder
#: {32, 64, ..., batch} bounds the number of compiled shapes at 5 for the
#: GPU's 512-frame batch (device.Capabilities.hash_batch).
MIN_BUCKET = 32
#: decode worker threads feeding the device
DECODE_WORKERS = 4
#: bounded buffer of decoded frames (backpressure, like the reference's
#: bounded native queue — vpdqpy.py:114-118); 2x the GPU's 512-frame batch
#: so decode keeps filling while a full batch is on the device
FRAME_BUFFER_FRAMES = 1024


class _ConsumerAborted(Exception):
    """Internal: the batch consumer died; decode workers must exit."""


@dataclass
class VideoResult:
    key: object
    phash: VpdqHash | None
    error: Exception | None = None
    #: frames decoded+hashed for this video (incl. quality-dropped frames —
    #: they cost decode + H2D all the same); lets callers size work chunks
    n_frames: int = 0


def _hash_batch_fn(mesh=None):
    """The device hash function: frames [B, 512, 512, 3] u8 -> (words,
    quality) through the XLA PDQ program (models/pdq.py).

    With a mesh, the batch axis is sharded over the devices via shard_map
    (each device hashes its slab — pure data parallelism, no collectives).
    """
    import jax

    from .pdq import ZERO, pdq_hash_batch, pdq_hash_batch_jit

    if mesh is None:
        return pdq_hash_batch_jit

    from jax.sharding import NamedSharding, PartitionSpec as P
    from ..parallel.mesh import shard_map

    rows = P(mesh.axis_names[0])
    fn = jax.jit(
        shard_map(
            pdq_hash_batch, mesh=mesh, in_specs=(rows, P()), out_specs=(rows, rows)
        )
    )
    sharding = NamedSharding(mesh, rows)

    def sharded(frames):
        return fn(jax.device_put(frames, sharding), ZERO)

    return sharded


class TpuVideoHasher:
    """Batched hashing of many videos on the device.

    Usage: ``results = TpuVideoHasher().hash_videos(items)`` where items
    yields (key, video_bytes_or_path); results preserve input order.
    """

    def __init__(
        self,
        batch_size: int | None = None,
        decode_workers: int | None = None,
        quality_min: int = pm.QUALITY_MIN_KEEP,
        sampling: str = "uniform",
        mesh=None,
    ):
        """decode_workers follows the reference's job-count convention
        (entrypoint.py:79-82): n > 0 explicit, 0 -> default, negative ->
        cores + 1 + n (so -1 = all cores, -2 = all but one).

        mesh: optional 1-D jax.sharding.Mesh; frame batches are sharded
        over its devices (batch_size is rounded up to a multiple of the
        mesh size)."""
        if decode_workers is None or decode_workers == 0:
            decode_workers = DECODE_WORKERS
        elif decode_workers < 0:
            import os

            decode_workers = max(1, (os.cpu_count() or 2) + 1 + decode_workers)
        if batch_size is None:
            from .. import device

            batch_size = device.capabilities().hash_batch
        if mesh is not None:
            n = mesh.devices.size
            batch_size = ((batch_size + n - 1) // n) * n
        self.batch_size = batch_size
        self.decode_workers = decode_workers
        self.quality_min = quality_min
        self.sampling = sampling
        self.mesh = mesh
        self._hash_batch = _hash_batch_fn(mesh)

    def _pad_target(self, n: int) -> int:
        """Padded shape for an n-frame flush: the smallest power-of-two
        bucket >= n (from MIN_BUCKET up to batch_size, rounded to a mesh
        multiple) — see MIN_BUCKET. Full batches return batch_size."""
        b = MIN_BUCKET
        while b < n:
            b *= 2
        b = min(b, self.batch_size)
        if self.mesh is not None:
            m = int(self.mesh.devices.size)
            b = ((b + m - 1) // m) * m
        return max(b, n)

    # -- decode stage -----------------------------------------------------

    @staticmethod
    def _abortable_put(out: "queue.Queue", item, abort: "threading.Event") -> None:
        """Bounded-queue put that gives up when the consumer aborted —
        otherwise a device-side failure would leave workers blocked on a
        full queue forever (thread + frame-buffer leak)."""
        while True:
            try:
                out.put(item, timeout=0.25)
                return
            except queue.Full:
                if abort.is_set():
                    raise _ConsumerAborted()

    def _decode_worker(self, jobs: "queue.Queue", out: "queue.Queue", abort) -> None:
        """Streams ('frame', idx, frame_no, rgb) messages through the
        frame-bounded queue (true decode->device backpressure: memory is
        bounded by frames in flight, not videos), then a
        ('done', idx, n_frames, error) terminator per video."""
        while True:
            item = jobs.get()
            if item is None:
                return
            idx, _key, video = item
            n = 0
            try:
                for f in extract_frames(video, sampling=self.sampling):
                    self._abortable_put(
                        out, ("frame", idx, n, np.ascontiguousarray(f)), abort
                    )
                    n += 1
                self._abortable_put(out, ("done", idx, n, None), abort)
            except _ConsumerAborted:
                return
            except Exception as exc:  # typed failure, never poisons the batch
                try:
                    self._abortable_put(out, ("done", idx, n, exc), abort)
                except _ConsumerAborted:
                    return

    # -- main pipeline -----------------------------------------------------

    def hash_videos(
        self,
        items: Iterable[tuple[object, bytes | str]],
        progress: Callable[[int, int], None] | None = None,
    ) -> list[VideoResult]:
        items = list(items)
        errors: dict[int, Exception] = {}

        jobs: "queue.Queue" = queue.Queue()
        decoded: "queue.Queue" = queue.Queue(maxsize=FRAME_BUFFER_FRAMES)
        abort = threading.Event()
        for idx, (key, video) in enumerate(items):
            jobs.put((idx, key, video))
        workers = []
        n_workers = min(self.decode_workers, max(1, len(items)))
        for _ in range(n_workers):
            jobs.put(None)
            t = threading.Thread(
                target=self._decode_worker, args=(jobs, decoded, abort), daemon=True
            )
            t.start()
            workers.append(t)

        # accumulate frames across videos into device batches
        pending_frames: list[np.ndarray] = []  # rgb [512,512,3]
        pending_owner: list[tuple[int, int]] = []  # (video idx, frame_no)
        hashes_per_video: dict[int, list[tuple[int, bytes]]] = {
            i: [] for i in range(len(items))
        }
        done_decoding = 0

        # one device batch stays in flight while the host keeps decoding:
        # jax dispatch is async, so submit returns immediately and the
        # np.asarray in drain is where the host actually waits
        from collections import deque

        inflight: deque = deque()

        def drain_one():
            words_dev, qual_dev, owners, n = inflight.popleft()
            words = np.asarray(words_dev)[:n]
            qual = np.asarray(qual_dev)[:n]
            from .pdq import words_to_blobs

            blobs = words_to_blobs(words)
            for i in range(n):
                owner, frame_no = owners[i]
                blob = blobs[i] if qual[i] >= self.quality_min else b""
                hashes_per_video[owner].append((frame_no, blob))

        def flush(batch_frames, batch_owner):
            if not batch_frames:
                return
            batch = np.stack(batch_frames)
            n = batch.shape[0]
            target = self._pad_target(n)
            if n < target:  # pad to the bucket's compiled shape
                pad = np.zeros((target - n,) + batch.shape[1:], dtype=batch.dtype)
                batch = np.concatenate([batch, pad])
            words_dev, qual_dev = self._hash_batch(batch)
            inflight.append((words_dev, qual_dev, batch_owner, n))
            while len(inflight) > 1:
                drain_one()

        try:
            while done_decoding < len(items):
                msg = decoded.get()
                if msg[0] == "frame":
                    _, idx, frame_no, frame = msg
                    pending_frames.append(frame)
                    pending_owner.append((idx, frame_no))
                    if len(pending_frames) >= self.batch_size:
                        flush(pending_frames, pending_owner)
                        pending_frames, pending_owner = [], []
                else:  # ("done", idx, n_frames, error)
                    _, idx, _n, exc = msg
                    done_decoding += 1
                    if exc is not None:
                        errors[idx] = exc
                    if progress:
                        progress(done_decoding, len(items))
            flush(pending_frames, pending_owner)
            while inflight:
                drain_one()
        except BaseException:
            # device/hash failure (or CTRL+C): release workers blocked on
            # the bounded queue before propagating — otherwise they leak,
            # each holding up to the full frame buffer in memory
            abort.set()
            while True:
                try:
                    decoded.get_nowait()
                except queue.Empty:
                    break
            for t in workers:
                t.join(timeout=5.0)
            raise
        for t in workers:
            t.join()

        out: list[VideoResult] = []
        for idx, (key, _video) in enumerate(items):
            if idx in errors:  # decode failure: drop any partial hashes
                out.append(VideoResult(key, None, errors[idx]))
                continue
            parts = sorted(hashes_per_video[idx])
            blob = b"".join(b for _, b in parts)
            out.append(VideoResult(key, VpdqHash(blob), n_frames=len(parts)))
        return out
