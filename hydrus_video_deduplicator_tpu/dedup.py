"""The 4-stage resumable dedupe orchestrator.

Reference behavior: /root/reference/src/hydrusvideodeduplicator/dedup.py
(HydrusVideoDeduplicator, FileHasher, progress dataclasses, per-file failure
handling, periodic commits, CTRL+C checkpointing).

Stages (each independently interruptible; progress persists in SQLite):
  1. hash videos           -> phashed_file_queue         (commit every 4)
  2. drain queue           -> tables + VP-tree insert    (commit every 64)
  3. tree maintenance      -> branch rebuilds if due
  4. search for duplicates -> mark pairs in Hydrus       (commit every 64)

Stage 4 has two engines with identical observable semantics:
  - "tree": the reference's VP-tree descent (per-file, incremental)
  - "tpu":  the exact all-pairs device engine (parallel/engine.py; the
            value names the accelerator, a GPU today) — default when a
            batch of files needs searching; strictly more correct than the
            tree (no metric assumption) and orders of magnitude faster at
            corpus scale.
Both honor the shape_search_cache contract, so runs are incremental and the
two engines can be mixed across runs.
"""

from __future__ import annotations

import functools
import gc
import logging
import time
from dataclasses import dataclass
from typing import TYPE_CHECKING

try:
    from rich import print
except ImportError:  # pragma: no cover
    pass

try:
    from tqdm import tqdm
except ImportError:  # pragma: no cover - progress bars are optional
    from .dedup_util import NoProgress as tqdm

from .client import HVDClient
from .client import hydrus_api
from .db import DedupeDB, vptree
from .hashing import compute_phash
from .page_logger import HydrusPageLogger

if TYPE_CHECKING:
    from collections.abc import Callable, Sequence
    from typing import TypeAlias

    FileHash = str

log = logging.getLogger("hvd")


# ---------------------------------------------------------------------------
# results / failures / progress
# ---------------------------------------------------------------------------


@dataclass
class PerceptuallyHashedFile:
    file_hash: "FileHash"
    perceptual_hash: bytes


@dataclass
class FailedPerceptuallyHashedFile:
    file_hash: "FileHash"
    exc: Exception


class HydrusApiException(Exception):
    """Wrapper that decouples FileHasher callers from the API library."""


class FailedPerceptualHashException(Exception):
    def __init__(self, file_hash: "FileHash", other_exc: str = ""):
        super().__init__()
        self.file_hash = file_hash
        self.other_exc = other_exc


@dataclass
class PerceptualHashingStats:
    success_hash_count: int = 0
    failed_from_api_errors_count: int = 0
    failed_from_phash_count: int = 0


class CancelledPerceptualHashException(Exception):
    def __init__(self, stats: PerceptualHashingStats):
        super().__init__()
        self.stats = stats


@dataclass
class NoneProgress:
    placeholder: None = None


@dataclass
class HashingProgress:
    complete: int
    total: int


@dataclass
class BuildingSearchTreeProgress:
    complete: int
    total: int


@dataclass
class SearchingForDuplicatesProgress:
    complete: int
    total: int


@dataclass
class DoneProgress:
    placeholder: None = None


@dataclass
class DedupeProgress:
    progress: (
        NoneProgress
        | HashingProgress
        | BuildingSearchTreeProgress
        | SearchingForDuplicatesProgress
        | DoneProgress
    )


if TYPE_CHECKING:
    UpdateDedupeProgressCallback: TypeAlias = Callable[[DedupeProgress], None]


# ---------------------------------------------------------------------------
# FileHasher
# ---------------------------------------------------------------------------


class FileHasher:
    """Fetch a file from Hydrus and perceptually hash it, with typed
    failure results and a cool-down after API errors."""

    API_ERROR_BACKOFF_SECONDS = 3

    def __init__(self, client: HVDClient, num_threads: int = 0, sampling: str = "uniform"):
        self.client = client
        self.num_threads = num_threads
        self.sampling = sampling

    def _fetch_file(self, file_hash: str) -> bytes:
        try:
            response = self.client.client.get_file(hash_=file_hash)
        except hydrus_api.HydrusAPIException as exc:
            raise HydrusApiException(exc)
        return response.content

    def _phash_file(self, file: bytes) -> bytes:
        try:
            phash_bytes = compute_phash(file, self.num_threads, sampling=self.sampling).bytes
        except Exception as exc:
            raise FailedPerceptualHashException("", str(exc))
        # Empty hashes are legitimate (all frames below quality floor).
        if phash_bytes is None or len(phash_bytes) % 32 != 0:
            raise FailedPerceptualHashException("", "phash was None or not a multiple of 32 bytes.")
        return phash_bytes

    def fetch_and_phash_file(
        self, file_hash: str
    ) -> PerceptuallyHashedFile | FailedPerceptuallyHashedFile:
        try:
            file = self._fetch_file(file_hash)
        except HydrusApiException as exc:
            # brief cool-down so one transient API failure doesn't cascade
            time.sleep(self.API_ERROR_BACKOFF_SECONDS)
            return FailedPerceptuallyHashedFile(file_hash, exc)
        try:
            phash = self._phash_file(file)
        except FailedPerceptualHashException as exc:
            return FailedPerceptuallyHashedFile(file_hash, exc)
        return PerceptuallyHashedFile(file_hash, phash)


# ---------------------------------------------------------------------------
# Orchestrator
# ---------------------------------------------------------------------------


class HydrusVideoDeduplicator:
    hydlog = log
    threshold: float = 75.0
    _DEBUG = False

    HASH_COMMIT_BATCH = 4
    TREE_COMMIT_BATCH = 64
    #: queue rows per set-based stage-2 drain batch (deferred-descent
    #: route); each batch commits, so this is also the interrupt
    #: granularity of stage 2 on the device backend
    QUEUE_DRAIN_BATCH = 50_000
    SEARCH_COMMIT_BATCH = 64
    #: row files per checkpointed device-search chunk: after each chunk its
    #: pairs are marked and its search-cache entries committed, bounding
    #: the work an interrupt can lose while keeping device batches large.
    #: At corpus scale the chunk size grows so the total chunk count stays
    #: <= SEARCH_MAX_CHUNKS (per-chunk fixed costs — row packing/upload,
    #: drain pipeline flush, verify dispatches, SQLite row fetch — measured
    #: ~10-13 s/chunk at 1M files on the r04 64-chunk schedule, i.e. the
    #: production run spent ~700 s more than the 8-chunk engine driver on
    #: the same corpus; 16 chunks keeps the loss bounded at ~1/16 of a run
    #: while giving up < 2 min of fixed costs at 1M). Override with
    #: HVD_SEARCH_MAX_CHUNKS for finer checkpoints.
    SEARCH_CHECKPOINT_ROWS = 8192
    SEARCH_MAX_CHUNKS = 16
    #: use the device engine when at least this many files need searching
    TPU_ENGINE_MIN_BATCH = 16

    def __init__(
        self,
        db: DedupeDB.DedupeDb,
        client: HVDClient,
        job_count: int = -2,
        failed_page_name: str | None = None,
        custom_query: "Sequence[str] | None" = None,
        update_progress_callback: "UpdateDedupeProgressCallback | None" = None,
        should_skip_step_fn: "Callable[[], bool] | None" = None,
        search_backend: str = "auto",  # "auto" | "tree" | "tpu"
        search_prefilter: str = "auto",  # "auto" | "reps" | "none"
        hash_backend: str = "auto",  # "auto" | "native" | "tpu"
        sampling: str = "uniform",  # "uniform" (reference parity) | "scene"
        rerank: str = "none",  # "none" | "clip" (stretch goal: embedding gate)
        rerank_weights: str | None = None,
        rerank_threshold: float = 0.85,
    ):
        self.db = db
        self.client = client
        self.job_count = job_count
        self.page_logger = (
            None if failed_page_name is None else HydrusPageLogger(client, failed_page_name)
        )
        self.search_tags = self.get_search_tags(custom_query)
        self.update_progress_callback = update_progress_callback
        if self.update_progress_callback:
            self.update_progress_callback(NoneProgress())
        self.should_skip_step_fn = should_skip_step_fn
        self.search_backend = search_backend
        self.search_prefilter = search_prefilter
        self.hash_backend = hash_backend
        self.sampling = sampling
        self.reranker = None
        if rerank == "clip":
            if not rerank_weights:
                raise ValueError("--rerank clip requires --rerank-weights")
            from .rerank import ClipReranker

            self.reranker = ClipReranker(
                rerank_weights, threshold=rerank_threshold, sampling=sampling
            )
        elif rerank != "none":
            raise ValueError(f"unknown rerank mode: {rerank!r}")

    def _pair_passes_rerank(self, hash_a: str, hash_b: str) -> bool:
        """Embedding gate for a candidate pair (always True when the
        rerank stage is disabled)."""
        if self.reranker is None:
            return True
        return self.reranker.pair_passes(hash_a, hash_b, self.client.get_video)

    def _print_rerank_summary(self) -> None:
        if self.reranker is not None and self.reranker.pairs_checked:
            print(
                f"[blue] Rerank: {self.reranker.pairs_rejected} of"
                f" {self.reranker.pairs_checked} candidate pairs rejected by"
                f" the embedding gate."
            )

    @staticmethod
    def _device_mesh():
        """1-D mesh over all devices when more than one is visible, else
        None. Both device paths (hashing, search) shard their leading batch
        axis over it; single-device behavior is unchanged."""
        from .parallel.mesh import build_mesh, device_count

        return build_mesh() if device_count() > 1 else None

    # -- stage 0: discovery ------------------------------------------------

    def get_search_tags(self, custom_query: "Sequence[str] | None") -> list[str]:
        search_tags = [
            "system:filetype=video, gif, apng",
            "system:has duration",
            "system:file service is not currently in trash",
        ]
        if custom_query is not None:
            custom_query = [q for q in custom_query if q.strip()]
            if custom_query:
                search_tags.extend(custom_query)
                print(f"[yellow] Custom Query: {custom_query}")
        return search_tags

    def filter_unhashed(self, file_hashes: "list[FileHash]") -> "list[FileHash]":
        already = set(self.db.get_phashed_files())
        return [h for h in file_hashes if h not in already]

    # -- top level ---------------------------------------------------------

    def deduplicate(self, skip_hashing: bool) -> int:
        """Run the full pipeline; returns the number of similar pairs found."""
        num_similar_pairs = 0

        if skip_hashing:
            print("[yellow] Skipping perceptual hashing")
        else:
            video_hashes = list(self.client.get_video_hashes(self.search_tags))
            video_hashes = self.filter_unhashed(video_hashes)
            print(f"[blue] Found {len(video_hashes)} eligible files to perceptually hash.")
            print("\nTip: You can skip perceptual hashing at any time by pressing CTRL+C.")
            self.db.begin_transaction()
            with self.db.conn:
                stats = PerceptualHashingStats()
                try:
                    stats = self.add_perceptual_hashes_to_db(video_hashes)
                except CancelledPerceptualHashException as exc:
                    stats = exc.stats
                    print("[yellow] Perceptual hash processing was interrupted! Progress was saved.")
                else:
                    print("[green] Finished perceptual hash processing.")
                finally:
                    if self.update_progress_callback:
                        self.update_progress_callback(NoneProgress())
                    self._print_hashing_stats(stats)

        print("\nTip: You can skip building the search tree at any time by pressing CTRL+C.")
        self.db.begin_transaction()
        with self.db.conn:
            try:
                self.process_phashed_file_queue()
            except KeyboardInterrupt:
                print("[yellow] Building the search tree was interrupted! Progress was saved.")
            else:
                print("[green] Finished fully building the search tree.")

        self.db.begin_transaction()
        with self.db.conn:
            try:
                self.run_maintenance()
            except KeyboardInterrupt:
                print("[yellow] Maintenance was interrupted!")
            else:
                print("[green] Finished maintenance.")

        pre_dedupe_count = self.client.get_potential_duplicate_count_hydrus()

        print("\nTip: You can skip finding potential duplicates at any time by pressing CTRL+C.")
        self.db.begin_transaction()
        with self.db.conn:
            try:
                num_similar_pairs = self.find_potential_duplicates()
            except KeyboardInterrupt:
                if getattr(self, "_last_search_backend", "tree") == "tpu":
                    # the engine checkpoints per SEARCH_CHECKPOINT_ROWS
                    # chunk: completed chunks' pairs are marked and their
                    # cache entries committed; only the in-flight chunk
                    # is redone next run
                    print(
                        "[yellow] Searching for duplicates was interrupted!"
                        " Completed search chunks were saved; the next run"
                        " redoes only the interrupted chunk."
                    )
                else:
                    print("[yellow] Searching for duplicates was interrupted! Progress was saved.")

        self._print_rerank_summary()
        post_dedupe_count = self.client.get_potential_duplicate_count_hydrus()
        new_count = post_dedupe_count - pre_dedupe_count
        if new_count > 0:
            print(f"[green] {new_count} new potential duplicate pairs marked for manual processing!")
        else:
            print("[green] No new potential duplicate pairs found.")

        log.info("%d similar file pairs found.", num_similar_pairs)
        log.info("Deduplication done.")
        if self.update_progress_callback:
            self.update_progress_callback(DoneProgress())
        return num_similar_pairs

    def _print_hashing_stats(self, stats: PerceptualHashingStats) -> None:
        total_failures = stats.failed_from_api_errors_count + stats.failed_from_phash_count
        if total_failures > 0:
            print(f"[yellow] Perceptual hash processing had {total_failures} total failed files.")
            if stats.failed_from_api_errors_count > 0:
                print(
                    f"[yellow] {stats.failed_from_api_errors_count} failures were due to API"
                    " errors. Ensure Hydrus is running and accessible before trying again."
                )
            if stats.failed_from_phash_count > 0:
                print(
                    f"[yellow] {stats.failed_from_phash_count} failures were from an error"
                    " during perceptual hashing. Are the files corrupted?"
                )
                print(
                    "\nTip: You could have seen which files failed directly in Hydrus by"
                    " creating a Hydrus page with the name 'failed' and running the"
                    " program with '--failed-page-name=failed'\n"
                )
        print(f"[green] Added {stats.success_hash_count} new perceptual hashes to the database.")

    # -- stage 1: hashing --------------------------------------------------

    #: use the device hash path (when "auto") only with at least this many
    #: files — below it the per-batch dispatch overhead never amortizes
    TPU_HASH_MIN_BATCH = 64

    def _pick_hash_backend(self, num_files: int) -> str:
        """Resolve the stage-1 backend ("auto" mirrors _pick_search_backend:
        the device when the batch is big enough and the platform hashes on
        the device — device.Capabilities.device_hashing)."""
        if self.hash_backend in ("native", "tpu"):
            return self.hash_backend
        if num_files < self.TPU_HASH_MIN_BATCH:
            return "native"
        from . import device

        backend = "tpu" if device.capabilities().device_hashing else "native"
        log.info("hash backend auto: %s", "device" if backend == "tpu" else backend)
        return backend

    def add_perceptual_hashes_to_db(self, video_hashes: "Sequence[str]") -> PerceptualHashingStats:
        if self._pick_hash_backend(len(video_hashes)) == "tpu":
            return self._add_perceptual_hashes_to_db_tpu(video_hashes)
        return self._add_perceptual_hashes_to_db_native(video_hashes)

    def _add_perceptual_hashes_to_db_native(
        self, video_hashes: "Sequence[str]"
    ) -> PerceptualHashingStats:
        stats = PerceptualHashingStats()
        try:
            with tqdm(
                total=len(video_hashes),
                desc="Perceptually hashing files",
                dynamic_ncols=True,
                unit="file",
                colour="BLUE",
            ) as pbar:
                hasher = FileHasher(self.client, self.job_count, sampling=self.sampling)
                success_count = 0
                for video_hash in video_hashes:
                    if self.update_progress_callback:
                        self.update_progress_callback(
                            HashingProgress(complete=pbar.n + 1, total=pbar.total)
                        )
                    if self.should_skip_step_fn and self.should_skip_step_fn():
                        return stats

                    result = hasher.fetch_and_phash_file(video_hash)
                    if isinstance(result, FailedPerceptuallyHashedFile):
                        if isinstance(result.exc, HydrusApiException):
                            stats.failed_from_api_errors_count += 1
                            print("[red] Hydrus API error during perceptual hashing:")
                            print(f"{result.exc}")
                        else:
                            stats.failed_from_phash_count += 1
                            print("[red] Failed to perceptually hash a file.")
                            print(f"Failed file SHA256 hash: {result.file_hash}")
                            print(f"{result.exc}")
                            if self.page_logger:
                                self.page_logger.add_failed_video(result.file_hash)
                    else:
                        self.db.add_to_phashed_files_queue(result.file_hash, result.perceptual_hash)
                        stats.success_hash_count += 1
                        success_count += 1
                        if success_count % self.HASH_COMMIT_BATCH == 0:
                            self.db.commit()

                    gc.collect()  # bound memory held by video bytes/frames
                    pbar.update(1)
                    if self.update_progress_callback:
                        self.update_progress_callback(
                            HashingProgress(complete=pbar.n, total=pbar.total)
                        )
        except KeyboardInterrupt:
            raise CancelledPerceptualHashException(stats)
        gc.collect()
        return stats

    #: files fetched+hashed per device round in the device hashing path.
    #: TPU_HASH_CHUNK is the floor (and the conservative first-chunk size —
    #: frames/file and bytes/file are unknown until something is hashed);
    #: later chunks adapt to carry ~2 device batches of frames each, so a
    #: short-video corpus doesn't pay a padded partial device flush per 16
    #: files. The cap bounds files in flight, and the fetch-RAM cap bounds
    #: the bytes a chunk may hold (2 chunks are resident at once: the one
    #: hashing and the one prefetching).
    TPU_HASH_CHUNK = 16
    TPU_HASH_CHUNK_MAX = 512
    TPU_HASH_FETCH_RAM_CAP = 1 << 30

    def _add_perceptual_hashes_to_db_tpu(
        self, video_hashes: "Sequence[str]"
    ) -> PerceptualHashingStats:
        """Device-batched hashing: fetch a chunk of files, decode in a thread
        pool, hash all their frames in shared device batches, then commit.
        Same failure/stat/commit semantics as the native path; CTRL+C
        checkpoints at chunk boundaries."""
        from .models.vpdq import TpuVideoHasher

        stats = PerceptualHashingStats()
        hasher = TpuVideoHasher(
            decode_workers=self.job_count,
            sampling=self.sampling,
            mesh=self._device_mesh(),
        )

        def fetch_chunk(chunk) -> list[tuple[str, bytes]]:
            """Per-file API failure isolation (FileHasher semantics)."""
            fetched: list[tuple[str, bytes]] = []
            for file_hash in chunk:
                try:
                    response = self.client.client.get_file(hash_=file_hash)
                    fetched.append((file_hash, response.content))
                except hydrus_api.HydrusAPIException as exc:
                    stats.failed_from_api_errors_count += 1
                    print("[red] Hydrus API error during perceptual hashing:")
                    print(f"{exc}")
                    time.sleep(FileHasher.API_ERROR_BACKOFF_SECONDS)
            return fetched

        # adaptive chunk sizing state: cumulative means over hashed files
        n_seen_frames = [0, 0]  # [files, frames]
        n_seen_bytes = [0, 0]  # [files, bytes]
        target_frames = 2 * hasher.batch_size

        def next_chunk_size() -> int:
            if n_seen_frames[0] == 0:
                return self.TPU_HASH_CHUNK
            mean_frames = max(1.0, n_seen_frames[1] / n_seen_frames[0])
            size = int(target_frames / mean_frames)
            if n_seen_bytes[0]:
                mean_bytes = max(1.0, n_seen_bytes[1] / n_seen_bytes[0])
                size = min(size, int(self.TPU_HASH_FETCH_RAM_CAP / mean_bytes))
            return max(self.TPU_HASH_CHUNK, min(size, self.TPU_HASH_CHUNK_MAX))

        try:
            from concurrent.futures import ThreadPoolExecutor

            with tqdm(
                total=len(video_hashes),
                desc="Perceptually hashing files (device)",
                dynamic_ncols=True,
                unit="file",
                colour="BLUE",
            ) as pbar, ThreadPoolExecutor(max_workers=1) as prefetcher:
                # fetch chunk k+1 while chunk k decodes/hashes so the decode
                # pool and the device never idle on network I/O
                pos = 0

                def submit_next():
                    nonlocal pos
                    if pos >= len(video_hashes):
                        return None, 0
                    chunk = video_hashes[pos : pos + next_chunk_size()]
                    pos += len(chunk)
                    return prefetcher.submit(fetch_chunk, chunk), len(chunk)

                future, chunk_len = submit_next()
                while future is not None:
                    if self.should_skip_step_fn and self.should_skip_step_fn():
                        return stats
                    if self.update_progress_callback:
                        self.update_progress_callback(
                            HashingProgress(complete=pbar.n, total=pbar.total)
                        )
                    fetched = future.result()
                    n_seen_bytes[0] += len(fetched)
                    n_seen_bytes[1] += sum(len(b) for _, b in fetched)
                    future_next, next_len = submit_next()
                    # decode + hash on device
                    for result in hasher.hash_videos(fetched):
                        if result.error is not None:
                            stats.failed_from_phash_count += 1
                            print("[red] Failed to perceptually hash a file.")
                            print(f"Failed file SHA256 hash: {result.key}")
                            print(f"{result.error}")
                            if self.page_logger:
                                self.page_logger.add_failed_video(result.key)
                        else:
                            self.db.add_to_phashed_files_queue(
                                result.key, result.phash.bytes
                            )
                            stats.success_hash_count += 1
                            n_seen_frames[0] += 1
                            n_seen_frames[1] += result.n_frames
                    self.db.commit()
                    gc.collect()
                    pbar.update(chunk_len)
                    if self.update_progress_callback:
                        self.update_progress_callback(
                            HashingProgress(complete=pbar.n, total=pbar.total)
                        )
                    future, chunk_len = future_next, next_len
        except KeyboardInterrupt:
            raise CancelledPerceptualHashException(stats)
        return stats

    # -- stage 2: queue -> tree -------------------------------------------

    def process_phashed_file_queue(self) -> None:
        (n_queued,) = self.db.execute(
            "SELECT count(*) FROM phashed_file_queue"
        ).fetchone()
        # the exact all-pairs engine never reads the VP-tree, so runs that
        # will search on it defer the per-insert tree descent entirely (at
        # corpus scale the descent — not hashing or search — would dominate
        # the pipeline). The decision mirrors stage 4's backend resolution
        # with the queue size as the corpus estimate; a wrong guess is
        # harmless because the tree path reconciles deferred phashes on
        # demand (_reconcile_tree).
        build_tree = self._pick_search_backend(n_queued) == "tree"
        if not build_tree:
            # deferred-descent route: drain the queue with set-based SQL
            # (~6 statements per batch vs ~10 per row; the per-row loop
            # measured ~1k rows/s at 1M rows — DedupeDB.drain_phashed_queue_batch)
            done = 0
            with tqdm(
                total=n_queued,
                desc="Binding hashed files",
                dynamic_ncols=True,
                unit="file",
                colour="BLUE",
            ) as pbar:
                # adaptive batch size: skip/interrupt is only checked
                # between batches, so batches target a few seconds of
                # wall each — start small, grow toward
                # QUEUE_DRAIN_BATCH while batches stay fast
                batch = min(self.QUEUE_DRAIN_BATCH, 4096)
                while done < n_queued:
                    if self.update_progress_callback:
                        self.update_progress_callback(
                            BuildingSearchTreeProgress(complete=done, total=n_queued)
                        )
                    if self.should_skip_step_fn and self.should_skip_step_fn():
                        return
                    t0 = time.monotonic()
                    n = self.db.drain_phashed_queue_batch(batch)
                    if n == 0:
                        break
                    done += n
                    self.db.commit()
                    pbar.update(n)
                    dt = time.monotonic() - t0
                    if dt < 1.0:
                        batch = min(batch * 2, self.QUEUE_DRAIN_BATCH)
                    elif dt > 4.0:
                        batch = max(batch // 2, 1024)
                if self.update_progress_callback:
                    self.update_progress_callback(
                        BuildingSearchTreeProgress(complete=n_queued, total=n_queued)
                    )
            return
        rows = self.db.execute("SELECT file_hash, phash FROM phashed_file_queue").fetchall()
        with tqdm(
            total=len(rows),
            desc="Building search tree",
            dynamic_ncols=True,
            unit="file",
            colour="BLUE",
        ) as pbar:
            for i, (file_hash, phash) in enumerate(rows, start=1):
                if self.update_progress_callback:
                    self.update_progress_callback(
                        BuildingSearchTreeProgress(complete=pbar.n, total=pbar.total)
                    )
                if self.should_skip_step_fn and self.should_skip_step_fn():
                    return
                self.db.add_file(file_hash)
                self.db.add_perceptual_hash(phash)
                self.db.associate_file_with_perceptual_hash(
                    file_hash, phash, build_tree=build_tree
                )
                self.db.execute(
                    "DELETE FROM phashed_file_queue WHERE file_hash = :f AND phash = :p",
                    {"f": file_hash, "p": phash},
                )
                if i % self.TREE_COMMIT_BATCH == 0:
                    self.db.commit()
                pbar.update(1)
                if self.update_progress_callback:
                    self.update_progress_callback(
                        BuildingSearchTreeProgress(complete=pbar.n, total=pbar.total)
                    )
            if self.update_progress_callback:
                self.update_progress_callback(
                    BuildingSearchTreeProgress(complete=len(rows), total=len(rows))
                )

    # -- stage 3: maintenance ---------------------------------------------

    def run_maintenance(self) -> None:
        tree = vptree.VpTreeManager(self.db)
        search_threshold = vptree.fix_vpdq_similarity(self.threshold)
        assert search_threshold > 0 and isinstance(search_threshold, int)
        if tree.maintenance_due(search_threshold):
            print("[blue] Running search tree maintenance...")
            tree.maintain_tree()

    # -- stage 4: search ---------------------------------------------------

    @staticmethod
    def _relationship_payload(hash_a: str, hash_b: str) -> dict:
        """The reference's potential-duplicate relationship (dedup.py:385-394)."""
        return {
            "hash_a": hash_a,
            "hash_b": hash_b,
            "relationship": int(hydrus_api.DuplicateStatus.POTENTIAL_DUPLICATES),
            "do_default_content_merge": True,
        }

    def mark_videos_as_duplicates(self, video1_hash: str, video2_hash: str) -> None:
        self.client.client.set_file_relationships(
            [self._relationship_payload(video1_hash, video2_hash)]
        )

    def _pick_search_backend(self, num_files: int) -> str:
        # degenerate thresholds (similarity < 1 => distance 101, "everything
        # matches") only have exact reference semantics on the tree path
        if vptree.fix_vpdq_similarity(self.threshold) > 100:
            return "tree"
        if self.search_backend in ("tree", "tpu"):
            return self.search_backend
        try:
            import jax  # noqa: F401

            return "tpu" if num_files >= self.TPU_ENGINE_MIN_BATCH else "tree"
        except ImportError:
            return "tree"

    #: auto prefilter: prune when the scene representatives are at most
    #: this fraction of the corpus frames — sweep cost scales with the
    #: SQUARE of the fraction, so 0.7 already means ~2x less device work,
    #: comfortably above the filter's own overhead (linear clustering +
    #: candidate verification)
    PREFILTER_MAX_REP_FRACTION = 0.7

    def _pick_search_prefilter(self, all_phashes: list[bytes], col_state: dict) -> bool:
        """Decide (once per sweep) whether stage 4 uses the exact
        scene-representative prune (engine.find_pairs_pruned), and when it
        does, seed col_state with the column-side reps so the per-chunk
        calls don't re-cluster the corpus.

        "auto" measures the actual compression: cluster the corpus, prune
        only if reps <= PREFILTER_MAX_REP_FRACTION of frames (few-frame or
        scene-less corpora gain nothing and would pay an extra sweep).
        """
        if self.search_prefilter == "none":
            return False
        import numpy as np

        from .ops import reps as reps_mod
        from .ops import similarity_segments as seg
        from .parallel.engine import blob_frame_counts, iter_blob_items

        counts = blob_frame_counts(all_phashes)
        eligible_idx = np.nonzero(
            (counts > 0) & (counts <= seg.SEG_MAX_FRAMES)
        )[0]
        # cluster in slabs so only one slab of blobs is resident at a time
        # (all_phashes may be a DB-backed column at corpus scale)
        rep_blobs: list[bytes] = []
        slab = 1 << 18
        for s0 in range(0, len(eligible_idx), slab):
            sl = eligible_idx[s0 : s0 + slab]
            rep_blobs.extend(
                reps_mod.extract_reps([b for _, b in iter_blob_items(all_phashes, sl)])
            )
        rep_cols = list(zip(eligible_idx.tolist(), rep_blobs))
        if self.search_prefilter != "reps":  # auto
            total_frames = int(counts[eligible_idx].sum())
            total_reps = sum(len(rb) // 32 for rb in rep_blobs)
            if total_reps > self.PREFILTER_MAX_REP_FRACTION * total_frames:
                log.info(
                    "prefilter auto: reps %d / frames %d — compression too weak, "
                    "using the plain sweep",
                    total_reps,
                    total_frames,
                )
                return False
        prune_state = col_state.setdefault("prune", {})
        prune_state["rep_cols"] = rep_cols
        # stamp the cap the seeded reps were clustered at, or the engine's
        # cache-validity check discards them and re-clusters
        prune_state["rep_cols_radius_cap"] = reps_mod.RADIUS_CAP
        return True

    def find_potential_duplicates(self) -> int:
        search_threshold = vptree.fix_vpdq_similarity(self.threshold)
        assert search_threshold > 0 and isinstance(search_threshold, int)
        files = [
            row[0]
            for row in self.db.execute(
                "SELECT hash_id FROM shape_search_cache WHERE searched_distance IS NULL"
                " OR searched_distance < :t",
                {"t": search_threshold},
            ).fetchall()
        ]
        backend = self._pick_search_backend(len(files))
        self._last_search_backend = backend
        log.info("searching %d files with the %s backend", len(files), backend)
        if backend == "tpu":
            return self._find_potential_duplicates_tpu(files, search_threshold)
        return self._find_potential_duplicates_tree(files, search_threshold)

    def _reconcile_tree(self, tree: "vptree.VpTreeManager") -> None:
        """Insert phashes whose tree descent was deferred by earlier
        tpu-backend runs (DedupeDB.associate_file_with_perceptual_hash
        build_tree=False) so tree search sees the full corpus."""
        missing = self.db.get_phashes_missing_from_tree()
        if not missing:
            return
        with tqdm(
            total=len(missing),
            desc="Inserting deferred files into the search tree",
            dynamic_ncols=True,
            unit="file",
            colour="BLUE",
        ) as pbar:
            for i, (phash_id, phash) in enumerate(missing, start=1):
                tree.add_leaf(phash_id, phash)
                if i % self.TREE_COMMIT_BATCH == 0:
                    self.db.commit()
                pbar.update(1)
        self.db.commit()

    def _find_potential_duplicates_tree(self, files: list[int], search_threshold: int) -> int:
        """Reference semantics: per-file VP-tree search (dedup.py:445-502)."""
        tree = vptree.VpTreeManager(self.db)
        self._reconcile_tree(tree)
        num_similar_pairs = 0
        with tqdm(
            dynamic_ncols=True,
            total=len(files),
            desc="Finding potential duplicates",
            unit="file",
            colour="BLUE",
        ) as pbar:
            for i, hash_id in enumerate(files, start=1):
                if self.update_progress_callback:
                    self.update_progress_callback(
                        SearchingForDuplicatesProgress(complete=pbar.n, total=pbar.total)
                    )
                if self.should_skip_step_fn and self.should_skip_step_fn():
                    return num_similar_pairs // 2
                result = tree.search_file(hash_id, max_hamming_distance=search_threshold)
                file_hash_a = self.db.get_file_hash(hash_id)
                for similar_hash_id, _distance in result:
                    if hash_id != similar_hash_id:
                        file_hash_b = self.db.get_file_hash(similar_hash_id)
                        if not self._pair_passes_rerank(file_hash_a, file_hash_b):
                            continue
                        log.info('Similar files found: "%s" and "%s"', file_hash_a, file_hash_b)
                        self.mark_videos_as_duplicates(file_hash_a, file_hash_b)
                        num_similar_pairs += 1
                self.db.execute(
                    "UPDATE shape_search_cache SET searched_distance = ? WHERE hash_id = ?",
                    (search_threshold, hash_id),
                )
                if i % self.SEARCH_COMMIT_BATCH == 0:
                    self.db.commit()
                pbar.update(1)
                if self.update_progress_callback:
                    self.update_progress_callback(
                        SearchingForDuplicatesProgress(complete=pbar.n, total=pbar.total)
                    )
        # pairs between two unsearched files are found from both directions
        return num_similar_pairs // 2

    def _find_potential_duplicates_tpu(self, files: list[int], search_threshold: int) -> int:
        """Exact all-pairs search on the device with identical cache + count
        semantics: each unsearched file is compared against the whole
        corpus; directional double-counts are halved like the reference."""
        from .parallel.engine import TpuSearchEngine

        if not files:
            return 0
        if self.should_skip_step_fn and self.should_skip_step_fn():
            return 0
        # distance <= t  <=>  int sim >= 101 - t; clamped to >= 1 — at the
        # degenerate threshold 0.0 ("everything matches") the engine still
        # requires at least 1% similarity (use the tree backend for exact
        # reference semantics there).
        min_sim = max(1, 101 - search_threshold)

        # corpus: every mapped file and its phash, ordered already-searched
        # files FIRST and the unsearched row files after them in chunk
        # order. That makes each chunk's comparison set a corpus PREFIX
        # (everything searched before it plus the chunk itself), so the
        # engine sweeps the triangle instead of the square: column tiles
        # holding only later chunks are skipped on device — a fresh
        # full-corpus run does ~half the square's work. Counting weights
        # below keep the reported pair count identical to the reference's
        # both-directions-then-halve accounting.
        #
        # Only (hash_id, LENGTH) metadata is fetched up front; blob bytes
        # stream from SQLite through DbBlobColumn so host RAM stays
        # bounded by chunk, not corpus (a 10M-video library's blobs are
        # tens of GB).
        import numpy as np

        from .db.blobs import DbBlobColumn, fetch_blobs

        meta = np.fromiter(
            self.db.execute(
                "SELECT m.hash_id, LENGTH(p.phash)"
                " FROM shape_perceptual_hash_map m"
                " JOIN shape_perceptual_hashes p ON p.phash_id = m.phash_id"
            ),
            dtype=np.dtype([("id", np.int64), ("len", np.int64)]),
        )
        files_arr = np.asarray(files, dtype=np.int64)
        in_rows = np.isin(meta["id"], files_arr)
        searched_ids = meta["id"][~in_rows]  # corpus iteration order
        searched_lens = meta["len"][~in_rows]
        # row files in `files` order, restricted to mapped hashes
        order = np.argsort(meta["id"], kind="stable")
        sorted_ids = meta["id"][order]
        pos = np.searchsorted(sorted_ids, files_arr)
        pos_c = np.minimum(pos, max(len(sorted_ids) - 1, 0))
        present = (
            (pos < len(sorted_ids)) & (sorted_ids[pos_c] == files_arr)
            if len(sorted_ids)
            else np.zeros(len(files_arr), dtype=bool)
        )
        row_ids = files_arr[present]
        row_lens = meta["len"][order][pos_c[present]]
        n_searched = len(searched_ids)
        all_ids = np.concatenate([searched_ids, row_ids])
        all_phashes = DbBlobColumn(
            self.db,
            all_ids,
            np.concatenate([searched_lens, row_lens]) // 32,
        )

        if self.update_progress_callback:
            self.update_progress_callback(
                SearchingForDuplicatesProgress(complete=0, total=len(row_ids))
            )
        engine = TpuSearchEngine(mesh=self._device_mesh())

        # Checkpointed sweep: row files are searched in chunks; after each
        # chunk its pairs are marked in Hydrus and its search-cache entries
        # committed, so an interrupt loses at most one chunk of work (the
        # reference's per-file granularity, amortized to device batch size
        # — PARITY.md). Column-side device state is shared across chunks
        # via col_state, so the corpus uploads once.
        MARK_BATCH = 256
        num_similar_pairs = 0
        marked: set[tuple[int, int]] = set()
        rejected: set[tuple[int, int]] = set()
        pending: list[dict] = []
        col_state: dict = {}
        row_id_set = set(row_ids.tolist())

        def post_pending():
            if pending:
                self.client.client.set_file_relationships(pending)
                pending.clear()

        def mark_hits(hits, chunk_row_ids, chunk_rows_start_pos) -> bool:
            """POST one chunk's hits; False if the user skipped mid-way.

            Counting weights reproduce the reference's accounting exactly
            under the triangle sweep (one event per searcher-found pair,
            halved at the end): a hit against an already-searched file is
            one event; a hit against an earlier chunk's row stands for the
            two directional events the square sweep would have produced (it
            is found only once here); a within-chunk hit arrives in both
            directions naturally, one event each.
            """
            nonlocal num_similar_pairs
            with tqdm(
                dynamic_ncols=True,
                total=len(hits),
                desc="Marking potential duplicates",
                unit="pair",
                colour="BLUE",
            ) as pbar:
                for r, c, _sim in hits:
                    if self.should_skip_step_fn and self.should_skip_step_fn():
                        # leave this chunk's search cache unmarked so the
                        # next run redoes the remaining marking work
                        post_pending()
                        return False
                    hash_a = chunk_row_ids[r]
                    hash_b = int(all_ids[c])
                    if hash_a == hash_b:
                        pbar.update(1)
                        continue
                    key = (min(hash_a, hash_b), max(hash_a, hash_b))
                    if key in rejected:
                        pbar.update(1)
                        continue
                    if key not in marked:
                        fh_a = self.db.get_file_hash(hash_a)
                        fh_b = self.db.get_file_hash(hash_b)
                        if not self._pair_passes_rerank(fh_a, fh_b):
                            rejected.add(key)  # neither direction is counted
                            pbar.update(1)
                            continue
                        marked.add(key)
                        pending.append(self._relationship_payload(fh_a, fh_b))
                        if len(pending) >= MARK_BATCH:
                            post_pending()
                    num_similar_pairs += (
                        2 if n_searched <= c < chunk_rows_start_pos else 1
                    )
                    pbar.update(1)
            post_pending()
            return True

        # ``hits`` covers the triangle: within-chunk pairs appear in both
        # directions, cross-chunk row-row pairs once (later chunk finds the
        # earlier one), row-vs-already-searched pairs once. mark_hits's
        # counting weights map these back to the reference's per-file tree
        # loop events (both directions for any two unsearched files), then
        # the total is halved at the end (reference dedup.py:502). POST
        # each unordered pair to Hydrus only once (the reference POSTs
        # both directions — Hydrus dedupes, so the end state is identical),
        # batched MARK_BATCH pairs per request instead of one HTTP
        # round-trip per pair.
        use_prune = self._pick_search_prefilter(all_phashes, col_state)
        log.info(
            "stage-4 prefilter: %s", "scene-representative prune" if use_prune else "none"
        )
        import os as _os
        import time as _time

        rows_done = 0
        max_chunks = int(
            _os.environ.get("HVD_SEARCH_MAX_CHUNKS", "0")
        ) or self.SEARCH_MAX_CHUNKS
        chunk_rows = max(
            self.SEARCH_CHECKPOINT_ROWS,
            -(-len(files) // max_chunks),
        )
        _chunk_debug = _os.environ.get("HVD_DEBUG_TIMING")

        # one-chunk-ahead prefetch: the next chunk's row blobs are read
        # from SQLite on a separate connection while the current chunk
        # sweeps on the device (the SQLite read was serial dead time —
        # stage 4 only ever reads the blob tables, so a second reader
        # connection is safe; writes happen on the main connection at the
        # chunk checkpoint, when the prefetch thread has long finished)
        import sqlite3 as _sqlite3
        import threading as _threading

        _db_path = str(self.db.db_dir / self.db.db_name)
        chunk_starts = list(range(0, len(files), chunk_rows))
        _prefetched: dict[int, tuple] = {}

        def _prefetch_worker(ids: list[int], out: list) -> None:
            conn = _sqlite3.connect(_db_path)
            try:
                conn.execute("PRAGMA busy_timeout=30000")
                out.append(fetch_blobs(conn, ids))
            except Exception:  # fall back to the main-thread fetch
                pass
            finally:
                conn.close()

        def _start_prefetch(idx: int) -> None:
            if idx >= len(chunk_starts):
                return
            k0 = chunk_starts[idx]
            ids = [h for h in files[k0 : k0 + chunk_rows] if h in row_id_set]
            out: list = []
            th = _threading.Thread(
                target=_prefetch_worker, args=(ids, out), daemon=True
            )
            th.start()
            _prefetched[idx] = (th, out, ids)

        _start_prefetch(0)
        with tqdm(
            total=100,
            desc="Searching for duplicates (all-pairs engine)",
            dynamic_ncols=True,
            unit="%",
            colour="BLUE",
        ) as search_bar:
            for ci, k0 in enumerate(chunk_starts):
                chunk_files = files[k0 : k0 + chunk_rows]
                if self.should_skip_step_fn and self.should_skip_step_fn():
                    return num_similar_pairs // 2
                _tc = _time.time()
                th, out, chunk_row_ids = _prefetched.pop(ci)
                # kick the NEXT chunk's read before joining this one so it
                # overlaps the device sweep below
                _start_prefetch(ci + 1)
                th.join()
                # row blobs live only for the chunk being searched
                chunk_phashes = (
                    out[0] if out else fetch_blobs(self.db, chunk_row_ids)
                )
                _t_fetch = _time.time() - _tc
                # triangle sweep: this chunk compares against the corpus
                # prefix ending at its own last row
                chunk_rows_start_pos = n_searched + rows_done
                col_limit = chunk_rows_start_pos + len(chunk_row_ids)

                def on_progress(done: int, total: int) -> None:
                    frac = done / total if total else 1.0
                    n_done = rows_done + int(len(chunk_row_ids) * min(frac, 1.0))
                    pct = int(100 * n_done / len(row_ids)) if len(row_ids) else 100
                    search_bar.n = min(pct, 100)
                    search_bar.refresh()
                    if self.update_progress_callback:
                        # protocol counts files; map pair-work onto them
                        self.update_progress_callback(
                            SearchingForDuplicatesProgress(
                                complete=n_done, total=len(row_ids)
                            )
                        )

                search_fn = engine.find_pairs_pruned if use_prune else engine.find_pairs
                extra = {}
                if use_prune:
                    # rows are the corpus suffix starting at this chunk's
                    # position: the engine reuses its column rep cache for
                    # the row side instead of re-clustering (at 1M files
                    # the per-chunk row clustering re-did the whole
                    # corpus's ~40 s host clustering over the run)
                    extra["rows_at"] = chunk_rows_start_pos
                _tc = _time.time()
                hits = (
                    search_fn(
                        chunk_phashes,
                        all_phashes,
                        min_sim,
                        progress=on_progress,
                        col_state=col_state,
                        col_limit=col_limit,
                        **extra,
                    )
                    if chunk_phashes
                    else []
                )
                _t_search = _time.time() - _tc
                _tc = _time.time()
                if not mark_hits(hits, chunk_row_ids, chunk_rows_start_pos):
                    return num_similar_pairs // 2
                _t_mark = _time.time() - _tc
                _tc = _time.time()
                # one batched statement per chunk: the chunk is the
                # checkpoint unit, so per-row commits buy nothing (the
                # whole chunk's cache entries land atomically below)
                self.db.conn.executemany(
                    "UPDATE shape_search_cache SET searched_distance = ?"
                    " WHERE hash_id = ?",
                    [(search_threshold, h) for h in chunk_files],
                )
                self.db.commit()  # checkpoint: this chunk survives interrupts
                if _chunk_debug:
                    print(
                        f"[chunk-timing] rows {k0}..{k0 + len(chunk_files)}: "
                        f"fetch {_t_fetch:.1f}s search {_t_search:.1f}s "
                        f"mark {_t_mark:.1f}s ({len(hits)} hits) "
                        f"cache-update {_time.time() - _tc:.1f}s",
                        flush=True,
                    )
                rows_done += len(chunk_row_ids)
                search_bar.n = int(100 * rows_done / len(row_ids)) if len(row_ids) else 100
                search_bar.refresh()
            search_bar.n = 100
            search_bar.refresh()
        if self.update_progress_callback:
            self.update_progress_callback(
                SearchingForDuplicatesProgress(complete=len(row_ids), total=len(row_ids))
            )
        return num_similar_pairs // 2
