"""CLI entrypoint.

Same flag surface as the reference (/root/reference/src/
hydrusvideodeduplicator/entrypoint.py:50-241), implemented with click
(typer-compatible option names):

  --api-key, --api-url, --query (repeatable), --threshold (default 50.0),
  --skip-hashing, --file-service-key (repeatable), --verify-cert,
  --clear-search-tree, --clear-search-cache, --failed-page-name,
  --job-count (default -2), --dedup-database-dir, --verbose, --debug
  (hidden), --gui, deprecated --overwrite/--no-overwrite warning.

``main()`` is callable directly from tests and returns the similar-pair
count, like the reference's typer main.
"""

from __future__ import annotations

import logging
import sys
from pathlib import Path
from typing import TYPE_CHECKING

if TYPE_CHECKING:
    from typing import NoReturn

try:
    from rich import print
except ImportError:  # pragma: no cover
    pass

from .__about__ import __version__
from . import config
from .client import ClientAPIException, FailedHVDClientConnection, create_client
from .db import DedupeDB
from .dedup import HydrusVideoDeduplicator
from .dedup_util import print_and_log


class ExitException(SystemExit):
    pass


def _enable_jax_compile_cache() -> None:
    """Persist compiled device programs across runs (device.py's rule:
    JAX_COMPILATION_CACHE_DIR when set, else <checkout>/.jax_cache).

    The search engine compiles one program per frame-count bucket-pair
    shape and one per sweep size class; without a persistent cache every
    invocation recompiles them all.
    """
    from . import device

    try:
        device.enable_compile_cache()
    except ImportError:  # jax absent: CPU-only install, no cache
        pass


def main(
    api_key: str | None = None,
    api_url: str | None = None,
    overwrite: bool | None = None,  # deprecated
    query: list[str] | None = None,
    threshold: float = 50.0,
    skip_hashing: bool = False,
    file_service_key: list[str] | None = None,
    verify_cert: str | None = None,
    clear_search_tree: bool = False,
    clear_search_cache: bool = False,
    failed_page_name: str | None = None,
    job_count: int = -2,
    dedup_database_dir: Path | None = None,
    verbose: bool = False,
    debug: bool = False,
    search_backend: str = "auto",
    search_prefilter: str = "auto",
    hash_backend: str = "auto",
    sampling: str = "uniform",
    decode_backend: str | None = None,
    rerank: str = "none",
    rerank_weights: str | None = None,
    rerank_threshold: float = 0.85,
) -> int:
    """Run the deduplicator; returns the number of similar pairs found."""
    if decode_backend is not None:
        # flag > env > default, like every other config tier (config.py);
        # the decode layer reads the env var lazily per stream
        import os

        from .decode.backends import DECODE_BACKEND_ENV, DECODE_BACKEND_MODES

        if decode_backend not in DECODE_BACKEND_MODES:
            print(f"[red] ERROR: Invalid decode backend: {decode_backend!r}.")
            raise SystemExit(1)
        os.environ[DECODE_BACKEND_ENV] = decode_backend
    if rerank == "clip" and (not rerank_weights or not Path(rerank_weights).is_file()):
        print(f"[red] ERROR: --rerank clip needs --rerank-weights pointing at a checkpoint.")
        raise SystemExit(1)
    if api_url is None:
        api_url = config.HYDRUS_API_URL
    if query is None:
        query = config.HYDRUS_QUERY
    if file_service_key is None:
        file_service_key = config.HYDRUS_LOCAL_FILE_SERVICE_KEYS
    if verify_cert is None:
        verify_cert = config.REQUESTS_CA_BUNDLE
    if failed_page_name is None:
        failed_page_name = config.FAILED_PAGE_NAME
    if dedup_database_dir is None:
        dedup_database_dir = config.DEDUP_DATABASE_DIR

    loglevel = logging.DEBUG if debug else logging.INFO
    if debug:
        verbose = True
    logging.basicConfig(
        format=" %(asctime)s - %(name)s: %(message)s", datefmt="%H:%M:%S", level=loglevel
    )
    logger = logging.getLogger("main")
    logger.debug("Starting Hydrus Video Deduplicator (device edition).")

    def exit_from_failure() -> "NoReturn":
        print_and_log(logger, "Exiting due to failure...")
        raise ExitException(1)

    if not verbose:
        logging.disable()

    DedupeDB.set_db_dir(Path(dedup_database_dir))
    _enable_jax_compile_cache()

    if overwrite is not None:
        pretty = "--" + ("" if overwrite else "no-") + "overwrite"
        print_and_log(
            logger,
            f"WARNING: '{pretty}' option was deprecated and does nothing as of 0.7.0."
            " Remove it from your args.",
        )

    if not api_key:
        api_key = config.HYDRUS_API_KEY
    if not api_key:
        print_and_log(logger, "Hydrus API key is not set. Please set with '--api-key'.")
        exit_from_failure()
    if not api_url:
        print_and_log(logger, "Hydrus API URL is not set. Please set with '--api-url'.")
        exit_from_failure()

    print_and_log(logger, f"Connecting to Hydrus at {api_url}")
    try:
        hvdclient = create_client(file_service_key, api_url, api_key, verify_cert)
        print_and_log(logger, f"Dedupe API version: 'v{hvdclient.get_api_version()}'")
        print_and_log(logger, f"Hydrus API version: 'v{hvdclient.get_hydrus_api_version()}'")
        hvdclient.verify_permissions()
    except (FailedHVDClientConnection, ClientAPIException) as exc:
        print_and_log(logger, str(exc), logging.FATAL)
        print_and_log(logger, exc.pretty_msg, logging.FATAL)
        exit_from_failure()

    if debug:
        from .client import HVDClient

        HVDClient._log.setLevel(logging.DEBUG)

    if DedupeDB.does_db_exist():
        print_and_log(logger, f"Found existing database at '{DedupeDB.get_db_file_path()}'")
        db = DedupeDB.DedupeDb(DedupeDB.get_db_dir(), DedupeDB.get_db_name())
        db.init_connection()
        db.begin_transaction()
        with db.conn:
            db_upgraded = db.upgrade_db()
        if db_upgraded:
            print_and_log(logger, "Database upgraded, vacuuming to save space.")
            before = DedupeDB.get_db_stats(db)
            print_and_log(logger, f"Database filesize before vacuum: {before.file_size} bytes.")
            db.vacuum()
            after = DedupeDB.get_db_stats(db)
            print_and_log(logger, f"Database filesize after vacuum: {after.file_size} bytes.")
        stats = DedupeDB.get_db_stats(db)
        print_and_log(
            logger, f"Database has {stats.num_videos} videos already perceptually hashed."
        )
        print_and_log(logger, f"Database filesize: {stats.file_size} bytes.")

        if clear_search_tree:
            db.begin_transaction()
            with db.conn:
                db.clear_search_tree()
            print("[green] Cleared the search tree.")
        if clear_search_cache:
            db.begin_transaction()
            with db.conn:
                db.clear_search_cache()
            print("[green] Cleared the search cache.")
    else:
        print_and_log(
            logger, f"Database not found. Creating one at '{DedupeDB.get_db_file_path()}'"
        )
        if not DedupeDB.get_db_dir().exists():
            DedupeDB.create_db_dir()
        db = DedupeDB.DedupeDb(DedupeDB.get_db_dir(), DedupeDB.get_db_name())
        db.init_connection()
        db.begin_transaction()
        with db.conn:
            db.create_tables()

    deduper = HydrusVideoDeduplicator(
        db,
        client=hvdclient,
        job_count=job_count,
        failed_page_name=failed_page_name,
        custom_query=query,
        search_backend=search_backend,
        search_prefilter=search_prefilter,
        hash_backend=hash_backend,
        sampling=sampling,
        rerank=rerank,
        rerank_weights=rerank_weights,
        rerank_threshold=rerank_threshold,
    )
    if debug:
        deduper.hydlog.setLevel(logging.DEBUG)
        deduper._DEBUG = True

    if threshold < 0.0 or threshold > 100.0:
        print("[red] ERROR: Invalid similarity threshold. Must be between 0 and 100.")
        raise ExitException(1)
    HydrusVideoDeduplicator.threshold = threshold

    num_similar_pairs = deduper.deduplicate(skip_hashing=skip_hashing)
    db.close()
    return num_similar_pairs


def _build_cli():
    import click

    @click.command(name="hydrus-video-deduplicator-tpu")
    @click.option("--api-key", default=None, help="Hydrus API Key")
    @click.option("--api-url", default=config.HYDRUS_API_URL, help="Hydrus API URL")
    @click.option("--overwrite/--no-overwrite", default=None, hidden=True)
    @click.option("--query", multiple=True, help="Custom Hydrus tag query")
    @click.option(
        "--threshold",
        default=50.0,
        type=float,
        help="Similarity threshold for a pair of videos where 100 is identical",
    )
    @click.option(
        "--skip-hashing/--no-skip-hashing",
        default=False,
        help="Skip perceptual hashing and just search for duplicates",
    )
    @click.option("--file-service-key", multiple=True, help="Local file service key")
    @click.option(
        "--verify-cert",
        default=config.REQUESTS_CA_BUNDLE,
        help="Path to TLS cert. This forces verification.",
    )
    @click.option(
        "--clear-search-tree/--no-clear-search-tree",
        default=False,
        help="Clear the search tree that tracks what files have already been compared.",
    )
    @click.option(
        "--clear-search-cache/--no-clear-search-cache",
        default=False,
        help="Clear the search cache that tracks what files have been compared"
        " with a given similarity threshold.",
    )
    @click.option(
        "--failed-page-name",
        default=config.FAILED_PAGE_NAME,
        help="The name of the Hydrus page to add failed files to.",
    )
    @click.option(
        "--job-count",
        default=-2,
        type=int,
        help="Number of CPU threads to use for perceptual hashing."
        " Default is all but one core.",
    )
    @click.option(
        "--dedup-database-dir",
        default=str(config.DEDUP_DATABASE_DIR),
        type=click.Path(path_type=Path),
        help="The directory to store the database used for dedupe.",
    )
    @click.option("--verbose/--no-verbose", default=False, help="Verbose logging")
    @click.option("--debug/--no-debug", default=False, hidden=True)
    @click.option(
        "--search-backend",
        default="auto",
        type=click.Choice(["auto", "tree", "tpu"]),
        help="Duplicate-search engine: VP-tree, exact all-pairs on the device"
        " (GPU; value 'tpu'), or auto.",
    )
    @click.option(
        "--search-prefilter",
        default="auto",
        type=click.Choice(["auto", "reps", "none"]),
        help="Exact scene-representative prune for the device search engine: "
        "auto measures corpus compression, reps forces it, none disables.",
    )
    @click.option(
        "--hash-backend",
        default="auto",
        type=click.Choice(["auto", "native", "tpu"]),
        help="Perceptual-hash engine: threaded native CPU, device-batched GPU"
        " (value 'tpu'), or auto (the GPU when one is present and the batch is"
        " large).",
    )
    @click.option(
        "--decode-backend",
        default=None,
        type=click.Choice(["auto", "libav", "legacy"]),
        help="Video decode path: 'libav' (native FFmpeg, reference-exact),"
        " 'legacy' (OpenCV/Pillow/y4m), or 'auto' (libav with fallback;"
        " default). Also settable via HVD_DECODE_BACKEND.",
    )
    @click.option(
        "--sampling",
        default="uniform",
        type=click.Choice(["uniform", "scene"]),
        help="Frame sampling: 'uniform' (1 fps, reference parity) or 'scene'"
        " (shot-boundary; fewer frames on static content — don't mix modes"
        " in one database).",
    )
    @click.option(
        "--rerank",
        default="none",
        type=click.Choice(["none", "clip"]),
        help="Embedding rerank of candidate pairs after the pHash prefilter"
        " (stretch): keeps a pair only when the vision-tower cosine"
        " similarity clears --rerank-threshold.",
    )
    @click.option(
        "--rerank-weights",
        default=None,
        type=click.Path(exists=True),
        help="Vision-tower checkpoint (.npz; see models/embed.py for the"
        " layout — e.g. a converted CLIP ViT).",
    )
    @click.option(
        "--rerank-threshold",
        default=0.85,
        type=float,
        help="Minimum embedding cosine similarity to keep a candidate pair.",
    )
    @click.option(
        "--gui/--no-gui",
        default=bool(config.HVD_GUI),
        help="Launch the GUI. This ignores all other CLI arguments.",
    )
    def cli(gui, **kwargs):
        if kwargs.get("api_key") is None:
            kwargs["api_key"] = click.prompt("Api key", default="", show_default=False)
        kwargs["query"] = list(kwargs["query"]) or None
        kwargs["file_service_key"] = list(kwargs["file_service_key"]) or None
        main(**kwargs)

    return cli


def run_main(gui: bool = False) -> None:
    print(f"[blue] Hydrus Video Deduplicator {__version__} [/]")
    want_gui = gui or bool(int(config.HVD_GUI or 0)) or (
        len(sys.argv) > 1 and sys.argv[1] == "--gui"
    )
    if want_gui:
        try:
            from .gui.gui import gui_main
        except ImportError as exc:
            print_and_log(
                logging.getLogger("main"),
                f"Failed to import GUI dependencies. Did you install the GUI"
                f" dependencies? Error: {exc}",
                logging.FATAL,
            )
            raise ExitException(1) from exc
        gui_main()
        return
    try:
        cli = _build_cli()
        cli(standalone_mode=True)
    except KeyboardInterrupt as exc:
        raise ExitException(-1) from exc
    finally:
        if config.is_windows_exe():
            input("Press ENTER to exit...")


def run_main_cli() -> None:
    """console_scripts entry (pyproject [project.scripts])."""
    run_main(gui=False)


if __name__ == "__main__":
    run_main(gui=False)
