"""Regenerate the committed request/response cassette.

Runs a full pipeline against the live fake Hydrus with a small 4-file
corpus subset, recording every HTTP interaction at the UrllibTransport
layer. Run from the repo root:

    python -m tests.record_cassette
"""

from __future__ import annotations

import sys
import tempfile
import uuid
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parents[1]))

from tests import cassette
from tests.fake_hydrus import DEFAULT_ACCESS_KEY, FakeHydrus, corpus_file_store, sha256_hex

#: small, real-codec files only — keeps the committed cassette compact
CASSETTE_FILES = ("S01_h264.mp4", "S01_vp9.webm", "S02_h264.mp4", "S02_mpeg4.avi")


def cassette_store() -> dict[str, bytes]:
    videos = Path(__file__).parent / "corpus" / "videos"
    store = {}
    for name in CASSETTE_FILES:
        matches = list(videos.rglob(name))
        assert len(matches) == 1, name
        data = matches[0].read_bytes()
        store[sha256_hex(data)] = data
    return store


def main() -> None:
    from hydrus_video_deduplicator_tpu.client.hydrus_api import UrllibTransport
    from hydrus_video_deduplicator_tpu.entrypoint import main as run_main

    store = cassette_store()
    server = FakeHydrus(store)
    server.start()
    recorder = cassette.Recorder(UrllibTransport.request)
    UrllibTransport.request = lambda self, method, url, **kw: recorder(
        self, method, url, **kw
    )
    try:
        with tempfile.TemporaryDirectory() as d:
            pairs = run_main(
                api_key=DEFAULT_ACCESS_KEY,
                api_url=server.url,
                dedup_database_dir=Path(d) / uuid.uuid4().hex,
            )
    finally:
        UrllibTransport.request = recorder.real_request
        server.stop()

    cassette.save_cassette(cassette.CASSETTE_PATH, pairs, recorder.interactions)
    size = cassette.CASSETTE_PATH.stat().st_size
    print(
        f"recorded {len(recorder.interactions)} interactions, {pairs} pairs ->"
        f" {cassette.CASSETTE_PATH} ({size / 1024:.0f} KiB)"
    )


if __name__ == "__main__":
    main()
