"""Recorded-session acceptance test (the reference's VCR replay analog).

Replays the committed cassette (tests/fixtures/cassette_main.json.zip)
through entrypoint.main() with NO live server: every HTTP request the
client emits must match the recorded one exactly (method, path, query,
JSON body, in order) and receives the recorded response. This pins the
exact wire shapes of the client, like the reference's vcrpy replay with
record_mode="none" (reference tests/acceptance_tests/test_main_vcr.py).

Regenerate after intentional client changes: python -m tests.record_cassette
"""

from __future__ import annotations

import uuid
from pathlib import Path

import pytest

from hydrus_video_deduplicator_tpu.client.hydrus_api import UrllibTransport
from hydrus_video_deduplicator_tpu.entrypoint import main

from .. import cassette
from ..fake_hydrus import DEFAULT_ACCESS_KEY


def test_main_replays_recorded_session(tmp_path, monkeypatch):
    assert cassette.CASSETTE_PATH.exists(), (
        "cassette missing — run python -m tests.record_cassette"
    )
    data = cassette.load_cassette(cassette.CASSETTE_PATH)
    replayer = cassette.Replayer(data["interactions"])
    monkeypatch.setattr(
        UrllibTransport,
        "request",
        lambda self, method, url, **kw: replayer(self, method, url, **kw),
    )
    pairs = main(
        api_key=DEFAULT_ACCESS_KEY,
        api_url="http://localhost:45869",  # never contacted: replay only
        dedup_database_dir=tmp_path / uuid.uuid4().hex,
    )
    assert pairs == data["pairs"]
    replayer.assert_exhausted()


def test_replayer_rejects_deviation():
    data = cassette.load_cassette(cassette.CASSETTE_PATH)
    replayer = cassette.Replayer(data["interactions"])
    with pytest.raises(AssertionError, match="mismatch"):
        replayer(None, "POST", "http://x/definitely_not_recorded")
