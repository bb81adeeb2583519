"""Record/replay of full Hydrus Client API sessions (vcrpy-style).

The reference's acceptance test replays a recorded real-Hydrus session from
zipped vcr cassettes with record_mode="none" (reference
tests/acceptance_tests/test_main_vcr.py:28-87). This module provides the
same guarantee for this framework: a committed cassette pins the EXACT
request shapes the client emits (method, path, query params, JSON body)
and the responses it must handle; the replayer serves only recorded
requests, in order, and fails on any deviation.

Cassette format: zip containing ``cassette.json``:
    {"pairs": N, "interactions": [
        {"method", "path", "query", "body", "status", "content_b64"}, ...]}

Regenerate with ``python -m tests.record_cassette`` after intentional
client-behavior changes.
"""

from __future__ import annotations

import base64
import io
import json
import zipfile
from pathlib import Path
from urllib.parse import urlencode, urlsplit

from hydrus_video_deduplicator_tpu.client.hydrus_api import Response

CASSETTE_PATH = Path(__file__).parent / "fixtures" / "cassette_main.json.zip"


def canonical_query(params) -> str:
    if not params:
        return ""
    return urlencode(sorted((str(k), str(v)) for k, v in dict(params).items()))


def canonical_body(json_body) -> str:
    if json_body is None:
        return ""
    return json.dumps(json_body, sort_keys=True, separators=(",", ":"))


def request_key(method: str, url: str, kwargs: dict) -> dict:
    parts = urlsplit(url)
    q = canonical_query(kwargs.get("params"))
    if parts.query:  # pre-encoded query in the URL itself
        q = "&".join(x for x in (parts.query, q) if x)
    return {
        "method": method.upper(),
        "path": parts.path,
        "query": q,
        "body": canonical_body(kwargs.get("json")),
    }


def make_response(status: int, content: bytes) -> Response:
    return Response(status, content, {"Content-Type": "application/json"})


def save_cassette(path: Path, pairs: int, interactions: list[dict]) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    payload = json.dumps({"pairs": pairs, "interactions": interactions}, indent=1)
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED, compresslevel=9) as zf:
        zf.writestr("cassette.json", payload)
    path.write_bytes(buf.getvalue())


def load_cassette(path: Path) -> dict:
    with zipfile.ZipFile(path) as zf:
        return json.loads(zf.read("cassette.json"))


class Recorder:
    """Wraps UrllibTransport.request: forwards to the live (fake) server
    and records each interaction."""

    def __init__(self, real_request):
        self.real_request = real_request
        self.interactions: list[dict] = []

    def __call__(self, session, method, url, **kwargs):
        resp = self.real_request(session, method, url, **kwargs)
        entry = request_key(method, url, kwargs)
        entry["status"] = resp.status_code
        entry["content_b64"] = base64.b64encode(resp.content).decode()
        self.interactions.append(entry)
        return resp


class Replayer:
    """Strict in-order replay: each outgoing request must match the next
    recorded interaction exactly; nothing is ever fetched from a network."""

    def __init__(self, interactions: list[dict]):
        self.interactions = interactions
        self.cursor = 0

    def __call__(self, session, method, url, **kwargs):
        if self.cursor >= len(self.interactions):
            raise AssertionError(
                f"unexpected request beyond cassette end: {method} {url}"
            )
        expected = self.interactions[self.cursor]
        got = request_key(method, url, kwargs)
        for field in ("method", "path", "query", "body"):
            if got[field] != expected[field]:
                raise AssertionError(
                    f"request #{self.cursor} {field!r} mismatch:\n"
                    f"  recorded: {expected[field]!r}\n"
                    f"  got:      {got[field]!r}"
                )
        self.cursor += 1
        return make_response(expected["status"], base64.b64decode(expected["content_b64"]))

    def assert_exhausted(self):
        assert self.cursor == len(self.interactions), (
            f"only {self.cursor} of {len(self.interactions)} recorded"
            " interactions were replayed"
        )
