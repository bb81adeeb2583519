"""The Hydrus client's stdlib (urllib) transport against the fake server."""

from __future__ import annotations

import pytest

from hydrus_video_deduplicator_tpu.client import hydrus_api

from ..fake_hydrus import DEFAULT_ACCESS_KEY, FakeHydrus


@pytest.fixture
def server():
    srv = FakeHydrus({"ab" * 32: b"video-bytes"})
    srv.start()
    yield srv
    srv.stop()


def _client(server, key=DEFAULT_ACCESS_KEY):
    return hydrus_api.Client(access_key=key, api_url=server.url)


def test_get_json(server):
    c = _client(server)
    assert isinstance(c.session, hydrus_api.UrllibTransport)
    assert c.get_api_version()["version"] == 70
    assert c.verify_access_key()["permits_everything"] is True


def test_query_params_are_encoded(server):
    c = _client(server)
    got = c.search_files(["system:everything", "a tag with spaces"], return_hashes=True)
    assert got["hashes"] == ["ab" * 32]
    assert "/get_files/search_files" in server.requests_seen


def test_file_bytes_round_trip(server):
    resp = _client(server).get_file(hash_="ab" * 32)
    assert resp.status_code == 200
    assert resp.content == b"video-bytes"


def test_post_json_body(server):
    c = _client(server)
    c.set_file_relationships(
        [{"hash_a": "ab" * 32, "hash_b": "cd" * 32, "relationship": 0,
          "do_default_content_merge": True}]
    )
    assert {tuple(sorted(p)) for p in server.relationships} == {("ab" * 32, "cd" * 32)}


@pytest.mark.parametrize(
    "call,exc",
    [
        (lambda c: c.verify_access_key(), hydrus_api.InsufficientAccess),
        (lambda c: c.get_file(hash_="00" * 32), hydrus_api.APIError),
    ],
    ids=["bad-key-401", "missing-file-404"],
)
def test_http_errors_map_to_typed_exceptions(server, call, exc):
    key = "0" * 64 if exc is hydrus_api.InsufficientAccess else DEFAULT_ACCESS_KEY
    with pytest.raises(exc) as info:
        call(_client(server, key))
    assert isinstance(info.value.response, hydrus_api.Response)
    assert info.value.response.status_code in (401, 404)


def test_unreachable_server_raises_connection_error():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    c = hydrus_api.Client(access_key=DEFAULT_ACCESS_KEY, api_url=f"http://127.0.0.1:{port}")
    with pytest.raises(hydrus_api.ConnectionError):
        c.get_api_version()


def test_response_text_and_json():
    r = hydrus_api.Response(200, b'{"x": [1, 2]}', {"Content-Type": "application/json"})
    assert r.json() == {"x": [1, 2]}
    assert r.text == '{"x": [1, 2]}'
    assert r.headers["Content-Type"] == "application/json"
