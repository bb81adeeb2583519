"""Utility tests: profiling helpers, batching, tag helpers, config parsing."""

from __future__ import annotations

import pytest

from hydrus_video_deduplicator_tpu import config
from hydrus_video_deduplicator_tpu.dedup_util import (
    batched,
    find_tag_in_tags,
    get_file_import_time,
    get_oldest_imported_file_time,
    severity_to_color,
)
from hydrus_video_deduplicator_tpu.utils import device_timer


def test_batched():
    assert list(batched("ABCDEFG", 3)) == [tuple("ABC"), tuple("DEF"), ("G",)]
    assert list(batched([], 4)) == []
    with pytest.raises(AssertionError):
        list(batched([1], 0))


def test_find_tag_in_tags():
    tags = ["character:edward", "filename:video.mp4", "series:twilight"]
    assert find_tag_in_tags("filename:", tags) == "video.mp4"
    assert find_tag_in_tags("creator:", tags) == ""


def test_import_time_helpers():
    metadata = {
        "file_services": {
            "current": {
                "abc": {"name": "all local files", "time_imported": 111},
                "def": {"name": "other", "time_imported": 50},
            }
        }
    }
    assert get_file_import_time(metadata) == 111
    assert get_oldest_imported_file_time([metadata]) == 111
    with pytest.raises(KeyError):
        get_file_import_time({"file_services": {"current": {}}})


def test_severity_colors():
    import logging

    assert severity_to_color(logging.ERROR) == "[red]"
    assert severity_to_color(logging.WARNING) == "[yellow]"
    assert severity_to_color(logging.INFO) == ""


def test_device_timer_measures():
    import jax.numpy as jnp

    calls = []

    def step(i):
        calls.append(i)
        return jnp.asarray([float(i)])

    mean = device_timer(step, iters=3, warmup=1)
    assert mean >= 0
    assert len(calls) == 4  # 1 warmup + 3 timed


def test_config_json_array_validation():
    assert config.validate_json_array_env_var(None, "x") is None
    assert config.validate_json_array_env_var('["a", "b"]', "x") == ["a", "b"]
    with pytest.raises(config.InvalidEnvironmentVariable):
        config.validate_json_array_env_var('{"not": "array"}', "x")
    with pytest.raises(config.InvalidEnvironmentVariable):
        config.validate_json_array_env_var("not json", "x")


def test_native_must_load_when_toolchain_exists():
    """Guard against silent skip cascades: if a C++ toolchain is present,
    the native library must actually build AND load (a mislinked .so once
    turned 20 bit-exactness tests into silent skips). Lives here, outside
    test_pdq_native's module-level skipif, so it FAILS rather than skips."""
    import shutil

    import pytest

    from hydrus_video_deduplicator_tpu import native

    if shutil.which("g++") is None and shutil.which("cc") is None:
        pytest.skip("no C++ toolchain")
    assert native.is_available(), "toolchain present but native lib failed to load"


def test_no_progress_stands_in_for_tqdm():
    """dedup falls back to this when tqdm is not installed: the same
    context manager, counters and iteration, silently."""
    from hydrus_video_deduplicator_tpu.dedup_util import NoProgress

    with NoProgress(total=5, desc="x", unit="file", colour="BLUE") as bar:
        bar.update(2)
        bar.update()
        bar.n = 4
        bar.refresh()
    assert (bar.n, bar.total) == (4, 5)
    assert list(NoProgress(range(3))) == [0, 1, 2]
