"""The capability module: platform choices, memory plan, compile cache."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from hydrus_video_deduplicator_tpu import device


def _dev(platform: str, bytes_limit: int | None = None):
    stats = None if bytes_limit is None else {"bytes_limit": bytes_limit}
    return SimpleNamespace(platform=platform, memory_stats=lambda: stats)


@pytest.mark.parametrize(
    "platform,hash_batch,device_hashing,segment_route,exists_kernel",
    [
        ("gpu", 512, True, True, "triton"),
        ("cpu", 16, False, False, "xla"),
    ],
)
def test_capabilities_by_platform(platform, hash_batch, device_hashing, segment_route, exists_kernel):
    caps = device.capabilities(_dev(platform))
    assert caps.platform == platform
    assert caps.hash_batch == hash_batch
    assert caps.device_hashing is device_hashing
    assert caps.segment_route is segment_route
    assert caps.exists_kernel == exists_kernel
    assert caps.row_blocks_per_tile >= 1
    assert device.is_gpu(_dev(platform)) is (platform == "gpu")


@pytest.mark.parametrize("platform", ["tpu", "rocm", "metal"])
def test_unknown_platform_raises(platform):
    with pytest.raises(device.UnsupportedPlatform):
        device.capabilities(_dev(platform))


def test_default_device_is_the_test_cpu():
    assert device.platform() == "cpu"
    assert device.capabilities() == device.capabilities(_dev("cpu"))


def test_memory_plan_gpu_from_bytes_limit():
    limit = 60 * 2**30
    plan = device.memory_plan([_dev("gpu", limit)])
    assert plan.seg_target_bytes == int(limit * device.SEG_TARGET_FRACTION)
    assert plan.col_pm1_bytes == int(limit * device.COL_PM1_FRACTION)
    assert plan.drain_bytes == int(limit * device.DRAIN_FRACTION)
    assert plan.col_pm1_bytes < plan.seg_target_bytes < limit


def test_memory_plan_mesh_plans_for_the_smallest_device():
    small, big = 40 * 2**30, 60 * 2**30
    plan = device.memory_plan([_dev("gpu", big), _dev("gpu", small), _dev("gpu", big)])
    assert plan == device.memory_plan([_dev("gpu", small)])


def test_memory_plan_cpu_keeps_the_cpu_plan():
    assert device.memory_plan([_dev("cpu")]) is device.CPU_PLAN
    assert device.memory_plan() is device.CPU_PLAN  # the test suite's CPU


@pytest.mark.parametrize(
    "devices",
    [
        [_dev("tpu", 16 * 2**30)],  # unknown platform: no assumed size
        [_dev("gpu")],  # a GPU that reports no limit
        [_dev("gpu", 2**30), _dev("cpu")],  # mixed platforms
    ],
    ids=["unknown-platform", "gpu-without-limit", "mixed"],
)
def test_memory_plan_raises(devices):
    with pytest.raises(device.UnsupportedPlatform):
        device.memory_plan(devices)


def test_engine_reads_its_plan_from_the_device(monkeypatch):
    from hydrus_video_deduplicator_tpu.parallel.engine import TpuSearchEngine

    eng = TpuSearchEngine()
    assert eng.memory is device.CPU_PLAN
    assert eng.exists_kernel == "xla"


@pytest.mark.parametrize(
    "environ,want",
    [
        ({"JAX_COMPILATION_CACHE_DIR": "/elsewhere/cache"}, "/elsewhere/cache"),
        ({}, str(device.CHECKOUT / ".jax_cache")),
    ],
    ids=["env-set", "env-unset"],
)
def test_compile_cache_dir(environ, want):
    assert device.compile_cache_dir(environ) == want


def test_compile_cache_dir_is_the_checkout():
    assert (device.CHECKOUT / "hydrus_video_deduplicator_tpu" / "device.py").is_file()


def test_enable_compile_cache_sets_jax(monkeypatch, tmp_path):
    import jax

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    try:
        assert device.enable_compile_cache() == str(tmp_path)
        assert jax.config.jax_compilation_cache_dir == str(tmp_path)
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
