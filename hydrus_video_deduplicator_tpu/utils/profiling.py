"""Profiling and tracing utilities.

The reference's observability is cProfile scripts + pytest-benchmark
(SURVEY.md §5); the device equivalents are:

- :func:`trace_to` — capture a JAX profiler trace of a code block
  (viewable with xprof / tensorboard-plugin-profile).
- :func:`device_timer` — wall-time a device computation, waiting for it
  with ``block_until_ready``.
"""

from __future__ import annotations

import contextlib
import time
from collections.abc import Callable, Iterator


@contextlib.contextmanager
def trace_to(log_dir: str) -> Iterator[None]:
    """Capture a JAX profiler trace of the enclosed block into log_dir."""
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def device_timer(step: Callable, iters: int = 10, warmup: int = 1) -> float:
    """Mean seconds per call of ``step(i) -> jax array(s)``, after
    ``warmup`` untimed calls (compilation)."""
    import jax

    for i in range(warmup):
        jax.block_until_ready(step(i))
    t0 = time.perf_counter()
    result = None
    for i in range(iters):
        result = step(i)
    jax.block_until_ready(result)
    return (time.perf_counter() - t0) / iters
