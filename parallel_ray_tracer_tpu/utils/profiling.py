"""Profiling/tracing harness (SURVEY.md §5).

The reference brackets kernels with cudaEvents + cudaProfilerStart/Stop for
Nsight capture (gpu/src/gpu.cu:104-116) and builds with -g -lineinfo
(gpu/makefile:9). The JAX equivalents:

  - `trace(dir)`: context manager capturing a jax.profiler trace viewable in
    TensorBoard/Perfetto (the Nsight analog);
  - `timed(fn)`: block_until_ready wall timing of a device computation (the
    cudaEvent analog);
  - `annotate(name)`: TraceAnnotation so custom phases (BVH build, upload,
    per-bounce passes) appear on the trace timeline.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Iterator, List, Tuple

import jax


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """Capture a device trace into `log_dir` (TensorBoard-compatible)."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def annotate(name: str):
    """Named span on the profiler timeline."""
    return jax.profiler.TraceAnnotation(name)


def timed(fn: Callable[[], object]) -> Tuple[object, float]:
    """(result, seconds) with a device fence — the cudaEvent analog."""
    t0 = time.perf_counter()
    out = fn()
    jax.block_until_ready(out)
    return out, time.perf_counter() - t0


def frame_times_ms(fn: Callable[[], object], iterations: int,
                   warmup: int = 1) -> List[float]:
    """Wall times of `iterations` fenced calls after `warmup` untimed ones."""
    for _ in range(warmup):
        jax.block_until_ready(fn())
    return [timed(fn)[1] * 1e3 for _ in range(iterations)]
