"""Utility-layer coverage: stats banner, profiling helpers, distributed
no-op init, compile cache, package exports."""

import math
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np

import pytest

from parallel_ray_tracer_tpu.utils.stats import (
    Z_99,
    format_summary,
    quartiles,
    summarize,
)
from parallel_ray_tracer_tpu.utils import compile_cache, profiling
from parallel_ray_tracer_tpu.parallel import distributed


class TestStats:
    def test_summary_math(self):
        # Population stddev + z=2.5758 CI (cpu/src/main.c:45-88 semantics).
        times = [10.0, 12.0, 14.0]
        s = summarize(times)
        assert s["mean_ms"] == 12.0 and s["median_ms"] == 12.0
        assert abs(s["stddev_ms"] - math.sqrt(8.0 / 3.0)) < 1e-9
        assert abs(s["ci99_ms"] - Z_99 * s["stddev_ms"] / math.sqrt(3)) < 1e-9
        assert abs(s["fps"] - 1000.0 / 12.0) < 1e-9

    def test_quartiles(self):
        q = quartiles([4.0, 1.0, 3.0, 2.0, 5.0])
        assert (q["q25_ms"], q["median_ms"], q["q75_ms"]) == (2.0, 3.0, 4.0)
        q = quartiles([1.0, 2.0])
        assert (q["q25_ms"], q["median_ms"], q["q75_ms"]) == (1.25, 1.5, 1.75)

    def test_banner_formats(self):
        s = summarize([5.0] * 40)
        out = format_summary(s)
        assert "99" in out and "FPS" in out  # CI line shown for >=30 iters
        s2 = summarize([5.0])
        assert "mean" in format_summary(s2)


class TestProfiling:
    def test_timed_fences(self):
        out, secs = profiling.timed(lambda: jnp.arange(8.0) * 2)
        assert secs >= 0 and float(np.asarray(out)[-1]) == 14.0

    def test_annotate_context(self):
        with profiling.annotate("test-span"):
            _ = jnp.ones(4) + 1


class TestCompileCache:
    CHILD = (
        "import jax, jax.numpy as jnp\n"
        "from parallel_ray_tracer_tpu.utils.compile_cache import "
        "enable_compile_cache\n"
        "d = enable_compile_cache()\n"
        "jax.config.update('jax_persistent_cache_min_compile_time_secs', 0)\n"
        "c = float(int.from_bytes(__import__('os').urandom(3), 'little'))\n"
        "jax.jit(lambda x: jnp.sin(x) * c + 1.5)(jnp.arange(7.0))"
        ".block_until_ready()\n"
        "print(d)\n"
    )

    @pytest.mark.parametrize("from_env", [True, False])
    def test_compiled_programs_land_in_cache_dir(self, tmp_path, from_env):
        """JAX_COMPILATION_CACHE_DIR wins when set (no directory set in
        code); otherwise the checkout's .jax_cache."""
        env = dict(os.environ)
        env.pop("JAX_COMPILATION_CACHE_DIR", None)
        if from_env:
            env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path)
        want = str(tmp_path) if from_env else compile_cache.DEFAULT_DIR
        before = set(os.listdir(want)) if os.path.isdir(want) else set()
        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        r = subprocess.run(
            [sys.executable, "-c", self.CHILD], env=env, cwd=repo,
            capture_output=True, text=True, timeout=120,
        )
        assert r.returncode == 0, r.stderr[-2000:]
        assert r.stdout.strip().splitlines()[-1] == want
        assert set(os.listdir(want)) - before, "no compiled program cached"


class TestDistributed:
    def test_initialize_single_process_noop(self):
        distributed.initialize()  # must not raise on single-host
        assert distributed.is_primary()


class TestPackageApi:
    def test_exports(self):
        import parallel_ray_tracer_tpu as prt

        assert hasattr(prt, "RenderConfig")
        assert hasattr(prt, "prepare")
        assert prt.__version__
