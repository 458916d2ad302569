"""Frame-time benchmark of the served path on the GPU.

Times `pipeline.prepare` + `Pipeline.render` (the calls the CLI and library
users make) with `block_until_ready`, at the reference's own default
workload — car_boxed, 1920x1080, 4 bounces, heuristic 6
(cpu/include/options.h:6-7,34) — and on the ~180k-triangle dragon
substitute at 1920x1080 (models/procgen.py). Prints one JSON line: the
device as JAX reports it, and per workload the set-up time (build + upload)
and the median and quartiles of the timed frames. Without a GPU it exits
non-zero.

    python bench.py
"""

from __future__ import annotations

import json
import sys
import time

ITERATIONS = 10


def main() -> int:
    import jax

    from parallel_ray_tracer_tpu import pipeline
    from parallel_ray_tracer_tpu.config import RenderConfig
    from parallel_ray_tracer_tpu.utils.compile_cache import enable_compile_cache
    from parallel_ray_tracer_tpu.utils.profiling import frame_times_ms
    from parallel_ray_tracer_tpu.utils.stats import quartiles

    if jax.default_backend() != "gpu":
        print(f"bench.py needs a GPU; JAX's backend is "
              f"{jax.default_backend()!r}", file=sys.stderr)
        return 1
    enable_compile_cache()
    dev = jax.devices()[0]
    out = {
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }
    for scene in ("car_boxed", "dragon"):
        cfg = RenderConfig(scene=scene, width=1920, height=1080, bounces=4,
                           bvh_heuristic=6)
        t0 = time.perf_counter()
        pipe = pipeline.prepare(cfg)
        jax.block_until_ready(pipe.ds)
        setup_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        jax.block_until_ready(pipe.render())
        first_ms = (time.perf_counter() - t0) * 1e3
        times = frame_times_ms(pipe.render, ITERATIONS, warmup=0)
        q = quartiles(times)
        out[scene] = {
            "setup_ms": setup_ms,
            "first_frame_ms": first_ms,
            **q,
            "primary_rays_per_s": cfg.width * cfg.height / q["median_ms"] * 1e3,
            "times_ms": times,
        }
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
