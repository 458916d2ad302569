"""CLI harness: render + benchmark with every reference knob at runtime.

Where the reference needs recompilation to change scene/resolution/heuristic
(compile-time macros, cpu/include/options.h, gpu/include/options.cuh), every
knob here is a flag. Output protocol mirrors the reference harness:
settings banner (cpu/src/main.c:149-165), BVH build time + structural
metrics (cpu/src/main.c:135-147, cpu/src/bvh.c:381-387), warmup + timed
iterations (gpu/include/options.cuh:25-26), per-frame times, then
mean/median/stddev/99% CI/FPS statistics (cpu/src/main.c:194-209) — plus a
structured JSON metrics file for sweep tooling.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from typing import Optional

import numpy as np

from .config import RESOLUTIONS, RenderConfig


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="parallel_ray_tracer_tpu",
        description="parallel ray tracer (JAX; per-ray GPU traversal)",
    )
    p.add_argument("--scene", default="car_boxed",
                   help="asset scene name (or use --synthetic)")
    p.add_argument("--asset-root", default=None)
    p.add_argument("--synthetic", type=int, default=0, metavar="N",
                   help="render N random triangles instead of a scene "
                        "(cpu/src/main.c:115-131)")
    p.add_argument("--resolution", default=None, choices=sorted(RESOLUTIONS),
                   help="preset name; overrides --width/--height")
    p.add_argument("--width", type=int, default=1920)
    p.add_argument("--height", type=int, default=1080)
    p.add_argument("--bounces", type=int, default=4)
    p.add_argument("--variant", default="auto",
                   choices=("auto", "gpu", "jax", "bruteforce"),
                   help="auto = gpu, which needs a GPU unless --interpret; "
                        "gpu = per-ray BVH traversal kernels; jax = "
                        "vmapped lax.while_loop packets (plain XLA); "
                        "bruteforce = USE_BVH=0 oracle")
    p.add_argument("--no-bvh", action="store_true",
                   help="USE_BVH=0: brute-force all triangles")
    p.add_argument("--heuristic", type=int, default=6, choices=range(7),
                   help="BVH split heuristic 0-6 (cpu/src/bvh.c:115-242)")
    p.add_argument("--sah-bins", type=int, default=32,
                   help="SAH_BIN_SIZE; -1 = per-centroid brute force")
    p.add_argument("--leaf-threshold", type=int, default=8,
                   help="BVH_ELEMENT_THRESHOLD")
    p.add_argument("--leaf-size", type=int, default=8, choices=(1, 2, 4, 8),
                   help="triangle slots per flattened leaf group")
    p.add_argument("--max-depth", type=int, default=32, help="BVH_MAX_ITER")
    p.add_argument("--seed", type=int, default=1,
                   help="SEED; 0 = time-based (options.h:66-71)")
    p.add_argument("--no-fast-light", action="store_true",
                   help="USE_BVH_FAST_LIGHT=0: closest-hit shadow traversal")
    p.add_argument("--no-bvh-metrics", action="store_true",
                   help="BVH_METRICS=0: suppress the leaf statistics banner")
    p.add_argument("--bf16-bvh", action="store_true",
                   help="bf16-compressed BVH boxes (conservative rounding)")
    p.add_argument("--no-reverse-shadows", action="store_true",
                   help="trace shadow segments hit->light (the reference's "
                        "direction) instead of the default light->hit, "
                        "which gives shadow rays one shared origin")
    p.add_argument("--presplit", type=float, default=0.0, metavar="RATIO",
                   help="pre-split oversized triangles before the BVH "
                        "build until every AABB diagonal <= RATIO * scene "
                        "diagonal (0 = off, reference build parity; try "
                        "0.0625)")
    p.add_argument("--true-sah", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="score heuristic-6 splits by true surface area "
                        "instead of the reference's squared diagonal "
                        "(--no-true-sah for strict reference tree parity)")
    p.add_argument("--tile", default="32x32",
                   help="pixel tile shape ROWSxCOLS (rays are traced in "
                        "tile-major order; ROWS*COLS rays per jax packet)")
    p.add_argument("--iterations", type=int, default=1)
    p.add_argument("--warmup", type=int, default=None,
                   help="untimed warmup frames before the timed loop; "
                        "default 1 for single renders, 50 (the reference "
                        "GPU protocol, gpu/include/options.cuh:25) when "
                        "--iterations > 1")
    p.add_argument("--checkpoint", default=None, metavar="PATH",
                   help="resumable banded render: completed scanline bands "
                        "persist to PATH and a rerun resumes at the first "
                        "missing band (long 4K/8K frames)")
    p.add_argument("--band-rows", type=int, default=128,
                   help="scanline rows per checkpoint band (multiple of the "
                        "tile row count)")
    p.add_argument("--devices", type=int, default=1,
                   help="shard image tiles over this many devices")
    p.add_argument("--output", default=None, metavar="BMP",
                   help="write the final frame as a BMP")
    p.add_argument("--metrics-json", default=None, metavar="PATH",
                   help="write run metrics as JSON")
    p.add_argument("--interpret", action="store_true",
                   help="run the gpu kernels in the Pallas interpreter "
                        "(debugging and CPU tests)")
    p.add_argument("--no-native", action="store_true",
                   help="skip the C++ host runtime; use the NumPy loaders "
                        "and builders")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="capture a jax.profiler trace of the timed "
                        "iterations into DIR (the Nsight-capture analog, "
                        "gpu/src/gpu.cu:109-111)")
    p.add_argument("--quiet", action="store_true")
    return p


def config_from_args(args) -> RenderConfig:
    width, height = args.width, args.height
    if args.resolution:
        width, height = RESOLUTIONS[args.resolution]
    tr, tc = (int(x) for x in args.tile.split("x"))
    return RenderConfig(
        width=width,
        height=height,
        scene=args.scene,
        use_bvh=not args.no_bvh,
        bvh_heuristic=args.heuristic,
        bvh_max_depth=args.max_depth,
        leaf_threshold=args.leaf_threshold,
        sah_bins=args.sah_bins,
        seed=args.seed,
        bvh_metrics=not args.no_bvh_metrics,
        fast_light=not args.no_fast_light,
        bounces=args.bounces,
        iterations=args.iterations,
        warmup=(
            args.warmup if args.warmup is not None
            else (50 if args.iterations > 1 else 1)
        ),
        tile_rows=tr,
        tile_cols=tc,
        variant=args.variant if not args.no_bvh else "bruteforce",
        bf16_bvh=args.bf16_bvh,
        synthetic_triangles=args.synthetic,
        asset_root=args.asset_root,
        num_devices=args.devices,
        use_native=not args.no_native,
        reverse_shadows=not args.no_reverse_shadows,
        presplit=args.presplit,
        true_sah=args.true_sah,
        leaf_size=args.leaf_size,
    )


def main(argv: Optional[list] = None) -> int:
    args = build_parser().parse_args(argv)
    cfg = config_from_args(args)

    import jax

    from . import pipeline
    from .parallel import distributed
    from .utils.bmp import write_bmp
    from .utils.compile_cache import enable_compile_cache
    from .utils.stats import format_summary, summarize

    # Multi-process runs: join the coordination service before any backend
    # use. Single-process runs are a no-op.
    distributed.initialize()
    try:
        variant = pipeline.resolve_variant(
            cfg.variant, cfg.use_bvh, args.interpret
        )
    except RuntimeError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    enable_compile_cache()

    say = (lambda *a: None) if args.quiet or not distributed.is_primary() else print

    say(f"\n# Scene settings #\nscene: "
        f"{'synthetic:%d' % cfg.synthetic_triangles if cfg.synthetic_triangles else cfg.scene}, "
        f"resolution: {cfg.width}x{cfg.height}, bounces: {cfg.bounces}")

    t0 = time.perf_counter()
    pipe = pipeline.prepare(cfg)
    prep_s = time.perf_counter() - t0
    say(f"# Host settings #\nbackend: {jax.default_backend()}, "
        f"devices: {len(jax.devices())}, variant: {variant}"
        + (f" (auto)" if cfg.variant == "auto" else ""))
    say(f"\n# Bvh settings #\nuse_bvh: {cfg.use_bvh}, heuristic: "
        f"{cfg.bvh_heuristic}, sah_bins: {cfg.sah_bins}, leaf: "
        f"{pipe.leaf_size}, max_depth: {cfg.bvh_max_depth}, seed: {cfg.seed}, "
        f"fast_light: {cfg.fast_light}, bf16: {cfg.bf16_bvh}")
    if cfg.use_bvh:
        say(f"Time to build the bvh: {pipe.build_ms:.0f} ms")
        if cfg.bvh_metrics:  # BVH_METRICS toggle (options.h:73)
            banner = pipe.bvh_metrics_banner()
            if banner:
                say(banner)
    say(f"(total prepare: {prep_s:.1f} s)")

    if args.checkpoint:
        # Resumable banded render (utils/checkpoint.py): each completed
        # band persists; a rerun picks up at the first missing band. This
        # path renders ONE frame and skips the timing loop.
        from .utils.checkpoint import TileRenderCheckpoint

        band = max(args.band_rows // cfg.tile_rows, 1) * cfg.tile_rows
        ckpt = TileRenderCheckpoint(
            args.checkpoint, cfg.width, cfg.height, band
        )
        img = ckpt.run(
            lambda y0, rows: np.asarray(
                pipe.render_band(
                    y0, max(rows, cfg.tile_rows), variant=variant,
                    interpret=args.interpret,
                )
            ),
            progress=lambda done, total: say(f"band {done}/{total}"),
        )
        if args.output:
            write_bmp(args.output, img)
            say(f"Wrote {args.output}")
        return 0

    mesh = None
    if cfg.num_devices > 1:
        from .parallel import sharded

        mesh = sharded.make_mesh(cfg.num_devices)

    def render_once():
        if mesh is None:
            return pipe.render(variant=variant, interpret=args.interpret)
        from .parallel import sharded

        return sharded.render_sharded(
            pipe.ds, pipe.dbvh, pipe.camera(), cfg.width, cfg.height, mesh,
            bounces=cfg.bounces, leaf_size=pipe.leaf_size, depth=pipe.depth,
            tile_rows=cfg.tile_rows, tile_cols=cfg.tile_cols,
            variant=variant, interpret=args.interpret,
            fast_light=cfg.fast_light, reverse_shadows=cfg.reverse_shadows,
        )

    for i in range(cfg.warmup):
        t0 = time.perf_counter()
        jax.block_until_ready(render_once())
        say(f"Warmup {i}: {(time.perf_counter()-t0)*1e3:.3f} ms")

    profile_ctx = None
    if args.profile:
        from .utils.profiling import trace

        profile_ctx = trace(args.profile)
        profile_ctx.__enter__()
    times = []
    img = None
    for i in range(cfg.iterations):
        t0 = time.perf_counter()
        img = jax.block_until_ready(render_once())
        times.append((time.perf_counter() - t0) * 1e3)
        say(f"Iteration {i}: {times[-1]:.3f} ms")
    if profile_ctx is not None:
        profile_ctx.__exit__(None, None, None)
        say(f"Wrote profiler trace to {args.profile}")

    stats = summarize(times)
    say(format_summary(stats))
    n_rays = cfg.width * cfg.height
    stats["primary_rays_per_s"] = n_rays / (stats["median_ms"] / 1e3)
    say(f"Primary rays/s: {stats['primary_rays_per_s']:.3e}")

    if args.output and img is not None:
        write_bmp(args.output, np.asarray(img))
        say(f"Wrote {args.output}")

    if args.metrics_json:
        record = {
            "config": dataclasses.asdict(cfg),
            "backend": jax.default_backend(),
            "build_ms": pipe.build_ms,
            "bvh_stats": pipe.bvh_stats,
            "times_ms": times,
            **stats,
        }
        with open(args.metrics_json, "w") as f:
            json.dump(record, f, indent=2)
        say(f"Wrote {args.metrics_json}")

    return 0


if __name__ == "__main__":
    sys.exit(main())
