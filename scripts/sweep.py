"""Benchmark sweep driver — the reference's gpu/*.bat equivalent.

The reference sweeps CUDA block shapes per kernel variant and collects
stdout into metrics/<variant>/data_<block>.txt (gpu/naive.bat,
gpu/fast_idx.bat, gpu/float_align_compression.bat, gpu/fuse.bat). Here the
swept axis is the pixel-tile shape that orders the rays (the tile aspect
trades spatial coherence within a kernel block or packet), plus the variant
(gpu | jax | bruteforce) and the bf16-BVH toggle; results land in
<out>/<variant>/data_<tile>.json via the CLI's --metrics-json. Each point is
its own CLI process, one at a time; this parent never starts a JAX backend.

Usage: python scripts/sweep.py [--scene car_boxed] [--resolution 720p]
       [--iterations 5] [--variants gpu] [--out sweep_out]
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

TILES = ["4x256", "8x128", "16x64", "32x32", "64x16", "128x8"]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scene", default="car_boxed")
    ap.add_argument("--resolution", default="720p")
    ap.add_argument("--iterations", type=int, default=5)
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--bounces", type=int, default=4)
    ap.add_argument("--variants", default="gpu,jax")
    ap.add_argument("--tiles", default=",".join(TILES))
    ap.add_argument("--bf16", action="store_true")
    ap.add_argument("--out", default="sweep_out")
    args = ap.parse_args()

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    failures = 0
    for variant in args.variants.split(","):
        suffix = "_bf16" if args.bf16 else ""
        outdir = os.path.join(args.out, variant + suffix)
        os.makedirs(outdir, exist_ok=True)
        for tile in args.tiles.split(","):
            dst = os.path.join(outdir, f"data_{tile}.json")
            cmd = [
                sys.executable, "-m", "parallel_ray_tracer_tpu",
                "--scene", args.scene,
                "--resolution", args.resolution,
                "--variant", variant,
                "--tile", tile,
                "--iterations", str(args.iterations),
                "--warmup", str(args.warmup),
                "--bounces", str(args.bounces),
                "--metrics-json", dst,
                "--quiet",
            ]
            if args.bf16:
                cmd.append("--bf16-bvh")
            print(f"[sweep] {variant} tile={tile} -> {dst}", flush=True)
            r = subprocess.run(cmd, cwd=repo)
            if r.returncode != 0:
                print(f"[sweep] FAILED: {' '.join(cmd)}", flush=True)
                failures += 1
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
