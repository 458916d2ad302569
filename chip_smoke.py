"""Smoke run of the served path on the GPU: renders, kernel parity, timings.

    python chip_smoke.py [--plain-iterations N]
    python chip_smoke.py --four        # the four-GPU path only

One process; the phases run in order and any failure exits non-zero:

1. the card (nvidia-smi name and power limit) and the device JAX sees;
2. car_boxed and car_only at 1920x1080, 4 bounces, through
   `pipeline.prepare` + `Pipeline.render` ("auto" -> the per-ray GPU
   kernels), each frame held to the reference binary's own frame
   (utils/parity.py bounds);
3. the kernels against the plain-XLA packet tracer (ops/trace_bvh.py) at
   full width: closest hit on car_boxed's 1080p primary rays, on one
   reflection bounce and on the dragon substitute's primary rays; any-hit
   on the primary hits' shadow rays. Hit indices agree on >= 99.99% of rays
   (exact depth ties may resolve to another triangle), t to 1e-5 relative
   where they agree (FMA contraction differs between the two compilers);
4. frame times of the kernel path and of the plain vmapped path at both
   workloads (car_boxed, dragon; 1080p, 4 bounces), set-up (build + upload)
   and the first (compiling) frame reported apart;
5. one differentiable step through the kernels (ops/diff.make_diff_closest),
   loss and vertex gradients finite and equal to the bruteforce tracer's.

--four runs only `parallel.sharded.render_sharded` of car_boxed 1080p on a
four-GPU mesh against the one-GPU render, and one `make_train_step` through
the kernels under shard_map against the bruteforce step on the same mesh.

The last line of standard output is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np

W, H = 1920, 1080


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()


def say(*a):
    print(*a, flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def agreement(h, ref, what: str) -> None:
    """Closest-hit agreement of two tracers on the same rays."""
    idx, idx_r = np.asarray(h.idx), np.asarray(ref.idx)
    t, t_r = np.asarray(h.t), np.asarray(ref.t)
    same = idx == idx_r
    frac = float(same.mean())
    hit = same & (idx_r >= 0)
    rel = float(np.max(np.abs(t[hit] - t_r[hit]) / np.abs(t_r[hit]),
                       initial=0.0))
    say(f"  {what}: rays {idx.size}, hits {int((idx_r >= 0).sum())}, "
        f"idx agree {frac:.6f}, max rel t diff {rel:.3e}")
    check(frac >= 0.9999, f"{what}: idx agreement {frac}")
    check(rel <= 1e-5, f"{what}: t relative difference {rel}")


def prepare_all(jax):
    """The three 1080p, 4-bounce pipelines; set-up (build + upload) timed."""
    from parallel_ray_tracer_tpu import pipeline
    from parallel_ray_tracer_tpu.config import RenderConfig

    pipes, setup_ms = {}, {}
    for scene in ("car_boxed", "car_only", "dragon"):
        cfg = RenderConfig(scene=scene, width=W, height=H, bounces=4,
                           bvh_heuristic=6)
        t0 = time.perf_counter()
        pipes[scene] = pipeline.prepare(cfg)
        jax.block_until_ready(pipes[scene].dbvh)
        setup_ms[scene] = (time.perf_counter() - t0) * 1e3
    return pipes, setup_ms


def frame_phase(pipes, jax):
    from parallel_ray_tracer_tpu.utils import parity

    say("## phase 2: 1080p frames vs the reference binary")
    for scene in ("car_boxed", "car_only"):
        pipe = pipes[scene]
        check(pipe.resolved_variant() == "gpu", "auto must resolve to gpu")
        img = np.asarray(jax.block_until_ready(pipe.render()))
        check(img.shape == (H, W, 3) and np.isfinite(img).all(),
              f"{scene}: frame shape/finiteness")
        stats = parity.parity(
            parity.quantize(img), parity.reference_frame(scene)
        )
        say(f"  {scene}: frac_any {stats['frac_any']:.3e} (< 5e-3), "
            f"frac_big {stats['frac_big']:.3e} (< 2e-3), "
            f"mean {stats['mean']:.4f} (< 0.1)")
        check(parity.within_bounds(stats), f"{scene}: parity {stats}")


def kernel_phase(pipes, jax, jnp):
    from parallel_ray_tracer_tpu.models.camera import ray_basis
    from parallel_ray_tracer_tpu.ops import gpu_trace, trace_bvh
    from parallel_ray_tracer_tpu.ops.render import generate_rays_tiled
    from parallel_ray_tracer_tpu.ops.shade import mask_dead_rays, surface_attrs
    from parallel_ray_tracer_tpu.ops.vecmath import Vec3

    say("## phase 3: kernels vs trace_bvh at full width")
    for scene in ("car_boxed", "dragon"):
        pipe = pipes[scene]
        ds, bvh = pipe.ds, pipe.dbvh
        kc, ko = gpu_trace.make_tracer(bvh, ds, pipe.leaf_size, pipe.depth)
        jc, jo = trace_bvh.make_tracer(bvh, ds, pipe.leaf_size, pipe.depth,
                                       packet=1024)
        jc, jo = jax.jit(jc), jax.jit(jo)
        cam = tuple(jnp.asarray(a) for a in ray_basis(pipe.camera(), W, H))
        o, d = generate_rays_tiled(cam, W, H, 32, 32)
        h, ref = kc(o, d), jc(o, d)
        agreement(h, ref, f"{scene} primary closest")
        if scene != "car_boxed":
            continue
        hit = ref.idx >= 0
        p = o + d * jnp.where(hit, ref.t, 1.0)
        lp = Vec3(ds.lights_pos.x[0], ds.lights_pos.y[0], ds.lights_pos.z[0])
        lvec = Vec3(lp.x - p.x, lp.y - p.y, lp.z - p.z)
        mag2 = lvec.mag2()
        so, sd = mask_dead_rays(p, lvec / jnp.sqrt(mag2), hit)
        bk, bj = np.asarray(ko(so, sd, mag2)), np.asarray(jo(so, sd, mag2))
        frac = float((bk == bj).mean())
        say(f"  car_boxed shadow any-hit: rays {bk.size}, blocked "
            f"{int(bj.sum())}, agree {frac:.6f}")
        check(frac >= 0.9999, f"any-hit agreement {frac}")
        # One mirror bounce (shade.trace_rays' reflection ray).
        n, _, _, _ = surface_attrs(ds, ref, p)
        n = (-n).where(ref.norm_dir, n)
        r = d + n * (2.0 * jnp.abs(d.dot(n)))
        r = r / jnp.sqrt(jnp.maximum(r.mag2(), 1e-30))
        ro, rd = mask_dead_rays(p, r, hit)
        agreement(kc(ro, rd), jc(ro, rd), "car_boxed reflection closest")


def timing_phase(pipes, setup_ms, jax, iterations: int,
                 plain_iterations: int):
    from parallel_ray_tracer_tpu.utils.profiling import frame_times_ms
    from parallel_ray_tracer_tpu.utils.stats import quartiles

    say("## phase 4: frame times, kernel path vs plain vmapped path")
    results = {}
    for scene in ("car_boxed", "dragon"):
        pipe = pipes[scene]
        say(f"  {scene}: triangles {pipe.scene.num_triangles}, tree depth "
            f"{pipe.depth}, set-up (build + upload) {setup_ms[scene]:.1f} ms")
        for variant, n in (("gpu", iterations), ("jax", plain_iterations)):
            t0 = time.perf_counter()
            jax.block_until_ready(pipe.render(variant=variant))
            first_ms = (time.perf_counter() - t0) * 1e3
            times = frame_times_ms(
                lambda: pipe.render(variant=variant), n, warmup=0
            )
            q = quartiles(times)
            results[(scene, variant)] = q["median_ms"]
            say(f"  {scene} {variant}: first frame (compile) {first_ms:.1f} "
                f"ms; {n} frames median {q['median_ms']:.3f} ms "
                f"[q25 {q['q25_ms']:.3f}, q75 {q['q75_ms']:.3f}]; "
                f"times {[round(t, 3) for t in times]}")
    for scene in ("car_boxed", "dragon"):
        say(f"  {scene}: plain / kernel frame time "
            f"{results[(scene, 'jax')] / results[(scene, 'gpu')]:.1f}x")


def _tiny_scene():
    from parallel_ray_tracer_tpu.models.scene import Scene

    verts = np.array(
        [[-5, -5, 0], [5, -5, 0], [5, 5, 0], [-5, 5, 0],
         [-1, 0, 1], [1, 0, 1], [0, 0, 2.5],
         [-0.8, -0.5, 3.0], [0.8, -0.5, 3.0], [0.0, 0.7, 3.2]],
        np.float32,
    )
    return Scene(
        verts=verts,
        faces=np.array([[0, 1, 2], [0, 2, 3], [4, 5, 6], [7, 8, 9]], np.int32),
        mat_idx=np.array([0, 0, 1, 2], np.int32),
        mats_kd=np.array([[0.8, 0.8, 0.8], [0.7, 0.1, 0.1], [0.1, 0.2, 0.7]],
                         np.float32),
        mats_ks=np.array([[0.0, 0.0, 0.0], [0.5, 0.5, 0.5], [0.3, 0.3, 0.3]],
                         np.float32),
        mats_kr=np.array([[0.2, 0.2, 0.2], [0.0, 0.0, 0.0], [0.4, 0.4, 0.4]],
                         np.float32),
        lights_pos=np.array([[0.0, -6.0, 6.0]], np.float32),
        lights_kl=np.array([[30.0, 30.0, 30.0]], np.float32),
    )


def diff_phase(jax, jnp):
    from parallel_ray_tracer_tpu.models.camera import default_camera, ray_basis
    from parallel_ray_tracer_tpu.models.device_scene import build_device_scene
    from parallel_ray_tracer_tpu.ops import diff, gpu_trace, trace_brute
    from parallel_ray_tracer_tpu.ops.bvh import build_bvh
    from parallel_ray_tracer_tpu.ops.bvh_flat import flatten_bvh
    from parallel_ray_tracer_tpu.ops.render import generate_rays_tiled
    from parallel_ray_tracer_tpu.ops.trace_bvh import device_bvh_from_flat

    say("## phase 5: one differentiable step through the kernels")
    sc = _tiny_scene()
    arrs = dict(faces=sc.faces, mat_idx=sc.mat_idx, mats_kd=sc.mats_kd,
                mats_ks=sc.mats_ks, mats_kr=sc.mats_kr,
                lights_pos=sc.lights_pos, lights_kl=sc.lights_kl)
    tv = sc.triangle_vertices()
    flat = flatten_bvh(build_bvh(tv, heuristic=6, leaf_threshold=8), tv,
                       leaf_size=8)
    dbvh, L, depth = device_bvh_from_flat(flat)
    cam = tuple(jnp.asarray(a) for a in ray_basis(default_camera(), 32, 32))
    o, d = generate_rays_tiled(cam, 32, 32, 32, 32)

    def loss(verts, kernel: bool):
        if kernel:
            ds = build_device_scene(verts, slot_map=flat.slot_map, **arrs)
            cf, of = gpu_trace.make_tracer(dbvh, ds, L, depth)
        else:
            ds = build_device_scene(verts, **arrs)
            cf, of = trace_brute.make_tracer(ds)
        col = diff.trace_rays_diff(ds, cf, of, o, d, 2)
        return jnp.sum(col.x + col.y + col.z)

    v0 = jnp.asarray(sc.verts)
    lk, gk = jax.value_and_grad(lambda v: loss(v, True))(v0)
    lb, gb = jax.value_and_grad(lambda v: loss(v, False))(v0)
    gk, gb = np.asarray(gk), np.asarray(gb)
    err = float(np.max(np.abs(gk - gb)))
    say(f"  loss kernel {float(lk):.6f} bruteforce {float(lb):.6f}; "
        f"max |grad diff| {err:.3e}")
    check(np.isfinite(float(lk)) and np.isfinite(gk).all(), "finite step")
    check(abs(float(lk) - float(lb)) < 1e-2 * max(1.0, abs(float(lb))),
          "loss matches bruteforce")
    np.testing.assert_allclose(gk, gb, atol=2e-3, rtol=2e-3)


def four_phase(jax, jnp):
    import os

    from parallel_ray_tracer_tpu import pipeline
    from parallel_ray_tracer_tpu.config import DEFAULT_ASSET_ROOTS, RenderConfig
    from parallel_ray_tracer_tpu.models.scene import load_scene_npz
    from parallel_ray_tracer_tpu.ops.bvh import build_bvh
    from parallel_ray_tracer_tpu.ops.bvh_flat import flatten_bvh
    from parallel_ray_tracer_tpu.ops.trace_bvh import device_bvh_from_flat
    from parallel_ray_tracer_tpu.parallel import sharded
    from parallel_ray_tracer_tpu.utils.profiling import frame_times_ms
    from parallel_ray_tracer_tpu.utils.stats import quartiles

    check(len(jax.devices()) >= 4, f"--four needs 4 GPUs, JAX sees "
          f"{len(jax.devices())}")
    say("## four GPUs: sharded car_boxed 1080p vs one GPU")
    mesh = sharded.make_mesh(4)
    cfg = RenderConfig(scene="car_boxed", width=W, height=H, bounces=4,
                       bvh_heuristic=6)
    pipe = pipeline.prepare(cfg)

    def four():
        return sharded.render_sharded(
            pipe.ds, pipe.dbvh, pipe.camera(), W, H, mesh, bounces=4,
            leaf_size=pipe.leaf_size, depth=pipe.depth, variant="gpu",
        )

    one = np.asarray(jax.block_until_ready(pipe.render()))
    img = np.asarray(jax.block_until_ready(four()))
    exact = float((img == one).all(axis=-1).mean())
    diff_max = float(np.abs(img - one).max())
    say(f"  pixels bit-identical {exact:.6f}, max |diff| {diff_max:.3e}")
    # Per-ray kernel results do not depend on the shard; only XLA's
    # shading arithmetic may reassociate for the per-device batch shape.
    check(diff_max <= 1e-6, f"sharded image differs by {diff_max}")
    t1 = quartiles(frame_times_ms(pipe.render, 10))
    t4 = quartiles(frame_times_ms(four, 10))
    say(f"  frame median: 1 GPU {t1['median_ms']:.3f} ms "
        f"[{t1['q25_ms']:.3f}, {t1['q75_ms']:.3f}], 4 GPUs "
        f"{t4['median_ms']:.3f} ms [{t4['q25_ms']:.3f}, {t4['q75_ms']:.3f}]")

    say("## four GPUs: make_train_step through the kernels under shard_map")
    sc = load_scene_npz(os.path.join(DEFAULT_ASSET_ROOTS[0], "car_only.npz"))
    tv = sc.triangle_vertices()
    flat = flatten_bvh(build_bvh(tv, heuristic=6, leaf_threshold=8), tv,
                       leaf_size=8)
    dbvh, L, depth = device_bvh_from_flat(flat)
    kw = dict(bounces=1, lr=1e-3)
    step_k, prep_k = sharded.make_train_step(
        sc, mesh, 256, 128, variant="gpu", bvh=dbvh, leaf_size=L,
        depth=depth, slot_map=flat.slot_map, **kw,
    )
    step_b, prep_b = sharded.make_train_step(sc, mesh, 256, 128, **kw)
    vk, lk = step_k(*prep_k())
    vb, lb = step_b(*prep_b())
    vk, vb = np.asarray(vk), np.asarray(vb)
    say(f"  loss kernel {float(lk):.6f} bruteforce {float(lb):.6f}; "
        f"max |verts diff| {float(np.abs(vk - vb).max()):.3e}")
    check(np.isfinite(float(lk)) and np.isfinite(vk).all(), "finite step")
    check(abs(float(lk) - float(lb)) < 1e-3 * max(1.0, float(lb)),
          "loss matches bruteforce")
    np.testing.assert_allclose(vk, vb, atol=1e-5)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-GPU path")
    ap.add_argument("--plain-iterations", type=int, default=3,
                    help="timed frames of the plain path (seconds each; "
                         "the kernel path times 10)")
    args = ap.parse_args(argv)

    import jax
    import jax.numpy as jnp

    if jax.default_backend() != "gpu":
        print(f"chip_smoke.py needs a GPU; JAX's backend is "
              f"{jax.default_backend()!r}", file=sys.stderr)
        return 1

    from parallel_ray_tracer_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    dev = jax.devices()[0]
    say("## phase 1: device")
    say(card_line())
    say(f"  JAX: {dev.platform} {dev.device_kind} x{len(jax.devices())}, "
        f"jax {jax.__version__}")
    t_start = time.perf_counter()
    if args.four:
        four_phase(jax, jnp)
    else:
        pipes, setup_ms = prepare_all(jax)
        frame_phase(pipes, jax)
        kernel_phase(pipes, jax, jnp)
        timing_phase(pipes, setup_ms, jax, 10, args.plain_iterations)
        diff_phase(jax, jnp)
    say(f"## all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({
        "ok": True,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
