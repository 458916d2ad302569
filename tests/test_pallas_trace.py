"""Pallas traversal kernels (interpret mode) vs the JAX packet reference and
the brute-force oracle. On the CPU these run through the Pallas interpreter;
the compiled GPU path is exercised by chip_smoke.py and `pytest -m gpu`.
"""

import numpy as np
import jax.numpy as jnp

from parallel_ray_tracer_tpu.config import RenderConfig
from parallel_ray_tracer_tpu.models.camera import default_camera, ray_basis
from parallel_ray_tracer_tpu.models.device_scene import device_scene_from_host
from parallel_ray_tracer_tpu.ops.bvh import build_bvh
from parallel_ray_tracer_tpu.ops.bvh_flat import flatten_bvh
from parallel_ray_tracer_tpu.ops import gpu_trace, trace_bvh
from parallel_ray_tracer_tpu.ops.render import (
    generate_rays_tiled,
    render_bruteforce,
    render_bvh,
)
from parallel_ray_tracer_tpu import pipeline


def _flat(scene, heuristic=6, L=8):
    tv = scene.triangle_vertices()
    bvh = build_bvh(tv, heuristic=heuristic, leaf_threshold=L)
    return flatten_bvh(bvh, tv, leaf_size=L)


class TestKernelsVsJaxReference:
    def test_closest_matches(self, car_only_scene):
        L = 8
        flat = _flat(car_only_scene, L=L)
        ds = device_scene_from_host(car_only_scene, slot_map=flat.slot_map)
        dbvh, _, depth = trace_bvh.device_bvh_from_flat(flat)
        cam_arrays = tuple(
            jnp.asarray(a) for a in ray_basis(default_camera(), 128, 64)
        )
        o, d = generate_rays_tiled(cam_arrays, 128, 64, 8, 128)

        cl_ref, _ = trace_bvh.make_tracer(dbvh, ds, L, depth, packet=1024)
        h_ref = cl_ref(o, d)
        cl_p, _ = gpu_trace.make_tracer(dbvh, ds, L, depth, interpret=True)
        h_p = cl_p(o, d)

        t_ref, t_p = np.asarray(h_ref.t), np.asarray(h_p.t)
        miss_ref, miss_p = t_ref > 1e30, t_p > 1e30
        assert (miss_ref == miss_p).all()
        np.testing.assert_allclose(
            t_ref[~miss_ref], t_p[~miss_p], atol=1e-4, rtol=1e-5
        )

    def test_occluded_matches(self, tiny_scene):
        L = 8
        flat = _flat(tiny_scene, L=L)
        ds = device_scene_from_host(tiny_scene, slot_map=flat.slot_map)
        dbvh, _, depth = trace_bvh.device_bvh_from_flat(flat)
        cam_arrays = tuple(
            jnp.asarray(a) for a in ray_basis(default_camera(), 128, 64)
        )
        o, d = generate_rays_tiled(cam_arrays, 128, 64, 8, 128)
        cl_ref, oc_ref = trace_bvh.make_tracer(dbvh, ds, L, depth, packet=1024)
        h = cl_ref(o, d)
        t_hit = jnp.clip(h.t, 0.0, 100.0)
        p = trace_bvh.Vec3(o.x + d.x * t_hit, o.y + d.y * t_hit, o.z + d.z * t_hit)
        lp = np.asarray([0.0, -6.0, 6.0], np.float32)
        lvec = trace_bvh.Vec3(lp[0] - p.x, lp[1] - p.y, lp[2] - p.z)
        mag = (lvec.x**2 + lvec.y**2 + lvec.z**2) ** 0.5
        ldir = trace_bvh.Vec3(lvec.x / mag, lvec.y / mag, lvec.z / mag)
        m2 = mag * mag

        b_ref = np.asarray(oc_ref(p, ldir, m2))
        _, oc_p = gpu_trace.make_tracer(dbvh, ds, L, depth, interpret=True)
        b_p = np.asarray(oc_p(p, ldir, m2))
        assert (b_ref == b_p).all()


def _render_gpu(scene, flat, width, height, bounces, bf16=False):
    ds = device_scene_from_host(scene, slot_map=flat.slot_map)
    dbvh, L, depth = trace_bvh.device_bvh_from_flat(flat, bf16=bf16)
    return np.asarray(
        render_bvh(
            ds, dbvh, default_camera(), width, height, variant="gpu",
            bounces=bounces, leaf_size=L, depth=depth, interpret=True,
        )
    )


class TestPallasRenderVsOracle:
    def test_tiny_scene_full_render(self, tiny_scene):
        flat = _flat(tiny_scene, heuristic=3)
        img = _render_gpu(tiny_scene, flat, 48, 32, bounces=3)
        ds_plain = device_scene_from_host(tiny_scene)
        ref = np.asarray(
            render_bruteforce(ds_plain, default_camera(), 48, 32, bounces=3)
        )
        np.testing.assert_allclose(img, ref, atol=3e-5)

    def test_bf16_bvh_exact(self, tiny_scene):
        """The kernel reads the conservative bf16 boxes: hits unchanged."""
        flat = _flat(tiny_scene)
        img = _render_gpu(tiny_scene, flat, 48, 32, bounces=2, bf16=True)
        ds_plain = device_scene_from_host(tiny_scene)
        ref = np.asarray(
            render_bruteforce(ds_plain, default_camera(), 48, 32, bounces=2)
        )
        np.testing.assert_allclose(img, ref, atol=3e-5)


class TestPipeline:
    def test_prepare_and_render_variants_agree(self, tiny_scene):
        cfg = RenderConfig(
            width=48, height=32, bounces=2, bvh_heuristic=6,
            tile_rows=32, tile_cols=32,
        )
        pipe = pipeline.prepare(cfg, scene=tiny_scene)
        assert pipe.build_ms > 0
        img_jax = np.asarray(pipe.render(variant="jax"))
        img_gpu = np.asarray(pipe.render(variant="gpu", interpret=True))
        img_ref = np.asarray(pipe.render(variant="bruteforce"))
        np.testing.assert_allclose(img_jax, img_ref, atol=3e-5)
        np.testing.assert_allclose(img_gpu, img_ref, atol=3e-5)

    def test_synthetic_scene_pipeline(self):
        cfg = RenderConfig(
            width=32, height=32, bounces=1, synthetic_triangles=200,
            tile_rows=32, tile_cols=32, bvh_heuristic=3,
        )
        pipe = pipeline.prepare(cfg)
        img = np.asarray(pipe.render(variant="jax"))
        ref = np.asarray(pipe.render(variant="bruteforce"))
        np.testing.assert_allclose(img, ref, atol=3e-5)
