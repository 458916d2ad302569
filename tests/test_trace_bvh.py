"""BVH flatten + packet traversal vs the brute-force oracle.

The reference's own verification pattern — USE_BVH=0 as the oracle for the
BVH path (cpu/src/raytracer.c:112-130) — automated as allclose checks
(SURVEY.md §4).
"""

import numpy as np
import pytest

from parallel_ray_tracer_tpu.models.camera import default_camera
from parallel_ray_tracer_tpu.models.device_scene import device_scene_from_host
from parallel_ray_tracer_tpu.ops.bvh import build_bvh
from parallel_ray_tracer_tpu.ops.bvh_flat import compress_bf16, flatten_bvh
from parallel_ray_tracer_tpu.ops.render import render_bruteforce, render_bvh
from parallel_ray_tracer_tpu.ops.trace_bvh import device_bvh_from_flat


def _flat_for(scene, heuristic=3, leaf_size=4, **kw):
    tv = scene.triangle_vertices()
    bvh = build_bvh(tv, heuristic=heuristic, **kw)
    return flatten_bvh(bvh, tv, leaf_size=leaf_size), bvh


class TestFlatten:
    def test_structure_tiny(self, tiny_scene):
        flat, bvh = _flat_for(tiny_scene)
        T = tiny_scene.num_triangles
        # Every original triangle appears exactly once among live slots.
        live = flat.slot_map[flat.slot_map >= 0]
        assert sorted(live.tolist()) == list(range(T))
        assert flat.slot_map.shape[0] % flat.leaf_size == 0
        # Leaves reference L-aligned bases; inners reference valid children.
        for i in range(flat.n_nodes):
            if flat.count[i] > 0:
                assert flat.a[i] % flat.leaf_size == 0
                assert flat.count[i] <= flat.leaf_size
            else:
                c = flat.a[i]
                assert 0 < c and c + 1 < flat.n_nodes

    def test_children_contained_in_parent(self, car_only_scene):
        flat, _ = _flat_for(car_only_scene, heuristic=6)
        eps = 1e-4
        for i in range(flat.n_nodes):
            if flat.count[i] == 0:
                c = int(flat.a[i])
                for ch in (c, c + 1):
                    assert (flat.node_min[ch] >= flat.node_min[i] - eps).all()
                    assert (flat.node_max[ch] <= flat.node_max[i] + eps).all()

    def test_oversized_leaves_split(self, car_only_scene):
        # Force huge leaves via tiny depth; flattening must still bound count.
        tv = car_only_scene.triangle_vertices()
        bvh = build_bvh(tv, heuristic=1, max_depth=3)
        flat = flatten_bvh(bvh, tv, leaf_size=8)
        assert flat.count.max() <= 8
        live = flat.slot_map[flat.slot_map >= 0]
        assert live.shape[0] == tv.shape[0]

    def test_bf16_conservative(self, car_only_scene):
        flat, _ = _flat_for(car_only_scene)
        lo, hi = compress_bf16(flat)
        assert (lo.astype(np.float32) <= flat.node_min).all()
        assert (hi.astype(np.float32) >= flat.node_max).all()


class TestPacketVsBrute:
    @pytest.mark.parametrize("heuristic", [0, 3, 6])
    def test_tiny_scene_image_matches(self, tiny_scene, heuristic):
        flat, _ = _flat_for(tiny_scene, heuristic=heuristic)
        ds = device_scene_from_host(tiny_scene, slot_map=flat.slot_map)
        bvh, L, depth = device_bvh_from_flat(flat)
        cam = default_camera()
        img_bvh = np.asarray(
            render_bvh(
                ds, bvh, cam, 64, 48, variant="jax", bounces=3,
                leaf_size=L, depth=depth, tile_rows=16, tile_cols=16,
            )
        )
        ds_plain = device_scene_from_host(tiny_scene)
        img_ref = np.asarray(render_bruteforce(ds_plain, cam, 64, 48, bounces=3))
        np.testing.assert_allclose(img_bvh, img_ref, atol=2e-5)

    def test_car_only_image_matches(self, car_only_scene):
        flat, _ = _flat_for(car_only_scene, heuristic=3, leaf_size=4)
        ds = device_scene_from_host(car_only_scene, slot_map=flat.slot_map)
        bvh, L, depth = device_bvh_from_flat(flat)
        cam = default_camera()
        img_bvh = np.asarray(
            render_bvh(
                ds, bvh, cam, 64, 36, variant="jax", bounces=2,
                leaf_size=L, depth=depth, tile_rows=8, tile_cols=32,
            )
        )
        ds_plain = device_scene_from_host(car_only_scene)
        img_ref = np.asarray(
            render_bruteforce(ds_plain, cam, 64, 36, bounces=2, row_chunk=6)
        )
        # fp reassociation between the two paths allows tiny drift only.
        np.testing.assert_allclose(img_bvh, img_ref, atol=1e-4)

    def test_bf16_bvh_still_exact(self, tiny_scene):
        flat, _ = _flat_for(tiny_scene)
        ds = device_scene_from_host(tiny_scene, slot_map=flat.slot_map)
        bvh, L, depth = device_bvh_from_flat(flat, bf16=True)
        cam = default_camera()
        img = np.asarray(
            render_bvh(
                ds, bvh, cam, 64, 48, variant="jax", bounces=3,
                leaf_size=L, depth=depth, tile_rows=16, tile_cols=16,
            )
        )
        ds_plain = device_scene_from_host(tiny_scene)
        ref = np.asarray(render_bruteforce(ds_plain, cam, 64, 48, bounces=3))
        # Conservative rounding: boxes only grow, hits are identical.
        np.testing.assert_allclose(img, ref, atol=2e-5)

    def test_nonuniform_resolution_padding(self, tiny_scene):
        # width/height not multiples of the tile shape exercise pad + crop.
        flat, _ = _flat_for(tiny_scene)
        ds = device_scene_from_host(tiny_scene, slot_map=flat.slot_map)
        bvh, L, depth = device_bvh_from_flat(flat)
        cam = default_camera()
        img = np.asarray(
            render_bvh(
                ds, bvh, cam, 50, 37, variant="jax", bounces=2,
                leaf_size=L, depth=depth, tile_rows=16, tile_cols=16,
            )
        )
        assert img.shape == (37, 50, 3)
        ds_plain = device_scene_from_host(tiny_scene)
        ref = np.asarray(render_bruteforce(ds_plain, cam, 50, 37, bounces=2))
        np.testing.assert_allclose(img, ref, atol=2e-5)
