"""Regression tests for the round-1 advisor findings.

1. Traversal stacks are sized from the actual tree depth instead of a fixed
   constant (deep --max-depth trees could overflow).
2. The native loader path no longer drops spheres.obj.
3. A tiny scene whose root is a leaf traces exactly (no synthetic root).
4. flatten_bvh fails loudly on an inner node with two dead children
   instead of recursing forever.
"""

import numpy as np
import pytest

from parallel_ray_tracer_tpu.models.scene import Scene
from parallel_ray_tracer_tpu.ops import gpu_trace, trace_bvh
from parallel_ray_tracer_tpu.ops.bvh import BVH, build_bvh
from parallel_ray_tracer_tpu.ops.bvh_flat import flatten_bvh
from parallel_ray_tracer_tpu.ops.vecmath import Vec3


def _scene_for(tv):
    n = tv.shape[0]
    return Scene(
        verts=tv.reshape(-1, 3), faces=np.arange(3 * n).reshape(n, 3),
        mat_idx=np.zeros(n, np.int32), mats_kd=np.ones((1, 3), np.float32),
        mats_ks=np.zeros((1, 3), np.float32),
        mats_kr=np.zeros((1, 3), np.float32),
        lights_pos=np.zeros((0, 3), np.float32),
        lights_kl=np.zeros((0, 3), np.float32),
    )


def _kernel_tracer(tv, flat):
    from parallel_ray_tracer_tpu.models.device_scene import (
        device_scene_from_host,
    )

    ds = device_scene_from_host(_scene_for(tv), slot_map=flat.slot_map)
    dbvh, L, depth = trace_bvh.device_bvh_from_flat(flat)
    return gpu_trace.make_tracer(dbvh, ds, L, depth, interpret=True)


class TestStackDepthGuard:
    def test_monotone_and_floor(self):
        per_ray = gpu_trace.stack_depth_for
        packet = trace_bvh.packet_stack_depth
        # Per-ray: one pending sibling per level, at least one slot.
        assert per_ray(0) == 1
        assert per_ray(22) == 22
        assert per_ray(120) == 120
        # Packets push both children per level; shallow trees keep a floor.
        assert packet(0) == 16
        assert packet(120) == 244
        depths = range(0, 200, 7)
        assert all(per_ray(a) <= per_ray(b) for a, b in zip(depths, depths[1:]))
        assert all(packet(d) >= per_ray(d) for d in depths)

    def test_pipeline_threads_depth(self, tiny_scene):
        from parallel_ray_tracer_tpu import pipeline
        from parallel_ray_tracer_tpu.config import RenderConfig

        cfg = RenderConfig(width=32, height=32, use_native=False)
        pipe = pipeline.prepare(cfg, scene=tiny_scene)
        assert pipe.depth == pipe.flat.depth

    def test_deep_tree_traces_in_interpret_mode(self):
        # 160 triangles stacked along one axis, leaf_threshold 1, midpoint
        # splits; the per-ray stack must cover the tree.
        n = 160
        z = np.arange(n, dtype=np.float32)[:, None]
        base = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)
        tv = base[None, :, :] + np.concatenate(
            [np.zeros((n, 1, 2), np.float32), z[:, :, None]], axis=2
        )
        bvh = build_bvh(tv, heuristic=1, max_depth=64, leaf_threshold=1)
        flat = flatten_bvh(bvh, tv, leaf_size=2)
        R = 64
        o = Vec3(
            np.full((R,), 0.3, np.float32),
            np.full((R,), 0.3, np.float32),
            np.full((R,), -1.0, np.float32),
        )
        d = Vec3(
            np.zeros((R,), np.float32),
            np.zeros((R,), np.float32),
            np.ones((R,), np.float32),
        )
        closest, _ = _kernel_tracer(tv, flat)
        h = closest(o, d)
        t = np.asarray(h.t)
        # Nearest stacked triangle is at z=0 -> t = 1.
        np.testing.assert_allclose(t, 1.0, atol=1e-5)


class TestTinySceneRootLeaf:
    def test_root_is_leaf(self):
        tv = np.array(
            [[[0, 0, 0], [1, 0, 0], [0, 1, 0]]], np.float32
        )
        bvh = build_bvh(tv, heuristic=0, leaf_threshold=4)
        flat = flatten_bvh(bvh, tv, leaf_size=4)
        assert flat.n_nodes == 1 and flat.count[0] == 1 and flat.depth == 0
        assert (flat.node_min[0] <= flat.node_max[0]).all()

    def test_single_triangle_hit_is_exact(self):
        tv = np.array(
            [[[0, 0, 0], [1, 0, 0], [0, 1, 0]]], np.float32
        )
        bvh = build_bvh(tv, heuristic=0, leaf_threshold=4)
        flat = flatten_bvh(bvh, tv, leaf_size=4)
        R = 64
        o = Vec3(
            np.full((R,), 0.2, np.float32),
            np.full((R,), 0.2, np.float32),
            np.full((R,), 2.0, np.float32),
        )
        d = Vec3(
            np.zeros((R,), np.float32),
            np.zeros((R,), np.float32),
            np.full((R,), -1.0, np.float32),
        )
        closest, occluded = _kernel_tracer(tv, flat)
        h = closest(o, d)
        np.testing.assert_allclose(np.asarray(h.t), 2.0, atol=1e-5)
        assert (np.asarray(h.idx) == 0).all()
        blocked = occluded(o, d, np.full((R,), 9.0, np.float32))
        assert np.asarray(blocked).all()


class TestDeadSubtreeGuard:
    def test_two_dead_children_raises(self):
        # Hand-built malformed tree: root is inner, both children dead
        # (count == 0 and a == 0, the builder's failed-split marker).
        tv = np.array([[[0, 0, 0], [1, 0, 0], [0, 1, 0]]], np.float32)
        z3 = np.zeros(3, np.float32)
        bvh = BVH(
            min_x=z3.copy(), min_y=z3.copy(), min_z=z3.copy(),
            max_x=z3 + 1, max_y=z3 + 1, max_z=z3 + 1,
            count=np.array([0, 0, 0], np.int32),
            a=np.array([1, 0, 0], np.int32),
            tri_perm=np.array([0], np.int32),
            stats={},
        )
        with pytest.raises(AssertionError, match="two dead children"):
            flatten_bvh(bvh, tv, leaf_size=4)


class TestNativeSphereParity:
    def test_native_loader_includes_spheres(self, tmp_path):
        from parallel_ray_tracer_tpu.native import builder as nb

        if not nb.available():
            pytest.skip("native toolchain unavailable")
        (tmp_path / "triangles.obj").write_text(
            "v 0 0 0\nv 1 0 0\nv 0 1 0\nusemtl m\nf 1 2 3\n"
        )
        (tmp_path / "triangles.mtl").write_text(
            "newmtl m\nKd 0.5 0.5 0.5\nKs 0 0 0\nKr 0 0 0\n"
        )
        (tmp_path / "lights.obj").write_text("0 0 5 10 10 10\n")
        (tmp_path / "spheres.obj").write_text("0.5 0.5 2 0.25 1\n")

        from parallel_ray_tracer_tpu.models.scene import load_scene

        sc_native = nb.load_scene_native(str(tmp_path))
        sc_py = load_scene(str(tmp_path))
        assert sc_native.num_spheres == sc_py.num_spheres == 1
        np.testing.assert_array_equal(
            sc_native.spheres_center, sc_py.spheres_center
        )
        np.testing.assert_array_equal(
            sc_native.spheres_radius, sc_py.spheres_radius
        )
        np.testing.assert_array_equal(
            sc_native.spheres_mat, sc_py.spheres_mat
        )
