"""Native C++ host runtime vs the NumPy reference implementations."""

import numpy as np
import pytest

from parallel_ray_tracer_tpu.native import builder as nb

pytestmark = pytest.mark.skipif(
    not nb.available(), reason="native toolchain unavailable"
)


def write_obj_scene(scene, path):
    """Write a Scene as the reference's OBJ/MTL/lights text files.

    Material slot 0 is the loaders' implicit zero material, so faces that
    use it are written before the first `usemtl`. The loaders read Kd/Ks/Kr
    within the 5 lines after `newmtl`, so filler lines keep each material's
    window clear of the next one.
    """
    order = np.argsort(scene.mat_idx != 0, kind="stable")
    assert (order == np.arange(order.size)).all(), "slot-0 faces must lead"
    with open(path / "triangles.mtl", "w") as f:
        for m in range(1, scene.mats_kd.shape[0]):
            f.write(f"newmtl m{m}\n")
            for tag, tbl in (("Kd", scene.mats_kd), ("Ks", scene.mats_ks),
                             ("Kr", scene.mats_kr)):
                f.write(tag + "".join(f" {x:.9g}" for x in tbl[m]) + "\n")
            f.write("Ns 0\nd 1\nillum 2\n")
    with open(path / "triangles.obj", "w") as f:
        for v in scene.verts:
            f.write("v" + "".join(f" {x:.9g}" for x in v) + "\n")
        cur = 0
        for face, m in zip(scene.faces, scene.mat_idx):
            if m != cur:
                f.write(f"usemtl m{m}\n")
                cur = m
            f.write("f" + "".join(f" {i + 1}" for i in face) + "\n")
    with open(path / "lights.obj", "w") as f:
        for pos, kl in zip(scene.lights_pos, scene.lights_kl):
            f.write(" ".join(f"{x:.9g}" for x in (*pos, *kl)) + "\n")


class TestNativeSceneLoader:
    def test_exact_parity_with_python_parser(self, car_only_scene, tmp_path):
        from parallel_ray_tracer_tpu.models.scene import load_scene

        write_obj_scene(car_only_scene, tmp_path)
        sc = nb.load_scene_native(str(tmp_path))
        py = load_scene(str(tmp_path))
        for ref in (py, car_only_scene):
            assert np.array_equal(sc.verts, ref.verts)
            assert np.array_equal(sc.faces, ref.faces)
            assert np.array_equal(sc.mat_idx, ref.mat_idx)
            assert np.array_equal(sc.mats_kd, ref.mats_kd)
            assert np.array_equal(sc.mats_ks, ref.mats_ks)
            assert np.array_equal(sc.mats_kr, ref.mats_kr)
            assert np.array_equal(sc.lights_pos, ref.lights_pos)
            assert np.array_equal(sc.lights_kl, ref.lights_kl)


class TestNativeBVH:
    @pytest.mark.parametrize("heuristic", [0, 1, 3, 4, 5, 6])
    def test_invariants(self, tiny_scene, heuristic):
        tv = tiny_scene.triangle_vertices()
        flat, stats = nb.build_bvh_native(
            tv, heuristic=heuristic, leaf_threshold=2, leaf_size=4
        )
        live = flat.slot_map[flat.slot_map >= 0]
        assert sorted(live.tolist()) == list(range(tv.shape[0]))
        assert (flat.count[flat.count > 0] <= 4).all()
        assert flat.n_slots % 4 == 0
        assert stats["leaf_count"] > 0

    def test_render_matches_oracle(self, car_only_scene):
        import jax.numpy as jnp
        from parallel_ray_tracer_tpu.models.camera import default_camera
        from parallel_ray_tracer_tpu.models.device_scene import (
            device_scene_from_host,
        )
        from parallel_ray_tracer_tpu.ops import trace_bvh
        from parallel_ray_tracer_tpu.ops.render import (
            render_bruteforce,
            render_bvh,
        )

        tv = car_only_scene.triangle_vertices()
        flat, _ = nb.build_bvh_native(
            tv, heuristic=6, leaf_threshold=8, leaf_size=8
        )
        ds = device_scene_from_host(car_only_scene, slot_map=flat.slot_map)
        dbvh, _, depth = trace_bvh.device_bvh_from_flat(flat)
        cam = default_camera()
        img = np.asarray(
            render_bvh(
                ds, dbvh, cam, 64, 36, variant="jax", bounces=2,
                leaf_size=8, depth=depth, tile_rows=8, tile_cols=32,
            )
        )
        ds_p = device_scene_from_host(car_only_scene)
        ref = np.asarray(
            render_bruteforce(ds_p, cam, 64, 36, bounces=2, row_chunk=6)
        )
        np.testing.assert_allclose(img, ref, atol=1e-4)

    def test_pipeline_uses_native(self, tiny_scene):
        from parallel_ray_tracer_tpu.config import RenderConfig
        from parallel_ray_tracer_tpu import pipeline

        cfg = RenderConfig(
            width=48, height=32, bounces=2, tile_rows=32, tile_cols=32,
            bvh_heuristic=6, use_native=True,
        )
        pipe = pipeline.prepare(cfg, scene=tiny_scene)
        assert pipe.bvh is None  # native path skips the NumPy tree
        assert pipe.bvh_stats is not None
        img = np.asarray(pipe.render(variant="jax"))
        ref = np.asarray(pipe.render(variant="bruteforce"))
        np.testing.assert_allclose(img, ref, atol=3e-5)

    @pytest.mark.parametrize("true_sah", [False, True])
    def test_true_sah_parity_with_numpy(self, true_sah):
        """C++ and NumPy builders agree exactly, both area formulas."""
        from parallel_ray_tracer_tpu.ops.bvh import build_bvh
        from parallel_ray_tracer_tpu.ops.bvh_flat import flatten_bvh

        rng = np.random.RandomState(3)
        tv = rng.rand(2000, 3, 3).astype(np.float32)
        flat_n, _ = nb.build_bvh_native(
            tv, heuristic=6, leaf_threshold=8, leaf_size=8, true_sah=true_sah
        )
        bvh = build_bvh(tv, heuristic=6, leaf_threshold=8, true_sah=true_sah)
        flat_p = flatten_bvh(bvh, tv, leaf_size=8)
        assert np.array_equal(flat_n.slot_map, flat_p.slot_map)
        np.testing.assert_allclose(flat_n.node_min, flat_p.node_min)
        np.testing.assert_allclose(flat_n.node_max, flat_p.node_max)
        assert np.array_equal(flat_n.count, flat_p.count)
        assert np.array_equal(flat_n.a, flat_p.a)

    def test_deterministic_per_seed(self, tiny_scene):
        tv = tiny_scene.triangle_vertices()
        a = nb.build_bvh_native(tv, heuristic=3, seed=7)
        b = nb.build_bvh_native(tv, heuristic=3, seed=7)
        c = nb.build_bvh_native(tv, heuristic=3, seed=8)
        assert np.array_equal(a[0].slot_map, b[0].slot_map)
        assert np.array_equal(a[0].node_min, b[0].node_min)
        # different seed may (usually does) give a different random tree;
        # only determinism per seed is contractual, so no assert on c.
        assert c is not None
