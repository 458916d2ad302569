"""Pre-split of oversized triangles (models/presplit.py): geometric
invariants + image equality with the unsplit scene.

The reference has no presplit (its trees degrade on scene-sized wall
triangles, cpu/src/bvh.c:78-267); these tests pin the tree-quality
optimization to "invisible except to the traversal cost".
"""

import numpy as np
import pytest

from parallel_ray_tracer_tpu import pipeline
from parallel_ray_tracer_tpu.config import RenderConfig
from parallel_ray_tracer_tpu.models.presplit import presplit_scene
from parallel_ray_tracer_tpu.models.scene import Scene


def _area(scene) -> float:
    tv = scene.triangle_vertices()
    cr = np.cross(tv[:, 1] - tv[:, 0], tv[:, 2] - tv[:, 0])
    return float(np.linalg.norm(cr, axis=1).sum() / 2)


def _box_scene() -> Scene:
    # Two scene-sized floor triangles + a small off-center one.
    verts = np.array(
        [
            [0, 0, 0], [10, 0, 0], [10, 0, 10], [0, 0, 10],
            [4, 1, 4], [4.5, 1, 4], [4, 1, 4.5],
        ],
        np.float32,
    )
    faces = np.array([[0, 1, 2], [0, 2, 3], [4, 5, 6]], np.int32)
    return Scene(
        verts=verts,
        faces=faces,
        mat_idx=np.array([0, 0, 1], np.int32),
        mats_kd=np.array([[0.5, 0.5, 0.5], [0.9, 0.1, 0.1]], np.float32),
        mats_ks=np.zeros((2, 3), np.float32),
        mats_kr=np.zeros((2, 3), np.float32),
        lights_pos=np.array([[5.0, 5.0, 5.0]], np.float32),
        lights_kl=np.array([[1.0, 1.0, 1.0]], np.float32),
    )


def test_invariants():
    sc = _box_scene()
    sp, src = presplit_scene(sc, ratio=1 / 8, budget=200.0)
    # Big triangles got split, the small one survived untouched.
    assert sp.num_triangles > sc.num_triangles
    assert (np.asarray(sc.mat_idx)[src] == sp.mat_idx).all()
    # Total surface area is conserved (coplanar bisection).
    assert _area(sp) == pytest.approx(_area(sc), rel=1e-5)
    # Every output triangle's AABB diagonal obeys the bound.
    tv = sp.triangle_vertices()
    ext = tv.max(axis=1) - tv.min(axis=1)
    d2 = (ext * ext).sum(axis=1)
    scene_ext = sp.verts.max(axis=0) - sp.verts.min(axis=0)
    limit2 = float((scene_ext * scene_ext).sum()) * (1 / 8) ** 2
    assert (d2 <= limit2 * (1 + 1e-5)).all()
    # Original vertices are a prefix of the split vertex array.
    np.testing.assert_array_equal(sp.verts[: len(sc.verts)], sc.verts)


def test_small_scene_noop():
    sc = _box_scene()
    sp, src = presplit_scene(sc, ratio=10.0)
    assert sp.num_triangles == sc.num_triangles
    np.testing.assert_array_equal(src, np.arange(3))


def test_budget_cap():
    sc = _box_scene()
    sp, _ = presplit_scene(sc, ratio=1 / 64, budget=2.0)
    assert sp.num_triangles <= 2 * sc.num_triangles + 2


def test_image_equality():
    base = dict(
        width=64, height=32, scene="car_only", bounces=2,
        bvh_heuristic=6, tile_rows=8, tile_cols=128,
    )
    img0 = np.asarray(
        pipeline.prepare(RenderConfig(**base)).render(variant="jax")
    )
    img1 = np.asarray(
        pipeline.prepare(RenderConfig(presplit=1 / 8, **base)).render(
            variant="jax"
        )
    )
    np.testing.assert_allclose(img0, img1, atol=1e-4)
