"""Procedural substitute scenes (models/procgen.py): structure + renders."""

import numpy as np
import pytest

from parallel_ray_tracer_tpu.config import DEFAULT_ASSET_ROOTS, RenderConfig
from parallel_ray_tracer_tpu.models import procgen
from parallel_ray_tracer_tpu import pipeline

ROOTS = DEFAULT_ASSET_ROOTS


def test_dragon_profile():
    sc = procgen.dragon_scene(target_triangles=20_000)
    # High-poly knot + floor; 2 lights / 6 materials like the reference's
    # dragon lights.obj + triangles.mtl profile.
    assert sc.num_triangles >= 18_000
    assert sc.num_lights == 2 and sc.num_materials == 6
    tv = sc.triangle_vertices().reshape(-1, 3)
    assert np.isfinite(tv).all()
    # Deterministic per seed.
    sc2 = procgen.dragon_scene(target_triangles=20_000)
    assert np.array_equal(sc.verts, sc2.verts)


def test_two_cars_profile():
    sc = procgen.substitute_scene("two_cars", ROOTS)
    if sc is None:
        pytest.skip("car_only unavailable")
    assert sc.num_lights == 2
    # Two instances: twice car_only's triangle count.
    assert sc.num_triangles % 2 == 0 and sc.num_triangles > 60_000
    # The instances must be disjoint in x (no overlapping bodies).
    half = sc.verts.shape[0] // 2
    assert sc.verts[:half, 0].mean() < sc.verts[half:, 0].mean()


def test_sportscar_profile():
    sc = procgen.substitute_scene("sportscar", ROOTS)
    if sc is None:
        pytest.skip("car_only unavailable")
    assert sc.num_lights == 4
    # Reflective showroom floor material appended.
    assert sc.mats_kr[-1].max() > 0.3


def test_dragon_renders_small():
    cfg = RenderConfig(
        width=64, height=32, scene="dragon", bounces=1,
        bvh_heuristic=6, tile_rows=32, tile_cols=32,
    )
    sc = procgen.dragon_scene(target_triangles=8_000)
    pipe = pipeline.prepare(cfg, scene=sc)
    img = np.asarray(pipe.render(variant="jax"))
    assert np.isfinite(img).all()
    # Knot (green) visible above floor: green channel dominates somewhere.
    assert ((img[..., 1] > img[..., 0] + 0.05) & (img[..., 1] > img[..., 2] + 0.05)).any()
