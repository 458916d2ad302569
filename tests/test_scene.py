"""Scene layer tests: OBJ/MTL/light parsing (cpu/src/triangle.c semantics)."""

import numpy as np

from parallel_ray_tracer_tpu.models.scene import (
    load_lights,
    load_obj,
    parse_materials,
    synthetic_scene,
)

MTL = """# comment
newmtl red
Ns 250.0
Ka 1 1 1
Kd 0.6 0 0
Ks 0.5 0.5 0.5
Kr 0.2 0.1 0.1

newmtl far_kd
l1
l2
l3
l4
l5
Kd 0.9 0.9 0.9
"""

OBJ = """v 0 0 0
v 1 0 0
v 0 1 0
v 0 0 1
f 1 2 3
usemtl red
f 1 2 4
usemtl missing_name
f 2 3 4
"""


def test_parse_materials_window():
    by_name, kd, ks, kr = parse_materials(MTL)
    assert by_name == {"red": 0, "far_kd": 1}
    np.testing.assert_allclose(kd[0], [0.6, 0, 0])
    np.testing.assert_allclose(ks[0], [0.5, 0.5, 0.5])
    np.testing.assert_allclose(kr[0], [0.2, 0.1, 0.1])
    # Kd more than 5 lines after newmtl is ignored (cpu/src/triangle.c:60).
    np.testing.assert_allclose(kd[1], [0, 0, 0])


def test_load_obj_materials_and_faces():
    sc = load_obj(OBJ, MTL)
    assert sc.num_triangles == 3
    assert sc.verts.shape == (4, 3)
    # Face before any usemtl -> implicit zero material (slot 0).
    np.testing.assert_allclose(sc.mats_kd[sc.mat_idx[0]], [0, 0, 0])
    # Face after usemtl red.
    np.testing.assert_allclose(sc.mats_kd[sc.mat_idx[1]], [0.6, 0, 0])
    # Unknown usemtl keeps the previous material (reference behavior).
    assert sc.mat_idx[2] == sc.mat_idx[1]


def test_normals_both_directions():
    sc = load_obj(OBJ, MTL)
    n = sc.normals()
    assert n.shape == (3, 2, 3)
    np.testing.assert_allclose(n[0, 0], [0, 0, 1], atol=1e-6)
    np.testing.assert_allclose(n[0, 1], [0, 0, -1], atol=1e-6)
    np.testing.assert_allclose(
        np.linalg.norm(n[1:, 0], axis=-1), 1.0, atol=1e-6
    )


def test_centroids():
    sc = load_obj(OBJ, MTL)
    np.testing.assert_allclose(
        sc.centroids()[0], [1 / 3, 1 / 3, 0], atol=1e-6
    )


def test_load_lights():
    pos, kl = load_lights("0 -8 3 50 50 50\n1 2 3 4 5 6")
    assert pos.shape == (2, 3)
    np.testing.assert_allclose(pos[0], [0, -8, 3])
    np.testing.assert_allclose(kl[1], [4, 5, 6])


def test_synthetic_scene():
    sc = synthetic_scene(100, seed=1)
    assert sc.num_triangles == 100
    assert sc.num_lights == 0
    tv = sc.triangle_vertices()
    # a in [-5, 5); b = a + U[0,1); c = b + U[0,1)
    assert tv[:, 0].min() >= -5 and tv[:, 0].max() < 5
    assert ((tv[:, 1] - tv[:, 0]) >= 0).all()
    assert ((tv[:, 2] - tv[:, 1]) >= 0).all()
    # deterministic
    sc2 = synthetic_scene(100, seed=1)
    np.testing.assert_array_equal(sc.verts, sc2.verts)


def test_reference_scene_counts():
    """Scene size facts from BASELINE.md (car_only: 32,136 tris, 18 mats),
    on the bundled snapshot (a byte-exact dump of the OBJ parse)."""
    import os

    from parallel_ray_tracer_tpu.config import DEFAULT_ASSET_ROOTS
    from parallel_ray_tracer_tpu.models.scene import load_scene_npz

    sc = load_scene_npz(os.path.join(DEFAULT_ASSET_ROOTS[0], "car_only.npz"))
    assert sc.num_triangles == 32136
    assert sc.verts.shape[0] == 17861
    assert sc.num_lights == 1
    # 18 named materials + 1 implicit zero slot.
    assert sc.num_materials == 19
