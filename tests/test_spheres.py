"""Sphere primitives through the full trace path (ops/spheres.py)."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from parallel_ray_tracer_tpu.models.scene import Scene, load_spheres
from parallel_ray_tracer_tpu.models.device_scene import device_scene_from_host
from parallel_ray_tracer_tpu.models.camera import default_camera
from parallel_ray_tracer_tpu.ops.render import render_bruteforce, render_bvh
from parallel_ray_tracer_tpu.ops.bvh import build_bvh
from parallel_ray_tracer_tpu.ops.bvh_flat import flatten_bvh
from parallel_ray_tracer_tpu.ops import trace_bvh


@pytest.fixture()
def sphere_scene():
    """Floor + one diffuse sphere + one mirror sphere + a light."""
    verts = np.array(
        [[-8, -8, 0], [8, -8, 0], [8, 8, 0], [-8, 8, 0]], np.float32
    )
    faces = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    return Scene(
        verts=verts,
        faces=faces,
        mat_idx=np.zeros(2, np.int32),
        mats_kd=np.array([[0.7, 0.7, 0.7], [0.7, 0.2, 0.2], [0.1, 0.1, 0.1]], np.float32),
        mats_ks=np.array([[0.0, 0.0, 0.0], [0.4, 0.4, 0.4], [0.2, 0.2, 0.2]], np.float32),
        mats_kr=np.array([[0.0, 0.0, 0.0], [0.0, 0.0, 0.0], [0.8, 0.8, 0.8]], np.float32),
        lights_pos=np.array([[0.0, -5.0, 7.0]], np.float32),
        lights_kl=np.array([[40.0, 40.0, 40.0]], np.float32),
        spheres_center=np.array([[-1.2, 0.5, 1.0], [1.4, 1.0, 1.2]], np.float32),
        spheres_radius=np.array([1.0, 1.2], np.float32),
        spheres_mat=np.array([1, 2], np.int32),
    )


def test_spheres_parser():
    c, r, m = load_spheres("1 2 3 0.5 2\n# junk\n4 5 6 1.0\nshort line\n")
    assert c.shape == (2, 3) and r.tolist() == [0.5, 1.0]
    assert m.tolist() == [2, 0]


def test_spheres_render_visible_and_shadowed(sphere_scene):
    ds = device_scene_from_host(sphere_scene)
    img = np.asarray(
        render_bruteforce(ds, default_camera(), 64, 48, bounces=2)
    )
    # Red diffuse sphere visible: some pixels dominated by red.
    red = (img[..., 0] > img[..., 1] + 0.1) & (img[..., 0] > img[..., 2] + 0.1)
    assert red.sum() > 10
    # The spheres cast shadows: floor brightness varies beyond noise.
    assert img.std() > 0.05


def test_spheres_in_bvh_variant_match_bruteforce(sphere_scene):
    tv = sphere_scene.triangle_vertices()
    bvh = build_bvh(tv, heuristic=1, leaf_threshold=2)
    flat = flatten_bvh(bvh, tv, leaf_size=4)
    ds = device_scene_from_host(sphere_scene, slot_map=flat.slot_map)
    dbvh, L, depth = trace_bvh.device_bvh_from_flat(flat)
    cam = default_camera()
    img_bvh = np.asarray(
        render_bvh(
            ds, dbvh, cam, 64, 32, variant="jax", bounces=2,
            leaf_size=L, depth=depth, tile_rows=32, tile_cols=32,
        )
    )
    ds_plain = device_scene_from_host(sphere_scene)
    ref = np.asarray(render_bruteforce(ds_plain, cam, 64, 32, bounces=2))
    np.testing.assert_allclose(img_bvh, ref, atol=3e-5)


def test_sphere_gradients(sphere_scene):
    """d(image)/d(sphere radius) via the differentiable path vs FD."""
    from parallel_ray_tracer_tpu.models.device_scene import build_device_scene
    from parallel_ray_tracer_tpu.models.camera import ray_basis
    from parallel_ray_tracer_tpu.ops.render import generate_rays_tiled
    from parallel_ray_tracer_tpu.ops import diff, trace_brute

    sc = sphere_scene
    cam_arrays = tuple(
        jnp.asarray(a) for a in ray_basis(default_camera(), 32, 32)
    )
    o, d = generate_rays_tiled(cam_arrays, 32, 32, 32, 32)

    def loss(radius):
        ds = build_device_scene(
            jnp.asarray(sc.verts), sc.faces, sc.mat_idx, sc.mats_kd,
            sc.mats_ks, sc.mats_kr, sc.lights_pos, sc.lights_kl,
            spheres_center=sc.spheres_center,
            spheres_radius=radius,
            spheres_mat=sc.spheres_mat,
        )
        cf, of = trace_brute.make_tracer(ds)
        col = diff.trace_rays_diff(ds, cf, of, o, d, 1)
        return jnp.sum(col.x + col.y + col.z)

    r0 = jnp.asarray(sc.spheres_radius)
    g = jax.grad(loss)(r0)
    # FD of an image loss w.r.t. radius is dominated by silhouette edge
    # terms the interior formulation intentionally drops, so the image-level
    # check is finiteness + nonzero flow only; the exact interior derivative
    # is verified analytically below.
    assert bool(jnp.isfinite(g).all())
    assert float(jnp.abs(g).sum()) > 0.0

    # Analytic check: a ray straight at the sphere center has t = dist - r,
    # so dt/dr = -1 exactly.
    from parallel_ray_tracer_tpu.ops.intersect import ray_sphere
    from parallel_ray_tracer_tpu.ops.vecmath import Vec3 as V

    def t_of_r(r):
        h = ray_sphere(
            V(jnp.float32(0), jnp.float32(-5), jnp.float32(1)),
            V(jnp.float32(0), jnp.float32(1), jnp.float32(0)),
            V(jnp.float32(0), jnp.float32(0), jnp.float32(1)),
            r,
        )
        return h.t

    assert abs(float(t_of_r(jnp.float32(0.5))) - 4.5) < 1e-5
    dt_dr = jax.grad(t_of_r)(jnp.float32(0.5))
    assert abs(float(dt_dr) + 1.0) < 1e-5
