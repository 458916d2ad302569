"""Differentiable rendering: finite-difference gradient checks (SURVEY.md §4,
BASELINE north star: pixel-grad allclose vs FD).

FD comparisons avoid silhouette/shadow-edge pixels where the true derivative
has a Dirac edge term the interior formulation intentionally drops.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from parallel_ray_tracer_tpu.models.camera import default_camera, ray_basis
from parallel_ray_tracer_tpu.models.device_scene import build_device_scene
from parallel_ray_tracer_tpu.ops import diff, trace_brute, trace_bvh
from parallel_ray_tracer_tpu.ops.bvh import build_bvh
from parallel_ray_tracer_tpu.ops.bvh_flat import flatten_bvh
from parallel_ray_tracer_tpu.ops.render import generate_rays_tiled
from parallel_ray_tracer_tpu.ops.shade import trace_rays
from parallel_ray_tracer_tpu.ops.vecmath import Vec3


def _scene_arrays(tiny_scene):
    return dict(
        faces=tiny_scene.faces,
        mat_idx=tiny_scene.mat_idx,
        mats_kd=tiny_scene.mats_kd,
        mats_ks=tiny_scene.mats_ks,
        mats_kr=tiny_scene.mats_kr,
        lights_pos=tiny_scene.lights_pos,
        lights_kl=tiny_scene.lights_kl,
    )


def _rays(width=32, height=32):
    cam_arrays = tuple(
        jnp.asarray(a) for a in ray_basis(default_camera(), width, height)
    )
    return generate_rays_tiled(cam_arrays, width, height, 32, 32)


def _render_from(verts, arrs, o, d, bounces=2, soft=False, **scene_over):
    kw = dict(arrs)
    kw.update(scene_over)
    ds = build_device_scene(verts, **kw)
    closest_fn, occluded_fn = trace_brute.make_tracer(ds)
    col = diff.trace_rays_diff(
        ds, closest_fn, occluded_fn, o, d, bounces, soft_shadows=soft
    )
    return jnp.stack([col.x, col.y, col.z], axis=-1)


class TestDiffClosest:
    def test_forward_matches_tracer(self, tiny_scene):
        arrs = _scene_arrays(tiny_scene)
        verts = jnp.asarray(tiny_scene.verts)
        o, d = _rays()
        img_diff = np.asarray(_render_from(verts, arrs, o, d))
        # plain (non-diff) forward
        ds = build_device_scene(verts, **arrs)
        closest_fn, occluded_fn = trace_brute.make_tracer(ds)
        col = trace_rays(ds, closest_fn, occluded_fn, o, d, 2)
        img_ref = np.asarray(jnp.stack([col.x, col.y, col.z], axis=-1))
        np.testing.assert_allclose(img_diff, img_ref, atol=1e-5)

    def test_material_gradient_matches_fd(self, tiny_scene):
        """d(loss)/d(kd): smooth in materials -> FD matches tightly."""
        arrs = _scene_arrays(tiny_scene)
        verts = jnp.asarray(tiny_scene.verts)
        o, d = _rays()

        def loss(kd):
            img = _render_from(verts, arrs, o, d, mats_kd=kd)
            return jnp.sum(img)

        kd0 = jnp.asarray(tiny_scene.mats_kd)
        g = jax.grad(loss)(kd0)
        h = 1e-3
        for (i, c) in [(0, 0), (1, 1), (2, 2)]:
            e = np.zeros_like(kd0)
            e[i, c] = h
            fd = (loss(kd0 + e) - loss(kd0 - e)) / (2 * h)
            assert np.isfinite(float(g[i, c]))
            np.testing.assert_allclose(float(g[i, c]), float(fd), rtol=2e-2)

    def test_light_gradient_matches_fd(self, tiny_scene):
        arrs = _scene_arrays(tiny_scene)
        verts = jnp.asarray(tiny_scene.verts)
        o, d = _rays()

        def loss(kl):
            img = _render_from(verts, arrs, o, d, lights_kl=kl)
            return jnp.sum(img)

        kl0 = jnp.asarray(tiny_scene.lights_kl)
        g = jax.grad(loss)(kl0)
        h = 1e-2
        e = np.zeros_like(kl0)
        e[0, 0] = h
        fd = (loss(kl0 + e) - loss(kl0 - e)) / (2 * h)
        np.testing.assert_allclose(float(g[0, 0]), float(fd), rtol=2e-2)

    def test_vertex_gradient_matches_fd_interior(self, tiny_scene):
        """d(masked loss)/d(floor vertex): FD on pixels away from edges."""
        arrs = _scene_arrays(tiny_scene)
        verts0 = jnp.asarray(tiny_scene.verts)
        o, d = _rays()

        # Interior mask: pixels whose hit triangle is the floor both before
        # and after a small perturbation, and whose 4-neighborhood hits the
        # same triangle (away from silhouettes and shadow edges).
        ds0 = build_device_scene(verts0, **_scene_arrays(tiny_scene))
        closest_fn, _ = trace_brute.make_tracer(ds0)
        hit = closest_fn(o, d)
        idx_img = np.asarray(hit.idx).reshape(32, 32)
        same = np.ones((32, 32), bool)
        for dy, dx in ((0, 1), (0, -1), (1, 0), (-1, 0), (0, 2), (2, 0)):
            same &= idx_img == np.roll(idx_img, (dy, dx), (0, 1))
        mask = jnp.asarray((same & (idx_img == 0)).reshape(-1), jnp.float32)

        def loss(verts):
            img = _render_from(verts, arrs, o, d, bounces=1)
            return jnp.sum(img.sum(axis=-1) * mask)

        g = jax.grad(loss)(verts0)
        h = 2e-3
        # The three visible floor vertices' z-derivatives are large and
        # smooth on interior pixels (measured agreement ~0.04%); every one
        # must be informative AND match tightly — no soft fallbacks.
        for vi, c in [(0, 2), (1, 2), (2, 2)]:
            e = np.zeros_like(verts0)
            e[vi, c] = h
            fd = (loss(verts0 + e) - loss(verts0 - e)) / (2 * h)
            assert abs(float(fd)) > 1.0, f"FD direction ({vi},{c}) uninformative"
            np.testing.assert_allclose(float(g[vi, c]), float(fd), rtol=5e-3)


class TestSoftShadows:
    def test_soft_matches_hard_away_from_edges(self, tiny_scene):
        arrs = _scene_arrays(tiny_scene)
        verts = jnp.asarray(tiny_scene.verts)
        o, d = _rays()
        img_hard = np.asarray(_render_from(verts, arrs, o, d, soft=False))
        img_soft = np.asarray(
            _render_from(verts, arrs, o, d, soft=True)
        )
        # Most pixels agree; only the shadow penumbra band differs.
        close = np.isclose(img_hard, img_soft, atol=5e-2).mean()
        assert close > 0.9

    def test_occluder_gradient_nonzero_only_when_soft(self, tiny_scene):
        arrs = _scene_arrays(tiny_scene)
        verts0 = jnp.asarray(tiny_scene.verts)
        o, d = _rays()

        def loss(verts, soft):
            img = _render_from(verts, arrs, o, d, bounces=1, soft=soft)
            return jnp.sum(img)

        # Vertices 4..6 form the raised triangle, the actual shadow caster in
        # this view. Hard visibility is a step (zero gradient through the
        # shadow term); soft visibility adds an edge-aware component, so the
        # blocker gradient must differ between the two modes.
        g_soft = jax.grad(lambda v: loss(v, True))(verts0)
        g_hard = jax.grad(lambda v: loss(v, False))(verts0)
        assert np.isfinite(np.asarray(g_soft)).all()
        assert np.isfinite(np.asarray(g_hard)).all()
        shadow_term = float(jnp.abs(g_soft[4:7] - g_hard[4:7]).sum())
        assert shadow_term > 0.0


class TestDiffWithPallasTracer:
    """Differentiable rendering THROUGH the per-ray Pallas kernels
    (interpret mode): the custom-VJP closest hit takes the kernel's frozen
    topology, vertices get gradients via the analytic recompute, materials
    via the shading gathers."""

    def _setup(self, tiny_scene):
        arrs = _scene_arrays(tiny_scene)
        tv = tiny_scene.triangle_vertices()
        bvh = build_bvh(tv, heuristic=6, leaf_threshold=8)
        flat = flatten_bvh(bvh, tv, leaf_size=8)
        dbvh, _, depth = trace_bvh.device_bvh_from_flat(flat)
        return arrs, flat, dbvh, depth

    def _loss_kernel(self, arrs, flat, dbvh, depth, o, d):
        from parallel_ray_tracer_tpu.ops import gpu_trace

        def loss(verts, over):
            kw = dict(arrs)
            kw.update(over)
            ds = build_device_scene(verts, slot_map=flat.slot_map, **kw)
            closest_fn, occluded_fn = gpu_trace.make_tracer(
                dbvh, ds, 8, depth, interpret=True,
            )
            col = diff.trace_rays_diff(ds, closest_fn, occluded_fn, o, d, 2)
            return jnp.sum(col.x + col.y + col.z)

        return loss

    def test_forward_and_vertex_grads_match_brute(self, tiny_scene):
        arrs, flat, dbvh, depth = self._setup(tiny_scene)
        verts0 = jnp.asarray(tiny_scene.verts)
        o, d = _rays()
        loss_p = self._loss_kernel(arrs, flat, dbvh, depth, o, d)

        def loss_b(verts, over):
            kw = dict(arrs)
            kw.update(over)
            ds = build_device_scene(verts, **kw)
            closest_fn, occluded_fn = trace_brute.make_tracer(ds)
            col = diff.trace_rays_diff(ds, closest_fn, occluded_fn, o, d, 2)
            return jnp.sum(col.x + col.y + col.z)

        lp = float(loss_p(verts0, {}))
        lb = float(loss_b(verts0, {}))
        assert abs(lp - lb) < 1e-2 * max(1.0, abs(lb))
        gp = np.asarray(jax.grad(loss_p)(verts0, {}))
        gb = np.asarray(jax.grad(loss_b)(verts0, {}))
        np.testing.assert_allclose(gp, gb, atol=2e-3, rtol=2e-3)

    def test_material_gradient_matches_fd(self, tiny_scene):
        """The material-table gradient (through the shading gathers) must
        equal central finite differences of the kernel-traced loss."""
        arrs, flat, dbvh, depth = self._setup(tiny_scene)
        verts0 = jnp.asarray(tiny_scene.verts)
        o, d = _rays()
        kd0 = jnp.asarray(tiny_scene.mats_kd)
        loss0 = self._loss_kernel(arrs, flat, dbvh, depth, o, d)

        def loss_with_kd(kd):
            return loss0(verts0, {"mats_kd": jnp.asarray(kd)})

        gkd = np.asarray(jax.grad(loss_with_kd)(kd0))
        h = 1e-3
        for (i, c) in [(0, 0), (1, 1), (2, 2)]:
            e = np.zeros_like(kd0)
            e[i, c] = h
            fd = (
                float(loss_with_kd(kd0 + e)) - float(loss_with_kd(kd0 - e))
            ) / (2 * h)
            assert abs(fd) > 0.3, "uninformative FD direction"
            np.testing.assert_allclose(gkd[i, c], fd, rtol=2e-2)


class TestDiffWithBVHTracer:
    def test_bvh_gradients_match_brute(self, tiny_scene):
        """The custom-VJP wrapper must give identical gradients whichever
        tracer supplies the topology (brute force vs packet BVH)."""
        arrs = _scene_arrays(tiny_scene)
        verts0 = jnp.asarray(tiny_scene.verts)
        tv = tiny_scene.triangle_vertices()
        bvh = build_bvh(tv, heuristic=6, leaf_threshold=8)
        flat = flatten_bvh(bvh, tv, leaf_size=8)
        o, d = _rays()

        def loss_bvh(verts):
            ds = build_device_scene(verts, slot_map=flat.slot_map, **arrs)
            dbvh, L, depth = trace_bvh.device_bvh_from_flat(flat)
            closest_fn, occluded_fn = trace_bvh.make_tracer(
                dbvh, ds, L, depth, packet=1024
            )
            col = diff.trace_rays_diff(ds, closest_fn, occluded_fn, o, d, 2)
            return jnp.sum(col.x + col.y + col.z)

        def loss_brute(verts):
            ds = build_device_scene(verts, **arrs)
            closest_fn, occluded_fn = trace_brute.make_tracer(ds)
            col = diff.trace_rays_diff(ds, closest_fn, occluded_fn, o, d, 2)
            return jnp.sum(col.x + col.y + col.z)

        g_bvh = np.asarray(jax.grad(loss_bvh)(verts0))
        g_brute = np.asarray(jax.grad(loss_brute)(verts0))
        assert np.abs(loss_bvh(verts0) - loss_brute(verts0)) < 1e-3
        np.testing.assert_allclose(g_bvh, g_brute, atol=1e-3, rtol=1e-3)
