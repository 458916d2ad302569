"""Multi-device sharded rendering + training step on the 8-device CPU mesh
(SURVEY.md §4(e): mesh logic validated via xla_force_host_platform_device_count).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from parallel_ray_tracer_tpu.config import RenderConfig
from parallel_ray_tracer_tpu import pipeline
from parallel_ray_tracer_tpu.parallel import sharded


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) >= 8
    return sharded.make_mesh(8)


class TestShardedRender:
    def test_jax_variant_matches_oracle(self, tiny_scene, mesh):
        cfg = RenderConfig(
            width=64, height=64, bounces=2, tile_rows=32, tile_cols=32,
            bvh_heuristic=6,
        )
        pipe = pipeline.prepare(cfg, scene=tiny_scene)
        img = np.asarray(
            sharded.render_sharded(
                pipe.ds, pipe.dbvh, pipe.camera(), 64, 64, mesh,
                bounces=2, leaf_size=pipe.leaf_size, depth=pipe.depth,
                variant="jax",
            )
        )
        ref = np.asarray(pipe.render(variant="bruteforce"))
        np.testing.assert_allclose(img, ref, atol=3e-5)

    def test_uneven_tiles_padded(self, tiny_scene, mesh):
        # 3 tiles over 8 devices exercises tile padding.
        cfg = RenderConfig(
            width=96, height=32, bounces=1, tile_rows=32, tile_cols=32,
            bvh_heuristic=3,
        )
        pipe = pipeline.prepare(cfg, scene=tiny_scene)
        img = np.asarray(
            sharded.render_sharded(
                pipe.ds, pipe.dbvh, pipe.camera(), 96, 32, mesh,
                bounces=1, leaf_size=pipe.leaf_size, depth=pipe.depth,
                variant="jax",
            )
        )
        ref = np.asarray(pipe.render(variant="bruteforce"))
        np.testing.assert_allclose(img, ref, atol=3e-5)

    def test_pallas_variant_matches_oracle(self, tiny_scene, mesh):
        """The multi-device configuration of the served path: the per-ray
        Pallas kernels inside shard_map (interpreted on the CPU mesh)."""
        cfg = RenderConfig(
            width=64, height=64, bounces=2, tile_rows=32, tile_cols=32,
            bvh_heuristic=6,
        )
        pipe = pipeline.prepare(cfg, scene=tiny_scene)
        img = np.asarray(
            sharded.render_sharded(
                pipe.ds, pipe.dbvh, pipe.camera(), 64, 64, mesh,
                bounces=2, leaf_size=pipe.leaf_size, depth=pipe.depth,
                variant="gpu", interpret=True,
            )
        )
        ref = np.asarray(pipe.render(variant="bruteforce"))
        np.testing.assert_allclose(img, ref, atol=3e-5)

    def test_production_schedule_bit_identical(self, tiny_scene, mesh):
        """The multi-device path must run the single-device schedule: the
        sharded image matches pipe.render() to float-ulp level (bit-
        exactness across shard shapes is blocked only by XLA reassociating
        the out-of-kernel shading arithmetic for different batch shapes)."""
        cfg = RenderConfig(
            width=64, height=64, bounces=2, tile_rows=32, tile_cols=32,
            bvh_heuristic=6,
        )
        pipe = pipeline.prepare(cfg, scene=tiny_scene)
        ref = np.asarray(pipe.render(variant="gpu", interpret=True))
        img = np.asarray(
            sharded.render_sharded(
                pipe.ds, pipe.dbvh, pipe.camera(), 64, 64, mesh,
                bounces=2, leaf_size=pipe.leaf_size, depth=pipe.depth,
                variant="gpu", interpret=True, fast_light=cfg.fast_light,
                reverse_shadows=cfg.reverse_shadows,
            )
        )
        np.testing.assert_allclose(img, ref, atol=1e-6, rtol=0)

    def test_no_fast_light_knob_respected(self, tiny_scene, mesh):
        """fast_light=False (USE_BVH_FAST_LIGHT=0 parity) must reach the
        sharded tracer instead of being silently overridden."""
        cfg = RenderConfig(
            width=64, height=32, bounces=1, tile_rows=32, tile_cols=32,
            bvh_heuristic=6, fast_light=False,
        )
        pipe = pipeline.prepare(cfg, scene=tiny_scene)
        ref = np.asarray(pipe.render(variant="gpu", interpret=True))
        img = np.asarray(
            sharded.render_sharded(
                pipe.ds, pipe.dbvh, pipe.camera(), 64, 32, mesh,
                bounces=1, leaf_size=pipe.leaf_size, depth=pipe.depth,
                variant="gpu", interpret=True, fast_light=False,
                reverse_shadows=cfg.reverse_shadows,
            )
        )
        np.testing.assert_array_equal(img, ref)

    def test_round_robin_perm(self):
        perm = sharded.round_robin_perm(16, 4)
        # Device 0 gets positions 0..3 -> original tiles 0, 4, 8, 12.
        assert perm[:4].tolist() == [0, 4, 8, 12]
        assert sorted(perm.tolist()) == list(range(16))


class TestShardedTraining:
    def test_step_descends_and_stays_finite(self, tiny_scene, mesh):
        step, prep = sharded.make_train_step(
            tiny_scene, mesh, 64, 64, bounces=1, lr=1e-3
        )
        v, o_t, d_t, target = prep()
        losses = []
        for _ in range(4):
            v, loss = step(v, o_t, d_t, target)
            losses.append(float(loss))
        assert np.isfinite(losses).all()
        assert bool(jnp.isfinite(v).all())
        assert losses[-1] < losses[0]

    def _flat(self, tiny_scene):
        from parallel_ray_tracer_tpu.ops.bvh import build_bvh
        from parallel_ray_tracer_tpu.ops.bvh_flat import flatten_bvh
        from parallel_ray_tracer_tpu.ops.trace_bvh import device_bvh_from_flat

        tv = tiny_scene.triangle_vertices()
        bvh = build_bvh(tv, heuristic=6, leaf_threshold=8)
        flat = flatten_bvh(bvh, tv, leaf_size=8)
        dbvh, _, depth = device_bvh_from_flat(flat)
        return flat, dbvh, depth

    def test_pallas_variant_step(self, tiny_scene, mesh):
        """Training THROUGH the per-ray kernels under shard_map (diff
        wrapper: frozen topology + analytic recompute). The first step's
        vertex update must closely match the brute-force tracer's (same
        differentiable semantics away from silhouettes)."""
        flat, dbvh, depth = self._flat(tiny_scene)
        step_p, prep_p = sharded.make_train_step(
            tiny_scene, mesh, 64, 32, bounces=1, lr=1e-3,
            variant="gpu", bvh=dbvh, leaf_size=8, depth=depth,
            slot_map=flat.slot_map, interpret=True,
        )
        step_b, prep_b = sharded.make_train_step(
            tiny_scene, mesh, 64, 32, bounces=1, lr=1e-3,
        )
        vp, op_, dp, tp = prep_p()
        vb, ob, db, tb = prep_b()
        vp1, lp = step_p(vp, op_, dp, tp)
        vb1, lb = step_b(vb, ob, db, tb)
        assert np.isfinite(float(lp)) and float(lp) > 0
        assert abs(float(lp) - float(lb)) < 1e-3 * max(1.0, float(lb))
        np.testing.assert_allclose(
            np.asarray(vp1), np.asarray(vb1), atol=1e-5
        )

    def test_train_forward_matches_render_sharded(self, tiny_scene, mesh):
        """The training-step forward must render EXACTLY what
        render_sharded renders at identical flags: with target = the
        rendered image, the loss of the first step must be ~0."""
        from parallel_ray_tracer_tpu.models.camera import default_camera
        from parallel_ray_tracer_tpu.models.device_scene import (
            build_device_scene,
        )

        flat, dbvh, depth = self._flat(tiny_scene)
        flags = dict(fast_light=True, reverse_shadows=True)
        ds = build_device_scene(
            jnp.asarray(tiny_scene.verts), tiny_scene.faces,
            tiny_scene.mat_idx, tiny_scene.mats_kd, tiny_scene.mats_ks,
            tiny_scene.mats_kr, tiny_scene.lights_pos,
            tiny_scene.lights_kl, slot_map=flat.slot_map,
        )
        img = np.asarray(
            sharded.render_sharded(
                ds, dbvh, default_camera(), 64, 32, mesh,
                bounces=1, leaf_size=8, depth=depth,
                variant="gpu", interpret=True, **flags,
            )
        )
        step_p, prep_p = sharded.make_train_step(
            tiny_scene, mesh, 64, 32, bounces=1, lr=0.0,
            variant="gpu", bvh=dbvh, leaf_size=8, depth=depth,
            slot_map=flat.slot_map, interpret=True, **flags,
        )
        # image -> tile-major target, padded to the device count
        tiles = (
            jnp.asarray(img).reshape(1, 32, 2, 32, 3)
            .swapaxes(1, 2).reshape(2, 1024, 3)
        )
        target = jnp.concatenate(
            [tiles, jnp.zeros((6, 1024, 3), jnp.float32)], axis=0
        )
        v, o_t, d_t, _ = prep_p()
        tgt = jax.device_put(
            target, jax.sharding.NamedSharding(
                mesh, jax.sharding.PartitionSpec("tiles"))
        )
        _, loss = step_p(v, o_t, d_t, tgt)
        assert float(loss) < 1e-12, float(loss)

    def test_gradients_match_single_device(self, tiny_scene, mesh):
        """The sharded step must equal an unsharded one numerically."""
        step8, prep8 = sharded.make_train_step(
            tiny_scene, mesh, 64, 32, bounces=1, lr=1e-2
        )
        mesh1 = sharded.make_mesh(1)
        step1, prep1 = sharded.make_train_step(
            tiny_scene, mesh1, 64, 32, bounces=1, lr=1e-2
        )
        v8, o8, d8, t8 = prep8()
        v1, o1, d1, t1 = prep1()
        n8, l8 = step8(v8, o8, d8, t8)
        n1, l1 = step1(v1, o1, d1, t1)
        assert abs(float(l8) - float(l1)) < 1e-6
        np.testing.assert_allclose(np.asarray(n8), np.asarray(n1), atol=1e-5)
