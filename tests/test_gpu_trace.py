"""Per-ray GPU traversal kernels (ops/gpu_trace.py) in the Pallas interpreter,
against the packet reference (ops/trace_bvh.py) and the brute-force oracle.

The compiled kernels run on the card (chip_smoke.py, `pytest -m gpu`); here
the same kernel bodies run through the interpreter, so the traversal logic,
the stack, padding and the wrapper's shapes are checked without a GPU.
"""

import numpy as np
import pytest
import jax.numpy as jnp

from parallel_ray_tracer_tpu import pipeline
from parallel_ray_tracer_tpu.config import RenderConfig
from parallel_ray_tracer_tpu.models.camera import default_camera, ray_basis
from parallel_ray_tracer_tpu.models.scene import synthetic_scene
from parallel_ray_tracer_tpu.ops import gpu_trace, trace_brute, trace_bvh
from parallel_ray_tracer_tpu.ops.render import generate_rays_tiled
from parallel_ray_tracer_tpu.ops.shade import mask_dead_rays
from parallel_ray_tracer_tpu.ops.vecmath import Vec3

from conftest import blocker_cloud_scene

W, H = 48, 32


def _scene(name, tiny_scene, car_only_scene):
    if name == "tiny":
        return tiny_scene
    if name == "blockers":
        return blocker_cloud_scene()
    if name == "spheres":
        return blocker_cloud_scene(with_spheres=True)
    if name == "car_only":
        return car_only_scene
    return synthetic_scene(2000, seed=3)


def _prepare(scene, heuristic=6, leaf_size=8, **kw):
    cfg = RenderConfig(width=W, height=H, bvh_heuristic=heuristic,
                       leaf_size=leaf_size, **kw)
    return pipeline.prepare(cfg, scene=scene)


def _camera_rays(width=W, height=H):
    cam = tuple(
        jnp.asarray(a) for a in ray_basis(default_camera(), width, height)
    )
    return generate_rays_tiled(cam, width, height, 16, 16)


def _shadow_rays(ds, o, d, hit):
    """Unit rays from the hits toward the first light (a fixed point light
    for light-less scenes); miss lanes masked dead."""
    lp = (
        (ds.lights_pos.x[0], ds.lights_pos.y[0], ds.lights_pos.z[0])
        if ds.num_lights else (4.0, -6.0, 8.0)
    )
    p = o + d * jnp.where(hit.idx >= 0, hit.t, 1.0)
    lvec = Vec3(lp[0] - p.x, lp[1] - p.y, lp[2] - p.z)
    mag2 = lvec.mag2()
    po, pd = mask_dead_rays(p, lvec / jnp.sqrt(mag2), hit.idx >= 0)
    return po, pd, mag2


def _assert_closest_agree(h, ref):
    idx, idx_ref = np.asarray(h.idx), np.asarray(ref.idx)
    t, t_ref = np.asarray(h.t), np.asarray(ref.t)
    np.testing.assert_array_equal(idx >= 0, idx_ref >= 0)
    same = idx == idx_ref
    # Exact depth ties may pick another triangle; nothing else may differ.
    assert same.mean() >= 0.999, same.mean()
    np.testing.assert_allclose(t[same], t_ref[same], rtol=1e-5)
    np.testing.assert_array_equal(
        np.asarray(h.norm_dir)[same], np.asarray(ref.norm_dir)[same]
    )


def _tracers(pipe, interpret=True):
    ds, bvh = pipe.ds, pipe.dbvh
    return (
        gpu_trace.make_tracer(bvh, ds, pipe.leaf_size, pipe.depth,
                              interpret=interpret),
        trace_bvh.make_tracer(bvh, ds, pipe.leaf_size, pipe.depth,
                              packet=256),
        trace_brute.make_tracer(ds),
    )


SCENES = ["tiny", "blockers", "car_only", "synthetic2k", "spheres"]


@pytest.mark.parametrize("heuristic", range(7))
@pytest.mark.parametrize("scene_name", SCENES)
def test_kernel_matches_references(scene_name, heuristic, tiny_scene,
                                   car_only_scene):
    """Closest and any-hit against trace_bvh and bruteforce, every scene
    shape and every split heuristic (cpu/src/bvh.c:115-242)."""
    pipe = _prepare(_scene(scene_name, tiny_scene, car_only_scene), heuristic)
    (kc, ko), (jc, jo), (bc, bo) = _tracers(pipe)
    o, d = _camera_rays()

    h = kc(o, d)
    ref = bc(o, d)
    assert (np.asarray(ref.idx) >= 0).any()          # non-vacuous
    _assert_closest_agree(h, ref)
    _assert_closest_agree(h, jc(o, d))

    so, sd, m2 = _shadow_rays(pipe.ds, o, d, ref)
    blocked = np.asarray(ko(so, sd, m2))
    np.testing.assert_array_equal(blocked, np.asarray(bo(so, sd, m2)))
    np.testing.assert_array_equal(blocked, np.asarray(jo(so, sd, m2)))


@pytest.mark.parametrize("leaf_size", [1, 2, 4, 8])
def test_leaf_sizes(leaf_size):
    pipe = _prepare(blocker_cloud_scene(), leaf_size=leaf_size)
    assert pipe.leaf_size == leaf_size
    (kc, ko), _, (bc, bo) = _tracers(pipe)
    o, d = _camera_rays()
    ref = bc(o, d)
    _assert_closest_agree(kc(o, d), ref)
    so, sd, m2 = _shadow_rays(pipe.ds, o, d, ref)
    np.testing.assert_array_equal(
        np.asarray(ko(so, sd, m2)), np.asarray(bo(so, sd, m2))
    )


@pytest.mark.parametrize("n_rays", [1, 31, 33, 100])
def test_ray_count_not_multiple_of_block(n_rays):
    """The wrapper pads to whole blocks with dead rays and crops back."""
    assert n_rays % gpu_trace.BLOCK != 0
    pipe = _prepare(blocker_cloud_scene())
    (kc, ko), _, (bc, bo) = _tracers(pipe)
    o, d = _camera_rays()
    start = 300                      # a band that hits the floor and blockers
    o = Vec3(*(x[start:start + n_rays] for x in o))
    d = Vec3(*(x[start:start + n_rays] for x in d))
    h = kc(o, d)
    assert h.t.shape == h.idx.shape == h.norm_dir.shape == (n_rays,)
    ref = bc(o, d)
    _assert_closest_agree(h, ref)
    so, sd, m2 = _shadow_rays(pipe.ds, o, d, ref)
    blocked = ko(so, sd, m2)
    assert blocked.shape == (n_rays,) and blocked.dtype == bool
    np.testing.assert_array_equal(
        np.asarray(blocked), np.asarray(bo(so, sd, m2))
    )


def test_dead_and_masked_rays():
    """Masked lanes (shade.mask_dead_rays) miss and are never blocked,
    whatever their neighbours in the block do."""
    pipe = _prepare(blocker_cloud_scene())
    (kc, ko), _, (bc, _) = _tracers(pipe)
    o, d = _camera_rays()
    alive = jnp.arange(o.x.shape[0]) % 3 != 0
    om, dm = mask_dead_rays(o, d, alive)
    h = kc(om, dm)
    ref = bc(o, d)
    live = np.asarray(alive)
    assert (np.asarray(h.idx)[~live] == -1).all()
    assert (np.asarray(h.t)[~live] > 1e38).all()
    np.testing.assert_array_equal(
        np.asarray(h.idx)[live], np.asarray(ref.idx)[live]
    )
    blocked = np.asarray(ko(om, dm, jnp.full(o.x.shape, 1e6)))
    assert not blocked[~live].any()
    assert blocked[live].any()


def test_deep_tree_stack_covers_depth():
    """A caterpillar tree, one leaf per level, traced from the deep end: the
    near-first walk pushes every level's leaf, so the per-ray stack (sized
    from the tree depth) must hold depth entries."""
    from parallel_ray_tracer_tpu.models.device_scene import (
        device_scene_from_host,
    )
    from parallel_ray_tracer_tpu.models.scene import Scene
    from parallel_ray_tracer_tpu.ops.bvh_flat import FlatBVH

    n = 48
    base = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)
    tv = base[None] + np.arange(n, dtype=np.float32)[:, None, None] * [0, 0, 1]
    lo, hi = tv.min(axis=1), tv.max(axis=1)
    # Inner node j sits at 2j with children (leaf j, rest); the last inner
    # node's children are the last two leaves.
    N = 2 * n - 1
    node_min, node_max = np.zeros((N, 3), np.float32), np.zeros((N, 3), np.float32)
    count, a = np.zeros(N, np.int32), np.zeros(N, np.int32)
    for j in range(n - 1):
        node_min[2 * j], node_max[2 * j] = lo[j:].min(0), hi[j:].max(0)
        a[2 * j] = 2 * j + 1
        leaf = 2 * j + 1
        node_min[leaf], node_max[leaf] = lo[j], hi[j]
        count[leaf], a[leaf] = 1, j
    node_min[N - 1], node_max[N - 1] = lo[n - 1], hi[n - 1]
    count[N - 1], a[N - 1] = 1, n - 1
    flat = FlatBVH(node_min=node_min, node_max=node_max, count=count, a=a,
                   slot_map=np.arange(n, dtype=np.int32), leaf_size=1,
                   depth=n - 1)
    scene = Scene(
        verts=tv.reshape(-1, 3), faces=np.arange(3 * n).reshape(n, 3),
        mat_idx=np.zeros(n, np.int32), mats_kd=np.ones((1, 3), np.float32),
        mats_ks=np.zeros((1, 3), np.float32),
        mats_kr=np.zeros((1, 3), np.float32),
        lights_pos=np.zeros((0, 3), np.float32),
        lights_kl=np.zeros((0, 3), np.float32),
    )
    ds = device_scene_from_host(scene, slot_map=flat.slot_map)
    dbvh, L, depth = trace_bvh.device_bvh_from_flat(flat)
    assert gpu_trace.stack_depth_for(depth) == depth == n - 1
    closest, occluded = gpu_trace.make_tracer(dbvh, ds, L, depth,
                                              interpret=True)
    R = 64
    z0 = np.linspace(n + 0.25, n + 4.0, R).astype(np.float32)
    o = Vec3(jnp.full((R,), 0.3), jnp.full((R,), 0.3), jnp.asarray(z0))
    d = Vec3(jnp.zeros(R), jnp.zeros(R), -jnp.ones(R))
    h = closest(o, d)
    np.testing.assert_allclose(np.asarray(h.t), z0 - (n - 1), rtol=1e-6)
    assert (np.asarray(h.idx) == n - 1).all()
    blocked = np.asarray(occluded(o, d, jnp.full((R,), 9.0)))
    np.testing.assert_array_equal(blocked, z0 - (n - 1) < 3.0)


class TestVariantResolution:
    def test_auto_resolves_to_kernel(self, tiny_scene, monkeypatch):
        pipe = _prepare(tiny_scene)
        assert pipe.resolved_variant(interpret=True) == "gpu"
        monkeypatch.setattr(pipeline.jax, "default_backend", lambda: "gpu")
        assert pipe.resolved_variant() == "gpu"

    def test_auto_fails_without_gpu(self, tiny_scene):
        pipe = _prepare(tiny_scene)
        with pytest.raises(RuntimeError, match="needs a GPU"):
            pipe.resolved_variant()
        with pytest.raises(RuntimeError, match="needs a GPU"):
            pipe.render()
        with pytest.raises(RuntimeError, match="needs a GPU"):
            pipe.resolved_variant("gpu")
        assert pipe.resolved_variant("jax") == "jax"
        assert pipe.resolved_variant("bruteforce") == "bruteforce"
        with pytest.raises(ValueError, match="unknown variant"):
            pipe.resolved_variant("fused")

    def test_cli_fails_without_gpu(self, capsys):
        from parallel_ray_tracer_tpu import cli

        rc = cli.main(["--synthetic", "50", "--width", "32", "--height",
                       "32", "--quiet"])
        assert rc == 2
        assert "needs a GPU" in capsys.readouterr().err

    def test_interpreted_auto_render_matches_oracle(self, tiny_scene):
        pipe = _prepare(tiny_scene, bounces=2)
        img = np.asarray(pipe.render(interpret=True))
        ref = np.asarray(pipe.render(variant="bruteforce"))
        np.testing.assert_allclose(img, ref, atol=3e-5)
