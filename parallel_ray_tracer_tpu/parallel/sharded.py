"""Multi-device rendering: image tiles sharded over a device mesh.

The reference's only parallelism is intra-host (pthreads work-stealing,
cpu/src/main.c:214-264; CUDA grid, gpu/src/gpu.cu:98-100). This module scales
the same axis — pixels — across devices (SURVEY.md §2.3):

  - one mesh axis ``tiles``; ray packets (1024-pixel tiles) are sharded over
    it, scene + BVH are replicated (the "shard the long axis, replicate the
    params" recipe, exactly context-parallelism's shape);
  - load balance: the reference work-steals scanlines because ray cost varies
    across the image; the static-SPMD substitute is over-decomposition with a
    round-robin tile permutation, interleaving cheap and expensive image
    regions across devices;
  - the forward pass needs no collectives at all (disjoint pixels); the
    differentiable path all-reduces parameter gradients, which XLA inserts
    automatically from the sharding annotations.

`render_sharded` wraps any tracer variant inside shard_map (the Pallas
kernels run per device on the local shard); `make_train_step` builds the
jitted differentiable step.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..models.camera import Camera, ray_basis
from ..models.device_scene import build_device_scene
from ..ops.render import (
    generate_rays_tiled,
    make_tracers,
    tile_image_shape,
    tiles_to_image,
)
from ..ops.shade import trace_rays
from ..ops.vecmath import Vec3


def make_mesh(n_devices: Optional[int] = None, axis: str = "tiles") -> Mesh:
    devs = jax.devices()
    n = n_devices or len(devs)
    return Mesh(np.asarray(devs[:n]), (axis,))


def round_robin_perm(ntiles: int, n_devices: int) -> np.ndarray:
    """Permutation placing tiles on devices round-robin.

    With contiguous sharding of the permuted array, device d receives tiles
    {d, d + D, d + 2D, ...} of the original order — interleaving image regions
    so per-device ray cost evens out (the static substitute for the CPU
    reference's atomic scanline stealing, cpu/src/main.c:252-261).
    """
    assert ntiles % n_devices == 0
    per = ntiles // n_devices
    # perm[k] = original tile index placed at position k.
    return (
        np.arange(ntiles).reshape(per, n_devices).T.reshape(ntiles)
    ).astype(np.int32)


def _pad_tiles(ntiles: int, n_devices: int) -> int:
    return -(-ntiles // n_devices) * n_devices


@functools.partial(
    jax.jit,
    static_argnames=(
        "width", "height", "bounces", "leaf_size", "depth", "tile_rows",
        "tile_cols", "variant", "mesh", "interpret", "fast_light",
        "reverse_shadows",
    ),
)
def _render_sharded(
    ds,
    bvh,
    cam_arrays,
    width: int,
    height: int,
    bounces: int,
    leaf_size: int,
    depth: int,
    tile_rows: int,
    tile_cols: int,
    variant: str,
    mesh: Mesh,
    interpret: bool,
    fast_light: bool = True,
    reverse_shadows: bool = True,
):
    K = tile_rows * tile_cols
    n_dev = mesh.devices.size
    wp, hp, nty, ntx = tile_image_shape(width, height, tile_rows, tile_cols)
    ntiles = nty * ntx
    ntiles_p = _pad_tiles(ntiles, n_dev)

    o, d = generate_rays_tiled(cam_arrays, width, height, tile_rows, tile_cols)

    def to_tiles(p):
        p = p.reshape(ntiles, K)
        return jnp.pad(p, ((0, ntiles_p - ntiles), (0, 0)))

    perm = jnp.asarray(round_robin_perm(ntiles_p, n_dev))
    o_t = Vec3(to_tiles(o.x)[perm], to_tiles(o.y)[perm], to_tiles(o.z)[perm])
    d_t = Vec3(to_tiles(d.x)[perm], to_tiles(d.y)[perm], to_tiles(d.z)[perm])

    def shard_body(ds_r, bvh_r, o_sh, d_sh):
        # (ntiles_p / n_dev, K) per device -> flat rays
        nt_local = o_sh.x.shape[0]
        of = o_sh.reshape(nt_local * K)
        df = d_sh.reshape(nt_local * K)
        closest_fn, occluded_fn = make_tracers(
            variant, ds_r, bvh_r, leaf_size, depth, K, interpret=interpret,
            fast_light=fast_light,
        )
        col = trace_rays(ds_r, closest_fn, occluded_fn, of, df, bounces,
                         reverse_shadows=fast_light and reverse_shadows)
        col = col.clamp(0.0, 1.0)
        return jnp.stack([col.x, col.y, col.z], axis=-1).reshape(nt_local, K, 3)

    rep = P()
    rep_specs = (
        jax.tree.map(lambda _: rep, ds),
        jax.tree.map(lambda _: rep, bvh),
    )
    out = jax.shard_map(
        shard_body,
        mesh=mesh,
        in_specs=rep_specs + (P("tiles"), P("tiles")),
        out_specs=P("tiles"),
        # The traversal's lax.cond mixes replicated (scene) and per-shard
        # (ray) operands; skip the varying-manual-axes checker.
        check_vma=False,
    )(ds, bvh, o_t, d_t)

    inv_perm = jnp.argsort(perm)
    out = out[inv_perm][:ntiles].reshape(ntiles * K, 3)
    return tiles_to_image(out, width, height, tile_rows, tile_cols)


def render_sharded(
    ds,
    bvh,
    cam: Camera,
    width: int,
    height: int,
    mesh: Mesh,
    bounces: int = 4,
    leaf_size: int = 8,
    depth: Optional[int] = None,
    tile_rows: int = 32,
    tile_cols: int = 32,
    variant: str = "gpu",
    interpret: bool = False,
    fast_light: bool = True,
    reverse_shadows: bool = True,
):
    """Render with image tiles sharded over `mesh` (scene replicated).

    bvh: the DeviceBVH for "gpu"/"jax" (None for "bruteforce"); depth is
    the tree depth. fast_light/reverse_shadows carry the single-device
    shading schedule, so `--devices N` renders the image of `--devices 1`
    (tests/test_sharded.py).
    """
    cam_arrays = tuple(jnp.asarray(a) for a in ray_basis(cam, width, height))
    return _render_sharded(
        ds, bvh, cam_arrays, width, height, bounces, leaf_size, depth,
        tile_rows, tile_cols, variant, mesh, interpret, fast_light,
        reverse_shadows,
    )


# ---------------------------------------------------------------------------
# Differentiable training step (sharded)
# ---------------------------------------------------------------------------

def make_train_step(
    scene,
    mesh: Mesh,
    width: int,
    height: int,
    bounces: int = 1,
    lr: float = 1e-2,
    tile_rows: int = 32,
    tile_cols: int = 32,
    variant: str = "bruteforce",
    bvh=None,
    leaf_size: int = 8,
    depth: Optional[int] = None,
    slot_map=None,
    interpret: bool = False,
    fast_light: bool = True,
    reverse_shadows: bool = True,
):
    """Jitted SGD step optimizing vertex positions against a target image.

    variant selects the differentiable forward:
      - "bruteforce": pure-jnp all-triangles tracer, exact AD end to end;
        rays sharded via GSPMD annotations, verts replicated, XLA inserts
        the gradient all-reduce.
      - "gpu" / "jax": the BVH tracers (per-ray kernels / vmapped packet
        while_loop) wrapped by ops/diff.make_diff_closest — traversal runs
        under stop_gradient for the frozen hit topology, gradients flow
        through the analytic recompute. These run inside shard_map with
        scene/BVH replicated and an explicit psum of the loss.
        `bvh` is the DeviceBVH built from the CURRENT verts (rebuild it as
        vertices move, as any BVH-based differentiable renderer refits its
        acceleration structure between steps) and `depth` its tree depth;
        `slot_map` must be the flattened BVH's slot permutation so hit
        indices address ds planes.
    """
    from ..ops import diff

    faces = jnp.asarray(scene.faces)
    mat_idx = jnp.asarray(scene.mat_idx)
    consts = (
        jnp.asarray(scene.mats_kd),
        jnp.asarray(scene.mats_ks),
        jnp.asarray(scene.mats_kr),
        jnp.asarray(scene.lights_pos),
        jnp.asarray(scene.lights_kl),
    )
    cam_arrays = tuple(
        jnp.asarray(a)
        for a in ray_basis(
            Camera(pos=(0.0, -9.0, 3.0), rot=(-np.pi / 12, 0.0, 0.0), fov=np.pi / 3.2),
            width,
            height,
        )
    )
    K = tile_rows * tile_cols
    n_dev = mesh.devices.size
    _, _, nty, ntx = tile_image_shape(width, height, tile_rows, tile_cols)
    ntiles = nty * ntx
    ntiles_p = _pad_tiles(ntiles, n_dev)
    tile_sharding = NamedSharding(mesh, P("tiles"))
    rep_sharding = NamedSharding(mesh, P())

    def forward_local(verts, o_t: Vec3, d_t: Vec3):
        """(local_tiles, K) rays -> (local_tiles, K, 3) image, diff."""
        kd, ks, kr, lp, kl = consts
        ds = build_device_scene(
            verts, faces, mat_idx, kd, ks, kr, lp, kl, slot_map=slot_map
        )
        nt_local = o_t.x.shape[0]
        of = Vec3(*(p.reshape(-1) for p in o_t))
        df = Vec3(*(p.reshape(-1) for p in d_t))
        closest_fn, occluded_fn = make_tracers(
            variant, ds, bvh, leaf_size, depth, K, interpret=interpret,
            fast_light=fast_light,
        )
        rs = fast_light and reverse_shadows
        if variant == "bruteforce":
            # the bruteforce oracle never reverses shadows (render.py:94-98)
            col = trace_rays(ds, closest_fn, occluded_fn, of, df, bounces)
        else:
            col = diff.trace_rays_diff(
                ds, closest_fn, occluded_fn, of, df, bounces,
                reverse_shadows=rs,
            )
        col = col.clamp(0.0, 1.0)
        return jnp.stack([col.x, col.y, col.z], axis=-1).reshape(
            nt_local, K, 3
        )

    # Pad tiles (added to round ntiles up to the device count) must not
    # contribute to the loss or its gradient.
    tile_mask = (jnp.arange(ntiles_p) < ntiles).astype(jnp.float32)[:, None, None]
    n_real = ntiles * K * 3

    if variant == "bruteforce":
        def loss_fn(verts, o_t, d_t, target):
            img = forward_local(verts, o_t, d_t)
            return jnp.sum(tile_mask * (img - target) ** 2) / n_real
    else:
        per = ntiles_p // n_dev

        def shard_loss(verts, o_t, d_t, target):
            img = forward_local(verts, o_t, d_t)
            start = jax.lax.axis_index("tiles") * per
            mask = (
                (start + jnp.arange(per)) < ntiles
            ).astype(jnp.float32)[:, None, None]
            partial = jnp.sum(mask * (img - target) ** 2) / n_real
            return jax.lax.psum(partial, "tiles")

        def loss_fn(verts, o_t, d_t, target):
            return jax.shard_map(
                shard_loss,
                mesh=mesh,
                in_specs=(P(), P("tiles"), P("tiles"), P("tiles")),
                out_specs=P(),
                check_vma=False,
            )(verts, o_t, d_t, target)

    @jax.jit
    def step(verts, o_t, d_t, target):
        loss, grad = jax.value_and_grad(loss_fn)(verts, o_t, d_t, target)
        verts = verts - lr * grad
        return verts, loss

    def prepare_inputs(target_image: Optional[np.ndarray] = None):
        o, d = generate_rays_tiled(cam_arrays, width, height, tile_rows, tile_cols)

        def to_tiles(p):
            p = p.reshape(ntiles, K)
            return jnp.pad(p, ((0, ntiles_p - ntiles), (0, 0)))

        o_t = Vec3(*(jax.device_put(to_tiles(p), tile_sharding) for p in o))
        d_t = Vec3(*(jax.device_put(to_tiles(p), tile_sharding) for p in d))
        if target_image is None:
            target = jnp.zeros((ntiles_p, K, 3), jnp.float32)
        else:
            target = jnp.asarray(target_image, jnp.float32)
        target = jax.device_put(target, tile_sharding)
        verts = jax.device_put(jnp.asarray(scene.verts), rep_sharding)
        return verts, o_t, d_t, target

    return step, prepare_inputs
