"""Device-resident scene: SoA pytree of jnp arrays.

The analog of the reference's `load_to_gpu` AoS->SoA split + constant-memory
publication (gpu/src/gpu.cu:129-201): triangle coordinates split from normals
split from materials (hot/cold separation, gpu/include/triangle.cuh:8-28),
but taken further — every component is its own plane, so a gather of one
coordinate for a warp of rays reads one plane. `jax.device_put` with a replicated sharding replaces cudaMemcpyToSymbol.

The scene is a pytree and `build_device_scene` is traceable, so gradients flow
from pixels back to the vertex buffer and material table (normals and edges
are *functions* of verts, exactly like triangle_init recomputes them,
cpu/src/triangle.c:14-23).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.vecmath import Vec3, from_array
from .scene import Scene


class DeviceScene(NamedTuple):
    # Triangle geometry, SoA planes of shape (T,) (possibly permuted into BVH
    # leaf order and padded with degenerate triangles).
    v0: Vec3
    v1: Vec3
    v2: Vec3
    n0: Vec3                # unit normal for norm_dir=0; the other is -n0
    mat_idx: jax.Array      # (T,) int32 into the material table
    # Material table (M,).
    kd: Vec3
    ks: Vec3
    kr: Vec3
    # Point lights (L,).
    lights_pos: Vec3
    lights_kl: Vec3
    # Ambient light, scalars.
    ambient: Vec3
    # Sphere primitives (S,) — first-class here, vestigial in the reference
    # (empty spheres.obj; see ops/spheres.py).
    sph_c: Vec3
    sph_r: jax.Array
    sph_mat: jax.Array

    @property
    def num_triangles(self) -> int:
        return int(self.v0.x.shape[0])

    @property
    def num_lights(self) -> int:
        return int(self.lights_pos.x.shape[0])


def build_device_scene(
    verts: jax.Array,
    faces,
    mat_idx,
    mats_kd,
    mats_ks,
    mats_kr,
    lights_pos,
    lights_kl,
    ambient=(0.5, 0.5, 0.5),
    perm: Optional[np.ndarray] = None,
    pad_to: Optional[int] = None,
    slot_map: Optional[np.ndarray] = None,
    spheres_center=None,
    spheres_radius=None,
    spheres_mat=None,
) -> DeviceScene:
    """Assemble the device pytree from a vertex buffer + topology.

    `verts` is the differentiable parameter; everything geometric is derived
    from it inside the trace. `perm` reorders triangles (BVH leaf order) and
    `pad_to` appends degenerate all-zero triangles (det=0 -> guaranteed miss
    in moller_trumbore) so array sizes hit chosen multiples.

    `slot_map` (exclusive with perm/pad_to) is the flattened-BVH slot layout
    (ops/bvh_flat.py): (S,) i32 mapping device slot -> original triangle, with
    -1 slots becoming interleaved degenerate triangles, so traversal hit
    indices directly address these planes.
    """
    verts = jnp.asarray(verts, jnp.float32)
    faces = np.asarray(faces, np.int32)
    mat_idx = np.asarray(mat_idx, np.int32)
    if slot_map is not None:
        assert perm is None and pad_to is None
        slot_map = np.asarray(slot_map, np.int32)
        safe = np.maximum(slot_map, 0)
        faces = np.where(slot_map[:, None] >= 0, faces[safe], 0)
        mat_idx = np.where(slot_map >= 0, mat_idx[safe], 0)
    elif perm is not None:
        faces = faces[perm]
        mat_idx = mat_idx[perm]
    ntri = faces.shape[0]
    if pad_to is not None and pad_to > ntri:
        pad = pad_to - ntri
        # Degenerate faces: all three vertices = vertex 0.
        faces = np.concatenate([faces, np.zeros((pad, 3), np.int32)], axis=0)
        mat_idx = np.concatenate([mat_idx, np.zeros(pad, np.int32)], axis=0)

    amb = np.asarray(ambient, np.float32)
    if spheres_center is None:
        spheres_center = np.zeros((0, 3), np.float32)
    if spheres_radius is None:
        spheres_radius = np.zeros((0,), np.float32)
    if spheres_mat is None:
        spheres_mat = np.zeros((0,), np.int32)
    # One jitted assembly = one device dispatch instead of ~30 eager ones.
    return _assemble(
        verts,
        jnp.asarray(faces),
        jnp.asarray(mat_idx),
        jnp.asarray(mats_kd, jnp.float32),
        jnp.asarray(mats_ks, jnp.float32),
        jnp.asarray(mats_kr, jnp.float32),
        jnp.asarray(lights_pos, jnp.float32),
        jnp.asarray(lights_kl, jnp.float32),
        jnp.asarray(amb),
        jnp.asarray(spheres_center, jnp.float32),
        jnp.asarray(spheres_radius, jnp.float32),
        jnp.asarray(spheres_mat, jnp.int32),
    )


@jax.jit
def _assemble(verts, faces, mat_idx, kd, ks, kr, lights_pos, lights_kl, amb,
              sph_c, sph_r, sph_mat):
    tv = verts[faces]                      # (T, 3, 3) gather from param buffer
    v0 = from_array(tv[:, 0])
    v1 = from_array(tv[:, 1])
    v2 = from_array(tv[:, 2])

    e1 = v1 - v0
    e2 = v2 - v0
    n = e1.cross(e2)
    # sqrt guarded away from 0 so degenerate (padding) triangles produce a
    # finite gradient that the `where` then zeroes, instead of sqrt'(0)=inf.
    mag2 = n.mag2()
    mag = jnp.sqrt(jnp.maximum(mag2, 1e-30))
    n0 = (n / mag).where(mag2 > 0, Vec3(n.x * 0, n.y * 0, n.z * 0))

    return DeviceScene(
        v0=v0,
        v1=v1,
        v2=v2,
        n0=n0,
        mat_idx=mat_idx,
        kd=from_array(kd),
        ks=from_array(ks),
        kr=from_array(kr),
        lights_pos=from_array(lights_pos),
        lights_kl=from_array(lights_kl),
        ambient=Vec3(amb[0], amb[1], amb[2]),
        sph_c=from_array(sph_c),
        sph_r=sph_r,
        sph_mat=sph_mat,
    )


def device_scene_from_host(
    scene: Scene, ambient=(0.5, 0.5, 0.5), perm=None, pad_to=None, slot_map=None
) -> DeviceScene:
    return build_device_scene(
        scene.verts,
        scene.faces,
        scene.mat_idx,
        scene.mats_kd,
        scene.mats_ks,
        scene.mats_kr,
        scene.lights_pos,
        scene.lights_kl,
        ambient=ambient,
        perm=perm,
        pad_to=pad_to,
        slot_map=slot_map,
        spheres_center=scene.spheres_center,
        spheres_radius=scene.spheres_radius,
        spheres_mat=scene.spheres_mat,
    )
