"""Procedural substitute scenes for the LFS-stripped reference assets.

The reference mirrors only car_only/car_boxed geometry; dragon, sportscar and
two_cars OBJs are stripped (the reference's `.MISSING_LARGE_BLOBS:1-3`), yet
they define the benchmark configs (BASELINE.json: "dragon asset (high-poly
BVH stress), 1080p"). This module regenerates *substitute* scenes with the
same structural profile, deterministically from a seed:

  - dragon: a high-poly displaced torus-knot ("dragon-class" organic mesh,
    default ~180k triangles) over a reflective floor; 2 lights, 6 materials
    (matching the reference dragon's lights/material counts,
    assets/dragon/lights.obj + triangles.mtl).
  - two_cars: two transformed instances of the available car_only geometry
    (~64k triangles); 2 lights (assets/two_cars/lights.obj profile).
  - sportscar: the car_only body on a glossy showroom floor; 4 lights
    (assets/sportscar/lights.obj profile).

These are stand-ins for benchmarking and tests, not replicas of the original
artwork.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np

from .scene import Scene, load_scene, load_scene_npz


def _surface_mesh(fn, nu: int, nv: int, close_u=True, close_v=True):
    """Tessellate a parametric surface fn(u, v in [0,1)) -> (N,3) verts +
    (M,3) faces (two triangles per quad)."""
    u = np.arange(nu, dtype=np.float64) / (nu if close_u else nu - 1)
    v = np.arange(nv, dtype=np.float64) / (nv if close_v else nv - 1)
    uu, vv = np.meshgrid(u, v, indexing="ij")
    verts = fn(uu.reshape(-1), vv.reshape(-1)).astype(np.float32)

    iu = np.arange(nu if close_u else nu - 1)
    iv = np.arange(nv if close_v else nv - 1)
    giu, giv = np.meshgrid(iu, iv, indexing="ij")
    i00 = (giu % nu) * nv + (giv % nv)
    i10 = ((giu + 1) % nu) * nv + (giv % nv)
    i01 = (giu % nu) * nv + ((giv + 1) % nv)
    i11 = ((giu + 1) % nu) * nv + ((giv + 1) % nv)
    f1 = np.stack([i00, i10, i11], axis=-1).reshape(-1, 3)
    f2 = np.stack([i00, i11, i01], axis=-1).reshape(-1, 3)
    faces = np.concatenate([f1, f2], axis=0).astype(np.int32)
    return verts, faces


def _torus_knot_surface(p=2, q=3, R=2.2, r0=0.72, seed=1):
    """Displaced (p,q)-torus-knot tube — the 'dragon-class' organic blob."""
    rng = np.random.RandomState(seed)
    # Random low-frequency displacement spectrum (deterministic per seed).
    n_modes = 10
    amp = rng.rand(n_modes) * 0.12
    fu = rng.randint(1, 14, n_modes)
    fv = rng.randint(1, 7, n_modes)
    ph = rng.rand(n_modes) * 2 * math.pi

    def fn(u, v):
        tu = 2 * math.pi * u
        # Knot centerline.
        cx = (R + math.cos(0) + np.cos(q * tu)) * np.cos(p * tu)
        cy = (R + np.cos(q * tu)) * np.sin(p * tu)
        cz = -np.sin(q * tu)
        # Frenet-ish frame by finite differences.
        eps = 1e-3
        tu2 = tu + eps
        dx = (R + np.cos(q * tu2)) * np.cos(p * tu2) - (R + np.cos(q * tu)) * np.cos(p * tu)
        dy = (R + np.cos(q * tu2)) * np.sin(p * tu2) - (R + np.cos(q * tu)) * np.sin(p * tu)
        dz = -np.sin(q * tu2) + np.sin(q * tu)
        tl = np.sqrt(dx * dx + dy * dy + dz * dz) + 1e-12
        dx, dy, dz = dx / tl, dy / tl, dz / tl
        # Normal: project 'up' off the tangent.
        nx = -dy
        ny = dx
        nz = np.zeros_like(dx)
        nl = np.sqrt(nx * nx + ny * ny + nz * nz) + 1e-12
        nx, ny, nz = nx / nl, ny / nl, nz / nl
        bx = dy * nz - dz * ny
        by = dz * nx - dx * nz
        bz = dx * ny - dy * nx

        tv = 2 * math.pi * v
        disp = np.zeros_like(u)
        for k in range(n_modes):
            disp = disp + amp[k] * np.sin(fu[k] * tu + ph[k]) * np.cos(fv[k] * tv)
        rr = r0 * (1.0 + disp)
        px = cx + rr * (np.cos(tv) * nx + np.sin(tv) * bx)
        py = cy + rr * (np.cos(tv) * ny + np.sin(tv) * by)
        pz = cz + rr * (np.cos(tv) * nz + np.sin(tv) * bz)
        return np.stack([px, py, pz], axis=-1)

    return fn


def dragon_scene(
    target_triangles: int = 180_000, seed: int = 1
) -> Scene:
    """High-poly BVH-stress scene: displaced torus knot + reflective floor."""
    # 2 tris per quad on an (nu, nv) closed grid -> 2 * nu * nv triangles.
    nv = max(24, int(math.sqrt(target_triangles / 2 / 4)))
    nu = max(48, (target_triangles // 2) // nv)
    body_v, body_f = _surface_mesh(
        _torus_knot_surface(seed=seed), nu, nv, close_u=True, close_v=True
    )
    # Scale/position in front of the default camera (at (0,-9,3) looking +y).
    body_v = body_v * 0.85
    body_v = body_v[:, [0, 1, 2]]
    body_v[:, 2] += 2.2

    floor_v = np.array(
        [[-12, -12, 0], [12, -12, 0], [12, 12, 0], [-12, 12, 0]], np.float32
    )
    floor_f = np.array([[0, 1, 2], [0, 2, 3]], np.int32)

    verts = np.concatenate([body_v, floor_v], axis=0)
    faces = np.concatenate([body_f, floor_f + body_v.shape[0]], axis=0)

    # 6 materials (reference dragon mtl count): body shades by height band.
    z = body_v[:, 2][body_f[:, 0]]
    band = np.clip(((z - 0.2) / 4.0 * 5).astype(np.int32), 0, 4)
    mat_idx = np.concatenate([band, np.full(2, 5, np.int32)])

    kd = np.array(
        [
            [0.10, 0.35, 0.12],
            [0.12, 0.42, 0.16],
            [0.16, 0.50, 0.20],
            [0.22, 0.58, 0.26],
            [0.30, 0.66, 0.32],
            [0.35, 0.35, 0.38],   # floor
        ],
        np.float32,
    )
    ks = np.array(
        [[0.25, 0.25, 0.2], [0.25, 0.25, 0.2], [0.3, 0.3, 0.25],
         [0.3, 0.3, 0.25], [0.35, 0.35, 0.3], [0.2, 0.2, 0.2]],
        np.float32,
    )
    kr = np.array(
        [[0, 0, 0], [0, 0, 0], [0.05, 0.05, 0.05], [0.05, 0.05, 0.05],
         [0.1, 0.1, 0.1], [0.35, 0.35, 0.35]],
        np.float32,
    )
    lights_pos = np.array([[6.0, -8.0, 9.0], [-7.0, -3.0, 7.0]], np.float32)
    lights_kl = np.array([[70.0, 68.0, 62.0], [30.0, 32.0, 40.0]], np.float32)
    return Scene(
        verts=verts, faces=faces, mat_idx=mat_idx,
        mats_kd=kd, mats_ks=ks, mats_kr=kr,
        lights_pos=lights_pos, lights_kl=lights_kl,
    )


def _transform(verts: np.ndarray, rot_z: float, scale: float, offset) -> np.ndarray:
    c, s = math.cos(rot_z), math.sin(rot_z)
    rot = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
    return (verts * scale) @ rot.T + np.asarray(offset, np.float32)


def two_cars_scene(base: Scene, seed: int = 1) -> Scene:
    """Two transformed instances of the car_only geometry; 2 lights."""
    v1 = _transform(base.verts, rot_z=0.35, scale=1.0, offset=(-3.4, 2.2, 0.0))
    v2 = _transform(base.verts, rot_z=-0.5, scale=1.0, offset=(3.2, -1.2, 0.0))
    verts = np.concatenate([v1, v2], axis=0)
    faces = np.concatenate(
        [base.faces, base.faces + base.verts.shape[0]], axis=0
    )
    mat_idx = np.concatenate([base.mat_idx, base.mat_idx])
    lights_pos = np.array([[5.0, -7.0, 8.0], [-6.0, -2.0, 7.0]], np.float32)
    lights_kl = np.array([[55.0, 55.0, 50.0], [25.0, 27.0, 35.0]], np.float32)
    return Scene(
        verts=verts, faces=faces, mat_idx=mat_idx,
        mats_kd=base.mats_kd, mats_ks=base.mats_ks, mats_kr=base.mats_kr,
        lights_pos=lights_pos, lights_kl=lights_kl,
    )


def sportscar_scene(base: Scene, seed: int = 1) -> Scene:
    """car_only body on a glossy showroom floor; 4 lights."""
    floor_v = np.array(
        [[-14, -14, -0.01], [14, -14, -0.01], [14, 14, -0.01], [-14, 14, -0.01]],
        np.float32,
    )
    floor_f = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    verts = np.concatenate([base.verts, floor_v], axis=0)
    faces = np.concatenate([base.faces, floor_f + base.verts.shape[0]], axis=0)
    floor_mat = base.mats_kd.shape[0]
    mat_idx = np.concatenate(
        [base.mat_idx, np.full(2, floor_mat, np.int32)]
    )
    kd = np.concatenate([base.mats_kd, [[0.25, 0.25, 0.28]]], axis=0).astype(np.float32)
    ks = np.concatenate([base.mats_ks, [[0.3, 0.3, 0.3]]], axis=0).astype(np.float32)
    kr = np.concatenate([base.mats_kr, [[0.45, 0.45, 0.45]]], axis=0).astype(np.float32)
    lights_pos = np.array(
        [[6, -8, 9], [-6, -8, 9], [6, 6, 9], [-6, 6, 9]], np.float32
    )
    lights_kl = np.array(
        [[40, 40, 38], [38, 38, 40], [30, 30, 28], [28, 28, 30]], np.float32
    )
    return Scene(
        verts=verts, faces=faces, mat_idx=mat_idx,
        mats_kd=kd, mats_ks=ks, mats_kr=kr,
        lights_pos=lights_pos, lights_kl=lights_kl,
    )


def substitute_scene(name: str, asset_roots, seed: int = 1) -> Optional[Scene]:
    """Build a substitute Scene for a stripped asset, or None if unknown.

    The car geometry comes from a car_only OBJ directory under
    `asset_roots`, else from a car_only.npz snapshot there, else from the
    snapshot bundled with the package's repository (assets/car_only.npz).
    """
    import os

    from ..config import DEFAULT_ASSET_ROOTS

    def find_car() -> Scene:
        for root in asset_roots:
            p = os.path.join(root, "car_only")
            if os.path.isfile(os.path.join(p, "triangles.obj")):
                return load_scene(p)
        for root in (*asset_roots, *DEFAULT_ASSET_ROOTS):
            snap = os.path.join(root, "car_only.npz")
            if os.path.isfile(snap):
                return load_scene_npz(snap)
        raise FileNotFoundError("car_only assets required for substitutes")

    if name == "dragon":
        return dragon_scene(seed=seed)
    if name == "two_cars":
        return two_cars_scene(find_car(), seed=seed)
    if name == "sportscar":
        return sportscar_scene(find_car(), seed=seed)
    return None
