"""Sphere primitives in the trace path.

Ray-sphere intersection is a named capability of the north star; the
reference's sphere support is vestigial (empty assets/car_only/spheres.obj,
comment at cpu/src/raytracer.c:61). Here spheres are first-class: they
participate in closest-hit, occlusion, shading and the differentiable path.

Design: scenes carry few spheres (they have no acceleration structure in any
renderer of this family), so spheres are tested as one dense batched pass
*after* the triangle tracer — the (K rays x S spheres) test is a handful of
elementwise ops and XLA fuses it into the surrounding shading. Hit indices extend
the triangle index space: idx in [0, T) is a triangle slot, idx in
[T, T + S) is sphere idx - T; `norm_dir` carries the sphere's inside flag
(normal flip) exactly like the triangle two-sided-normal flag.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .intersect import T_MAX, ray_sphere
from .trace_brute import Hit
from .vecmath import Vec3


def _num_spheres(ds) -> int:
    return int(ds.sph_c.x.shape[0])


def sphere_closest(ds, o: Vec3, d: Vec3):
    """Nearest sphere per ray: (t, sphere_idx, inside) over (K,) rays."""
    S = _num_spheres(ds)
    o2 = Vec3(o.x[..., None], o.y[..., None], o.z[..., None])
    d2 = Vec3(d.x[..., None], d.y[..., None], d.z[..., None])
    c = Vec3(ds.sph_c.x[None, :], ds.sph_c.y[None, :], ds.sph_c.z[None, :])
    h = ray_sphere(o2, d2, c, ds.sph_r[None, :])        # (K, S)
    am = jnp.argmin(h.t, axis=-1)
    rows = jnp.arange(h.t.shape[0])
    return h.t[rows, am], am.astype(jnp.int32), h.inside[rows, am]


def wrap_tracer(ds, closest_fn, occluded_fn):
    """Extend a triangle-only (closest, occluded) pair with sphere tests.

    No-op (returns the originals) when the scene has no spheres, so the
    triangle-only hot path stays untouched.
    """
    S = _num_spheres(ds)
    if S == 0:
        return closest_fn, occluded_fn
    T = ds.v0.x.shape[0]

    def closest(o: Vec3, d: Vec3) -> Hit:
        h = closest_fn(o, d)
        ts, si, inside = sphere_closest(ds, o, d)
        better = ts < h.t
        return Hit(
            t=jnp.where(better, ts, h.t),
            idx=jnp.where(better, T + si, h.idx),
            norm_dir=jnp.where(better, inside, h.norm_dir),
        )

    def occluded(o: Vec3, d: Vec3, max_dist2: jax.Array) -> jax.Array:
        base = occluded_fn(o, d, max_dist2)
        ts, _, _ = sphere_closest(ds, o, d)
        blocked = (ts < T_MAX) & (ts * ts < max_dist2)
        return base | blocked

    return closest, occluded


def surface_frame(ds, hit: Hit, p: Vec3, tri_normal: Vec3, tri_mat):
    """Merge triangle and sphere surface attributes at the hit points.

    tri_normal/tri_mat are the triangle-path gathers (valid where the hit is
    a triangle); returns (unflipped normal, material index) with the sphere
    branch substituted where idx >= T. Flip by hit.norm_dir happens in the
    caller, uniformly for both primitive kinds.
    """
    S = _num_spheres(ds)
    if S == 0:
        return tri_normal, tri_mat
    T = ds.v0.x.shape[0]
    is_sph = hit.idx >= T
    sidx = jnp.clip(hit.idx - T, 0, S - 1)
    c = Vec3(ds.sph_c.x[sidx], ds.sph_c.y[sidx], ds.sph_c.z[sidx])
    r = jnp.maximum(ds.sph_r[sidx], 1e-30)
    n_sph = (p - c) / r
    n = n_sph.where(is_sph, tri_normal)
    mat = jnp.where(is_sph, ds.sph_mat[sidx], tri_mat)
    return n, mat


def override_attrs(ds, hit, p: Vec3, n: Vec3, kd: Vec3, ks: Vec3, kr: Vec3):
    """Substitute sphere-surface attributes on lanes with sphere hits.

    A static unrolled loop over the (few) spheres using masked selects and
    single-element table lookups.
    """
    S = _num_spheres(ds)
    if S == 0:
        return n, kd, ks, kr
    T = ds.v0.x.shape[0]
    for s_i in range(S):
        is_s = hit.idx == T + s_i
        r = jnp.maximum(ds.sph_r[s_i], 1e-30)
        ns = Vec3(
            (p.x - ds.sph_c.x[s_i]) / r,
            (p.y - ds.sph_c.y[s_i]) / r,
            (p.z - ds.sph_c.z[s_i]) / r,
        )
        mi = ds.sph_mat[s_i]
        def pick(tbl, cur, comp):
            return jnp.where(is_s, tbl[mi], comp)
        n = Vec3(jnp.where(is_s, ns.x, n.x), jnp.where(is_s, ns.y, n.y),
                 jnp.where(is_s, ns.z, n.z))
        kd = Vec3(pick(ds.kd.x, kd, kd.x), pick(ds.kd.y, kd, kd.y),
                  pick(ds.kd.z, kd, kd.z))
        ks = Vec3(pick(ds.ks.x, ks, ks.x), pick(ds.ks.y, ks, ks.y),
                  pick(ds.ks.z, ks, ks.z))
        kr = Vec3(pick(ds.kr.x, kr, kr.x), pick(ds.kr.y, kr, kr.y),
                  pick(ds.kr.z, kr, kr.z))
    return n, kd, ks, kr
