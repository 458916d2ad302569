"""Batched intersection primitives: Möller–Trumbore, AABB slab, ray-sphere.

Semantics match the reference exactly so that brute-force renders are
bit-comparable oracles:
  - hit_triangle (cpu/src/raytracer.c:35-59, gpu/src/raytracer.cu:23-47):
    EPSILON=1e-3, det = -dot(dir, n), norm_dir = det < 0, miss -> FLT_MAX.
  - aabb_intersect (cpu/src/bvh.c:48-59): slab test returning tmin or FLT_MAX.
  - Ray-sphere is a capability named by the north star; the reference's
    sphere support is vestigial (assets/car_only/spheres.obj is empty), so the
    quadratic form here is the canonical one.

All functions broadcast: rays and primitives may carry any leading shapes as
long as they broadcast against each other (e.g. rays (R,1) vs triangles (T,)).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from .vecmath import Vec3

EPSILON = 1e-3
# NumPy scalars, so Pallas kernels see them as literals, not captured arrays.
T_MAX = np.float32(3.4028235e38)  # FLT_MAX, the reference miss sentinel


class TriHit(NamedTuple):
    t: jax.Array          # distance in units of |dir|; T_MAX on miss
    norm_dir: jax.Array   # bool: det < 0 (selects the -n normal)
    u: jax.Array          # barycentric u (valid only when t < T_MAX)
    v: jax.Array          # barycentric v


def moller_trumbore(o: Vec3, d: Vec3, v0: Vec3, v1: Vec3, v2: Vec3) -> TriHit:
    """Batched Möller–Trumbore (cpu/src/raytracer.c:35-59)."""
    e1 = v1 - v0
    e2 = v2 - v0
    n = e1.cross(e2)
    det = -(d.dot(n))
    norm_dir = det < 0.0

    # The miss test gates the result, so a safe denominator changes nothing
    # in the forward pass — but it keeps reverse-mode AD finite: 1/0 = inf
    # would turn the (zero) cotangents of miss lanes into NaN (inf * 0).
    det_safe = jnp.where(jnp.abs(det) >= EPSILON, det, np.float32(1.0))
    invdet = 1.0 / det_safe
    ao = o - v0
    dao = ao.cross(d)

    u = e2.dot(dao) * invdet
    v = -(e1.dot(dao)) * invdet
    t = ao.dot(n) * invdet

    hit = (
        (jnp.abs(det) >= EPSILON)
        & (t > EPSILON)
        & (u >= 0.0)
        & (v >= 0.0)
        & ((u + v) <= 1.0)
    )
    t = jnp.where(hit, t, T_MAX)
    return TriHit(t=t, norm_dir=norm_dir, u=u, v=v)


def moller_trumbore_t(o: Vec3, d: Vec3, v0: Vec3, v1: Vec3, v2: Vec3):
    """Differentiable (t, u, v) of the *known-hit* triangle.

    Used by the backward path: traversal finds the hit topology; this
    recomputes the distance analytically so grads flow to vertices. Real
    hits have |det| >= EPSILON, so the guarded denominator is inert for
    them; it only keeps masked/miss lanes (callers substitute garbage
    rays there) finite so their zero cotangents stay zero instead of
    0 * inf = NaN.
    """
    e1 = v1 - v0
    e2 = v2 - v0
    n = e1.cross(e2)
    det = -(d.dot(n))
    det_safe = jnp.where(jnp.abs(det) >= 1e-12, det, np.float32(1.0))
    invdet = 1.0 / det_safe
    ao = o - v0
    dao = ao.cross(d)
    u = e2.dot(dao) * invdet
    v = -(e1.dot(dao)) * invdet
    t = ao.dot(n) * invdet
    return t, u, v


INV_DIR_MAX = 1e30  # finite stand-in for 1/0 (see clip_inv_dir)


def clip_inv_dir(d: Vec3) -> Vec3:
    """Reciprocal direction with infinities clamped to +/-1e30.

    The reference divides slab extents by direction components per node
    (cpu/src/bvh.c:50-55), relying on C99 fminf/fmaxf ignoring the NaNs that
    0 * inf produces. Precomputing one clamped reciprocal per ray removes 6
    divides per node AND every NaN path: with finite +/-1e30, 0 * 1e30 == 0,
    so an on-slab axis-parallel ray yields an unconstrained axis — a strictly
    conservative (never-cull-a-true-hit) superset of the C semantics, and
    plain min/max suffice (cheaper than NaN-aware fmin/fmax).
    """
    one = np.float32(1.0)
    lim = np.float32(INV_DIR_MAX)
    return Vec3(
        jnp.clip(one / d.x, -lim, lim),
        jnp.clip(one / d.y, -lim, lim),
        jnp.clip(one / d.z, -lim, lim),
    )


def aabb_intersect(
    bb_min: Vec3, bb_max: Vec3, o: Vec3, inv_d: Vec3
) -> jax.Array:
    """Slab test returning entry distance tmin, or T_MAX on miss
    (cpu/src/bvh.c:48-59). `inv_d` must come from clip_inv_dir (no NaNs)."""
    tx1 = (bb_min.x - o.x) * inv_d.x
    tx2 = (bb_max.x - o.x) * inv_d.x
    tmin = jnp.minimum(tx1, tx2)
    tmax = jnp.maximum(tx1, tx2)
    ty1 = (bb_min.y - o.y) * inv_d.y
    ty2 = (bb_max.y - o.y) * inv_d.y
    tmin = jnp.maximum(tmin, jnp.minimum(ty1, ty2))
    tmax = jnp.minimum(tmax, jnp.maximum(ty1, ty2))
    tz1 = (bb_min.z - o.z) * inv_d.z
    tz2 = (bb_max.z - o.z) * inv_d.z
    tmin = jnp.maximum(tmin, jnp.minimum(tz1, tz2))
    tmax = jnp.minimum(tmax, jnp.maximum(tz1, tz2))
    hit = (tmax >= tmin) & (tmax > 0.0)
    return jnp.where(hit, tmin, T_MAX)


class SphereHit(NamedTuple):
    t: jax.Array
    inside: jax.Array  # bool: origin inside the sphere (normal flips)


def ray_sphere(o: Vec3, d: Vec3, center: Vec3, radius) -> SphereHit:
    """Batched ray-sphere intersection (north-star capability).

    Solves |o + t*d - c|^2 = r^2; returns the nearest t > EPSILON in units of
    |d| (consistent with the triangle convention), T_MAX on miss.
    """
    oc = o - center
    a = d.dot(d)
    half_b = oc.dot(d)
    c = oc.dot(oc) - radius * radius
    disc = half_b * half_b - a * c
    # Guarded sqrt/denominator: keeps forward results identical for real
    # hits (disc > 0, a > 0) while reverse-mode AD stays finite on miss and
    # masked (d == 0) lanes, where the zero cotangent would otherwise meet
    # an infinite partial (0 * inf = NaN).
    sq = jnp.sqrt(jnp.maximum(disc, 1e-30))
    a_safe = jnp.where(a > 1e-20, a, np.float32(1.0))
    t0 = (-half_b - sq) / a_safe
    t1 = (-half_b + sq) / a_safe
    t = jnp.where(t0 > EPSILON, t0, t1)
    hit = (disc >= 0.0) & (t > EPSILON) & (a > 1e-20)
    inside = c < 0.0
    return SphereHit(t=jnp.where(hit, t, T_MAX), inside=inside)
