"""Shading + fixed-trip bounce loop (the whole-ray engine).

Batched formulation of the reference GPU's iterative raytrace
(gpu/src/raytracer.cu:61-116), which is the canonical one (SURVEY.md §2/quirks):
recursion becomes a fixed `bounces`-trip loop carrying (origin, dir,
multiplier, final_color), early exits become lane masks. This shape is both
XLA-friendly (static trip count, no data-dependent control flow) and
reverse-mode-AD-friendly.

Semantics replicated exactly:
  - Blinn-Phong *without* shininess exponent: kd*max(0,n·l) + ks*max(0,n·h)
    (cpu/src/raytracer.c:21-33). NOTE the reference quirk: the view vector in
    the half-vector is the *unnormalized* -dir — replicated for parity.
  - ambient term kd*amb on hit, plain amb on miss (cpu/src/raytracer.c:132-146).
  - per-light: 1/r^2 falloff, backface check dot(L-P, n) < 0 -> shadowed,
    occlusion via any-hit (cpu/src/raytracer.c:62-98, :149-160).
  - reflection r = normalize(dir + n*2|dir·n|), multiplier *= kr, early break
    when |multiplier|^2 < EPSILON^2 *before* the kr update
    (gpu/src/raytracer.cu:101-115).
"""

from __future__ import annotations

from typing import Callable, Tuple

import jax
import jax.numpy as jnp

from .intersect import EPSILON, T_MAX
from .trace_brute import Hit
from .vecmath import Vec3

ClosestFn = Callable[[Vec3, Vec3], Hit]
OccludedFn = Callable[[Vec3, Vec3, jax.Array], jax.Array]


_FAR_ORIGIN = 1e30


def mask_dead_rays(o: Vec3, d: Vec3, alive) -> Tuple[Vec3, Vec3]:
    """Make dead lanes invisible to packet traversal at zero cost.

    A dead lane gets direction 0 and an origin far outside every AABB: the
    slab test then yields tmin = tmax = -inf (miss) for every node, and
    Möller–Trumbore has det == 0, so neither traversal nor leaf tests ever
    act on the lane. This is the masked-lane equivalent of the reference's
    early exits (gpu/src/raytracer.cu:71-74, :103-104) — dead lanes stop
    steering the packet, and fully dead packets terminate at the root.
    """
    far = Vec3(
        jnp.full_like(o.x, _FAR_ORIGIN),
        jnp.full_like(o.y, _FAR_ORIGIN),
        jnp.full_like(o.z, _FAR_ORIGIN),
    )
    zero = Vec3(d.x * 0, d.y * 0, d.z * 0)
    return o.where(alive, far), d.where(alive, zero)


def occluded_from_closest(closest_fn: ClosestFn) -> OccludedFn:
    """USE_BVH_FAST_LIGHT=0 fallback: shadow visibility via the closest-hit
    traversal instead of the dedicated any-hit walk — blocked iff the closest
    hit lies nearer than the light (cpu/src/raytracer.c:72-84, with t in
    units of the unit shadow direction so t^2 < light_dist^2)."""

    def occluded(o: Vec3, d: Vec3, max_dist2: jax.Array) -> jax.Array:
        h = closest_fn(o, d)
        return (h.idx >= 0) & (h.t * h.t < max_dist2)

    return occluded


def _gather_vec(v: Vec3, idx: jax.Array) -> Vec3:
    return Vec3(v.x[idx], v.y[idx], v.z[idx])


def _bcast_scalar_vec(v: Vec3, i: int, like: jax.Array) -> Vec3:
    return Vec3(
        jnp.broadcast_to(v.x[i], like.shape),
        jnp.broadcast_to(v.y[i], like.shape),
        jnp.broadcast_to(v.z[i], like.shape),
    )


def surface_attrs(ds, hit, p: Vec3):
    """(unit unflipped normal, kd, ks, kr) at the hit points.

    Per-lane gathers of the winning triangle's normal and material (the
    reference's material index read, gpu/include/triangle.cuh:8-28); sphere
    lanes are overridden by a gather-free select loop.
    """
    from .spheres import override_attrs

    T = ds.v0.x.shape[0]
    safe_idx = jnp.clip(hit.idx, 0, T - 1)
    n = _gather_vec(ds.n0, safe_idx)
    mi = ds.mat_idx[safe_idx]
    kd = _gather_vec(ds.kd, mi)
    ks = _gather_vec(ds.ks, mi)
    kr = _gather_vec(ds.kr, mi)
    return override_attrs(ds, hit, p, n, kd, ks, kr)


def shade_hit(
    ds,
    occluded_fn: OccludedFn,
    o: Vec3,
    d: Vec3,
    hit: Hit,
    active=None,
    reverse_shadows: bool = False,
) -> Vec3:
    """Direct lighting at the hit points (no reflection term).

    Returns the reference's per-bounce `col`: kd*amb + sum over lights.
    Values on miss lanes are garbage; callers mask.

    `active` (bool lanes) gates the shadow rays: inactive lanes get a
    zero direction, which makes every AABB/triangle test miss, so packet
    traversal skips them at zero cost (dead-lane culling).

    reverse_shadows traces each shadow segment FROM THE LIGHT toward the
    hit point instead of hit point -> light. Occlusion of a segment is
    symmetric, and the window maps exactly: the forward test accepts
    hits with t in (EPS, dist) (cpu/src/raytracer.c:35-59 EPSILON +
    bvh_light_traverse's t^2 < dist^2), which is s in (0, dist - EPS)
    from the light end, so the reversed call passes
    max_dist2 = (dist - EPS)^2 and the kernel's own t > EPS origin guard
    excludes only geometry within EPS of the light (none in practice).
    The payoff is coherence: a pixel tile's shadow rays toward a point
    light share ONE origin reversed — like primary rays from a "light
    camera" — where their forward origins scatter across geometry.
    """
    t_safe = jnp.where(hit.idx >= 0, hit.t, 1.0)
    if active is None:
        active = hit.idx >= 0

    p = o + d * t_safe
    n, kd, ks, _ = surface_attrs(ds, hit, p)
    n = (-n).where(hit.norm_dir, n)

    col = kd * ds.ambient
    view = -d  # unnormalized, as in the reference (cpu/src/raytracer.c:148)

    for i in range(ds.num_lights):
        lp = _bcast_scalar_vec(ds.lights_pos, i, p.x)
        kl = _bcast_scalar_vec(ds.lights_kl, i, p.x)
        lvec = lp - p
        # Guarded sqrt: keeps reverse-mode AD finite when a hit point
        # coincides with (or the half-vector cancels at) the light.
        mag2 = lvec.mag2()
        mag = jnp.sqrt(jnp.maximum(mag2, 1e-30))
        l = lvec / mag
        n_dot_l = n.dot(l)
        hv = l + view
        h = hv / jnp.sqrt(jnp.maximum(hv.mag2(), 1e-30))
        coeff = jnp.maximum(0.0, n.dot(h))
        col_ray = kd * jnp.maximum(0.0, n_dot_l) + ks * coeff
        backface = lvec.dot(n) < 0.0            # cpu/src/raytracer.c:66-67
        # Only lanes whose visibility can matter trace a shadow ray; the
        # rest are masked out so the traversal never visits nodes for them.
        need = active & jnp.logical_not(backface)
        if reverse_shadows:
            # light -> hit point; -l is bit-exactly antiparallel to l.
            ro_m, rd_m = mask_dead_rays(lp, -l, need)
            rng2 = jnp.maximum(mag - EPSILON, 0.0) ** 2
            occ = occluded_fn(ro_m, rd_m, rng2)
        else:
            p_m, l_m = mask_dead_rays(p, l, need)
            occ = occluded_fn(p_m, l_m, mag2)
        # Float visibility, the reference GPU's branchless form
        # (gpu/src/raytracer.cu:50-59): 0/1 for hard shadows, fractional for
        # the differentiable soft-visibility tracer (ops/diff.py).
        vis = jnp.logical_not(backface).astype(jnp.float32) * (
            1.0 - occ.astype(jnp.float32)
        )
        contrib = kl * col_ray / jnp.maximum(mag2, 1e-30)
        col = col + contrib * vis

    return col


def trace_rays(
    ds,
    closest_fn: ClosestFn,
    occluded_fn: OccludedFn,
    o: Vec3,
    d: Vec3,
    bounces: int,
    reverse_shadows: bool = False,
) -> Vec3:
    """Full masked bounce loop; returns unclamped color per ray.

    reverse_shadows: see shade_hit."""
    zero = Vec3(o.x * 0, o.y * 0, o.z * 0)
    final = zero
    mult = Vec3(o.x * 0 + 1, o.y * 0 + 1, o.z * 0 + 1)
    alive = jnp.ones(o.x.shape, bool)

    for b in range(bounces):
        o_m, d_m = mask_dead_rays(o, d, alive)
        hit = closest_fn(o_m, d_m)
        is_hit = hit.idx >= 0

        # Miss: add multiplier * ambient, lane dies (raytracer.cu:71-74).
        miss_now = alive & jnp.logical_not(is_hit)
        amb = Vec3(
            jnp.broadcast_to(ds.ambient.x, o.x.shape),
            jnp.broadcast_to(ds.ambient.y, o.x.shape),
            jnp.broadcast_to(ds.ambient.z, o.x.shape),
        )
        final = final + (mult * amb).where(miss_now, zero)
        alive = alive & is_hit

        col = shade_hit(ds, occluded_fn, o, d, hit,
                        active=alive, reverse_shadows=reverse_shadows)
        final = final + (mult * col).where(alive, zero)

        # Early exit check happens BEFORE the kr update (raytracer.cu:103-106).
        alive = alive & (mult.mag2() >= EPSILON * EPSILON)

        t_safe = jnp.where(is_hit, hit.t, 1.0)
        p = o + d * t_safe
        n, _, _, kr = surface_attrs(ds, hit, p)
        mult = mult * kr

        # Reflection ray (raytracer.cu:109-114).
        n = (-n).where(hit.norm_dir, n)
        refl = d + n * (2.0 * jnp.abs(d.dot(n)))
        rmag = jnp.sqrt(jnp.maximum(refl.mag2(), 1e-30))
        d = refl / rmag
        o = p

    return final
