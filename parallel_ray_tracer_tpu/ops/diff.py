"""Differentiable rendering: gradients through the BVH-accelerated tracer.

The north-star capability (BASELINE.json): pixel colors carry gradients
w.r.t. vertex positions, normals (derived from vertices) and material
parameters, with a custom VJP around the traversal+intersection hot loop.

The decomposition:

  closest_hit(o, d)  =  argmin-topology  ∘  analytic intersection
                        (non-differentiable) (differentiable)

Traversal only *selects* which triangle each ray hits; for fixed topology
the hit distance is the smooth Möller–Trumbore t(v0, v1, v2, o, d). So the
custom VJP runs the fast (GPU kernel) tracer for the primal topology and routes
the cotangent of t through an analytic recompute on the winning triangle —
`diff_closest` below. Hit topology changes only on a measure-zero set
(silhouettes), where the true derivative has a Dirac edge term this
formulation drops (the standard differentiable-ray-tracing interior
gradient).

Shadow visibility is a step function; `make_soft_occluded` provides the
edge-aware soft relaxation: visibility falls off smoothly with the blocker
margin, computed from the *closest-hit* distance along the shadow ray
(differentiable through the same recompute), so gradients exist at shadow
edges and drive blockers in and out of the light path.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .intersect import T_MAX, moller_trumbore_t
from .shade import ClosestFn, trace_rays, _gather_vec
from .trace_brute import Hit
from .vecmath import Vec3


def _stop_hit(hit: Hit) -> Hit:
    return Hit(
        t=jax.lax.stop_gradient(hit.t),
        idx=jax.lax.stop_gradient(hit.idx),
        norm_dir=jax.lax.stop_gradient(hit.norm_dir),
    )


def _recompute_tuv(ds, o: Vec3, d: Vec3, hit: Hit):
    """Differentiable (t, u, v) for the (fixed) winning primitives.

    Triangle slots recompute Möller–Trumbore; sphere slots (idx >= T,
    ops/spheres.py index space) recompute the quadratic root, so sphere
    centers/radii also receive gradients. u, v are triangle-only
    (barycentric); sphere lanes carry a large interior margin so the
    soft-shadow edge term is inert for them.
    """
    T = ds.v0.x.shape[0]
    safe = jnp.clip(hit.idx, 0, T - 1)
    v0 = _gather_vec(ds.v0, safe)
    v1 = _gather_vec(ds.v1, safe)
    v2 = _gather_vec(ds.v2, safe)
    t, u, v = moller_trumbore_t(o, d, v0, v1, v2)

    S = ds.sph_c.x.shape[0]
    if S:
        from .intersect import ray_sphere

        is_sph = hit.idx >= T
        sidx = jnp.clip(hit.idx - T, 0, S - 1)
        c = Vec3(ds.sph_c.x[sidx], ds.sph_c.y[sidx], ds.sph_c.z[sidx])
        hs = ray_sphere(o, d, c, ds.sph_r[sidx])
        t = jnp.where(is_sph, hs.t, t)
        u = jnp.where(is_sph, 1.0 / 3.0, u)
        v = jnp.where(is_sph, 1.0 / 3.0, v)

    valid = hit.idx >= 0
    # Primal parity: the recomputed t equals the tracer's t up to op
    # reassociation; keep the recompute as the primal so forward==backward.
    return jnp.where(valid, t, T_MAX), u, v


def _recompute_t(ds, o: Vec3, d: Vec3, hit: Hit) -> jax.Array:
    return _recompute_tuv(ds, o, d, hit)[0]


def make_diff_closest(ds, closest_fn: ClosestFn) -> ClosestFn:
    """Wrap a fast tracer into a differentiable closest-hit.

    This realizes the custom VJP of the traversal+intersection hot loop
    described in the module docstring, in its stop-gradient normal form:

      - primal: the fast tracer (GPU kernel / packet while_loop) runs with
        every output under stop_gradient — reverse-mode AD never attempts to
        transpose the traversal (while_loop/pallas_call have no transpose);
      - backward: the cotangent of t flows through the analytic
        Möller–Trumbore recompute on the (frozen) winning triangle, reaching
        ds.v0/v1/v2 via the gather's scatter-add transpose — and through
        build_device_scene, the vertex buffer. Normals and materials reach
        their tables through the shading gathers (shade.surface_attrs).

    The two formulations (explicit jax.custom_vjp vs stopped-primal +
    differentiable recompute) define the same VJP; this form also lets the
    tracer close over scene arrays that are themselves being differentiated
    (their cotangent contribution is exactly the recompute path).
    """

    def closest(o: Vec3, d: Vec3):
        o_s = jax.tree.map(jax.lax.stop_gradient, o)
        d_s = jax.tree.map(jax.lax.stop_gradient, d)
        hit = _stop_hit(closest_fn(o_s, d_s))
        t = _recompute_t(ds, o, d, hit)
        return Hit(t=t, idx=hit.idx, norm_dir=hit.norm_dir)

    return closest


def make_soft_occluded(
    ds, closest_fn: ClosestFn, beta: float = 25.0
):
    """Edge-aware soft shadow visibility (returns float blocked in [0, 1]).

    Softness lives in the *silhouette* direction: a blocked shadow ray's
    occlusion fades with its barycentric margin min(u, v, 1-u-v) on the
    blocking triangle — 0 exactly at the blocker's edge, so moving a blocker
    vertex changes the penumbra smoothly and gradients drive blockers in and
    out of the light path (the soft-rasterizer formulation of "edge-aware").
    A depth factor additionally fades blockers lying close to the light end
    of the segment. beta -> inf recovers the reference's hard test
    t^2 < dist^2 (cpu/src/raytracer.c:85-97) for interior hits.

    One-sided: rays that *miss* the blocker carry no gradient (the true
    derivative's other half lives on the miss side of the edge); FD checks
    therefore compare on the blocked side.
    """

    def occluded(o: Vec3, d: Vec3, max_dist2: jax.Array) -> jax.Array:
        o_s = jax.tree.map(jax.lax.stop_gradient, o)
        d_s = jax.tree.map(jax.lax.stop_gradient, d)
        hit = _stop_hit(closest_fn(o_s, d_s))
        t, u, v = _recompute_tuv(ds, o, d, hit)
        dist = jnp.sqrt(jnp.maximum(max_dist2, 1e-30))
        has_hit = hit.idx >= 0
        # Finite stand-ins on miss lanes keep every sigmoid input bounded
        # (T_MAX would overflow the logit; its sigmoid gradient is NaN).
        t_safe = jnp.where(has_hit, t, 4.0 * dist)
        u_safe = jnp.where(has_hit, u, -1.0)
        v_safe = jnp.where(has_hit, v, -1.0)
        edge_margin = jnp.minimum(jnp.minimum(u_safe, v_safe), 1.0 - u_safe - v_safe)
        edge = jax.nn.sigmoid(jnp.clip(2.0 * beta * edge_margin, -30.0, 30.0))
        depth = jax.nn.sigmoid(
            jnp.clip(beta * (1.0 - t_safe / dist), -30.0, 30.0)
        )
        return jnp.where(has_hit, edge * depth, 0.0)

    return occluded


def make_hard_occluded_diff(occluded_fn):
    """Hard (reference-parity) visibility for the differentiable path:
    zero-gradient step function, exact forward values."""

    def occluded(o: Vec3, d: Vec3, max_dist2: jax.Array) -> jax.Array:
        o = jax.tree.map(jax.lax.stop_gradient, o)
        d = jax.tree.map(jax.lax.stop_gradient, d)
        max_dist2 = jax.lax.stop_gradient(max_dist2)
        return occluded_fn(o, d, max_dist2)

    return occluded


def trace_rays_diff(
    ds,
    closest_fn: ClosestFn,
    occluded_fn,
    o: Vec3,
    d: Vec3,
    bounces: int,
    soft_shadows: bool = False,
    beta: float = 25.0,
    reverse_shadows: bool = False,
) -> Vec3:
    """Differentiable bounce loop: trace_rays with the custom-VJP closest hit
    and the chosen visibility model. reverse_shadows threads the
    light-origin shadow schedule through the HARD
    visibility model only (binary occlusion of a segment is symmetric,
    so values and gradients are unaffected); the SOFT model's depth
    factor sigmoid(beta*(1 - t/dist)) is NOT symmetric under reversal
    (it fades blockers near the segment's far end), so soft_shadows
    ignores reverse_shadows and always traces hit -> light."""
    diff_closest = make_diff_closest(ds, closest_fn)
    if soft_shadows:
        occ = make_soft_occluded(ds, closest_fn, beta=beta)
        reverse_shadows = False
    else:
        occ = make_hard_occluded_diff(occluded_fn)
    return trace_rays(ds, diff_closest, occ, o, d, bounces,
                      reverse_shadows=reverse_shadows)
