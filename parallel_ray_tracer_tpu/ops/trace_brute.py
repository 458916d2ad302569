"""Brute-force tracer: every ray against every triangle.

The batched rewrite of the reference's USE_BVH=0 oracle path
(cpu/src/raytracer.c:112-130 closest hit, :85-97 occlusion): a lax.scan over
triangle chunks carrying the running (t, index, norm_dir) minimum — the
flash-attention-style streaming reduction, so memory stays O(rays + chunk)
instead of O(rays * triangles).

Tie-breaking matches the reference: strict improvement per chunk plus
first-argmin inside a chunk == global first-index-of-minimum.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from .intersect import T_MAX, moller_trumbore
from .vecmath import Vec3


class Hit(NamedTuple):
    t: jax.Array         # (R,) f32, T_MAX on miss
    idx: jax.Array       # (R,) i32 triangle index, -1 on miss
    norm_dir: jax.Array  # (R,) bool


def _chunked_tris(ds, chunk: int):
    """Reshape triangle SoA planes to (num_chunks, chunk), zero-padded.

    Zero padding is safe: a degenerate all-zero triangle has det=0 and always
    misses in moller_trumbore.
    """
    n = ds.v0.x.shape[0]
    nc = -(-n // chunk)
    pad = nc * chunk - n

    def prep(a):
        return jnp.pad(a, (0, pad)).reshape(nc, chunk)

    planes = []
    for v in (ds.v0, ds.v1, ds.v2):
        planes.append(Vec3(prep(v.x), prep(v.y), prep(v.z)))
    return nc, pad, planes


@functools.partial(jax.jit, static_argnames=("chunk",))
def closest_hit(ds, o: Vec3, d: Vec3, chunk: int = 512) -> Hit:
    """First-hit over all triangles. o, d: Vec3 of (R,) planes."""
    nc, _, (c0, c1, c2) = _chunked_tris(ds, chunk)
    R = o.x.shape[0]

    o2 = Vec3(o.x[:, None], o.y[:, None], o.z[:, None])
    d2 = Vec3(d.x[:, None], d.y[:, None], d.z[:, None])

    def step(carry, tri_chunk):
        t_best, idx_best, nd_best, base = carry
        v0, v1, v2 = tri_chunk
        v0 = Vec3(v0.x[None, :], v0.y[None, :], v0.z[None, :])
        v1 = Vec3(v1.x[None, :], v1.y[None, :], v1.z[None, :])
        v2 = Vec3(v2.x[None, :], v2.y[None, :], v2.z[None, :])
        h = moller_trumbore(o2, d2, v0, v1, v2)          # (R, chunk)
        am = jnp.argmin(h.t, axis=1)                      # first min in chunk
        rows = jnp.arange(R)
        t_c = h.t[rows, am]
        nd_c = h.norm_dir[rows, am]
        better = t_c < t_best
        t_best = jnp.where(better, t_c, t_best)
        idx_best = jnp.where(better, base + am.astype(jnp.int32), idx_best)
        nd_best = jnp.where(better, nd_c, nd_best)
        return (t_best, idx_best, nd_best, base + chunk), None

    init = (
        jnp.full((R,), T_MAX, jnp.float32),
        jnp.full((R,), -1, jnp.int32),
        jnp.zeros((R,), bool),
        jnp.int32(0),
    )
    (t, idx, nd, _), _ = jax.lax.scan(step, init, (c0, c1, c2))
    idx = jnp.where(t < T_MAX, idx, -1)
    return Hit(t=t, idx=idx, norm_dir=nd)


@functools.partial(jax.jit, static_argnames=("chunk",))
def occluded(ds, o: Vec3, d: Vec3, max_dist2: jax.Array, chunk: int = 512):
    """Any-hit: True where some triangle lies between o and sqrt(max_dist2)
    along unit direction d (cpu/src/raytracer.c:85-97: blocked iff
    |o - hitpoint|^2 < light_dist2, i.e. t^2 < max_dist2 for unit d)."""
    nc, _, (c0, c1, c2) = _chunked_tris(ds, chunk)

    o2 = Vec3(o.x[:, None], o.y[:, None], o.z[:, None])
    d2 = Vec3(d.x[:, None], d.y[:, None], d.z[:, None])

    def step(blocked, tri_chunk):
        v0, v1, v2 = tri_chunk
        v0 = Vec3(v0.x[None, :], v0.y[None, :], v0.z[None, :])
        v1 = Vec3(v1.x[None, :], v1.y[None, :], v1.z[None, :])
        v2 = Vec3(v2.x[None, :], v2.y[None, :], v2.z[None, :])
        h = moller_trumbore(o2, d2, v0, v1, v2)
        near = (h.t < T_MAX) & (h.t * h.t < max_dist2[:, None])
        return blocked | jnp.any(near, axis=1), None

    init = jnp.zeros((o.x.shape[0],), bool)
    blocked, _ = jax.lax.scan(step, init, (c0, c1, c2))
    return blocked


def make_tracer(ds, chunk: int = 512):
    """Bind a (closest_hit, occluded) pair for the shade loop."""
    from .spheres import wrap_tracer

    return wrap_tracer(
        ds,
        lambda o, d: closest_hit(ds, o, d, chunk=chunk),
        lambda o, d, m2: occluded(ds, o, d, m2, chunk=chunk),
    )
