"""Packet BVH traversal in pure JAX (lax.while_loop reference).

A packet rewrite of the reference's per-ray stack traversals
(cpu/src/bvh.c:317-358 closest hit, :269-315 any-hit shadow): a whole
*packet* of K rays shares one traversal stack. The stack and node fetches
are scalar; every AABB slab test and Möller–Trumbore test is a dense
(K,) / (K, L) vector op. A node is visited when ANY lane in the packet can
still be improved by it, so the result is exactly the per-ray reference
result — packets only change which nodes get *culled*.

Near-child-first ordering (the reference's swap at cpu/src/bvh.c:344-350)
becomes a per-packet majority vote of lanes on which child is nearer.

Early exits become masks:
  - closest-hit pruning: push child only if any lane has t_child < t_best;
  - any-hit: a lane is done when blocked; the loop ends when the stack
    empties or every lane is blocked (bvh_light_traverse's return-false
    early exit, cpu/src/bvh.c:283-290).

This module is the plain-XLA reference for the per-ray GPU kernels
(ops/gpu_trace.py), which read the same DeviceBVH.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from .intersect import T_MAX, aabb_intersect, clip_inv_dir, moller_trumbore
from .trace_brute import Hit
from .vecmath import Vec3


class DeviceBVH(NamedTuple):
    """Flat SoA BVH on device. Planes (N,); bf16 AABBs when compressed."""

    bb_min: Vec3
    bb_max: Vec3
    count: jax.Array   # (N,) i32; > 0 leaf, 0 inner
    a: jax.Array       # (N,) i32; leaf: base triangle slot; inner: left child


def device_bvh_from_flat(flat, bf16: bool = False) -> Tuple[DeviceBVH, int, int]:
    """Upload a host FlatBVH; returns (bvh, leaf_size, tree depth)."""
    if bf16:
        from .bvh_flat import compress_bf16

        lo, hi = compress_bf16(flat)
        bb_min = Vec3(*(jnp.asarray(lo[:, i]) for i in range(3)))
        bb_max = Vec3(*(jnp.asarray(hi[:, i]) for i in range(3)))
    else:
        bb_min = Vec3(*(jnp.asarray(flat.node_min[:, i]) for i in range(3)))
        bb_max = Vec3(*(jnp.asarray(flat.node_max[:, i]) for i in range(3)))
    bvh = DeviceBVH(
        bb_min=bb_min,
        bb_max=bb_max,
        count=jnp.asarray(flat.count),
        a=jnp.asarray(flat.a),
    )
    return bvh, flat.leaf_size, flat.depth


def packet_stack_depth(depth: int) -> int:
    """Packet traversal can push both children per level: bound the stack
    by tree depth + 2, doubled, with a floor."""
    return max(16, 2 * (depth + 2))


def _node_aabb(bvh: DeviceBVH, i) -> Tuple[Vec3, Vec3]:
    lo = Vec3(bvh.bb_min.x[i], bvh.bb_min.y[i], bvh.bb_min.z[i])
    hi = Vec3(bvh.bb_max.x[i], bvh.bb_max.y[i], bvh.bb_max.z[i])
    return lo.astype(jnp.float32), hi.astype(jnp.float32)


def _group_tris(ds, base, L: int):
    """Fetch the L-triangle leaf group starting at slot `base` as (1, L)."""

    def sl(p):
        return jax.lax.dynamic_slice(p, (base,), (L,))[None, :]

    v0 = Vec3(sl(ds.v0.x), sl(ds.v0.y), sl(ds.v0.z))
    v1 = Vec3(sl(ds.v1.x), sl(ds.v1.y), sl(ds.v1.z))
    v2 = Vec3(sl(ds.v2.x), sl(ds.v2.y), sl(ds.v2.z))
    return v0, v1, v2


def _push(stack, sp, node, pred):
    """Write `node` at stack[sp]; advance sp only when pred (lane-masked push
    without control flow)."""
    stack = jax.lax.dynamic_update_index_in_dim(stack, node, sp, 0)
    return stack, sp + pred.astype(jnp.int32)


_inv_dir = clip_inv_dir


@functools.partial(jax.jit, static_argnames=("leaf_size", "stack_depth"))
def packet_closest(
    bvh: DeviceBVH,
    ds,
    o: Vec3,
    d: Vec3,
    leaf_size: int = 4,
    stack_depth: int = 64,
) -> Hit:
    """Closest hit for one packet. o, d: Vec3 of (K,) planes."""
    L = leaf_size
    K = o.x.shape[0]
    inv_d = _inv_dir(d)

    stack0 = jnp.zeros((stack_depth,), jnp.int32)  # root pre-pushed at slot 0
    init = (
        stack0,
        jnp.int32(1),
        jnp.full((K,), T_MAX, jnp.float32),
        jnp.full((K,), -1, jnp.int32),
        jnp.zeros((K,), bool),
    )

    def cond(state):
        return state[1] > 0

    def body(state):
        stack, sp, t, idx, nd = state
        sp = sp - 1
        node = stack[sp]
        cnt = bvh.count[node]
        a = bvh.a[node]

        def leaf(args):
            stack, sp, t, idx, nd = args
            v0, v1, v2 = _group_tris(ds, a, L)
            o2 = Vec3(o.x[:, None], o.y[:, None], o.z[:, None])
            d2 = Vec3(d.x[:, None], d.y[:, None], d.z[:, None])
            h = moller_trumbore(o2, d2, v0, v1, v2)     # (K, L)
            am = jnp.argmin(h.t, axis=1)
            rows = jnp.arange(K)
            t_c = h.t[rows, am]
            nd_c = h.norm_dir[rows, am]
            better = t_c < t
            t = jnp.where(better, t_c, t)
            idx = jnp.where(better, a + am.astype(jnp.int32), idx)
            nd = jnp.where(better, nd_c, nd)
            return stack, sp, t, idx, nd

        def inner(args):
            stack, sp, t, idx, nd = args
            lo_l, hi_l = _node_aabb(bvh, a)
            lo_r, hi_r = _node_aabb(bvh, a + 1)
            tl = aabb_intersect(lo_l, hi_l, o, inv_d)   # (K,)
            tr = aabb_intersect(lo_r, hi_r, o, inv_d)
            hit_l = jnp.any(tl < t)
            hit_r = jnp.any(tr < t)
            # Majority vote on near child (reference swap, cpu/src/bvh.c:344-350).
            left_near = jnp.sum((tl < tr).astype(jnp.int32)) * 2 >= K
            near = jnp.where(left_near, a, a + 1)
            far = a + (a + 1) - near
            near_hit = jnp.where(left_near, hit_l, hit_r)
            far_hit = jnp.where(left_near, hit_r, hit_l)
            stack, sp = _push(stack, sp, far, far_hit)
            stack, sp = _push(stack, sp, near, near_hit)
            return stack, sp, t, idx, nd

        return jax.lax.cond(cnt > 0, leaf, inner, (stack, sp, t, idx, nd))

    _, _, t, idx, nd = jax.lax.while_loop(cond, body, init)
    return Hit(t=t, idx=idx, norm_dir=nd)


@functools.partial(jax.jit, static_argnames=("leaf_size", "stack_depth"))
def packet_occluded(
    bvh: DeviceBVH,
    ds,
    o: Vec3,
    d: Vec3,
    max_dist2: jax.Array,
    leaf_size: int = 4,
    stack_depth: int = 64,
) -> jax.Array:
    """Any-hit occlusion for one packet: True where a triangle lies between
    o and sqrt(max_dist2) along unit d (cpu/src/bvh.c:269-315 semantics)."""
    L = leaf_size
    K = o.x.shape[0]
    inv_d = _inv_dir(d)
    t_limit = jnp.sqrt(max_dist2)        # d is unit for shadow rays

    stack0 = jnp.zeros((stack_depth,), jnp.int32)
    init = (stack0, jnp.int32(1), jnp.zeros((K,), bool))

    def cond(state):
        _, sp, blocked = state
        return (sp > 0) & jnp.logical_not(jnp.all(blocked))

    def body(state):
        stack, sp, blocked = state
        sp = sp - 1
        node = stack[sp]
        cnt = bvh.count[node]
        a = bvh.a[node]

        def leaf(args):
            stack, sp, blocked = args
            v0, v1, v2 = _group_tris(ds, a, L)
            o2 = Vec3(o.x[:, None], o.y[:, None], o.z[:, None])
            d2 = Vec3(d.x[:, None], d.y[:, None], d.z[:, None])
            h = moller_trumbore(o2, d2, v0, v1, v2)
            near = (h.t < T_MAX) & (h.t * h.t < max_dist2[:, None])
            return stack, sp, blocked | jnp.any(near, axis=1)

        def inner(args):
            stack, sp, blocked = args
            lo_l, hi_l = _node_aabb(bvh, a)
            lo_r, hi_r = _node_aabb(bvh, a + 1)
            tl = aabb_intersect(lo_l, hi_l, o, inv_d)
            tr = aabb_intersect(lo_r, hi_r, o, inv_d)
            active_limit = jnp.where(blocked, jnp.float32(0.0), t_limit)
            hit_l = jnp.any(tl < active_limit)
            hit_r = jnp.any(tr < active_limit)
            # Any-hit traversal has no useful ordering (reference pushes both
            # unordered, cpu/src/bvh.c:298-313); push left last so it pops
            # first, matching the reference's near-left bias.
            stack, sp = _push(stack, sp, a + 1, hit_r)
            stack, sp = _push(stack, sp, a, hit_l)
            return stack, sp, blocked

        return jax.lax.cond(cnt > 0, leaf, inner, (stack, sp, blocked))

    _, _, blocked = jax.lax.while_loop(cond, body, init)
    return blocked


def make_tracer(bvh: DeviceBVH, ds, leaf_size: int, depth: int, packet: int):
    """(closest, occluded) over flat (R,) ray planes, R % packet == 0.

    `depth` is the tree depth (FlatBVH.depth). The packets are vmapped, so
    one while loop advances all of them together. Sphere primitives are
    tested in a dense post-pass (ops/spheres.py).
    """
    from .spheres import wrap_tracer

    stack_depth = packet_stack_depth(depth)

    def closest(o: Vec3, d: Vec3) -> Hit:
        R = o.x.shape[0]
        assert R % packet == 0, (R, packet)
        n = R // packet

        def one(args):
            oo, dd = args
            return packet_closest(
                bvh, ds, oo, dd, leaf_size=leaf_size, stack_depth=stack_depth
            )

        h = jax.vmap(one)((o.reshape(n, packet), d.reshape(n, packet)))
        return Hit(
            t=h.t.reshape(R), idx=h.idx.reshape(R), norm_dir=h.norm_dir.reshape(R)
        )

    def occluded(o: Vec3, d: Vec3, max_dist2: jax.Array) -> jax.Array:
        R = o.x.shape[0]
        assert R % packet == 0, (R, packet)
        n = R // packet

        def one(args):
            oo, dd, m2 = args
            return packet_occluded(
                bvh, ds, oo, dd, m2, leaf_size=leaf_size, stack_depth=stack_depth
            )

        blocked = jax.vmap(one)(
            (
                o.reshape(n, packet),
                d.reshape(n, packet),
                max_dist2.reshape(n, packet),
            ),
        )
        return blocked.reshape(R)

    return wrap_tracer(ds, closest, occluded)
