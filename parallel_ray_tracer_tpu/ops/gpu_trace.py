"""Per-ray BVH traversal kernels for the GPU (Pallas, Triton route).

The reference renderer's CUDA formulation (gpu/src/bvh.cu:342-392): every
lane traces one ray with its own node index and its own short stack, and
descends into the nearer child first. Closest hit keeps the best (t, slot)
per ray (cpu/src/bvh.c:317-358); any-hit stops a ray at its first blocker
(cpu/src/bvh.c:269-315, the `bvh_light_traverse` early exit).

The kernels read the same arrays as the pure-JAX packet tracer
(`trace_bvh.DeviceBVH` and the `DeviceScene` triangle planes in `slot_map`
order). Node and triangle fetches are per-lane gathers. A program traces
BLOCK consecutive rays of the tile-major ray order, so the rays of a block
come from one pixel tile and stay coherent. The per-ray stacks live in a
scratch output laid out stack-level-major within each program, so the
lanes of a warp that push or pop at the same level touch adjacent words
(the layout CUDA gives per-thread local arrays).

Results equal `trace_bvh` (same slab and Möller–Trumbore arithmetic, same
first-minimum tie rule within a leaf); only the order in which leaves are
visited differs, which can change the winner of an exact depth tie.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from .intersect import T_MAX, aabb_intersect, clip_inv_dir, moller_trumbore
from .shade import _FAR_ORIGIN
from .trace_brute import Hit
from .trace_bvh import DeviceBVH
from .vecmath import Vec3

# Rays per program: one warp, one ray per thread (measured against 64 and
# 128 rays on 2 and 4 warps, PERF.md).
BLOCK = 32
NUM_WARPS = 1


def stack_depth_for(depth: int) -> int:
    """Per-ray stack entries for a tree of the given depth: one pending
    sibling per level of the current root-to-node path."""
    return max(int(depth), 1)


def _gather(ref, i, mask, dtype=None):
    x = plgpu.load(ref.at[i], mask=mask, other=0)
    return x if dtype is None else x.astype(dtype)


def _gather3(refs, i, mask) -> Vec3:
    return Vec3(*(_gather(r, i, mask, jnp.float32) for r in refs))


def _any(x) -> jax.Array:
    # Triton has no boolean reduction; reduce the lanes as int32.
    return jnp.max(x.astype(jnp.int32)) > 0


def _traverse(refs, o: Vec3, d: Vec3, max_dist2, *, leaf_size: int,
              stack_ref):
    """Shared traversal loop; returns (t, slot, norm_dir, blocked).

    max_dist2 None: closest hit. Otherwise any-hit within sqrt(max_dist2):
    boxes are tested against the distance, triangles compare t^2 with
    max_dist2 (cpu/src/bvh.c:269-315)."""
    any_hit = max_dist2 is not None
    limit = jnp.sqrt(max_dist2) if any_hit else None   # d is unit
    count_ref, a_ref, lo_refs, hi_refs, v0_refs, v1_refs, v2_refs = refs
    inv_d = clip_inv_dir(d)
    lane = jax.lax.broadcasted_iota(jnp.int32, (BLOCK,), 0)
    zero_i = jnp.zeros((BLOCK,), jnp.int32)

    def child_entry(c, mask):
        lo = _gather3(lo_refs, c, mask)
        hi = _gather3(hi_refs, c, mask)
        return aabb_intersect(lo, hi, o, inv_d)

    def cond(state):
        return _any(jnp.logical_not(state[-1]))

    def body(state):
        node, sp, t, slot, nd, blocked, done = state
        active = jnp.logical_not(done)
        cnt = _gather(count_ref, node, active)
        a = _gather(a_ref, node, active)
        leaf = active & (cnt > 0)
        inner = active & (cnt == 0)

        # Leaf: test the group's live triangles in slot order; a strict `<`
        # keeps the first minimum, as the packet tracer's argmin does.
        for j in range(leaf_size):
            m = leaf & (cnt > j)
            s = a + j
            h = moller_trumbore(
                o, d, _gather3(v0_refs, s, m), _gather3(v1_refs, s, m),
                _gather3(v2_refs, s, m),
            )
            if any_hit:
                blocked = blocked | (
                    m & (h.t < T_MAX) & (h.t * h.t < max_dist2)
                )
            else:
                better = m & (h.t < t)
                t = jnp.where(better, h.t, t)
                slot = jnp.where(better, s, slot)
                nd = jnp.where(better, h.norm_dir.astype(jnp.int32), nd)

        # Inner: slab-test both children against the ray's current bound.
        left, right = a, a + 1
        tl = child_entry(left, inner)
        tr = child_entry(right, inner)
        bound = limit if any_hit else t
        hl = inner & (tl < bound)
        hr = inner & (tr < bound)
        if any_hit:
            left_first = jnp.ones((BLOCK,), bool)   # no useful order
        else:
            left_first = tl <= tr
        near = jnp.where(left_first, left, right)
        far = jnp.where(left_first, right, left)
        both = hl & hr
        plgpu.store(stack_ref.at[sp * BLOCK + lane], far, mask=both)
        sp = sp + both.astype(jnp.int32)
        descend = hl | hr
        nxt = jnp.where(both, near, jnp.where(hl, left, right))

        need_pop = active & jnp.logical_not(descend)
        if any_hit:
            need_pop = need_pop & jnp.logical_not(blocked)
        can_pop = need_pop & (sp > 0)
        popped = _gather(stack_ref, (sp - 1) * BLOCK + lane, can_pop)
        sp = sp - can_pop.astype(jnp.int32)
        node = jnp.where(descend, nxt, jnp.where(can_pop, popped, node))
        done = done | (need_pop & jnp.logical_not(can_pop))
        if any_hit:
            done = done | blocked
        return node, sp, t, slot, nd, blocked, done

    init = (
        zero_i, zero_i, jnp.full((BLOCK,), T_MAX, jnp.float32),
        jnp.full((BLOCK,), -1, jnp.int32), zero_i,
        jnp.zeros((BLOCK,), bool), jnp.zeros((BLOCK,), bool),
    )
    _, _, t, slot, nd, blocked, _ = jax.lax.while_loop(cond, body, init)
    return t, slot, nd, blocked


def _split_refs(refs):
    count_ref, a_ref = refs[:2]
    planes = refs[2:17]
    return (count_ref, a_ref, planes[0:3], planes[3:6], planes[6:9],
            planes[9:12], planes[12:15]), refs[17:]


def _closest_kernel(*refs, leaf_size: int):
    scene, (ox, oy, oz, dx, dy, dz, t_ref, idx_ref, nd_ref, stack_ref) = (
        _split_refs(refs)
    )
    o = Vec3(ox[...], oy[...], oz[...])
    d = Vec3(dx[...], dy[...], dz[...])
    t, slot, nd, _ = _traverse(
        scene, o, d, None, leaf_size=leaf_size, stack_ref=stack_ref
    )
    t_ref[...] = t
    idx_ref[...] = slot
    nd_ref[...] = nd


def _occluded_kernel(*refs, leaf_size: int):
    scene, (ox, oy, oz, dx, dy, dz, m2, blk_ref, stack_ref) = _split_refs(refs)
    o = Vec3(ox[...], oy[...], oz[...])
    d = Vec3(dx[...], dy[...], dz[...])
    _, _, _, blocked = _traverse(
        scene, o, d, m2[...], leaf_size=leaf_size, stack_ref=stack_ref
    )
    blk_ref[...] = blocked.astype(jnp.int32)


def _scene_arrays(bvh: DeviceBVH, ds):
    return (
        bvh.count, bvh.a, *bvh.bb_min, *bvh.bb_max,
        *ds.v0, *ds.v1, *ds.v2,
    )


def _pad_rays(R: int):
    return -(-R // BLOCK) * BLOCK - R


def _call(kernel, scene_arrays, ray_arrays, out_dtypes, stack_depth,
          interpret):
    # The traversal has no derivative of its own: ops/diff.py differentiates
    # hits through an analytic recompute on the winning triangle.
    scene_arrays, ray_arrays = jax.lax.stop_gradient((scene_arrays, ray_arrays))
    R = ray_arrays[0].shape[0]
    n = R // BLOCK
    full = [pl.BlockSpec(x.shape, lambda i: (0,)) for x in scene_arrays]
    blocked = pl.BlockSpec((BLOCK,), lambda i: (i,))
    out_shape = [jax.ShapeDtypeStruct((R,), dt) for dt in out_dtypes]
    out_shape.append(jax.ShapeDtypeStruct((R * stack_depth,), jnp.int32))
    out_specs = [blocked] * len(out_dtypes)
    out_specs.append(pl.BlockSpec((BLOCK * stack_depth,), lambda i: (i,)))
    outs = pl.pallas_call(
        kernel,
        grid=(n,),
        in_specs=full + [blocked] * len(ray_arrays),
        out_specs=out_specs,
        out_shape=out_shape,
        interpret=interpret,
        backend="triton",
        compiler_params=plgpu.CompilerParams(
            num_warps=NUM_WARPS, num_stages=1
        ),
    )(*scene_arrays, *ray_arrays)
    return outs[:-1]


def _ray_planes(o: Vec3, d: Vec3, pad: int):
    def p(x, v):
        return jnp.pad(x, (0, pad), constant_values=v)

    # Padding rays are dead rays (shade.mask_dead_rays): they miss at the root.
    return [p(x, _FAR_ORIGIN) for x in o] + [p(x, 0.0) for x in d]


@functools.partial(
    jax.jit, static_argnames=("leaf_size", "stack_depth", "interpret")
)
def closest_hit(bvh: DeviceBVH, ds, o: Vec3, d: Vec3, *, leaf_size: int,
                stack_depth: int, interpret: bool = False) -> Hit:
    """Closest triangle hit per ray. o, d: Vec3 of (R,) planes; any R."""
    R = o.x.shape[0]
    pad = _pad_rays(R)
    t, idx, nd = _call(
        functools.partial(_closest_kernel, leaf_size=leaf_size),
        _scene_arrays(bvh, ds), _ray_planes(o, d, pad),
        (jnp.float32, jnp.int32, jnp.int32), stack_depth, interpret,
    )
    return Hit(t=t[:R], idx=idx[:R], norm_dir=nd[:R] != 0)


@functools.partial(
    jax.jit, static_argnames=("leaf_size", "stack_depth", "interpret")
)
def occluded(bvh: DeviceBVH, ds, o: Vec3, d: Vec3, max_dist2: jax.Array, *,
             leaf_size: int, stack_depth: int,
             interpret: bool = False) -> jax.Array:
    """Any-hit: True where a triangle lies between o and sqrt(max_dist2)
    along unit d."""
    R = o.x.shape[0]
    pad = _pad_rays(R)
    rays = _ray_planes(o, d, pad) + [jnp.pad(max_dist2, (0, pad))]
    (blocked,) = _call(
        functools.partial(_occluded_kernel, leaf_size=leaf_size),
        _scene_arrays(bvh, ds), rays, (jnp.int32,), stack_depth, interpret,
    )
    return blocked[:R] != 0


def make_tracer(bvh: DeviceBVH, ds, leaf_size: int, depth: int,
                interpret: bool = False):
    """(closest, occluded) over flat (R,) ray planes, spheres included
    (dense post-pass, ops/spheres.py). `depth` is the tree depth
    (FlatBVH.depth); interpret runs the kernels in the Pallas interpreter."""
    from .spheres import wrap_tracer

    kw = dict(leaf_size=leaf_size, stack_depth=stack_depth_for(depth),
              interpret=interpret)
    return wrap_tracer(
        ds,
        lambda o, d: closest_hit(bvh, ds, o, d, **kw),
        lambda o, d, m2: occluded(bvh, ds, o, d, m2, **kw),
    )
