"""Device-flattened BVH: fixed-size leaf groups, SoA planes, bf16 option.

The host builder (ops/bvh.py) reproduces the reference tree semantics
(cpu/src/bvh.c:78-388). This module rewrites that tree into the shape the
device traversals want:

  - **Fixed leaf groups.** Reference leaves hold a variable triangle count
    (`tr_len`, cpu/include/bvh.h:17). Variable trip counts are poison under
    XLA/Pallas, so every leaf is normalized to exactly `L` triangle slots; a
    leaf with more than L triangles becomes a balanced binary subtree of
    L-sized groups (tighter AABBs recomputed from triangle bounds), and
    shorter groups are padded with degenerate-triangle slots that can never
    intersect (det == 0 in moller_trumbore).
  - **Dead-node collapse.** The reference marks failed splits as
    `count==0 && child==0` empty leaves and re-splits the full set one level
    deeper (cpu/src/bvh.c:85-86); we collapse those chains so traversal only
    ever sees live nodes.
  - **SoA planes.** Node AABBs are six (N,) float planes + (N,) i32 `count`
    (>0 leaf, 0 inner) and `a` (leaf: base slot into the grouped triangle
    arrays; inner: left-child index, right child adjacent at a+1 — the
    reference's child/child+1 layout, cpu/src/bvh.c:98-99).
  - **bf16 compression** (the hbvh_t analog, gpu/include/bvh.cuh:14-28,
    gpu/src/gpu.cu:176-185) with *conservative* rounding — min rounded down,
    max rounded up — instead of the reference's round-to-nearest
    `__float22half2_rn`, which can cull true hits (SURVEY.md §7 step 3).

The triangle slot order defines a permutation+padding (`slot_map`) that the
device scene applies to its own SoA planes, so a traversal hit index is
directly an index into the device triangle/material arrays.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import jax.numpy as jnp
import numpy as np

from .bvh import BVH


@dataclasses.dataclass
class FlatBVH:
    """Host-side flattened tree (NumPy); `as_device()` yields the jnp pytree."""

    node_min: np.ndarray  # (N, 3) f32
    node_max: np.ndarray  # (N, 3) f32
    count: np.ndarray     # (N,) i32; > 0 leaf (always == L live+pad slots), 0 inner
    a: np.ndarray         # (N,) i32; leaf: base slot; inner: left child
    slot_map: np.ndarray  # (S,) i32; slot -> original triangle id, -1 = pad
    leaf_size: int        # L
    depth: int            # max node depth (root = 0)

    @property
    def n_nodes(self) -> int:
        return int(self.count.shape[0])

    @property
    def n_slots(self) -> int:
        return int(self.slot_map.shape[0])


def flatten_bvh(
    bvh: BVH,
    tri_verts: np.ndarray,
    leaf_size: int = 4,
) -> FlatBVH:
    """Rewrite a builder tree into fixed-leaf-group SoA form.

    tri_verts: (T, 3, 3) float32 original triangle vertices (for the tight
    per-group AABBs of split oversized leaves).
    """
    L = int(leaf_size)
    tv = np.asarray(tri_verts, np.float32)
    tri_min = tv.min(axis=1)
    tri_max = tv.max(axis=1)

    src_count = bvh.count
    src_a = bvh.a
    src_min = np.stack([bvh.min_x, bvh.min_y, bvh.min_z], axis=1)
    src_max = np.stack([bvh.max_x, bvh.max_y, bvh.max_z], axis=1)
    perm = bvh.tri_perm

    out_min: List[np.ndarray] = []
    out_max: List[np.ndarray] = []
    out_count: List[int] = []
    out_a: List[int] = []
    slots: List[np.ndarray] = []
    max_depth = [0]

    def alloc() -> int:
        out_min.append(np.zeros(3, np.float32))
        out_max.append(np.zeros(3, np.float32))
        out_count.append(0)
        out_a.append(0)
        return len(out_count) - 1

    def live(i: int) -> bool:
        return src_count[i] > 0 or src_a[i] != 0

    def collapse(i: int) -> int:
        """Skip inner nodes with a dead child (failed reference splits)."""
        while src_count[i] == 0:
            c = int(src_a[i])
            ll, rl = live(c), live(c + 1)
            if ll and rl:
                break
            if not (ll or rl):
                # An inner node with two dead children cannot come out of
                # the builder (a failed split keeps all triangles at the
                # parent, cpu/src/bvh.c:85-86, so at least one child is
                # live). Emitting it as inner would recurse into node 0
                # forever (a == 0 on dead nodes) — fail loudly instead.
                raise AssertionError(
                    f"BVH node {i} is inner with two dead children; "
                    "the builder tree is malformed"
                )
            i = c if ll else c + 1
        return i

    def emit_group(slot_idx: int, tris: np.ndarray, depth: int) -> None:
        """Write a single ≤L-triangle leaf at `slot_idx`."""
        base = len(slots) * L
        padded = np.full(L, -1, np.int32)
        padded[: tris.shape[0]] = tris
        slots.append(padded)
        out_min[slot_idx] = tri_min[tris].min(axis=0)
        out_max[slot_idx] = tri_max[tris].max(axis=0)
        out_count[slot_idx] = int(tris.shape[0])
        out_a[slot_idx] = base
        max_depth[0] = max(max_depth[0], depth)

    def emit_tris(slot_idx: int, tris: np.ndarray, depth: int) -> None:
        """Emit a triangle set as a leaf or a balanced subtree of L-groups."""
        n = tris.shape[0]
        if n <= L:
            emit_group(slot_idx, tris, depth)
            return
        # Balanced split on group count so subtree depth is O(log(n/L)).
        k = -(-n // L)
        half_groups = k // 2
        cut = half_groups * L
        pair = alloc()
        alloc()
        out_min[slot_idx] = tri_min[tris].min(axis=0)
        out_max[slot_idx] = tri_max[tris].max(axis=0)
        out_count[slot_idx] = 0
        out_a[slot_idx] = pair
        emit_tris(pair, tris[:cut], depth + 1)
        emit_tris(pair + 1, tris[cut:], depth + 1)

    def emit(i: int, slot_idx: int, depth: int) -> None:
        i = collapse(i)
        cnt = int(src_count[i])
        if cnt > 0:
            first = int(src_a[i])
            emit_tris(slot_idx, perm[first : first + cnt].copy(), depth)
            return
        c = int(src_a[i])
        pair = alloc()
        alloc()
        out_min[slot_idx] = src_min[i]
        out_max[slot_idx] = src_max[i]
        out_count[slot_idx] = 0
        out_a[slot_idx] = pair
        max_depth[0] = max(max_depth[0], depth)
        emit(c, pair, depth + 1)
        emit(c + 1, pair + 1, depth + 1)

    root = alloc()
    emit(0, root, 0)

    slot_map = (
        np.concatenate(slots) if slots else np.zeros((0,), np.int32)
    ).astype(np.int32)
    return FlatBVH(
        node_min=np.stack(out_min).astype(np.float32),
        node_max=np.stack(out_max).astype(np.float32),
        count=np.asarray(out_count, np.int32),
        a=np.asarray(out_a, np.int32),
        slot_map=slot_map,
        leaf_size=L,
        depth=int(max_depth[0]),
    )


def compress_bf16(flat: FlatBVH) -> Tuple[np.ndarray, np.ndarray]:
    """Conservatively bf16-round node AABBs: min down, max up.

    The reference compresses with round-to-nearest (gpu/src/gpu.cu:181-184),
    which can shrink boxes and cull true hits; directed rounding keeps every
    box a superset of its f32 original, so traversal stays exact (only
    slightly less effective at culling).
    """
    def trunc_bits(x: np.ndarray) -> np.ndarray:
        """f32 -> bf16 bit pattern by mantissa truncation (round toward zero
        in magnitude for positives, toward zero for negatives too)."""
        return np.ascontiguousarray(x, np.float32).view(np.uint32) & np.uint32(
            0xFFFF0000
        )

    def bump(bits: np.ndarray) -> np.ndarray:
        """One bf16 ulp away from zero (works for both signs: increasing the
        magnitude bits of a negative float makes it more negative)."""
        return bits + np.uint32(0x00010000)

    def as_f32(bits: np.ndarray) -> np.ndarray:
        return bits.view(np.float32)

    lo_bits = trunc_bits(flat.node_min)
    # Truncation only increases negative values; push those one ulp down.
    lo_bits = np.where(as_f32(lo_bits) > flat.node_min, bump(lo_bits), lo_bits)
    hi_bits = trunc_bits(flat.node_max)
    # Truncation only decreases positive values; push those one ulp up.
    hi_bits = np.where(as_f32(hi_bits) < flat.node_max, bump(hi_bits), hi_bits)

    lo = as_f32(lo_bits).astype(jnp.bfloat16)
    hi = as_f32(hi_bits).astype(jnp.bfloat16)
    assert (lo.astype(np.float32) <= flat.node_min).all()
    assert (hi.astype(np.float32) >= flat.node_max).all()
    return lo, hi
