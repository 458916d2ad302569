"""Pre-split of oversized triangles before the BVH build.

car_boxed's room is a handful of wall/floor triangles the size of the
whole scene; their AABBs overlap every subtree, so bounce and shadow rays
descend both children of almost every node they touch.
Subdividing those triangles into scene-fraction-sized pieces before the
build restores spatial separation — the classic "early split clipping"
technique (Ernst & Greiner 2007) in its simplest watertight form:
longest-edge midpoint bisection, repeated until every triangle's AABB
diagonal is at most `ratio` of the scene diagonal.

Rendering semantics are unchanged: split pieces are coplanar with the
source triangle, inherit its material and (derived) normals, and shared
edges are bisected at identical midpoint vertices (deduplicated per edge)
so the mesh stays watertight. Hit indices refer to the split list and
shading gathers from the same list, so nothing downstream observes the
renumbering. The differentiable-training path
keeps `presplit=0` — vertex parameters must stay the authored ones.

The reference has no analog (its BVH simply degrades on car_boxed,
cpu/src/bvh.c:78-267); this is a tree-quality optimization, off
by default for strict build parity and enabled by RenderConfig.presplit.
"""

from __future__ import annotations

from typing import Tuple

import dataclasses

import numpy as np

from .scene import Scene


def _aabb_diag2(tv: np.ndarray) -> np.ndarray:
    """(T,) squared AABB diagonal per triangle; tv is (T, 3, 3)."""
    ext = tv.max(axis=1) - tv.min(axis=1)
    return (ext * ext).sum(axis=1)


def presplit_scene(
    scene: Scene, ratio: float = 1 / 16, max_rounds: int = 24,
    budget: float = 2.0,
) -> Tuple[Scene, np.ndarray]:
    """Split triangles until every AABB diagonal <= ratio * scene diagonal.

    Returns (new_scene, src_idx) where src_idx maps each output triangle
    to its source triangle in the input scene. Stops early if the
    triangle count would exceed `budget` x the original count.
    """
    verts = np.asarray(scene.verts, np.float32)
    faces = np.asarray(scene.faces, np.int64)
    src = np.arange(faces.shape[0], dtype=np.int64)

    scene_diag2 = float(_aabb_diag2(verts[None, :, :])[0]) if len(verts) else 0.0
    limit2 = scene_diag2 * float(ratio) * float(ratio)
    max_tris = int(faces.shape[0] * budget) + 1

    new_verts = [verts]
    n_verts = verts.shape[0]
    edge_mid: dict = {}

    def midpoint_index(a: int, b: int) -> int:
        nonlocal n_verts
        key = (a, b) if a < b else (b, a)
        m = edge_mid.get(key)
        if m is None:
            m = n_verts
            edge_mid[key] = m
            new_verts.append(
                ((new_verts_flat[a] + new_verts_flat[b]) * 0.5)[None, :]
            )
            n_verts += 1
        return m

    for _ in range(max_rounds):
        new_verts_flat = (
            np.concatenate(new_verts, axis=0) if len(new_verts) > 1
            else new_verts[0]
        )
        new_verts = [new_verts_flat]
        tv = new_verts_flat[faces]
        big = _aabb_diag2(tv) > limit2
        if not big.any() or faces.shape[0] >= max_tris:
            break
        n_split = min(int(big.sum()), max_tris - faces.shape[0])
        idx = np.nonzero(big)[0][:n_split]

        # Longest edge per selected triangle (0: v0v1, 1: v1v2, 2: v2v0).
        e01 = ((tv[idx, 1] - tv[idx, 0]) ** 2).sum(axis=1)
        e12 = ((tv[idx, 2] - tv[idx, 1]) ** 2).sum(axis=1)
        e20 = ((tv[idx, 0] - tv[idx, 2]) ** 2).sum(axis=1)
        longest = np.argmax(np.stack([e01, e12, e20], axis=1), axis=1)

        keep = np.ones(faces.shape[0], bool)
        keep[idx] = False
        out_faces = [faces[keep]]
        out_src = [src[keep]]
        add_faces = []
        add_src = []
        for t, le in zip(idx, longest):
            a, b, c = (int(x) for x in faces[t])
            if le == 0:
                m = midpoint_index(a, b)
                f1, f2 = (a, m, c), (m, b, c)
            elif le == 1:
                m = midpoint_index(b, c)
                f1, f2 = (a, b, m), (a, m, c)
            else:
                m = midpoint_index(c, a)
                f1, f2 = (a, b, m), (m, b, c)
            add_faces.extend((f1, f2))
            add_src.extend((src[t], src[t]))
        out_faces.append(np.asarray(add_faces, np.int64).reshape(-1, 3))
        out_src.append(np.asarray(add_src, np.int64))
        faces = np.concatenate(out_faces, axis=0)
        src = np.concatenate(out_src, axis=0)

    new_verts_flat = (
        np.concatenate(new_verts, axis=0) if len(new_verts) > 1
        else new_verts[0]
    )
    out = dataclasses.replace(
        scene,
        verts=new_verts_flat.astype(np.float32),
        faces=faces.astype(np.int32),
        mat_idx=np.asarray(scene.mat_idx)[src].astype(np.int32),
    )
    return out, src.astype(np.int64)
