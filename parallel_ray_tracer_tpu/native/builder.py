"""ctypes bindings for the native host runtime (src/rtnative.cpp).

Auto-compiles the shared library on first use (g++ -O3; ~2s) and caches it
next to the source; every entry point degrades gracefully to the NumPy
implementations (ops/bvh.py + ops/bvh_flat.py, models/scene.py) when no
toolchain is available, so the Python path remains the portable fallback and
the parity oracle.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "src", "rtnative.cpp")
_LIB = os.path.join(_DIR, "librtnative.so")
_lock = threading.Lock()
_lib = None
_lib_failed = False


def _compile() -> bool:
    try:
        subprocess.run(
            [
                "g++", "-O3", "-march=native", "-std=c++17", "-shared",
                "-fPIC", _SRC, "-o", _LIB,
            ],
            check=True,
            capture_output=True,
            timeout=120,
        )
        return True
    except Exception:
        return False


def get_lib() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native library, or None."""
    global _lib, _lib_failed
    with _lock:
        if _lib is not None or _lib_failed:
            return _lib
        fresh = os.path.exists(_LIB) and os.path.getmtime(_LIB) >= os.path.getmtime(_SRC)
        if not fresh and not _compile():
            _lib_failed = True
            return None
        try:
            lib = ctypes.CDLL(_LIB)
        except OSError:
            _lib_failed = True
            return None

        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")

        lib.rt_bvh_build.restype = ctypes.c_void_p
        lib.rt_bvh_build.argtypes = [
            f32p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_ulonglong, ctypes.c_int,
            ctypes.c_int,
        ]
        for name in ("rt_bvh_n_flat_nodes", "rt_bvh_n_slots"):
            getattr(lib, name).restype = ctypes.c_longlong
            getattr(lib, name).argtypes = [ctypes.c_void_p]
        lib.rt_bvh_depth.restype = ctypes.c_int
        lib.rt_bvh_depth.argtypes = [ctypes.c_void_p]
        lib.rt_bvh_get_flat.restype = None
        lib.rt_bvh_get_flat.argtypes = [ctypes.c_void_p, f32p, f32p, i32p, i32p, i32p]
        lib.rt_bvh_stats.restype = None
        lib.rt_bvh_stats.argtypes = [ctypes.c_void_p, f64p]
        lib.rt_bvh_free.restype = None
        lib.rt_bvh_free.argtypes = [ctypes.c_void_p]

        lib.rt_scene_load.restype = ctypes.c_void_p
        lib.rt_scene_load.argtypes = [ctypes.c_char_p]
        for name in ("rt_scene_n_verts", "rt_scene_n_faces",
                     "rt_scene_n_mats", "rt_scene_n_lights"):
            getattr(lib, name).restype = ctypes.c_longlong
            getattr(lib, name).argtypes = [ctypes.c_void_p]
        lib.rt_scene_get.restype = None
        lib.rt_scene_get.argtypes = [
            ctypes.c_void_p, f32p, i32p, i32p, f32p, f32p, f32p, f32p,
        ]
        lib.rt_scene_free.restype = None
        lib.rt_scene_free.argtypes = [ctypes.c_void_p]

        _lib = lib
        return _lib


def available() -> bool:
    return get_lib() is not None


def build_bvh_native(
    tri_verts: np.ndarray,
    heuristic: int = 6,
    max_depth: int = 32,
    leaf_threshold: int = 8,
    sah_bins: int = 32,
    seed: int = 1,
    leaf_size: int = 8,
    true_sah: bool = False,
):
    """Build + flatten in C++. Returns (FlatBVH, stats) with the same array
    semantics as the NumPy path, or None if the native library is
    unavailable.
    """
    lib = get_lib()
    if lib is None:
        return None
    from ..ops.bvh_flat import FlatBVH

    tv = np.ascontiguousarray(tri_verts, np.float32).reshape(-1, 9)
    T = tv.shape[0]
    h = lib.rt_bvh_build(
        tv, T, heuristic, max_depth, leaf_threshold, sah_bins, seed, leaf_size,
        int(true_sah),
    )
    if not h:
        return None
    try:
        n_nodes = lib.rt_bvh_n_flat_nodes(h)
        n_slots = lib.rt_bvh_n_slots(h)
        depth = lib.rt_bvh_depth(h)

        node_min = np.empty((n_nodes, 3), np.float32)
        node_max = np.empty((n_nodes, 3), np.float32)
        count = np.empty(n_nodes, np.int32)
        a = np.empty(n_nodes, np.int32)
        slot_map = np.empty(n_slots, np.int32)
        lib.rt_bvh_get_flat(h, node_min, node_max, count, a, slot_map)

        stats_raw = np.empty(5, np.float64)
        lib.rt_bvh_stats(h, stats_raw)
        stats = {
            "min_leaf": stats_raw[0],
            "max_leaf": stats_raw[1],
            "avg_leaf": stats_raw[2],
            "leaf_count": stats_raw[3],
            "n_nodes": stats_raw[4],
            "bytes": 32.0 * stats_raw[4],
        }
    finally:
        lib.rt_bvh_free(h)

    flat = FlatBVH(
        node_min=node_min, node_max=node_max, count=count, a=a,
        slot_map=slot_map, leaf_size=leaf_size, depth=depth,
    )
    return flat, stats


def load_scene_native(asset_dir: str):
    """C++ OBJ/MTL/lights loader. Returns a Scene or None."""
    lib = get_lib()
    if lib is None:
        return None
    sp = lib.rt_scene_load(asset_dir.encode())
    if not sp:
        return None
    from ..models.scene import Scene

    try:
        V = lib.rt_scene_n_verts(sp)
        F = lib.rt_scene_n_faces(sp)
        M = lib.rt_scene_n_mats(sp)
        Lg = lib.rt_scene_n_lights(sp)
        verts = np.empty((V, 3), np.float32)
        faces = np.empty((F, 3), np.int32)
        mat_idx = np.empty(F, np.int32)
        kd = np.empty((M, 3), np.float32)
        ks = np.empty((M, 3), np.float32)
        kr = np.empty((M, 3), np.float32)
        lights = np.empty((Lg, 6), np.float32)
        lib.rt_scene_get(sp, verts, faces, mat_idx, kd, ks, kr, lights)
    finally:
        lib.rt_scene_free(sp)

    scene = Scene(
        verts=verts, faces=faces, mat_idx=mat_idx,
        mats_kd=kd, mats_ks=ks, mats_kr=kr,
        lights_pos=np.ascontiguousarray(lights[:, :3]),
        lights_kl=np.ascontiguousarray(lights[:, 3:]),
    )
    # Sphere primitives are a framework extension the C++ loader does not
    # parse; run the Python parse here so both loaders agree on sphere
    # scenes (use_native defaults to True — without this a spheres.obj
    # would silently vanish; flagged in ADVICE.md round 1).
    spheres_path = os.path.join(asset_dir, "spheres.obj")
    if os.path.exists(spheres_path):
        from ..models.scene import load_spheres

        with open(spheres_path) as f:
            c, r, m = load_spheres(f.read())
        scene.spheres_center, scene.spheres_radius, scene.spheres_mat = c, r, m
    return scene
