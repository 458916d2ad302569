"""Runtime configuration for the ray tracer.

Every compile-time knob of the reference (cpu/include/options.h:1-74 and
gpu/include/options.cuh) becomes a runtime field here, so a single build
serves every workload variation.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Optional, Tuple

# cpu/src/main.c:105-106: cam at (0,-9,3), fov pi/3.2, rot.x = -pi/12.
DEFAULT_CAM_POS = (0.0, -9.0, 3.0)
DEFAULT_CAM_ROT = (-math.pi / 12.0, 0.0, 0.0)
DEFAULT_CAM_FOV = math.pi / 3.2

# Resolution presets mirroring the reference table (cpu/include/options.h:8-20).
RESOLUTIONS = {
    "32p": (64, 32),
    "144p": (256, 144),
    "240p": (426, 240),
    "360p": (640, 360),
    "480p": (854, 480),
    "720p": (1280, 720),
    "1080p": (1920, 1080),
    "2k": (2560, 1440),
    "4k": (3840, 2160),
    "8k": (7680, 4320),
}

SCENES = ("car_only", "car_boxed", "dragon", "sportscar", "two_cars")

# Default asset search path: the repo-local assets (OBJ/MTL directories or
# npz snapshots); --asset-root points at a reference checkout instead.
_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_ASSET_ROOTS = (os.path.join(_REPO_ROOT, "assets"),)


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """All reference knobs, runtime-selectable.

    Reference citations: WIDTH/HEIGHT (cpu/include/options.h:6-7), USE_BVH
    (:22), BVH_HEURISTIC (:34), SCENE (:40), TILE_SIZE (:49), BOUNCES (:52),
    ITERATIONS (:55), BVH_ELEMENT_THRESHOLD (:58), SAH_BIN_SIZE (:61),
    BVH_MAX_ITER (:64), SEED (:67), BVH_METRICS (:73), USE_BVH_FAST_LIGHT (:74).
    """

    width: int = 1920
    height: int = 1080
    scene: str = "car_boxed"

    use_bvh: bool = True
    # 0: axis 0 midpoint, 1: largest-axis midpoint, 2: random-axis midpoint,
    # 3: random pos on random axis, 4: median on largest axis,
    # 5: median on best-SAH axis, 6: binned SAH sweep  (cpu/src/bvh.c:115-242)
    bvh_heuristic: int = 3
    bvh_max_depth: int = 32          # BVH_MAX_ITER
    leaf_threshold: int = 2          # BVH_ELEMENT_THRESHOLD
    sah_bins: int = 32               # SAH_BIN_SIZE; -1 = brute-force sweep
    seed: int = 1                    # 0 = time-based, else fixed (options.h:66-71)
    bvh_metrics: bool = True
    fast_light: bool = True          # USE_BVH_FAST_LIGHT: any-hit shadow traversal

    bounces: int = 4
    iterations: int = 1
    warmup: int = 0                  # GPU harness uses 50 (gpu/include/options.cuh:25)

    # Pixel-tile shape: rays are traced in tile-major order, so a packet
    # ("jax") or a kernel block ("gpu") holds neighbouring pixels — the
    # analog of the CUDA (tx, ty) block-shape sweep (gpu/src/gpu.cu:98-100).
    tile_rows: int = 32
    tile_cols: int = 32

    # Tracer variant (pipeline.resolve_variant, ops/render.make_tracers):
    #   "gpu": per-ray Pallas BVH traversal kernels (ops/gpu_trace.py)
    #   "jax": vmapped lax.while_loop packet traversal, its plain-XLA
    #          reference (ops/trace_bvh.py)
    #   "bruteforce": all-triangles oracle (USE_BVH=0 analog)
    #   "auto": "gpu"; fails without a GPU unless the kernel is
    #           interpreted, so the default run is the served path.
    variant: str = "auto"
    # bf16 AABB compression — the hbvh_t analog (gpu/include/bvh.cuh:14-28),
    # with conservative rounding (min down/max up) instead of the
    # reference's round-to-nearest. Both BVH tracers read it.
    bf16_bvh: bool = False

    # Ambient light (cpu/src/main.c:36).
    ambient: Tuple[float, float, float] = (0.5, 0.5, 0.5)

    # Camera defaults (cpu/src/main.c:105-107).
    cam_pos: Tuple[float, float, float] = DEFAULT_CAM_POS
    cam_rot: Tuple[float, float, float] = DEFAULT_CAM_ROT
    cam_fov: float = DEFAULT_CAM_FOV

    # Synthetic scene mode: if >0, generate this many random triangles and no
    # lights (cpu/src/main.c:115-131).
    synthetic_triangles: int = 0

    asset_root: Optional[str] = None

    # Multi-device: number of mesh devices for image-tile sharding (1 = off).
    num_devices: int = 1

    # Use the C++ host runtime (native/src/rtnative.cpp) for scene loading
    # and BVH build/flatten; falls back to NumPy when no toolchain.
    use_native: bool = True

    # Score SAH splits by true surface area instead of the reference's
    # squared-diagonal approximation (cpu/src/bvh.c:43-46). A documented
    # divergence, ON by default: tree SEMANTICS still match the reference's
    # rules, only the heuristic-6 scoring differs, and the image is
    # tracer-identical. Set False for strict reference tree parity.
    # Implemented by both the C++ and NumPy builders.
    true_sah: bool = True

    # Trace shadow segments from the light toward the hit points (one
    # shared origin per light -> coherent shadow rays; the distance window
    # maps exactly, see ops/shade.shade_hit). Applies only with fast_light
    # (the any-hit tracer); the USE_BVH_FAST_LIGHT=0 parity fallback always
    # traces forward.
    reverse_shadows: bool = True

    # Triangle slots per flattened leaf group (1, 2, 4 or 8).
    leaf_size: int = 8

    # Pre-split oversized triangles before the BVH build (models/
    # presplit.py): 0 = off (strict reference build parity, and required
    # by the differentiable-training path, which owns the authored vertex
    # parameters); > 0 = split until every triangle AABB diagonal is at
    # most this fraction of the scene diagonal. Scene-sized wall/floor
    # triangles otherwise overlap every subtree.
    presplit: float = 0.0

    def __post_init__(self):
        if self.leaf_size not in (1, 2, 4, 8):
            raise ValueError(
                f"leaf_size must be 1, 2, 4 or 8, got {self.leaf_size}"
            )

    def resolution(self) -> Tuple[int, int]:
        return (self.width, self.height)

    def with_resolution(self, name: str) -> "RenderConfig":
        w, h = RESOLUTIONS[name]
        return dataclasses.replace(self, width=w, height=h)

    def asset_dir(self) -> str:
        roots = (self.asset_root,) if self.asset_root else DEFAULT_ASSET_ROOTS
        for root in roots:
            path = os.path.join(root, self.scene)
            if os.path.isdir(path):
                return path
        raise FileNotFoundError(
            f"scene '{self.scene}' not found under any of {roots}"
        )
