"""End-to-end pipeline: config -> scene -> BVH -> device arrays -> render.

The analog of the reference's main() flow (cpu/src/main.c:90-212,
gpu/src/main.cu:80-141): load scene, build BVH (timed), upload once, render
many frames. Everything after `prepare()` is jitted and device-resident —
the scene/BVH stay on the device across frames exactly like the reference
keeps them across kernel launches (gpu/src/main.cu:110-115).
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Optional

import jax
import jax.numpy as jnp

from .config import RenderConfig
from .models.camera import Camera
from .models.device_scene import DeviceScene, device_scene_from_host
from .models.scene import Scene, load_scene, synthetic_scene
from .ops import render as render_ops, trace_bvh
from .ops.bvh import BVH, build_bvh
from .ops.bvh_flat import FlatBVH, flatten_bvh


def resolve_variant(variant: str, use_bvh: bool = True,
                    interpret: bool = False) -> str:
    """Resolve "auto" to a concrete tracer variant.

    "auto" is the per-ray GPU kernel. Without a GPU it fails instead of
    quietly tracing on the CPU: the kernel then runs only when the caller
    asks for the Pallas interpreter (interpret=True), and the pure-JAX
    variants only when named. USE_BVH=0 always means bruteforce.
    """
    if not use_bvh:
        return "bruteforce"
    if variant == "auto":
        variant = "gpu"
    if variant not in render_ops.VARIANTS:
        raise ValueError(
            f"unknown variant {variant!r}; expected 'auto' or one of "
            f"{render_ops.VARIANTS}"
        )
    if variant == "gpu" and not interpret and jax.default_backend() != "gpu":
        raise RuntimeError(
            "the 'gpu' tracer (the default 'auto' variant) needs a GPU, and "
            f"JAX's backend is {jax.default_backend()!r}. Name the 'jax' or "
            "'bruteforce' variant, or ask for the Pallas interpreter "
            "(interpret=True, --interpret), to render without one."
        )
    return variant


@dataclasses.dataclass
class Pipeline:
    """Prepared, device-resident render state."""

    cfg: RenderConfig
    scene: Scene
    ds: DeviceScene
    bvh: Optional[BVH]               # host tree (None: native build or no BVH)
    flat: Optional[FlatBVH]
    dbvh: Optional[trace_bvh.DeviceBVH]
    leaf_size: int
    depth: int                       # tree depth; sizes the traversal stacks
    build_ms: float
    bvh_stats: Optional[dict] = None

    def bvh_metrics_banner(self) -> Optional[str]:
        """The reference's BVH_METRICS printout (cpu/src/bvh.c:381-387)."""
        s = self.bvh_stats
        if not s:
            return None
        return (
            f"min number of triangle: {int(s['min_leaf'])}\n"
            f"max number of triangle: {int(s['max_leaf'])}\n"
            f"avg number of triangle: {s['avg_leaf']:.2f}\n"
            f"number of leaf: {int(s['leaf_count'])}\n"
            f"bvh size (bytes): {int(s['bytes'])}"
        )

    def camera(self) -> Camera:
        return Camera(
            pos=self.cfg.cam_pos, rot=self.cfg.cam_rot, fov=self.cfg.cam_fov
        )

    def resolved_variant(self, variant: Optional[str] = None,
                         interpret: bool = False) -> str:
        """The concrete tracer for `variant` (default: the config's)."""
        return resolve_variant(
            variant or self.cfg.variant, self.cfg.use_bvh, interpret
        )

    def render(
        self,
        cam: Optional[Camera] = None,
        width: Optional[int] = None,
        height: Optional[int] = None,
        variant: Optional[str] = None,
        interpret: bool = False,
    ) -> jax.Array:
        """Render one frame -> (H, W, 3) f32 in [0, 1]."""
        cfg = self.cfg
        cam = cam or self.camera()
        width = width or cfg.width
        height = height or cfg.height
        variant = self.resolved_variant(variant, interpret)
        if variant == "bruteforce":
            return render_ops.render_bruteforce(
                self.ds, cam, width, height, bounces=cfg.bounces
            )
        return render_ops.render_bvh(
            self.ds, self.dbvh, cam, width, height, variant=variant,
            bounces=cfg.bounces, leaf_size=self.leaf_size, depth=self.depth,
            tile_rows=cfg.tile_rows, tile_cols=cfg.tile_cols,
            fast_light=cfg.fast_light, reverse_shadows=cfg.reverse_shadows,
            interpret=interpret,
        )

    def render_band(
        self,
        y0: int,
        rows: int,
        cam: Optional[Camera] = None,
        variant: Optional[str] = None,
        interpret: bool = False,
    ) -> jax.Array:
        """Render scanlines [y0, y0+rows) of the full frame -> (rows, W, 3).

        The band reuses the FULL frame's camera basis with the dir00 corner
        shifted down y0 rows, so band pixels are bit-identical to the same
        rows of a whole-frame render. Used by the checkpoint/resume path
        (utils/checkpoint.TileRenderCheckpoint) for long renders.
        """
        from .models.camera import ray_basis

        cfg = self.cfg
        cam = cam or self.camera()
        cam_arrays = tuple(
            jnp.asarray(a) for a in ray_basis(cam, cfg.width, cfg.height)
        )
        y0 = jnp.int32(y0)  # dynamic: bands share one compiled program
        variant = self.resolved_variant(variant, interpret)
        if variant == "bruteforce":
            return render_ops._render_bruteforce(
                self.ds, cam_arrays, cfg.width, rows, cfg.bounces,
                y_offset=y0,
            )
        return render_ops._render_bvh(
            self.ds, self.dbvh, cam_arrays, cfg.width, rows, cfg.bounces,
            variant, self.leaf_size, self.depth, cfg.tile_rows,
            cfg.tile_cols, cfg.fast_light, y_offset=y0,
            reverse_shadows=cfg.reverse_shadows, interpret=interpret,
        )


def _load(cfg: RenderConfig, native) -> Scene:
    if cfg.synthetic_triangles > 0:
        return synthetic_scene(cfg.synthetic_triangles, seed=cfg.seed)
    try:
        asset_dir = cfg.asset_dir()
        return (
            native.load_scene_native(asset_dir) if native else None
        ) or load_scene(asset_dir)
    except FileNotFoundError:
        from .config import DEFAULT_ASSET_ROOTS
        from .models.procgen import substitute_scene
        from .models.scene import load_scene_npz

        roots = (cfg.asset_root,) if cfg.asset_root else DEFAULT_ASSET_ROOTS
        # Repo-bundled npz snapshots keep car_only/car_boxed renderable
        # without the reference's OBJ assets.
        for root in roots:
            snap = os.path.join(root, cfg.scene + ".npz")
            if os.path.isfile(snap):
                return load_scene_npz(snap)
        # dragon/sportscar/two_cars OBJs are LFS-stripped upstream;
        # regenerate deterministic substitutes.
        scene = substitute_scene(cfg.scene, roots, seed=cfg.seed)
        if scene is None:
            raise
        return scene


def prepare(cfg: RenderConfig, scene: Optional[Scene] = None) -> Pipeline:
    """Load assets, build + flatten + upload the BVH, stage the scene."""
    native = None
    if cfg.use_native:
        from .native import builder as native

        if not native.available():
            native = None

    if scene is None:
        scene = _load(cfg, native)

    if cfg.presplit > 0 and scene.num_triangles > 0:
        from .models.presplit import presplit_scene

        scene, _ = presplit_scene(scene, ratio=cfg.presplit)

    leaf_size = cfg.leaf_size
    bvh = flat = dbvh = None
    bvh_stats = None
    build_ms = 0.0
    depth = 0
    ds_kwargs = {}

    if cfg.use_bvh:
        tv = scene.triangle_vertices()
        # The reference's BVH_ELEMENT_THRESHOLD (options.h:58) bounds the
        # leaves at build time; flattening groups them into leaf_size slots.
        build_kw = dict(
            heuristic=cfg.bvh_heuristic,
            max_depth=cfg.bvh_max_depth,
            leaf_threshold=max(cfg.leaf_threshold, leaf_size),
            sah_bins=cfg.sah_bins,
            seed=cfg.seed,
            true_sah=cfg.true_sah,
        )
        t0 = time.perf_counter()
        res = (
            native.build_bvh_native(tv, leaf_size=leaf_size, **build_kw)
            if native is not None else None
        )
        if res is not None:
            flat, bvh_stats = res
        else:
            bvh = build_bvh(tv, **build_kw)
            flat = flatten_bvh(bvh, tv, leaf_size=leaf_size)
            bvh_stats = bvh.stats
        build_ms = (time.perf_counter() - t0) * 1e3
        ds_kwargs["slot_map"] = flat.slot_map

    ds = device_scene_from_host(scene, ambient=cfg.ambient, **ds_kwargs)
    if cfg.use_bvh:
        dbvh, _, depth = trace_bvh.device_bvh_from_flat(
            flat, bf16=cfg.bf16_bvh
        )

    return Pipeline(
        cfg=cfg,
        scene=scene,
        ds=ds,
        bvh=bvh,
        flat=flat,
        dbvh=dbvh,
        leaf_size=leaf_size,
        depth=depth,
        build_ms=build_ms,
        bvh_stats=bvh_stats,
    )
