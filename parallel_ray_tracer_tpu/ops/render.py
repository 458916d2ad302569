"""render(): pure function scene -> image, plus the ray generator.

The batched form of the reference's per-thread/per-CUDA-thread pixel loop
(cpu/src/main.c:228-261, gpu/src/gpu.cu:60-95): the whole image is one batched
computation. Pixel (x, y) gets the unnormalized direction
dir00 + x*inc_x + y*inc_y from the camera basis; colors are clamped to [0,1]
at the end (vec_constrain, cpu/src/main.c:235-238).
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..models.camera import Camera, ray_basis
from . import trace_brute
from .shade import occluded_from_closest, trace_rays
from .vecmath import Vec3


def generate_rays(
    origin: np.ndarray,
    dir00: np.ndarray,
    inc_x: np.ndarray,
    inc_y: np.ndarray,
    width: int,
    height: int,
    y_offset: int = 0,
    rows: Optional[int] = None,
) -> Tuple[Vec3, Vec3]:
    """Per-pixel (origin, direction) planes of shape (rows, width).

    y_offset/rows select a horizontal band (for chunked or sharded rendering).
    """
    rows = height if rows is None else rows
    x = jax.lax.broadcasted_iota(jnp.float32, (rows, width), 1)
    y = jax.lax.broadcasted_iota(jnp.float32, (rows, width), 0) + jnp.float32(
        y_offset
    )

    def plane(c):
        return dir00[c] + x * inc_x[c] + y * inc_y[c]

    d = Vec3(plane(0), plane(1), plane(2))
    o = Vec3(
        jnp.full((rows, width), origin[0], jnp.float32),
        jnp.full((rows, width), origin[1], jnp.float32),
        jnp.full((rows, width), origin[2], jnp.float32),
    )
    return o, d


def render_band(
    ds,
    closest_fn,
    occluded_fn,
    cam_arrays,
    width: int,
    height: int,
    y_offset,
    rows: int,
    bounces: int,
    reverse_shadows: bool = True,
):
    """Render a band of `rows` scanlines -> (rows, width, 3) f32 in [0,1]."""
    origin, dir00, inc_x, inc_y = cam_arrays
    o, d = generate_rays(origin, dir00, inc_x, inc_y, width, height, y_offset, rows)
    flat_o = o.reshape(rows * width)
    flat_d = d.reshape(rows * width)
    col = trace_rays(ds, closest_fn, occluded_fn, flat_o, flat_d, bounces,
                     reverse_shadows=reverse_shadows)
    col = col.clamp(0.0, 1.0).reshape(rows, width)
    return jnp.stack([col.x, col.y, col.z], axis=-1)


@functools.partial(
    jax.jit, static_argnames=("width", "height", "bounces", "chunk", "row_chunk")
)
def _render_bruteforce(
    ds,
    cam_arrays,
    width: int,
    height: int,
    bounces: int,
    chunk: int = 512,
    row_chunk: int = 0,
    y_offset=0,
):
    closest_fn, occluded_fn = trace_brute.make_tracer(ds, chunk=chunk)
    if not row_chunk or row_chunk >= height:
        return render_band(
            ds, closest_fn, occluded_fn, cam_arrays, width, height,
            jnp.int32(y_offset), height, bounces,
        )
    assert height % row_chunk == 0, (height, row_chunk)

    def band(y0):
        return render_band(
            ds, closest_fn, occluded_fn, cam_arrays, width, height,
            y0, row_chunk, bounces,
        )

    offsets = jnp.arange(0, height, row_chunk, dtype=jnp.int32) + jnp.int32(
        y_offset
    )
    bands = jax.lax.map(band, offsets)
    return bands.reshape(height, width, 3)


def render_bruteforce(
    ds, cam: Camera, width: int, height: int, bounces: int = 4,
    chunk: int = 512, row_chunk: int = 0,
):
    """USE_BVH=0 oracle render (cpu/src/raytracer.c:112-130 semantics)."""
    cam_arrays = tuple(
        jnp.asarray(a) for a in ray_basis(cam, width, height)
    )
    return _render_bruteforce(
        ds, cam_arrays, width, height, bounces, chunk, row_chunk
    )


# ---------------------------------------------------------------------------
# Tile-major packet rendering (BVH variants)
# ---------------------------------------------------------------------------

def _ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


def tile_image_shape(width: int, height: int, tr: int, tc: int):
    """Padded dims + tile grid for (tr, tc) pixel tiles."""
    wp, hp = _ceil_to(width, tc), _ceil_to(height, tr)
    return wp, hp, hp // tr, wp // tc


def tiles_to_image(flat, width, height, tr, tc):
    """(ntiles*K,) or (ntiles*K, C) tile-major -> (height, width[, C]), cropped.

    Tile order is row-major over the (hp/tr, wp/tc) tile grid; within a tile,
    row-major over (tr, tc) pixels.
    """
    wp, hp, nty, ntx = tile_image_shape(width, height, tr, tc)
    trailing = flat.shape[1:]
    img = flat.reshape(nty, ntx, tr, tc, *trailing)
    img = jnp.moveaxis(img, 2, 1).reshape(hp, wp, *trailing)
    return img[:height, :width]


def generate_rays_tiled(cam_arrays, width, height, tr, tc, y_offset=0):
    """(ntiles*K,) Vec3 origin/direction planes in tile-major order.

    y_offset shifts pixel rows (band rendering): row r gets the direction
    of full-frame row r + y_offset, computed with the same arithmetic as
    the full frame (bit-exact bands)."""
    origin, dir00, inc_x, inc_y = cam_arrays
    wp, hp, nty, ntx = tile_image_shape(width, height, tr, tc)
    o, d = generate_rays(origin, dir00, inc_x, inc_y, wp, hp, y_offset, hp)

    def tilewise(p):
        return (
            p.reshape(nty, tr, ntx, tc).swapaxes(1, 2).reshape(nty * ntx * tr * tc)
        )

    return (
        Vec3(tilewise(o.x), tilewise(o.y), tilewise(o.z)),
        Vec3(tilewise(d.x), tilewise(d.y), tilewise(d.z)),
    )


VARIANTS = ("gpu", "jax", "bruteforce")


def make_tracers(
    variant: str,
    ds,
    bvh,
    leaf_size: int,
    depth: Optional[int],
    packet: int,
    interpret: bool = False,
    fast_light: bool = True,
):
    """The (closest, occluded) pair of one tracer variant.

    "gpu": per-ray Pallas kernels (ops/gpu_trace.py), the served path;
    "jax": the vmapped packet while_loop (ops/trace_bvh.py), its plain-XLA
    reference; "bruteforce": every ray against every triangle, the oracle.
    `depth` is the tree depth; `packet` the "jax" packet size. With
    fast_light off, shadows come from the closest-hit traversal
    (USE_BVH_FAST_LIGHT=0).
    """
    if variant in ("gpu", "jax") and (bvh is None or depth is None):
        # The stacks are sized from depth; a wrong one overflows them.
        raise ValueError(f"variant {variant!r} needs the DeviceBVH and its "
                         "tree depth")
    if variant == "gpu":
        from . import gpu_trace

        closest_fn, occluded_fn = gpu_trace.make_tracer(
            bvh, ds, leaf_size, depth, interpret=interpret
        )
    elif variant == "jax":
        from . import trace_bvh

        closest_fn, occluded_fn = trace_bvh.make_tracer(
            bvh, ds, leaf_size, depth, packet=packet
        )
    elif variant == "bruteforce":
        closest_fn, occluded_fn = trace_brute.make_tracer(ds)
    else:
        raise ValueError(f"unknown variant {variant!r}; expected {VARIANTS}")
    if not fast_light:
        occluded_fn = occluded_from_closest(closest_fn)
    return closest_fn, occluded_fn


@functools.partial(
    jax.jit,
    static_argnames=(
        "width", "height", "bounces", "variant", "leaf_size", "depth",
        "tile_rows", "tile_cols", "fast_light", "reverse_shadows",
        "interpret",
    ),
)
def _render_bvh(
    ds,
    bvh,
    cam_arrays,
    width: int,
    height: int,
    bounces: int,
    variant: str,
    leaf_size: int,
    depth: int,
    tile_rows: int,
    tile_cols: int,
    fast_light: bool = True,
    y_offset=0,
    reverse_shadows: bool = True,
    interpret: bool = False,
):
    o, d = generate_rays_tiled(
        cam_arrays, width, height, tile_rows, tile_cols, y_offset
    )
    closest_fn, occluded_fn = make_tracers(
        variant, ds, bvh, leaf_size, depth, tile_rows * tile_cols,
        interpret=interpret, fast_light=fast_light,
    )
    # The USE_BVH_FAST_LIGHT=0 parity mode stays literally reference-shaped:
    # forward shadow rays.
    col = trace_rays(ds, closest_fn, occluded_fn, o, d, bounces,
                     reverse_shadows=fast_light and reverse_shadows)
    col = col.clamp(0.0, 1.0)
    flat = jnp.stack([col.x, col.y, col.z], axis=-1)
    return tiles_to_image(flat, width, height, tile_rows, tile_cols)


def render_bvh(
    ds,
    bvh,
    cam: Camera,
    width: int,
    height: int,
    variant: str = "gpu",
    bounces: int = 4,
    leaf_size: int = 8,
    depth: Optional[int] = None,
    tile_rows: int = 32,
    tile_cols: int = 32,
    fast_light: bool = True,
    reverse_shadows: bool = True,
    interpret: bool = False,
):
    """Tile-major BVH render with the "gpu" or "jax" tracer; `depth` is
    the tree depth (FlatBVH.depth)."""
    cam_arrays = tuple(jnp.asarray(a) for a in ray_basis(cam, width, height))
    return _render_bvh(
        ds, bvh, cam_arrays, width, height, bounces, variant, leaf_size,
        depth, tile_rows, tile_cols, fast_light,
        reverse_shadows=reverse_shadows, interpret=interpret,
    )
