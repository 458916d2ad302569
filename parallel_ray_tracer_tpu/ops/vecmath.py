"""SoA 3-vector math over JAX arrays.

The array-plane replacement for the reference's `vec_t` (cpu/include/vec.h:4-32,
gpu/include/vec.cuh:6-27). Instead of padding a 3-float struct to 16 bytes for
coalescing (the GPU "float_align" trick), we store each component as its own
full array plane: every elementwise op reads dense, contiguous lanes and XLA
fuses chains of them into single kernels (the `vec_ma` FMA fusion of
gpu/src/vec.cu:100-114 falls out for free).

A Vec3 is a pytree, so it passes through jit/vmap/shard_map/grad unchanged.
"""

from __future__ import annotations

from typing import NamedTuple, Union

import jax
import jax.numpy as jnp

Array = jax.Array
Scalar = Union[float, Array]


class Vec3(NamedTuple):
    x: Array
    y: Array
    z: Array

    # -- arithmetic ---------------------------------------------------------
    def __add__(self, o: "Vec3") -> "Vec3":
        return Vec3(self.x + o.x, self.y + o.y, self.z + o.z)

    def __sub__(self, o: "Vec3") -> "Vec3":
        return Vec3(self.x - o.x, self.y - o.y, self.z - o.z)

    def __mul__(self, s) -> "Vec3":
        if isinstance(s, Vec3):  # elementwise (Hadamard), like vec_mul(v1, v2)
            return Vec3(self.x * s.x, self.y * s.y, self.z * s.z)
        return Vec3(self.x * s, self.y * s, self.z * s)

    __rmul__ = __mul__

    def __truediv__(self, s) -> "Vec3":
        if isinstance(s, Vec3):
            return Vec3(self.x / s.x, self.y / s.y, self.z / s.z)
        return Vec3(self.x / s, self.y / s, self.z / s)

    def __neg__(self) -> "Vec3":
        return Vec3(-self.x, -self.y, -self.z)

    # -- geometry (cpu/src/vec.c:4-69) --------------------------------------
    def dot(self, o: "Vec3") -> Array:
        return self.x * o.x + self.y * o.y + self.z * o.z

    def cross(self, o: "Vec3") -> "Vec3":
        return Vec3(
            self.y * o.z - self.z * o.y,
            self.z * o.x - self.x * o.z,
            self.x * o.y - self.y * o.x,
        )

    def mag2(self) -> Array:
        return self.dot(self)

    def mag(self) -> Array:
        return jnp.sqrt(self.mag2())

    def normalized(self) -> "Vec3":
        return self / self.mag()

    def min(self, o: "Vec3") -> "Vec3":
        return Vec3(
            jnp.minimum(self.x, o.x),
            jnp.minimum(self.y, o.y),
            jnp.minimum(self.z, o.z),
        )

    def max(self, o: "Vec3") -> "Vec3":
        return Vec3(
            jnp.maximum(self.x, o.x),
            jnp.maximum(self.y, o.y),
            jnp.maximum(self.z, o.z),
        )

    def clamp(self, lo: float, hi: float) -> "Vec3":
        """vec_constrain (cpu/src/vec.c:48-55)."""
        return Vec3(
            jnp.clip(self.x, lo, hi),
            jnp.clip(self.y, lo, hi),
            jnp.clip(self.z, lo, hi),
        )

    # -- structural ---------------------------------------------------------
    def where(self, pred: Array, other: "Vec3") -> "Vec3":
        """Select self where pred else other (lane masking)."""
        return Vec3(
            jnp.where(pred, self.x, other.x),
            jnp.where(pred, self.y, other.y),
            jnp.where(pred, self.z, other.z),
        )

    def astype(self, dtype) -> "Vec3":
        return Vec3(
            self.x.astype(dtype), self.y.astype(dtype), self.z.astype(dtype)
        )

    def reshape(self, *shape) -> "Vec3":
        return Vec3(
            self.x.reshape(*shape),
            self.y.reshape(*shape),
            self.z.reshape(*shape),
        )

    @property
    def shape(self):
        return jnp.shape(self.x)

    def stack(self, axis: int = -1) -> Array:
        """Materialize as a (..., 3) array (host interchange only)."""
        return jnp.stack([self.x, self.y, self.z], axis=axis)


def vec3(x, y, z) -> Vec3:
    return Vec3(jnp.asarray(x), jnp.asarray(y), jnp.asarray(z))


def from_array(a) -> Vec3:
    """Build a Vec3 of (...,) planes from a (..., 3) array."""
    a = jnp.asarray(a)
    return Vec3(a[..., 0], a[..., 1], a[..., 2])


def full_like(v: Vec3, value: float) -> Vec3:
    return Vec3(
        jnp.full_like(v.x, value),
        jnp.full_like(v.y, value),
        jnp.full_like(v.z, value),
    )
