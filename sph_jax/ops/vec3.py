"""Component-split 3-vectors.

All inner-loop vector math in this framework runs on a :class:`V3` of
three scalar arrays whose minor dimension is a real data axis: a
``[N, K, 3]`` neighbor-gather intermediate would put a length-3 axis
minor, which strides every load and pads badly under tiled layouts.

``FluidState`` keeps the ergonomic ``[N, 3]`` shape at the API boundary;
``split``/``merge`` convert once per step.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp


class V3(NamedTuple):
    x: jax.Array
    y: jax.Array
    z: jax.Array

    def __add__(self, o):
        if isinstance(o, V3):
            return V3(self.x + o.x, self.y + o.y, self.z + o.z)
        return V3(self.x + o, self.y + o, self.z + o)

    def __sub__(self, o):
        if isinstance(o, V3):
            return V3(self.x - o.x, self.y - o.y, self.z - o.z)
        return V3(self.x - o, self.y - o, self.z - o)

    def __mul__(self, s):
        if isinstance(s, V3):
            return V3(self.x * s.x, self.y * s.y, self.z * s.z)
        return V3(self.x * s, self.y * s, self.z * s)

    __rmul__ = __mul__

    def __neg__(self):
        return V3(-self.x, -self.y, -self.z)

    def dot(self, o: "V3") -> jax.Array:
        return self.x * o.x + self.y * o.y + self.z * o.z

    def norm2(self) -> jax.Array:
        return self.dot(self)

    def norm(self) -> jax.Array:
        return jnp.sqrt(self.norm2())

    def take(self, idx) -> "V3":
        """Gather per-component (idx of any shape; minor dim stays real)."""
        return V3(self.x[idx], self.y[idx], self.z[idx])

    def where(self, cond, other: "V3") -> "V3":
        return V3(
            jnp.where(cond, self.x, other.x),
            jnp.where(cond, self.y, other.y),
            jnp.where(cond, self.z, other.z),
        )

    def sum(self, axis) -> "V3":
        return V3(
            jnp.sum(self.x, axis=axis),
            jnp.sum(self.y, axis=axis),
            jnp.sum(self.z, axis=axis),
        )

    def expand(self, axis) -> "V3":
        return V3(
            jnp.expand_dims(self.x, axis),
            jnp.expand_dims(self.y, axis),
            jnp.expand_dims(self.z, axis),
        )

    def astype(self, dt) -> "V3":
        return V3(self.x.astype(dt), self.y.astype(dt), self.z.astype(dt))


def split(a: jax.Array) -> V3:
    """[..., 3] -> V3 of [...] arrays (one transpose at the API boundary)."""
    return V3(a[..., 0], a[..., 1], a[..., 2])


def merge(v: V3) -> jax.Array:
    """V3 -> [..., 3] array (only at API boundaries)."""
    return jnp.stack([v.x, v.y, v.z], axis=-1)


def masked(cond, v: V3) -> V3:
    z = jnp.zeros_like(v.x)
    return V3(jnp.where(cond, v.x, z), jnp.where(cond, v.y, z),
              jnp.where(cond, v.z, z))


def zeros_like(v: V3) -> V3:
    return V3(jnp.zeros_like(v.x), jnp.zeros_like(v.y), jnp.zeros_like(v.z))
