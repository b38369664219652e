"""Dense local warping: image sampling at small per-pixel displacements
without gathers.

The classic "project every pixel and bilinearly sample" formulation of
dense tracking needs 4+ random-access gathers of every pixel per GN
iteration.  But projective data association only ever needs SMALL
displacements — coarse-to-fine GN converges each level to sub-pixel error,
so the next level starts within a few pixels — and a small displacement can
be resolved densely: build the (2R+1)^2 stack of statically shifted images
(pure data movement) and select per pixel with masks (elementwise ops).
Cost is O((2R+1)^2 * H * W * C) dense work at memory bandwidth, with no
random access.  The reference gets the same effect from GPU texture units;
which form is faster on the H100 is not measured yet.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp


def decimate(img: jnp.ndarray, k: int) -> jnp.ndarray:
    """Strided decimation ``img[::k, ::k]`` as a native strided-window op.

    `lax.reduce_window` with a 1x1 window and stride k is a first-class
    strided-window op, where a python strided slice may lower to a gather.
    Works for [H, W] and [H, W, C]."""
    if k == 1:
        return img
    ndim = img.ndim
    window = (1,) * ndim
    strides = (k, k) + (1,) * (ndim - 2)
    return jax.lax.reduce_window(
        img, -jnp.inf, jax.lax.max, window, strides, "VALID"
    )


def shift(img: jnp.ndarray, dy: int, dx: int) -> jnp.ndarray:
    """Static shift with zero fill: out[y, x] = img[y+dy, x+dx] (0 outside).
    Pad+slice — compiles to pure data movement."""
    H, W = img.shape[0], img.shape[1]
    py0, py1 = max(dy, 0), max(-dy, 0)
    px0, px1 = max(dx, 0), max(-dx, 0)
    pad_width = [(py1, py0), (px1, px0)] + [(0, 0)] * (img.ndim - 2)
    padded = jnp.pad(img, pad_width, mode="constant")
    return jax.lax.slice(
        padded,
        [py0, px0] + [0] * (img.ndim - 2),
        [py0 + H, px0 + W] + list(img.shape[2:]),
    )


@functools.partial(jax.jit, static_argnames=("radius",))
def sample_nearest_local(
    img: jnp.ndarray,  # [H, W, C]
    du: jnp.ndarray,  # [H, W] x-displacement (float pixels)
    dv: jnp.ndarray,  # [H, W]
    radius: int = 3,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Nearest-neighbour sample of img at (x + du, y + dv) per pixel.

    Returns (sampled [H,W,C], valid [H,W]); displacements beyond `radius`
    (or landing outside the image) are invalid and sample to zero.
    """
    i0 = jnp.round(du).astype(jnp.int32)
    j0 = jnp.round(dv).astype(jnp.int32)
    valid = (jnp.abs(i0) <= radius) & (jnp.abs(j0) <= radius)
    acc = jnp.zeros_like(img)
    for sy in range(-radius, radius + 1):
        for sx in range(-radius, radius + 1):
            m = (i0 == sx) & (j0 == sy)
            acc = acc + jnp.where(m[..., None], shift(img, sy, sx), 0.0)
    return acc, valid


@functools.partial(jax.jit, static_argnames=("radius",))
def sample_bilinear_local(
    img: jnp.ndarray,  # [H, W, C]
    du: jnp.ndarray,
    dv: jnp.ndarray,
    radius: int = 3,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Bilinear sample of img at (x + du, y + dv) per pixel (see
    `sample_nearest_local`).  All four corner taps must lie within the
    shift stack for the pixel to be valid."""
    # bilinear interpolation == tent-weighted sum over integer shifts:
    # out = sum_s tent(du - sx) * tent(dv - sy) * img_s — one fused
    # multiply-add per shift, no corner bookkeeping.
    i0 = jnp.floor(du).astype(jnp.int32)
    j0 = jnp.floor(dv).astype(jnp.int32)
    valid = (i0 >= -radius) & (i0 <= radius - 1) & (j0 >= -radius) & (j0 <= radius - 1)
    acc = jnp.zeros_like(img)
    for sy in range(-radius, radius + 1):
        for sx in range(-radius, radius + 1):
            w = jnp.clip(1.0 - jnp.abs(du - sx), 0.0, 1.0) * jnp.clip(
                1.0 - jnp.abs(dv - sy), 0.0, 1.0
            )
            acc = acc + w[..., None] * shift(img, sy, sx)
    return acc, valid


def pixel_grid(height: int, width: int) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """(x, y) pixel coordinate images."""
    x = jax.lax.broadcasted_iota(jnp.float32, (height, width), 1)
    y = jax.lax.broadcasted_iota(jnp.float32, (height, width), 0)
    return x, y
