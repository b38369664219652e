"""Camera-geometry ops: back-projection (vertex maps), normal maps,
projection, and bilinear sampling.

Replacements for the reference's `createVMap`/`createNMap`/
`tranformMaps`/`projectToPointCloud` CUDA kernels
(`Core/src/Cuda/cudafuncs.cu`) — all pure XLA elementwise/stencil code.

Conventions: vertex maps are [H, W, 3] camera- or world-frame points with
invalid pixels marked by z == 0; normal maps are [H, W, 3] unit vectors with
invalid marked by all-zero.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from densemonoslam_tpu.config import CameraIntrinsics


def backproject(depth: jnp.ndarray, intr: CameraIntrinsics) -> jnp.ndarray:
    """Depth [H,W] (metres, 0 = invalid) -> camera-frame vertex map [H,W,3]."""
    H, W = depth.shape
    u = jax.lax.broadcasted_iota(jnp.float32, (H, W), 1)
    v = jax.lax.broadcasted_iota(jnp.float32, (H, W), 0)
    x = (u - intr.cx) / intr.fx * depth
    y = (v - intr.cy) / intr.fy * depth
    return jnp.stack([x, y, depth], axis=-1)


def project(
    points: jnp.ndarray, intr: CameraIntrinsics
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Camera-frame points [..., 3] -> (u, v, z) pixel coordinates."""
    z = points[..., 2]
    zsafe = jnp.where(jnp.abs(z) > 1e-9, z, 1e-9)
    u = points[..., 0] / zsafe * intr.fx + intr.cx
    v = points[..., 1] / zsafe * intr.fy + intr.cy
    return u, v, z


def normal_map(vmap: jnp.ndarray) -> jnp.ndarray:
    """Central-difference normals from a vertex map (reference `createNMap`:
    cross of horizontal and vertical neighbours, zero where support invalid).
    """
    H, W, _ = vmap.shape
    right = jnp.roll(vmap, -1, axis=1)
    left = jnp.roll(vmap, 1, axis=1)
    down = jnp.roll(vmap, -1, axis=0)
    up = jnp.roll(vmap, 1, axis=0)
    dx = right - left
    dy = down - up
    n = jnp.cross(dx, dy)
    norm = jnp.linalg.norm(n, axis=-1, keepdims=True)
    valid = (
        (vmap[..., 2] > 0)
        & (right[..., 2] > 0)
        & (left[..., 2] > 0)
        & (down[..., 2] > 0)
        & (up[..., 2] > 0)
        & (norm[..., 0] > 1e-12)
    )
    n = jnp.where(valid[..., None], n / jnp.maximum(norm, 1e-12), 0.0)
    # border pixels used rolled (wrapped) neighbours — kill them
    edge = jnp.zeros((H, W), jnp.bool_).at[0, :].set(True).at[-1, :].set(True)
    edge = edge.at[:, 0].set(True).at[:, -1].set(True)
    return jnp.where(edge[..., None], 0.0, n)


def transform_maps(
    vmap: jnp.ndarray, nmap: jnp.ndarray, T: jnp.ndarray
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Rigidly transform vertex+normal maps, keeping invalid markers
    (reference `tranformMaps`)."""
    valid = vmap[..., 2] > 0
    # elementwise (exact f32) — see utils.se3.transform_points
    v = jnp.sum(T[:3, :3] * vmap[..., None, :], axis=-1) + T[:3, 3]
    n = jnp.sum(T[:3, :3] * nmap[..., None, :], axis=-1)
    return jnp.where(valid[..., None], v, 0.0), jnp.where(valid[..., None], n, 0.0)


def bilinear_sample(img: jnp.ndarray, u: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
    """Bilinear interpolation of img [H,W] at float pixel coords; out-of-range
    clamped.  Matches the texture-fetch behaviour of the reference's RGB step.
    """
    H, W = img.shape[0], img.shape[1]
    u = jnp.clip(u, 0.0, W - 1.001)
    v = jnp.clip(v, 0.0, H - 1.001)
    u0 = jnp.floor(u).astype(jnp.int32)
    v0 = jnp.floor(v).astype(jnp.int32)
    du = u - u0.astype(jnp.float32)
    dv = v - v0.astype(jnp.float32)
    i00 = img[v0, u0]
    i01 = img[v0, u0 + 1]
    i10 = img[v0 + 1, u0]
    i11 = img[v0 + 1, u0 + 1]
    top = i00 * (1 - du) + i01 * du
    bot = i10 * (1 - du) + i11 * du
    return top * (1 - dv) + bot * dv


def nearest_sample(img: jnp.ndarray, u: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
    H, W = img.shape[0], img.shape[1]
    ui = jnp.clip(jnp.round(u).astype(jnp.int32), 0, W - 1)
    vi = jnp.clip(jnp.round(v).astype(jnp.int32), 0, H - 1)
    return img[vi, ui]


def in_bounds(u: jnp.ndarray, v: jnp.ndarray, W: int, H: int, margin: int = 0) -> jnp.ndarray:
    return (u >= margin) & (u <= W - 1 - margin) & (v >= margin) & (v <= H - 1 - margin)
