"""SO(3)/SE(3) Lie-group utilities in JAX.

Replaces the reference's `Core/src/Utils/OdometryProvider.h` (rodrigues +
`computeUpdateSE3`) and scattered Eigen pose math.  All functions are pure,
jittable, f32-friendly (small-angle Taylor branches chosen with `jnp.where`
so they are compilation-safe), and batched via `vmap` where needed.

Conventions:
- a pose is a 4x4 camera-to-world matrix ``T`` (column-vector convention,
  ``p_world = T @ [p_cam, 1]``) — matching the reference's `currPose`
  (`Core/src/ElasticFusion.cpp`), where surfels are stored in world frame.
- a twist is ``xi = (omega[3], v[3])`` with update ``T <- exp(xi) @ T``
  applied on the left, like the reference's GN update
  (`RGBDOdometry.cpp:573-585`).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_EPS = 1e-8


def hat(w: jnp.ndarray) -> jnp.ndarray:
    """Skew-symmetric matrix of a 3-vector: hat(w) @ x == cross(w, x)."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zeros = jnp.zeros_like(wx)
    return jnp.stack(
        [
            jnp.stack([zeros, -wz, wy], axis=-1),
            jnp.stack([wz, zeros, -wx], axis=-1),
            jnp.stack([-wy, wx, zeros], axis=-1),
        ],
        axis=-2,
    )


def so3_exp(w: jnp.ndarray) -> jnp.ndarray:
    """Rodrigues' formula exp: R^3 -> SO(3), with Taylor fallback near 0.

    Dead-branch denominators are masked to 1 so autodiff through the untaken
    branch stays finite (jvp at w=0 is the common case in GN pipelines)."""
    theta2 = jnp.sum(w * w, axis=-1)
    small = theta2 < 1e-8
    theta2_safe = jnp.where(small, 1.0, theta2)
    theta = jnp.sqrt(theta2_safe)
    # sin(t)/t and (1-cos(t))/t^2 with series fallbacks
    a = jnp.where(small, 1.0 - theta2 / 6.0, jnp.sin(theta) / theta)
    b = jnp.where(small, 0.5 - theta2 / 24.0, (1.0 - jnp.cos(theta)) / theta2_safe)
    W = hat(w)
    eye = jnp.eye(3, dtype=w.dtype)
    return eye + a[..., None, None] * W + b[..., None, None] * (W @ W)


def so3_log(R: jnp.ndarray) -> jnp.ndarray:
    """Log map SO(3) -> R^3 (rotation vector).

    Differentiable at the identity: `arccos` has an infinite derivative at 1
    and `jnp.where` does not stop NaNs flowing from the untaken branch, so the
    small-angle branch uses the series `scale = 1/2 + (1-c)/6 + ...` written
    directly in terms of the (safe) cosine — jvp/vjp through pose-graph
    residuals of near-satisfied edges stay finite."""
    trace = jnp.trace(R)
    c = jnp.clip((trace - 1.0) * 0.5, -1.0, 1.0)
    small = c > 1.0 - 1e-5
    c_safe = jnp.where(small, 0.0, c)  # keeps arccos' finite in the dead branch
    theta = jnp.arccos(c_safe)
    w_hat = jnp.stack(
        [R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]], axis=-1
    )
    one_m_c = jnp.maximum(1.0 - c, 0.0)
    # theta/(2 sin theta) ~= 1/2 + theta^2/12 + ...; theta^2 ~= 2(1-c)
    scale_small = 0.5 + one_m_c / 6.0 + one_m_c * one_m_c * (7.0 / 90.0)
    scale_big = theta / (2.0 * jnp.sin(theta) + _EPS)
    scale = jnp.where(small, scale_small, scale_big)
    return scale * w_hat


def se3_exp(xi: jnp.ndarray) -> jnp.ndarray:
    """exp: R^6 (omega, v) -> SE(3) 4x4 matrix (autodiff-safe at 0)."""
    w, v = xi[..., :3], xi[..., 3:]
    theta2 = jnp.sum(w * w, axis=-1)
    small = theta2 < 1e-8
    theta2_safe = jnp.where(small, 1.0, theta2)
    theta = jnp.sqrt(theta2_safe)
    a = jnp.where(small, 1.0 - theta2 / 6.0, jnp.sin(theta) / theta)
    b = jnp.where(small, 0.5 - theta2 / 24.0, (1.0 - jnp.cos(theta)) / theta2_safe)
    c = jnp.where(small, 1.0 / 6.0 - theta2 / 120.0, (1.0 - a) / theta2_safe)
    W = hat(w)
    W2 = W @ W
    eye = jnp.eye(3, dtype=xi.dtype)
    R = eye + a[..., None, None] * W + b[..., None, None] * W2
    V = eye + b[..., None, None] * W + c[..., None, None] * W2
    t = jnp.einsum("...ij,...j->...i", V, v)
    top = jnp.concatenate([R, t[..., None]], axis=-1)
    bottom = jnp.broadcast_to(
        jnp.array([0.0, 0.0, 0.0, 1.0], dtype=xi.dtype), top.shape[:-2] + (1, 4)
    )
    return jnp.concatenate([top, bottom], axis=-2)


def se3_log(T: jnp.ndarray) -> jnp.ndarray:
    """Log map SE(3) -> R^6 (omega, v) (autodiff-safe at the identity)."""
    R, t = T[:3, :3], T[:3, 3]
    w = so3_log(R)
    theta2 = jnp.sum(w * w)
    small = theta2 < 1e-8
    theta2_safe = jnp.where(small, 1.0, theta2)
    theta = jnp.sqrt(theta2_safe)
    a = jnp.where(small, 1.0 - theta2 / 6.0, jnp.sin(theta) / theta)
    b = jnp.where(small, 0.5 - theta2 / 24.0, (1.0 - jnp.cos(theta)) / theta2_safe)
    W = hat(w)
    # V^{-1} = I - 0.5 W + (1/theta^2)(1 - a/(2b)) W^2
    coef = jnp.where(
        small,
        1.0 / 12.0 + theta2 / 720.0,
        (1.0 - a / (2.0 * jnp.maximum(b, 1e-12))) / theta2_safe,
    )
    Vinv = jnp.eye(3, dtype=T.dtype) - 0.5 * W + coef * (W @ W)
    v = Vinv @ t
    return jnp.concatenate([w, v], axis=-1)


def se3_inverse(T: jnp.ndarray) -> jnp.ndarray:
    """Inverse of a rigid transform without a general 4x4 inverse."""
    R, t = T[..., :3, :3], T[..., :3, 3]
    Rt = jnp.swapaxes(R, -1, -2)
    ti = -jnp.einsum("...ij,...j->...i", Rt, t)
    top = jnp.concatenate([Rt, ti[..., None]], axis=-1)
    bottom = jnp.broadcast_to(
        jnp.array([0.0, 0.0, 0.0, 1.0], dtype=T.dtype), top.shape[:-2] + (1, 4)
    )
    return jnp.concatenate([top, bottom], axis=-2)


def transform_points(T: jnp.ndarray, p: jnp.ndarray) -> jnp.ndarray:
    """Apply a 4x4 rigid transform to points [..., 3].

    Written as broadcast multiply-adds, NOT an einsum: a K=3 einsum becomes
    a matmul that a backend may run at reduced precision (TF32 keeps ~3
    digits: millimetres on metre-scale vertices); the elementwise form is
    exact f32 everywhere."""
    R = T[:3, :3]
    return jnp.sum(R * p[..., None, :], axis=-1) + T[:3, 3]


def rotate_vectors(T: jnp.ndarray, n: jnp.ndarray) -> jnp.ndarray:
    """Apply only the rotation of a 4x4 transform to vectors [..., 3]
    (elementwise for the same reason as `transform_points`)."""
    return jnp.sum(T[:3, :3] * n[..., None, :], axis=-1)


def apply_update(T: jnp.ndarray, xi: jnp.ndarray) -> jnp.ndarray:
    """Left-multiplicative GN update ``T <- exp(xi) @ T`` (the reference
    composes `rgbOdom` increments the same way, `RGBDOdometry.cpp:573-585`)."""
    return se3_exp(xi) @ T


def orthonormalise(R: jnp.ndarray) -> jnp.ndarray:
    """Project a near-rotation onto SO(3) via SVD (reference uses Eigen SVD in
    `DeformationGraph::applyGraphToPoses`, `DeformationGraph.cpp:102-131`)."""
    u, _, vt = jnp.linalg.svd(R)
    det = jnp.linalg.det(u @ vt)
    d = jnp.stack([jnp.ones_like(det), jnp.ones_like(det), det], axis=-1)
    return (u * d[..., None, :]) @ vt


def pose_distance(Ta: jnp.ndarray, Tb: jnp.ndarray) -> jnp.ndarray:
    """(rotation angle, translation distance) between two poses."""
    dT = se3_inverse(Ta) @ Tb
    w = so3_log(dT[:3, :3])
    return jnp.linalg.norm(w), jnp.linalg.norm(dT[:3, 3])
