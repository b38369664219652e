"""Wide-baseline global registration (the FGR role).

The reference carries Intel Fast Global Registration (`Core/src/FGROdometry
.cpp`: FPFH features + reciprocal/tuple matching + graduated-non-convexity
line-process optimisation) for initialisation-free inter-map alignment —
though the call sites are compiled out in the current code
(`ElasticFusion.cpp:1118-1145`).  This module provides the equivalent
capability as dense array programs, without PCL/flann:

- correspondences come from the sparse module's ORB features (Hamming
  matching already runs as dense XOR/popcount on device);
- the rigid transform is solved by **graduated non-convexity** over the
  Geman-McClure robust cost — exactly FGR's line-process iteration: closed
  -form weighted Kabsch/Umeyama alignment alternating with weight updates
  ``w_i = (mu / (mu + r_i^2))^2`` while ``mu`` anneals from coarse to fine.

No initial guess is required, which is what distinguishes this from the
projective-association ICP in `tracking.odometry`.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from densemonoslam_tpu.config import CameraIntrinsics
from densemonoslam_tpu.tracking import sparse

GNC_ITERS = 32
MU_INIT = 1.0  # metres^2; annealed /1.4 per iteration (FGR's division by 1.4)
MU_MIN = 1e-4


def _backproject_kp(kp: sparse.Keypoints, intr: CameraIntrinsics) -> jnp.ndarray:
    u, v = kp.uv[:, 0], kp.uv[:, 1]
    z = kp.depth
    return jnp.stack(
        [(u - intr.cx) / intr.fx * z, (v - intr.cy) / intr.fy * z, z], axis=-1
    )


@jax.jit
def _weighted_kabsch(
    P: jnp.ndarray, Q: jnp.ndarray, w: jnp.ndarray
) -> jnp.ndarray:
    """Closed-form rigid T minimising sum w_i ||T P_i - Q_i||^2."""
    wsum = jnp.maximum(jnp.sum(w), 1e-9)
    mu_p = jnp.sum(w[:, None] * P, axis=0) / wsum
    mu_q = jnp.sum(w[:, None] * Q, axis=0) / wsum
    Pc = P - mu_p
    Qc = Q - mu_q
    H = jnp.einsum("n,ni,nj->ij", w, Pc, Qc)
    U, _, Vt = jnp.linalg.svd(H)
    d = jnp.linalg.det(Vt.T @ U.T)
    D = jnp.diag(jnp.array([1.0, 1.0, 1.0]) * jnp.array([1.0, 1.0, 0.0]) + jnp.array([0.0, 0.0, 1.0]) * d)
    R = Vt.T @ D @ U.T
    t = mu_q - R @ mu_p
    T = jnp.eye(4).at[:3, :3].set(R).at[:3, 3].set(t)
    return T


@functools.partial(jax.jit, static_argnames=("iters",))
def gnc_rigid_align(
    P: jnp.ndarray,  # [N, 3] source points
    Q: jnp.ndarray,  # [N, 3] target points
    valid: jnp.ndarray,  # [N] bool
    iters: int = GNC_ITERS,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Graduated-non-convexity robust rigid alignment (FGR's line process).

    Returns (T mapping P->Q, inlier count at the final scale, rms inlier
    residual)."""
    base = valid.astype(jnp.float32)

    def body(i, carry):
        T, mu = carry
        moved = jnp.einsum("ij,nj->ni", T[:3, :3], P) + T[:3, 3]
        r2 = jnp.sum(jnp.square(moved - Q), axis=-1)
        w = jnp.square(mu / (mu + r2)) * base  # Geman-McClure line process
        T_new = _weighted_kabsch(P, Q, w)
        ok = jnp.all(jnp.isfinite(T_new))
        T = jnp.where(ok, T_new, T)
        return T, jnp.maximum(mu / 1.4, MU_MIN)

    T, mu = jax.lax.fori_loop(0, iters, body, (jnp.eye(4), jnp.asarray(MU_INIT)))
    moved = jnp.einsum("ij,nj->ni", T[:3, :3], P) + T[:3, 3]
    r2 = jnp.sum(jnp.square(moved - Q), axis=-1)
    inl = base * (r2 < 9.0 * MU_MIN)
    n_inl = jnp.sum(inl)
    rms = jnp.sqrt(jnp.sum(r2 * inl) / jnp.maximum(n_inl, 1.0))
    return T, n_inl, rms


def global_registration(
    intensity_a: jnp.ndarray,
    depth_a: jnp.ndarray,
    intensity_b: jnp.ndarray,
    depth_b: jnp.ndarray,
    intr: CameraIntrinsics,
    fast_threshold: float = 5.0,
) -> Tuple[jnp.ndarray, float, float]:
    """Initialisation-free alignment of two RGB-D frames.

    Returns (T mapping frame-a camera coords into frame-b camera coords,
    inlier count, rms residual).  The caller gates acceptance on inliers/rms
    (the reference gates its FGR result with ICP error/inlier checks)."""
    kp_a = sparse.detect_and_describe(intensity_a, depth_a, threshold=fast_threshold)
    kp_b = sparse.detect_and_describe(intensity_b, depth_b, threshold=fast_threshold)
    matches, _ = sparse.match(kp_a, kp_b)
    m_safe = jnp.maximum(matches, 0)
    P = _backproject_kp(kp_a, intr)
    Q = _backproject_kp(kp_b, intr)[m_safe]
    valid = (
        (matches >= 0)
        & kp_a.valid
        & (kp_a.depth > 0.05)
        & (kp_b.depth[m_safe] > 0.05)
    )
    T, n_inl, rms = gnc_rigid_align(P, Q, valid)
    return T, float(n_inl), float(rms)
