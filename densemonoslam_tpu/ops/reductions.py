"""Gauss-Newton normal-equation builders for dense tracking.

Replacement for the reference's CUDA reduction kernels
(`Core/src/Cuda/reduce.cu`: `ICPReduction`/`icpStep`, `RGBReduction`/`rgbStep`,
`SO3Reduction`/`so3Step`, `RGBResidual`/`computeRgbResidual`; accumulator
layout `JtJJtrSE3` in `Cuda/types.cuh:117-168`).

Design: instead of warp-shuffle tree reductions of 27 upper-triangle products,
each pixel contributes one masked row ``M[p] = [J_p (6) | r_p | m_p]`` and the
whole normal-equation bundle is the Gram matrix ``G = M^T M`` — a single
``(P×8)^T (P×8)`` f32 matmul that XLA fuses the row construction into.  ``G`` then contains:

- ``G[:6,:6]`` = JtJ,
- ``G[:6, 6]`` = -Jtb  (sign: we solve JtJ xi = -Jtr),
- ``G[6, 6]``  = sum of squared residuals,
- ``G[7, 7]``  = inlier count (mask column, m in {0,1}).

Coordinate convention: tracking estimates the relative transform ``A``
(current-camera -> reference/model-camera) with model maps stored in the
reference camera frame, so all arithmetic stays in small camera-local
coordinates (good f32 conditioning; the reference works in analogous
view-local frames).  The GN update is left-multiplicative: ``A <- exp(xi) A``.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from densemonoslam_tpu.config import CameraIntrinsics
from densemonoslam_tpu.ops import geometry, warp
from densemonoslam_tpu.utils import se3

# Association gates — same values as the reference ICP kernel
# (`reduce.cu` ICPReduction: distThres 0.10 m, angleThres sin(20 deg)).
ICP_DIST_THRESH = 0.10
ICP_ANGLE_SIN_THRESH = 0.34202  # sin(20 degrees)
RGB_MIN_GRAD = 1.0  # intensity gradient magnitude gate, [0,255] units


class GramStats(NamedTuple):
    """Unpacked Gram-matrix results for one GN step."""

    JtJ: jnp.ndarray  # [6,6]
    Jtr: jnp.ndarray  # [6]
    residual_sq: jnp.ndarray  # scalar, sum r^2
    inliers: jnp.ndarray  # scalar, number of rows that passed the gates


def gram(M: jnp.ndarray) -> jnp.ndarray:
    """[P, C] masked rows -> [C, C] Gram matrix ``M^T M`` with f32
    accumulation."""
    return jax.lax.dot_general(
        M, M, (((0,), (0,)), ((), ())), preferred_element_type=jnp.float32
    )


def unpack_gram(G: jnp.ndarray) -> GramStats:
    return GramStats(
        JtJ=G[:6, :6], Jtr=G[:6, 6], residual_sq=G[6, 6], inliers=G[7, 7]
    )


def icp_rows(
    vmap_c: jnp.ndarray,
    nmap_c: jnp.ndarray,
    vmap_m: jnp.ndarray,
    nmap_m: jnp.ndarray,
    A: jnp.ndarray,
    intr: CameraIntrinsics,
    dist_thresh: float = ICP_DIST_THRESH,
    angle_thresh: float = ICP_ANGLE_SIN_THRESH,
) -> jnp.ndarray:
    """Point-to-plane ICP rows with projective data association.

    Mirrors the association + row construction of the reference `ICPReduction`
    (`reduce.cu:259-343`): transform current vertex into the model frame,
    project, gather model vertex/normal at that pixel, gate on distance and
    normal angle, emit row ``[(p x n), n, r, 1]`` for residual
    ``r = n . (p - v_m)``.

    All maps are [H, W, 3]; returns M [H*W, 8].
    """
    H, W, _ = vmap_c.shape
    valid_c = vmap_c[..., 2] > 0
    p = se3.transform_points(A, vmap_c.reshape(-1, 3))  # model frame
    n_c = se3.rotate_vectors(A, nmap_c.reshape(-1, 3))
    u, v, z = geometry.project(p, intr)
    inb = geometry.in_bounds(u, v, W, H, margin=1) & (z > 0)
    ui = jnp.clip(jnp.round(u).astype(jnp.int32), 0, W - 1)
    vi = jnp.clip(jnp.round(v).astype(jnp.int32), 0, H - 1)
    v_m = vmap_m[vi, ui]
    n_m = nmap_m[vi, ui]
    valid_m = v_m[..., 2] > 0
    diff = p - v_m
    dist = jnp.linalg.norm(diff, axis=-1)
    sin_angle = jnp.linalg.norm(jnp.cross(n_c, n_m), axis=-1)
    has_n = jnp.linalg.norm(nmap_c.reshape(-1, 3), axis=-1) > 0.5
    mask = (
        valid_c.reshape(-1)
        & inb
        & valid_m
        & has_n
        & (dist < dist_thresh)
        & (sin_angle < angle_thresh)
    )
    r = jnp.sum(n_m * diff, axis=-1)
    Jw = jnp.cross(p, n_m)  # d r / d omega
    m = mask.astype(jnp.float32)
    M = jnp.concatenate([Jw, n_m, r[:, None], jnp.ones_like(r)[:, None]], axis=-1)
    return M * m[:, None]


def _image_grad_rows(
    p: jnp.ndarray,
    gx: jnp.ndarray,
    gy: jnp.ndarray,
    intr: CameraIntrinsics,
) -> jnp.ndarray:
    """Chain rule through perspective projection: for a point p (camera frame)
    and image gradient (gx, gy) at its projection, the 3-vector g3 with
    ``dr = g3 . dp``."""
    z = jnp.maximum(p[..., 2], 1e-6)
    a = gx * intr.fx / z
    b = gy * intr.fy / z
    c = -(a * p[..., 0] + b * p[..., 1]) / z
    return jnp.stack([a, b, c], axis=-1)


def rgb_rows(
    vmap_c: jnp.ndarray,
    intensity_c: jnp.ndarray,
    intensity_m: jnp.ndarray,
    grad_mx: jnp.ndarray,
    grad_my: jnp.ndarray,
    A: jnp.ndarray,
    intr: CameraIntrinsics,
    depth_m: jnp.ndarray | None = None,
    min_grad: float = RGB_MIN_GRAD,
    max_residual: float = 255.0,
    occlusion_thresh: float = 0.15,
) -> jnp.ndarray:
    """Photometric rows (reference `RGBReduction`/`rgbStep`,
    `reduce.cu:641-685`; residual+gradient gating as in `computeRgbResidual`,
    `reduce.cu:863-1050`).

    Forward-compositional: warp each valid current pixel into the model view,
    sample model intensity and its Sobel gradients bilinearly, emit row
    ``[(p x g3), g3, r, 1]`` for ``r = I_m(pi(A v_c)) - I_c(u)``.

    If `depth_m` ([H,W] model z-depth) is given, pixels whose warped depth
    disagrees with the model depth by more than `occlusion_thresh` are gated
    out — these are occlusions/disocclusions whose photometric residual is
    meaningless (the reference gets the same effect from its per-iteration
    sigma estimate downweighting the heavy tail).
    """
    H, W, _ = vmap_c.shape
    valid_c = vmap_c[..., 2] > 0
    p = se3.transform_points(A, vmap_c.reshape(-1, 3))
    u, v, z = geometry.project(p, intr)
    inb = geometry.in_bounds(u, v, W, H, margin=1) & (z > 0)
    i_m = geometry.bilinear_sample(intensity_m, u, v)
    gx = geometry.bilinear_sample(grad_mx, u, v)
    gy = geometry.bilinear_sample(grad_my, u, v)
    r = i_m - intensity_c.reshape(-1)
    gmag2 = gx * gx + gy * gy
    mask = (
        valid_c.reshape(-1)
        & inb
        & (gmag2 > min_grad * min_grad)
        & (jnp.abs(r) < max_residual)
    )
    if depth_m is not None:
        z_m = geometry.nearest_sample(depth_m, u, v)
        mask = mask & (z_m > 0) & (jnp.abs(z - z_m) < occlusion_thresh)
    g3 = _image_grad_rows(p, gx, gy, intr)
    Jw = jnp.cross(p, g3)
    m = mask.astype(jnp.float32)
    M = jnp.concatenate([Jw, g3, r[:, None], jnp.ones_like(r)[:, None]], axis=-1)
    return M * m[:, None]


def so3_rows(
    intensity_c: jnp.ndarray,
    intensity_m: jnp.ndarray,
    grad_mx: jnp.ndarray,
    grad_my: jnp.ndarray,
    R: jnp.ndarray,
    intr: CameraIntrinsics,
    min_grad: float = 0.0,
    max_residual: float = 255.0,
) -> jnp.ndarray:
    """Rotation-only photometric rows for SO(3) pre-alignment (reference
    `SO3Reduction`/`so3Step`, `reduce.cu:1052-1197`: homography-warp residual
    between the coarsest pyramid levels).

    Rays have unit z; rotating ray d by R and projecting gives the warp.
    Rows are [Jw (3), r, 1] padded to 8 columns so the same Gram kernel
    applies; G[:3,:3]=JtJ, G[:3,3]=Jtb', G[3,3]=r^2 sum, G[7,7]=count.
    """
    H, W = intensity_c.shape
    uu = jax.lax.broadcasted_iota(jnp.float32, (H, W), 1).reshape(-1)
    vv = jax.lax.broadcasted_iota(jnp.float32, (H, W), 0).reshape(-1)
    d = jnp.stack(
        [(uu - intr.cx) / intr.fx, (vv - intr.cy) / intr.fy, jnp.ones_like(uu)],
        axis=-1,
    )
    rd = jnp.sum(R * d[:, None, :], axis=-1)  # K=3: elementwise, exact f32
    u, v, z = geometry.project(rd, intr)
    inb = geometry.in_bounds(u, v, W, H, margin=1) & (z > 0)
    i_m = geometry.bilinear_sample(intensity_m, u, v)
    gx = geometry.bilinear_sample(grad_mx, u, v)
    gy = geometry.bilinear_sample(grad_my, u, v)
    r = i_m - intensity_c.reshape(-1)
    gmag2 = gx * gx + gy * gy
    mask = inb & (gmag2 >= min_grad * min_grad) & (jnp.abs(r) < max_residual)
    g3 = _image_grad_rows(rd, gx, gy, intr)
    Jw = jnp.cross(rd, g3)
    m = mask.astype(jnp.float32)
    zeros = jnp.zeros_like(r)[:, None]
    M = jnp.concatenate(
        [Jw, r[:, None], zeros, zeros, zeros, jnp.ones_like(r)[:, None]], axis=-1
    )
    return M * m[:, None]


def _inv3(M: jnp.ndarray) -> jnp.ndarray:
    """Closed-form 3x3 inverse (adjugate/determinant) — a handful of vector
    ops instead of a generic LU, which costs real time when it sits inside
    every GN iteration of the tracking loop."""
    r0, r1, r2 = M[0], M[1], M[2]
    c0 = jnp.cross(r1, r2)
    c1 = jnp.cross(r2, r0)
    c2 = jnp.cross(r0, r1)
    det = jnp.dot(r0, c0)
    return jnp.stack([c0, c1, c2], axis=-1) / det


def solve_se3(
    JtJ: jnp.ndarray, Jtr: jnp.ndarray, damping: float = 0.0
) -> jnp.ndarray:
    """Solve ``JtJ xi = -Jtr`` for the twist update (the reference downloads
    29 floats and runs Eigen LDLT on the host, `reduce.cu:412-427` +
    `RGBDOdometry.cpp:549-567`; we stay on device).  Solved via a 3x3 block
    Schur complement with closed-form 3x3 inverses — ~12 small ops vs a
    generic LU, and this runs once per GN iteration."""
    Areg = JtJ + damping * jnp.eye(6, dtype=JtJ.dtype)
    b = -Jtr
    P, Q = Areg[:3, :3], Areg[:3, 3:]
    S = Areg[3:, 3:]
    Pinv = _inv3(P)
    T = Pinv @ Q
    S_schur = S - Q.T @ T
    y1p = Pinv @ b[:3]
    x2 = _inv3(S_schur) @ (b[3:] - Q.T @ y1p)
    x1 = y1p - T @ x2
    return jnp.concatenate([x1, x2])


def solve_so3(JtJ3: jnp.ndarray, Jtr3: jnp.ndarray, damping: float = 0.0) -> jnp.ndarray:
    Areg = JtJ3 + damping * jnp.eye(3, dtype=JtJ3.dtype)
    return _inv3(Areg) @ (-Jtr3)


def diag_inv_6x6(A: jnp.ndarray, damping: float = 1e-12) -> jnp.ndarray:
    """diag(A^-1) for an SPD 6x6 (the tracking covariance diagonal, reference
    `getCovariance()` = lastA.inverse, `RGBDOdometry.cpp:607-610`) via the
    same 3x3 block Schur complement as `solve_se3`: a handful of vector ops
    instead of the LU a generic `jnp.linalg.inv` lowers to.

    For A = [[P, Q], [Q^T, S]]:
        diag(A^-1)[:3] = diag(P^-1 + M Ssc^-1 M^T),  M = P^-1 Q
        diag(A^-1)[3:] = diag(Ssc^-1),               Ssc = S - Q^T M
    """
    Areg = A + damping * jnp.eye(6, dtype=A.dtype)
    P, Q, S = Areg[:3, :3], Areg[:3, 3:], Areg[3:, 3:]
    Pinv = _inv3(P)
    M = Pinv @ Q
    Ssc_inv = _inv3(S - Q.T @ M)
    top = jnp.diagonal(Pinv) + jnp.sum((M @ Ssc_inv) * M, axis=-1)
    bot = jnp.diagonal(Ssc_inv)
    return jnp.concatenate([top, bot])


def combined_system(
    M_icp: jnp.ndarray, M_rgb: jnp.ndarray, icp_weight: float, rgb_scale: float = 1.0
) -> Tuple[GramStats, GramStats, jnp.ndarray, jnp.ndarray]:
    """Joint ICP+RGB normal equations (reference `RGBDOdometry.cpp:549-555`:
    ``A = A_rgbd + w^2 A_icp``).  We scale the ICP *rows* by w, which yields
    the self-consistent least-squares combination ``A_rgb + w^2 A_icp`` /
    ``b_rgb + w^2 b_icp`` (the reference's ``w * b_icp`` under-weights the ICP
    gradient relative to its own Hessian by 1/w; we keep the consistent form
    and expose w as `icp_weight`).  `rgb_scale` normalises intensity units."""
    # ONE [P,16] Gram instead of two [P,8] ones: the diagonal 8x8 blocks are
    # exactly gram(M_icp) and gram(M_rgb) (the cross block is unused), and
    # the rows are read once.
    G = gram(jnp.concatenate([M_icp, M_rgb], axis=-1))
    G_icp = unpack_gram(G[:8, :8])
    G_rgb = unpack_gram(G[8:, 8:])
    w2 = icp_weight * icp_weight
    JtJ = rgb_scale * G_rgb.JtJ + w2 * G_icp.JtJ
    Jtr = rgb_scale * G_rgb.Jtr + w2 * G_icp.Jtr
    return G_icp, G_rgb, JtJ, Jtr


# ---------------------------------------------------------------------------
# Packed-sampling row builders (the tracking path).
#
# The gather-based builders above are the readable reference implementation
# (and the oracle in tests).  The tracking path packs ALL model attributes
# into one [H, W, 12] tensor and fetches the four bilinear corner rows per
# pixel in a single fused sampling bundle per GN iteration, instead of one
# narrow gather per attribute:
#   channels 0:3 vertex, 3:6 normal (corner-selected, "nearest"),
#   6 intensity, 7 grad_x, 8 grad_y, 9 z  (bilinearly blended), 10:12 pad.
# ---------------------------------------------------------------------------

PACK_CHANNELS = 12


def pack_model(vmap_m, nmap_m, intensity_m, gx_m, gy_m) -> jnp.ndarray:
    """[H,W,*] model maps -> packed [H, W, 12] sampling tensor."""
    H, W, _ = vmap_m.shape
    pad = jnp.zeros((H, W, 2), jnp.float32)
    return jnp.concatenate(
        [
            vmap_m,
            nmap_m,
            intensity_m[..., None],
            gx_m[..., None],
            gy_m[..., None],
            vmap_m[..., 2:3],
            pad,
        ],
        axis=-1,
    )


class ModelSample(NamedTuple):
    v_m: jnp.ndarray  # [P,3] corner-selected vertex
    n_m: jnp.ndarray  # [P,3] corner-selected normal
    i_m: jnp.ndarray  # [P] bilinear intensity
    gx: jnp.ndarray  # [P]
    gy: jnp.ndarray  # [P]
    z_m: jnp.ndarray  # [P] bilinear model depth
    inb: jnp.ndarray  # [P] bool in-bounds


def sample_model(
    pack: jnp.ndarray, u: jnp.ndarray, v: jnp.ndarray, bilinear: bool = True
) -> ModelSample:
    """Sample the packed model at float pixel coords (u, v) [P].

    `bilinear=False` fetches only the nearest row — 1 gather instead of 4;
    used on the finest level where subpixel blending matters least (the ICP
    term's projective association is nearest-pixel in the reference CUDA
    kernel too, `reduce.cu:259-343`)."""
    H, W, C = pack.shape
    flat = pack.reshape(H * W, C)
    inb = (u >= 0) & (u <= W - 1) & (v >= 0) & (v <= H - 1)
    uc = jnp.clip(u, 0.0, W - 1.001)
    vc = jnp.clip(v, 0.0, H - 1.001)
    if not bilinear:
        ui = jnp.round(uc).astype(jnp.int32)
        vi = jnp.round(vc).astype(jnp.int32)
        near = flat[vi * W + ui]
        return ModelSample(
            v_m=near[:, 0:3], n_m=near[:, 3:6], i_m=near[:, 6],
            gx=near[:, 7], gy=near[:, 8], z_m=near[:, 9], inb=inb,
        )
    u0 = jnp.floor(uc).astype(jnp.int32)
    v0 = jnp.floor(vc).astype(jnp.int32)
    fu = (uc - u0.astype(jnp.float32))[:, None]
    fv = (vc - v0.astype(jnp.float32))[:, None]
    base = v0 * W + u0
    c00 = flat[base]
    c01 = flat[base + 1]
    c10 = flat[base + W]
    c11 = flat[base + W + 1]
    bil = (
        c00 * (1 - fu) * (1 - fv)
        + c01 * fu * (1 - fv)
        + c10 * (1 - fu) * fv
        + c11 * fu * fv
    )
    right = fu[:, 0] > 0.5
    down = fv[:, 0] > 0.5
    near = jnp.where(
        down[:, None],
        jnp.where(right[:, None], c11, c10),
        jnp.where(right[:, None], c01, c00),
    )
    return ModelSample(
        v_m=near[:, 0:3],
        n_m=near[:, 3:6],
        i_m=bil[:, 6],
        gx=bil[:, 7],
        gy=bil[:, 8],
        z_m=bil[:, 9],
        inb=inb,
    )


def joint_rows_packed(
    vmap_c: jnp.ndarray,  # [H,W,3]
    nmap_c: jnp.ndarray,
    intensity_c: jnp.ndarray,  # [H,W]
    model_pack: jnp.ndarray,  # [H,W,12]
    A: jnp.ndarray,
    intr: CameraIntrinsics,
    dist_thresh: float = ICP_DIST_THRESH,
    angle_thresh: float = ICP_ANGLE_SIN_THRESH,
    min_grad: float = RGB_MIN_GRAD,
    max_residual: float = 255.0,
    occlusion_thresh: float = 0.15,
    bilinear: bool = True,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Build BOTH the ICP and RGB row matrices from one sampling bundle.

    Same math and gates as `icp_rows` + `rgb_rows`; one fused 4-corner gather
    of the packed model instead of 7+ separate samples.
    Returns (M_icp [P,8], M_rgb [P,8]).
    """
    H, W, _ = vmap_c.shape
    P = H * W
    v_c = vmap_c.reshape(P, 3)
    n_c_raw = nmap_c.reshape(P, 3)
    valid_c = v_c[:, 2] > 0
    p = se3.transform_points(A, v_c)
    n_c = se3.rotate_vectors(A, n_c_raw)
    u, v, z = geometry.project(p, intr)
    smp = sample_model(model_pack, u, v, bilinear=bilinear)
    inb = smp.inb & (z > 0)

    # --- ICP rows ---
    valid_m = smp.v_m[:, 2] > 0
    diff = p - smp.v_m
    dist = jnp.linalg.norm(diff, axis=-1)
    sin_angle = jnp.linalg.norm(jnp.cross(n_c, smp.n_m), axis=-1)
    has_n = jnp.linalg.norm(n_c_raw, axis=-1) > 0.5
    mask_icp = (
        valid_c & inb & valid_m & has_n
        & (dist < dist_thresh) & (sin_angle < angle_thresh)
    )
    r_icp = jnp.sum(smp.n_m * diff, axis=-1)
    Jw_icp = jnp.cross(p, smp.n_m)
    mi = mask_icp.astype(jnp.float32)[:, None]
    M_icp = jnp.concatenate(
        [Jw_icp, smp.n_m, r_icp[:, None], jnp.ones_like(r_icp)[:, None]], axis=-1
    ) * mi

    # --- RGB rows ---
    r_rgb = smp.i_m - intensity_c.reshape(P)
    gmag2 = smp.gx * smp.gx + smp.gy * smp.gy
    mask_rgb = (
        valid_c & inb
        & (gmag2 > min_grad * min_grad)
        & (jnp.abs(r_rgb) < max_residual)
        & (smp.z_m > 0)
        & (jnp.abs(z - smp.z_m) < occlusion_thresh)
    )
    g3 = _image_grad_rows(p, smp.gx, smp.gy, intr)
    Jw_rgb = jnp.cross(p, g3)
    mr = mask_rgb.astype(jnp.float32)[:, None]
    M_rgb = jnp.concatenate(
        [Jw_rgb, g3, r_rgb[:, None], jnp.ones_like(r_rgb)[:, None]], axis=-1
    ) * mr
    return M_icp, M_rgb


def joint_rows_frozen(
    v_c: jnp.ndarray,  # [P,3] current-frame vertices (camera frame)
    n_c_raw: jnp.ndarray,  # [P,3]
    i_c: jnp.ndarray,  # [P]
    smp: ModelSample,  # model sampled ONCE at uv0 = project(A0 v_c)
    uv0: jnp.ndarray,  # [P,2] the sample positions
    A: jnp.ndarray,
    intr: CameraIntrinsics,
    dist_thresh: float = ICP_DIST_THRESH,
    angle_thresh: float = ICP_ANGLE_SIN_THRESH,
    min_grad: float = RGB_MIN_GRAD,
    max_residual: float = 255.0,
    occlusion_thresh: float = 0.15,
    drift_px: float = 2.0,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """ICP+RGB rows against a FROZEN model sample (Lucas-Kanade style).

    The model gather is the per-GN-iteration cost that scales with rows
    fetched, so within one pyramid level the model is sampled once at the
    warm-start projection and subsequent iterations update the rows
    analytically:

    - ICP (exact under frozen association): the associated pair (v_m, n_m) is
      fixed; the residual ``r = n_m . (A v_c - v_m)`` and Jacobian follow the
      *current* A.  Classic fixed-correspondence point-to-plane ICP — the
      reference re-associates every iteration (`reduce.cu:259-343`), but after
      the coarse levels the association changes by <1 px between iterations.
    - RGB (first-order): ``r(A) = i_m(uv0) + g(uv0) . (uv(A) - uv0) - i_c``,
      the forward-additive Lucas-Kanade linearisation around the sample
      position, with the same projection-chain Jacobian as `rgb_rows`.

    Rows whose reprojection drifts more than `drift_px` from the sample
    position are gated out (the linearisation stops being trustworthy).
    """
    P = v_c.shape[0]
    valid_c = v_c[:, 2] > 0
    p = se3.transform_points(A, v_c)
    n_c = se3.rotate_vectors(A, n_c_raw)
    u, v, z = geometry.project(p, intr)
    inb = smp.inb & (z > 0)
    du = u - uv0[:, 0]
    dv = v - uv0[:, 1]
    near = (jnp.abs(du) <= drift_px) & (jnp.abs(dv) <= drift_px)

    # --- ICP rows (exact, frozen association) ---
    valid_m = smp.v_m[:, 2] > 0
    diff = p - smp.v_m
    dist = jnp.linalg.norm(diff, axis=-1)
    sin_angle = jnp.linalg.norm(jnp.cross(n_c, smp.n_m), axis=-1)
    has_n = jnp.linalg.norm(n_c_raw, axis=-1) > 0.5
    mask_icp = (
        valid_c & inb & near & valid_m & has_n
        & (dist < dist_thresh) & (sin_angle < angle_thresh)
    )
    r_icp = jnp.sum(smp.n_m * diff, axis=-1)
    Jw_icp = jnp.cross(p, smp.n_m)
    mi = mask_icp.astype(jnp.float32)[:, None]
    M_icp = jnp.concatenate(
        [Jw_icp, smp.n_m, r_icp[:, None], jnp.ones_like(r_icp)[:, None]],
        axis=-1,
    ) * mi

    # --- RGB rows (Lucas-Kanade around uv0) ---
    i_warp = smp.i_m + smp.gx * du + smp.gy * dv
    r_rgb = i_warp - i_c
    gmag2 = smp.gx * smp.gx + smp.gy * smp.gy
    mask_rgb = (
        valid_c & inb & near
        & (gmag2 > min_grad * min_grad)
        & (jnp.abs(r_rgb) < max_residual)
        & (smp.z_m > 0)
        & (jnp.abs(z - smp.z_m) < occlusion_thresh)
    )
    g3 = _image_grad_rows(p, smp.gx, smp.gy, intr)
    Jw_rgb = jnp.cross(p, g3)
    mr = mask_rgb.astype(jnp.float32)[:, None]
    M_rgb = jnp.concatenate(
        [Jw_rgb, g3, r_rgb[:, None], jnp.ones_like(r_rgb)[:, None]], axis=-1
    ) * mr
    return M_icp, M_rgb


def so3_rows_frozen(
    d: jnp.ndarray,  # [P,3] unit-plane rays (fixed per level)
    i_c: jnp.ndarray,  # [P] current intensities
    smp: ModelSample,  # model sampled ONCE at uv0 = project(R0 d)
    uv0: jnp.ndarray,  # [P,2] the sample positions
    R: jnp.ndarray,
    intr: CameraIntrinsics,
    max_residual: float = 255.0,
    drift_px: float = 3.0,
) -> jnp.ndarray:
    """SO3 photometric rows against a FROZEN model sample (Lucas-Kanade).

    Same rationale as `joint_rows_frozen`: the model gather dominates the
    per-iteration cost, and after the first exact iterations the warp moves
    sub-pixel, so the sample taken at uv0 is linearised forward-additively:
    ``r(R) = i_m(uv0) + g(uv0) . (uv(R) - uv0) - i_c``.
    """
    rd = jnp.sum(R * d[:, None, :], axis=-1)
    u, v, z = geometry.project(rd, intr)
    du = u - uv0[:, 0]
    dv = v - uv0[:, 1]
    near = (jnp.abs(du) <= drift_px) & (jnp.abs(dv) <= drift_px)
    i_warp = smp.i_m + smp.gx * du + smp.gy * dv
    r = i_warp - i_c
    mask = smp.inb & near & (z > 0) & (jnp.abs(r) < max_residual)
    g3 = _image_grad_rows(rd, smp.gx, smp.gy, intr)
    Jw = jnp.cross(rd, g3)
    m = mask.astype(jnp.float32)[:, None]
    zeros = jnp.zeros_like(r)[:, None]
    M = jnp.concatenate(
        [Jw, r[:, None], zeros, zeros, zeros, jnp.ones_like(r)[:, None]], axis=-1
    ) * m
    return M


def so3_rows_packed(
    intensity_c: jnp.ndarray,
    model_pack: jnp.ndarray,
    R: jnp.ndarray,
    intr: CameraIntrinsics,
    max_residual: float = 255.0,
) -> jnp.ndarray:
    """Packed-sampling variant of `so3_rows` (rotation-only homography warp)."""
    H, W = intensity_c.shape
    P = H * W
    uu = jax.lax.broadcasted_iota(jnp.float32, (H, W), 1).reshape(P)
    vv = jax.lax.broadcasted_iota(jnp.float32, (H, W), 0).reshape(P)
    d = jnp.stack(
        [(uu - intr.cx) / intr.fx, (vv - intr.cy) / intr.fy, jnp.ones_like(uu)],
        axis=-1,
    )
    rd = jnp.sum(R * d[:, None, :], axis=-1)  # K=3: elementwise, exact f32
    u, v, z = geometry.project(rd, intr)
    smp = sample_model(model_pack, u, v)
    r = smp.i_m - intensity_c.reshape(P)
    mask = smp.inb & (z > 0) & (jnp.abs(r) < max_residual)
    g3 = _image_grad_rows(rd, smp.gx, smp.gy, intr)
    Jw = jnp.cross(rd, g3)
    m = mask.astype(jnp.float32)[:, None]
    zeros = jnp.zeros_like(r)[:, None]
    M = jnp.concatenate(
        [Jw, r[:, None], zeros, zeros, zeros, jnp.ones_like(r)[:, None]], axis=-1
    ) * m
    return M
