"""Dense frame-to-model RGB-D odometry: pyramidal joint ICP + photometric
Gauss-Newton with optional SO(3) pre-alignment.

Equivalent of the reference `RGBDOdometry`
(`Core/src/Utils/RGBDOdometry.cpp:268-605`): same structure — SO3 rotation
pre-alignment on the coarsest level (<=10 iters with divergence rollback,
:297-385), then coarse-to-fine Gauss-Newton with per-level iteration budgets
{10, 5, 4} ({3,0,0} fast, {50,50,50} inter-map, :387-389), each iteration
combining ICP and RGB normal equations (:479-555) and applying an SE(3)
exponential update (:573-585), with the ||dt|| > 0.3 m failure guard
(:589-593).

Differences by design:
- normal equations are built by Gram matmuls (`ops.reductions`), not CUDA
  tree reductions, and the 6x6 solve stays on device;
- the whole multi-level loop is one jitted function per image shape; only the
  final pose/stats cross the host boundary;
- tracking estimates the relative transform A (current camera -> model
  camera) in camera-local coordinates for f32 conditioning.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from densemonoslam_tpu.config import CameraIntrinsics, EngineConfig
from densemonoslam_tpu.ops import geometry, preprocess, reductions, warp
from densemonoslam_tpu.utils import se3

# Reference iteration budgets (`RGBDOdometry.cpp:387-389`), finest-first.
ITERATIONS_DEFAULT = (4, 5, 10)
ITERATIONS_FAST = (3, 0, 0)
ITERATIONS_INTERMAP = (50, 50, 50)
SO3_ITERATIONS = 10
TRANSLATION_FAILURE_THRESH = 0.3  # metres (`RGBDOdometry.cpp:589-593`)

# Intensity residuals are in [0,255] units while ICP residuals are metres; the
# reference folds this into its sobelScale/sigma machinery — we use a fixed
# photometric scale so both terms are comparable before icp_weight is applied.
RGB_UNIT_SCALE = 1.0 / (255.0 * 255.0)


class FramePyramid(NamedTuple):
    """Per-level image data for one frame (all tuples are coarse..fine
    indexed fine-to-coarse: index 0 = full resolution)."""

    intensity: Tuple[jnp.ndarray, ...]
    vmap: Tuple[jnp.ndarray, ...]
    nmap: Tuple[jnp.ndarray, ...]
    grad_x: Tuple[jnp.ndarray, ...]
    grad_y: Tuple[jnp.ndarray, ...]


class ModelPyramid(NamedTuple):
    """Packed model tensors per level ([H, W, 12], see
    `reductions.pack_model`): one fused 4-corner gather per GN iteration
    fetches every model attribute the ICP and RGB terms need."""

    pack: Tuple[jnp.ndarray, ...]


def model_pyramid_from_maps(
    intensity: Tuple[jnp.ndarray, ...],
    vmap: Tuple[jnp.ndarray, ...],
    nmap: Tuple[jnp.ndarray, ...],
    grad_x: Tuple[jnp.ndarray, ...],
    grad_y: Tuple[jnp.ndarray, ...],
) -> ModelPyramid:
    pack = tuple(
        reductions.pack_model(v, n, i, gx, gy)
        for v, n, i, gx, gy in zip(vmap, nmap, intensity, grad_x, grad_y)
    )
    return ModelPyramid(pack=pack)


def model_pyramid_from_frame(pyr: "FramePyramid") -> ModelPyramid:
    """Use a live frame as the tracking model (frame-to-frame mode)."""
    return model_pyramid_from_maps(
        pyr.intensity, pyr.vmap, pyr.nmap, pyr.grad_x, pyr.grad_y
    )


def frame_pyramid_from_maps(
    intensity: jnp.ndarray, vmap0: jnp.ndarray, nmap0: jnp.ndarray, levels: int
) -> FramePyramid:
    """Build a FramePyramid from rendered maps (used when a *prediction*
    plays the role of the live frame, e.g. model-to-model loop-closure
    tracking, reference `ElasticFusion.cpp:410-424`)."""
    ints = preprocess.build_pyramid(intensity, levels, depth=False)
    vmaps, nmaps, gxs, gys = [], [], [], []
    vm, nm = vmap0, nmap0
    for lv in range(levels):
        vmaps.append(vm)
        nmaps.append(nm)
        gx, gy = preprocess.sobel_gradients(ints[lv])
        gxs.append(gx)
        gys.append(gy)
        vm, nm = warp.decimate(vm, 2), warp.decimate(nm, 2)
    return FramePyramid(
        intensity=tuple(ints), vmap=tuple(vmaps), nmap=tuple(nmaps),
        grad_x=tuple(gxs), grad_y=tuple(gys),
    )


def build_model_pyramid(
    intensity: jnp.ndarray, vmap0: jnp.ndarray, nmap0: jnp.ndarray, levels: int
) -> ModelPyramid:
    """Predicted (filled) model maps -> packed tracking pyramid (reference
    `initICPModel`/`initRGBModel`).  Vertex/normal maps are decimated from
    the splat output (exact fused normals, reference `resizeVMap`)."""
    ints = preprocess.build_pyramid(intensity, levels, depth=False)
    vmaps, nmaps, gxs, gys = [], [], [], []
    vm, nm = vmap0, nmap0
    for _ in range(levels):
        vmaps.append(vm)
        nmaps.append(nm)
        vm, nm = warp.decimate(vm, 2), warp.decimate(nm, 2)
    for lv in range(levels):
        gx, gy = preprocess.sobel_gradients(ints[lv])
        gxs.append(gx)
        gys.append(gy)
    return model_pyramid_from_maps(ints, vmaps, nmaps, gxs, gys)


class TrackResult(NamedTuple):
    A: jnp.ndarray  # [4,4] current-camera -> model-camera
    icp_error: jnp.ndarray  # mean squared point-to-plane residual
    icp_inliers: jnp.ndarray  # inlier count at the finest level
    rgb_error: jnp.ndarray
    rgb_inliers: jnp.ndarray
    JtJ: jnp.ndarray  # [6,6] final combined system (covariance = inv)
    failed: jnp.ndarray  # bool: update exceeded the translation guard


@functools.partial(jax.jit, static_argnames=("levels", "intr"))
def build_frame_pyramid(
    rgb: jnp.ndarray,
    depth_metric: jnp.ndarray,
    intr: CameraIntrinsics,
    levels: int = 3,
) -> FramePyramid:
    """rgb u8/f32 [H,W,3] + metric depth [H,W] -> FramePyramid.

    Replaces the reference's `initICP`/`initRGB`/`populateRGBDData`
    (`RGBDOdometry.cpp`): intensity + Gaussian pyramid, depth-aware depth
    pyramid, vertex/normal maps and Sobel derivatives per level.
    """
    intensity = preprocess.build_pyramid(
        preprocess.rgb_to_intensity(rgb), levels, depth=False
    )
    depths = preprocess.build_pyramid(depth_metric, levels, depth=True)
    vmaps, nmaps, gxs, gys = [], [], [], []
    for lv in range(levels):
        vm = geometry.backproject(depths[lv], intr.scaled(lv))
        vmaps.append(vm)
        nmaps.append(geometry.normal_map(vm))
        gx, gy = preprocess.sobel_gradients(intensity[lv])
        gxs.append(gx)
        gys.append(gy)
    return FramePyramid(
        intensity=tuple(intensity),
        vmap=tuple(vmaps),
        nmap=tuple(nmaps),
        grad_x=tuple(gxs),
        grad_y=tuple(gys),
    )


@functools.partial(jax.jit, static_argnames=("levels", "intr"))
def frame_pyramid_from_depth_intensity(
    intensity: jnp.ndarray,
    depth_metric: jnp.ndarray,
    intr: CameraIntrinsics,
    levels: int = 3,
) -> FramePyramid:
    """Like `build_frame_pyramid` but from an already-computed intensity
    image (decimated views, fern-resolution verification)."""
    ints = preprocess.build_pyramid(intensity, levels, depth=False)
    depths = preprocess.build_pyramid(depth_metric, levels, depth=True)
    vmaps, nmaps, gxs, gys = [], [], [], []
    for lv in range(levels):
        vm = geometry.backproject(depths[lv], intr.scaled(lv))
        vmaps.append(vm)
        nmaps.append(geometry.normal_map(vm))
        gx, gy = preprocess.sobel_gradients(ints[lv])
        gxs.append(gx)
        gys.append(gy)
    return FramePyramid(
        intensity=tuple(ints), vmap=tuple(vmaps), nmap=tuple(nmaps),
        grad_x=tuple(gxs), grad_y=tuple(gys),
    )


def _so3_prealign(
    model: ModelPyramid, frame: FramePyramid, intr_top: CameraIntrinsics,
    R0: jnp.ndarray | None = None,
) -> jnp.ndarray:
    """Rotation-only photometric alignment on the coarsest level with
    divergence rollback (reference `RGBDOdometry.cpp:297-385`).  `R0`
    warm-starts the estimate (model-relative initial rotation)."""
    lv = len(frame.intensity) - 1
    i_c = frame.intensity[lv]
    pack_m = model.pack[lv]

    # UNROLLED with a frozen carry instead of lax.while_loop: every tracking
    # loop is unrolled to its static budget, so there is no per-iteration
    # loop control on the device, and "early exit" freezes the carry with
    # `where` — same math, same result.  Whether the unrolled form still pays
    # on the H100 is not measured yet.
    eye = jnp.eye(3, dtype=jnp.float32) if R0 is None else R0
    R_best = eye
    err_best = jnp.array(jnp.inf, jnp.float32)
    R = eye
    done = jnp.asarray(False)
    # exact re-association (bilinear model sample at the CURRENT rotation)
    # for the first iterations, then ONE more sample frozen at the warmed-up
    # rotation and Lucas-Kanade iterations against it — the model gather is
    # the per-iteration cost, and past iteration 3 the warp moves sub-pixel.
    exact = min(3, SO3_ITERATIONS)
    H, W = i_c.shape
    P = H * W
    uu = jax.lax.broadcasted_iota(jnp.float32, (H, W), 1).reshape(P)
    vv = jax.lax.broadcasted_iota(jnp.float32, (H, W), 0).reshape(P)
    d = jnp.stack(
        [
            (uu - intr_top.cx) / intr_top.fx,
            (vv - intr_top.cy) / intr_top.fy,
            jnp.ones_like(uu),
        ],
        axis=-1,
    )
    i_flat = i_c.reshape(P)
    smp = None
    uv0 = None
    for k in range(SO3_ITERATIONS):
        if k == exact and k < SO3_ITERATIONS:
            rd0 = jnp.sum(R * d[:, None, :], axis=-1)
            u0, v0, _ = geometry.project(rd0, intr_top)
            smp = reductions.sample_model(pack_m, u0, v0)
            uv0 = jnp.stack([u0, v0], axis=-1)
        if k < exact:
            M = reductions.so3_rows_packed(i_c, pack_m, R, intr_top)
        else:
            M = reductions.so3_rows_frozen(d, i_flat, smp, uv0, R, intr_top)
        G = reductions.gram(M)
        JtJ3, Jtr3 = G[:3, :3], G[:3, 3]
        count = jnp.maximum(G[7, 7], 1.0)
        err = G[3, 3] / count
        dw = reductions.solve_so3(JtJ3, Jtr3, damping=1e-4)
        ok = (G[7, 7] > 50) & jnp.all(jnp.isfinite(dw))
        R_new = jnp.where(ok, se3.so3_exp(dw) @ R, R)
        improved = err < err_best
        R_best_new = jnp.where(improved, R, R_best)
        err_best_new = jnp.minimum(err, err_best)
        # diverged: fall back to the best-so-far rotation
        R_next = jnp.where(improved, R_new, R_best_new)
        step_done = ~ok | (jnp.sum(dw * dw) < 1e-10)
        R_best = jnp.where(done, R_best, R_best_new)
        err_best = jnp.where(done, err_best, err_best_new)
        R = jnp.where(done, R, R_next)
        done = done | step_done
    return R


def _gn_level(
    model: ModelPyramid,
    frame: FramePyramid,
    A0: jnp.ndarray,
    level: int,
    iterations: int,
    intr: CameraIntrinsics,
    icp_weight: float,
    rgb_only: bool,
    row_stride: int = 1,
    nearest_finest: bool = True,
    exact_iters: int = 0,
):
    """Gauss-Newton iterations at one pyramid level; returns (A, stats).

    `exact_iters` iterations re-associate against the live model sample
    (exact projective data association, the reference's per-iteration
    behaviour); the remaining budget runs Lucas-Kanade style against ONE
    sample frozen at the warmed-up estimate (`joint_rows_frozen`).  The
    model gather is the per-iteration cost, so the first GN level (whose
    warm start carries the unsolved translation) gets a couple of exact
    iterations and every later level — warm-started by its coarser
    predecessor to sub-pixel — freezes from iteration 0."""
    i_c = frame.intensity[level]
    v_c, n_c = frame.vmap[level], frame.nmap[level]
    pack_m = model.pack[level]
    intr_l = intr.scaled(level)
    # subsample the residual rows (77k constraints still over-determine
    # 6 DoF by ~4 orders of magnitude); the model is still sampled at full
    # level resolution, only the row count shrinks — the per-GN-iteration
    # cost is the model gather, which scales with rows fetched.  Applied at
    # EVERY
    # level that keeps a healthy row count (an unstrided level 1 costs
    # exactly as much per iteration as a stride-2 level 0), with a floor so
    # coarse levels keep enough constraints for a stable 6x6 system.
    if row_stride > 1 and i_c.size // (row_stride * row_stride) >= 4096:
        i_c = warp.decimate(i_c, row_stride)
        v_c = warp.decimate(v_c, row_stride)
        n_c = warp.decimate(n_c, row_stride)

    # UNROLLED to the static iteration budget (see `_so3_prealign`).  The
    # early-exit of the old while_loop ("converged twist stops iterating")
    # becomes a frozen carry: once `done`, later iterations' results are
    # discarded via `where` — bit-identical outcome, straight-line HLO.
    init_stats = (
        jnp.array(jnp.inf, jnp.float32),
        jnp.array(0.0, jnp.float32),
        jnp.array(jnp.inf, jnp.float32),
        jnp.array(0.0, jnp.float32),
        jnp.eye(6, dtype=jnp.float32),
    )
    bilinear = not (nearest_finest and level <= 1)

    def gn_iter(A):
        M_icp, M_rgb = reductions.joint_rows_packed(
            v_c, n_c, i_c, pack_m, A, intr_l,
            # nearest sampling on the two finest levels: 1 gather instead
            # of 4 (subpixel blending matters least where pixels are
            # densest; the coarsest levels stay bilinear for convergence)
            bilinear=bilinear,
        )
        return _solve_iter(M_icp, M_rgb)

    def _solve_iter(M_icp, M_rgb):
        G_icp, G_rgb, JtJ, Jtr = reductions.combined_system(
            M_icp, M_rgb, icp_weight=0.0 if rgb_only else icp_weight,
            rgb_scale=RGB_UNIT_SCALE,
        )
        xi = reductions.solve_se3(JtJ, Jtr, damping=1e-8)
        ok = (
            jnp.all(jnp.isfinite(xi))
            & ((G_icp.inliers > 10) | (G_rgb.inliers > 10))
        )
        stats_new = (
            G_icp.residual_sq / jnp.maximum(G_icp.inliers, 1.0),
            G_icp.inliers,
            G_rgb.residual_sq / jnp.maximum(G_rgb.inliers, 1.0),
            G_rgb.inliers,
            JtJ,
        )
        return xi, ok, stats_new

    A = A0
    stats = init_stats
    done = jnp.asarray(iterations == 0)
    # `nearest_finest` is False in single-level fast mode, where the warm
    # start may sit several pixels off and the frozen sample's drift gate
    # would starve the solve — that mode keeps exact re-association only.
    if iterations <= 12 and nearest_finest:
        ex = min(exact_iters, iterations)
        for _ in range(ex):
            xi, ok, stats_new = gn_iter(A)
            A_new = jnp.where(ok, se3.apply_update(A, xi), A)
            step_done = ~ok | (jnp.sum(xi * xi) < 1e-9)
            A = jnp.where(done, A, A_new)
            stats = jax.tree_util.tree_map(
                lambda old, new: jnp.where(done, old, new), stats, stats_new
            )
            done = done | step_done
        if iterations - ex > 0:
            # ONE model gather (at the warmed-up projection), then
            # Lucas-Kanade iterations against the frozen sample —
            # re-associating every iteration (the reference's behaviour)
            # pays the gather repeatedly for sub-pixel association changes.
            rest = iterations - ex
            P = i_c.size
            v_flat = v_c.reshape(P, 3)
            n_flat = n_c.reshape(P, 3)
            i_flat = i_c.reshape(P)
            p0 = se3.transform_points(A, v_flat)
            u0, v0, _z0 = geometry.project(p0, intr_l)
            smp = reductions.sample_model(pack_m, u0, v0, bilinear=bilinear)
            uv0 = jnp.stack([u0, v0], axis=-1)
            # keep the tight 2 px linearisation gate at every level (widening
            # it admits rows whose Lucas-Kanade expansion is unreliable and
            # measurably degrades convergence); fast-motion robustness comes
            # from the starvation fallback below instead
            drift = 2.0

            # keep the pre-frozen carry so the starvation fallback can redo
            # the level from the warm start with exact re-association
            A_pre, stats_pre, done_pre = A, stats, done

            first_ok = jnp.asarray(True)
            for k in range(rest):
                M_icp, M_rgb = reductions.joint_rows_frozen(
                    v_flat, n_flat, i_flat, smp, uv0, A, intr_l,
                    drift_px=drift,
                )
                xi, ok, stats_new = _solve_iter(M_icp, M_rgb)
                if k == 0:
                    first_ok = ok
                A_new = jnp.where(ok, se3.apply_update(A, xi), A)
                step_done = ~ok | (jnp.sum(xi * xi) < 1e-9)
                A = jnp.where(done, A, A_new)
                stats = jax.tree_util.tree_map(
                    lambda old, new: jnp.where(done, old, new),
                    stats, stats_new,
                )
                done = done | step_done

            # starvation fallback: under fast motion the warm start can sit
            # outside the frozen drift gate and the first frozen iteration
            # collapses below the inlier floor — the old behaviour then set
            # `done` and silently accepted the warm start (coarse-only
            # refinement) without raising `failed`.  When that happens,
            # redo the level with exact re-association (costs `rest`
            # gathers, but only on the rare starved frames — lax.cond).
            def run_exact(carry):
                A, stats, done = carry
                for _ in range(rest):
                    xi, ok, stats_new = gn_iter(A)
                    A_new = jnp.where(ok, se3.apply_update(A, xi), A)
                    step_done = ~ok | (jnp.sum(xi * xi) < 1e-9)
                    A = jnp.where(done, A, A_new)
                    stats = jax.tree_util.tree_map(
                        lambda old, new: jnp.where(done, old, new),
                        stats, stats_new,
                    )
                    done = done | step_done
                return A, stats, done

            starved = ~done_pre & ~first_ok
            A, stats, done = jax.lax.cond(
                starved,
                lambda _: run_exact((A_pre, stats_pre, done_pre)),
                lambda _: (A, stats, done),
                None,
            )
    elif iterations <= 12:
        for _ in range(iterations):
            xi, ok, stats_new = gn_iter(A)
            A_new = jnp.where(ok, se3.apply_update(A, xi), A)
            step_done = ~ok | (jnp.sum(xi * xi) < 1e-9)
            A = jnp.where(done, A, A_new)
            stats = jax.tree_util.tree_map(
                lambda old, new: jnp.where(done, old, new), stats, stats_new
            )
            done = done | step_done
    else:
        # large budgets (inter-map {50,50,50}) stay a while_loop: unrolling
        # them would multiply compile time for a path that runs rarely (loop
        # closures / relocalisation), where the per-iteration loop overhead
        # does not bound frame rate.
        def cond(carry):
            i, _A, _stats, d = carry
            return (i < iterations) & ~d

        def body(carry):
            i, A, _stats, _d = carry
            xi, ok, stats_new = gn_iter(A)
            A_new = jnp.where(ok, se3.apply_update(A, xi), A)
            step_done = ~ok | (jnp.sum(xi * xi) < 1e-9)
            return i + 1, A_new, stats_new, step_done

        _, A, stats, _ = jax.lax.while_loop(
            cond, body, (jnp.array(0, jnp.int32), A, stats, done)
        )
    return A, stats


@functools.partial(
    jax.jit,
    static_argnames=(
        "intr", "iterations", "icp_weight", "rgb_only", "pyramid", "use_so3",
        "row_stride", "nearest_finest", "trans_fail_thresh",
    ),
)
def track(
    model: ModelPyramid,
    frame: FramePyramid,
    A_init: jnp.ndarray,
    intr: CameraIntrinsics,
    iterations: Tuple[int, ...] = ITERATIONS_DEFAULT,
    icp_weight: float = 10.0,
    rgb_only: bool = False,
    pyramid: bool = True,
    use_so3: bool = True,
    row_stride: int = 1,
    nearest_finest: bool = True,
    trans_fail_thresh: float = TRANSLATION_FAILURE_THRESH,
) -> TrackResult:
    """Full multi-level tracking (reference
    `RGBDOdometry::getIncrementalTransformation`).

    `model` holds the predicted maps rendered at the model/reference pose (in
    that camera's frame); returns A such that
    ``T_curr = T_model_view @ A``.
    """
    levels = len(frame.intensity)
    A = A_init
    if use_so3 and levels > 1:
        # warm-started: estimates the full model->frame rotation from
        # A_init's rotation, then replaces it (not composed — composing would
        # double-count when A_init is not identity)
        R = _so3_prealign(model, frame, intr.scaled(levels - 1), A[:3, :3])
        A = A.at[:3, :3].set(R)

    # nearest finest-level sampling is only safe when coarser levels refine
    # the estimate first (single-level fast mode keeps bilinear)
    coarse_iters = sum(
        iterations[lv] for lv in range(1, min(levels, len(iterations)))
        if pyramid
    )
    nearest_eff = nearest_finest and coarse_iters > 0
    stats = None
    first_gn = True
    for level in range(levels - 1, -1, -1):
        iters = iterations[level] if level < len(iterations) else 0
        if iters == 0 or (not pyramid and level != 0):
            continue
        # the first GN level's warm start still carries the unsolved
        # translation, so it re-associates exactly for a couple of
        # iterations before freezing; later levels arrive sub-pixel warm
        # from their coarser predecessor and freeze from iteration 0
        A, stats = _gn_level(
            model, frame, A, level, iters, intr, icp_weight, rgb_only,
            row_stride=row_stride, nearest_finest=nearest_eff,
            exact_iters=2 if first_gn else 0,
        )
        first_gn = False

    icp_err, icp_inl, rgb_err, rgb_inl, JtJ = stats
    # failure guard (`RGBDOdometry.cpp:589-593`).  `trans_fail_thresh` is a
    # parameter because inter-map verification legitimately crosses larger
    # baselines than frame-to-model tracking ever should.
    dt = jnp.linalg.norm(A[:3, 3] - A_init[:3, 3])
    failed = (dt > trans_fail_thresh) | ~jnp.all(jnp.isfinite(A))
    A_out = jnp.where(failed, A_init, A)
    return TrackResult(
        A=A_out,
        icp_error=icp_err,
        icp_inliers=icp_inl,
        rgb_error=rgb_err,
        rgb_inliers=rgb_inl,
        JtJ=JtJ,
        failed=failed,
    )


def covariance(result: TrackResult) -> jnp.ndarray:
    """Pose covariance = inverse of the final combined JtJ (reference
    `getCovariance()`, `RGBDOdometry.cpp:607-610`); used by the
    relocalisation and loop-closure acceptance gates."""
    return jnp.linalg.inv(
        result.JtJ + 1e-12 * jnp.eye(6, dtype=result.JtJ.dtype)
    )
