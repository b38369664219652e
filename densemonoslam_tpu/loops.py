"""Loop closure orchestration: local (time-window) loops, global fern loops,
and relocalisation.

Host-side equivalents of the reference's in-`processFrame` loop machinery:

- **local loops** (`ElasticFusion.cpp:399-495`): render the INACTIVE model at
  the current pose, align the ACTIVE prediction onto it with the dense
  tracker, and on success feed sampled surface constraints to the
  deformation graph, folding the drifted recent map onto the old one and
  reactivating it;
- **global loops / relocalisation** (`ElasticFusion.cpp:279-394` +
  `Ferns.cpp:277-423`): retrieve a fern keyframe, refine with ICP at fern
  resolution, photometric-check, then constrain the global deformation.

These run at a host cadence (every `loop_check_interval` frames) because they
are data-dependent multi-stage decisions; each stage is a jitted device
function and only scalar gates cross the host boundary.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from densemonoslam_tpu import step as stepmod
from densemonoslam_tpu.config import CameraConfig, EngineConfig
from densemonoslam_tpu.mapping import deformation as dg
from densemonoslam_tpu.mapping import ferns as fernmod
from densemonoslam_tpu.mapping import surfel_map as sm
from densemonoslam_tpu.ops import splat, warp
from densemonoslam_tpu.tracking import odometry
from densemonoslam_tpu.utils import se3


class LoopInfo(NamedTuple):
    attempted: bool
    closed: bool
    inactive_frac: float
    inlier_frac: float
    icp_error: float
    cons_error: float


class RelBank(NamedTuple):
    """Ring buffer of carried relative constraints (the reference's
    per-context `relativeCons()`: 3 sampled constraints appended after every
    accepted local deformation, `ElasticFusion.cpp:489-492`, consumed by all
    subsequent local AND global deformations, `ElasticFusion.cpp:337,373`)."""

    cons: dg.RelConstraint
    next: jnp.ndarray  # [] i32 ring write pointer


def make_rel_bank(capacity: int = 64) -> RelBank:
    return RelBank(cons=dg.empty_rel(capacity), next=jnp.array(0, jnp.int32))


@jax.jit
def merge_rel_banks(dst: RelBank, src: RelBank, T: jnp.ndarray) -> RelBank:
    """Transform map A's carried relative constraints by T and append them to
    map B's bank (reference `consumeReferenceFrame` transforms member
    contexts' relativeCons, `ReferenceFrame.h:129-149`)."""
    sel = src.cons.valid
    R = dst.cons.src.shape[0]
    rank = jnp.cumsum(sel.astype(jnp.int32)) - 1
    dest = jnp.where(sel, (dst.next + rank) % R, R)
    d = dst.cons
    return RelBank(
        cons=dg.RelConstraint(
            src=d.src.at[dest].set(
                se3.transform_points(T, src.cons.src), mode="drop"
            ),
            dst=d.dst.at[dest].set(
                se3.transform_points(T, src.cons.dst), mode="drop"
            ),
            src_time=d.src_time.at[dest].set(src.cons.src_time, mode="drop"),
            dst_time=d.dst_time.at[dest].set(src.cons.dst_time, mode="drop"),
            valid=d.valid.at[dest].set(src.cons.valid, mode="drop"),
        ),
        next=(dst.next + jnp.sum(sel.astype(jnp.int32))) % R,
    )


def _emit_relative(
    bank: RelBank, graph: dg.DeformGraph, cons: dg.Constraint, n_src: int
) -> RelBank:
    """After an accepted deformation, store ~3 spread samples of the point
    constraints as relative pairs (deformed src, original target) — reference
    `Deformation.cpp:171-187` (emission: src position AFTER
    applyGraphToVertices) + `ElasticFusion.cpp:489-492` (keep every
    size/3-th)."""
    P = n_src
    moved = dg.deform_points(graph, cons.src[:P], cons.time[:P])
    sel = (
        cons.valid[:P]
        & ~cons.pinned[:P]
        & (jnp.arange(P) % max(P // 3, 1) == 0)
    )
    R = bank.cons.src.shape[0]
    rank = jnp.cumsum(sel.astype(jnp.int32)) - 1
    dest = jnp.where(sel, (bank.next + rank) % R, R)  # R = drop
    c = bank.cons
    return RelBank(
        cons=dg.RelConstraint(
            src=c.src.at[dest].set(moved, mode="drop"),
            dst=c.dst.at[dest].set(cons.dst[:P], mode="drop"),
            src_time=c.src_time.at[dest].set(cons.time[:P], mode="drop"),
            # the target half of the constraint set is index-aligned with the
            # source half (same decimated pixel grid), so its times are the
            # targets' times
            dst_time=c.dst_time.at[dest].set(cons.time[P:2 * P], mode="drop"),
            valid=c.valid.at[dest].set(
                jnp.ones((P,), bool), mode="drop"
            ),
        ),
        next=(bank.next + jnp.sum(sel.astype(jnp.int32))) % R,
    )


def _constraints_from_alignment(
    act_vmap: jnp.ndarray,  # [H,W,3] active prediction vertices (cam frame)
    act_time: jnp.ndarray,  # [H,W] active last-seen ticks
    inact_depth: jnp.ndarray,  # [H,W] inactive prediction depth
    inact_vmap: jnp.ndarray,
    inact_time: jnp.ndarray,
    A: jnp.ndarray,  # active-cam -> inactive-cam correction
    pose: jnp.ndarray,
    stride: int,
) -> dg.Constraint:
    """Surface constraints on a sparse pixel grid (reference builds them on a
    20x-downsampled grid, `ElasticFusion.cpp:443-474`): pull each active
    point onto its ICP-corrected position, and pin the corresponding inactive
    point in place."""
    src_cam = warp.decimate(act_vmap, stride).reshape(-1, 3)
    t_src = warp.decimate(act_time, stride).reshape(-1)
    dst_cam = se3.transform_points(A, src_cam)
    d_in = warp.decimate(inact_depth, stride).reshape(-1)
    pin_cam = warp.decimate(inact_vmap, stride).reshape(-1, 3)
    t_pin = warp.decimate(inact_time, stride).reshape(-1)
    valid = (src_cam[:, 2] > 0) & (d_in > 0)
    src_w = se3.transform_points(pose, src_cam)
    dst_w = se3.transform_points(pose, dst_cam)
    pin_w = se3.transform_points(pose, pin_cam)
    src = jnp.concatenate([src_w, pin_w], axis=0)
    dst = jnp.concatenate([dst_w, pin_w], axis=0)
    time = jnp.concatenate([t_src, t_pin], axis=0)
    vmask = jnp.concatenate([valid, valid & (pin_cam[:, 2] > 0)], axis=0)
    pinned = jnp.concatenate(
        [jnp.zeros_like(valid), jnp.ones_like(valid)], axis=0
    )
    return dg.Constraint(src=src, dst=dst, time=time, valid=vmask, pinned=pinned)


def _reactivate_in_view(
    data, count, pose, t_now, intr, width: int, height: int,
    depth_max: float = 25.0,
):
    """After a successful local loop the inactive region folds back into the
    active window (reference `copy_unstable.vert:150-156`: a deformed surfel
    whose POST-deformation position projects into the current frustum gets
    its last-seen time bumped to now).  Only in-view surfels are reactivated
    — bumping every live surfel would blow the active set past the windowed
    passes' tail block on maps larger than `active_window` and silently drop
    the overflow from fusion (duplicate geometry on the revisited region).

    Called from inside an already-jitted loop program; `data` holds the
    post-`apply_to_map` (deformed) positions, `pose` the corrected pose."""
    idx = jnp.arange(data.shape[0] - 1)
    alive = (data[:-1, sm.CONF] > 0) & (idx < count)
    Tinv = se3.se3_inverse(pose)
    p_c = se3.transform_points(Tinv, data[:-1, sm.POS])
    z = p_c[:, 2]
    zs = jnp.maximum(z, 1e-6)
    u = p_c[:, 0] / zs * intr.fx + intr.cx
    v = p_c[:, 1] / zs * intr.fy + intr.cy
    in_view = (
        (z > 0.05) & (z < depth_max)
        & (u >= 0) & (u < width) & (v >= 0) & (v < height)
    )
    sel = alive & in_view
    col = data[:-1, 12]
    data = data.at[:-1, 12].set(
        jnp.where(sel, jnp.asarray(t_now, jnp.float32), col)
    )
    return data


_LOCAL_LOOP_CACHE: dict = {}


def _make_local_loop(intr, W: int, H: int, cfg: EngineConfig):
    """Build the fully-jitted local-loop device function for a camera/config.

    The ENTIRE check — INACTIVE/ACTIVE renders, model-to-model tracking, the
    acceptance gates, deformation-graph GN, and map/pose application — runs as
    ONE device program with `lax.cond` gates, so a loop check costs one
    dispatch instead of one per op."""
    key = (intr, W, H, cfg)
    if key in _LOCAL_LOOP_CACHE:
        return _LOCAL_LOOP_CACHE[key]
    levels = cfg.pyramid_levels
    iters = cfg.iterations_for_levels()
    win = cfg.active_window if cfg.active_window < cfg.max_surfels else 0

    @jax.jit
    def run(state: stepmod.SlamState, bank: RelBank):
        t_now = state.tick
        t_f = t_now.astype(jnp.float32)
        pred_in = splat.render(
            state.map_data, state.map_count, state.pose, intr, W, H,
            t_now, time_delta=cfg.time_delta, mode=splat.MODE_INACTIVE,
        )
        inact_frac = jnp.mean((pred_in.depth > 0).astype(jnp.float32))

        def attempt(op):
            data, count = op
            pred_act = splat.render(
                data, count, state.pose, intr, W, H, t_now,
                time_delta=cfg.time_delta, mode=splat.MODE_ACTIVE, window=win,
            )
            model = odometry.build_model_pyramid(
                pred_in.intensity, pred_in.vmap, pred_in.nmap, levels
            )
            frame = odometry.frame_pyramid_from_maps(
                pred_act.intensity, pred_act.vmap, pred_act.nmap, levels
            )
            res = odometry.track(
                model, frame, jnp.eye(4, dtype=jnp.float32), intr,
                iterations=iters, icp_weight=cfg.icp_weight,
                use_so3=False,  # predictions share the pose
            )
            n_valid = jnp.sum((pred_act.depth > 0).astype(jnp.float32))
            inlier_frac = res.icp_inliers / jnp.maximum(n_valid, 1.0)
            # acceptance mirrors `ElasticFusion.cpp:427-442`: inlier count
            # (icpCountThresh, scaled from the reference's VGA operating
            # point), ICP error, and the covariance-diagonal gate
            count_gate = cfg.icp_count_thresh * (W * H) / (640.0 * 480.0)
            cov_ok = jnp.all(
                jnp.diag(odometry.covariance(res)) < cfg.cov_thresh
            )
            go = (
                ~res.failed
                & (inlier_frac >= cfg.loop_inlier_frac)
                & (res.icp_inliers >= count_gate)
                & (res.icp_error <= cfg.loop_icp_err_thresh)
                & cov_ok
            )

            def deform(op2):
                d2, c2 = op2
                cons = _constraints_from_alignment(
                    pred_act.vmap, pred_act.time, pred_in.depth,
                    pred_in.vmap, pred_in.time, res.A, state.pose,
                    cfg.loop_constraint_stride,
                )
                graph = dg.sample_graph(
                    d2, c2, max_nodes=cfg.max_deform_nodes,
                    sample_rate=cfg.deform_graph_sample_rate,
                )
                # anchor the old (inactive-epoch) part; deform the recent part
                frozen = graph.time < (t_f - cfg.time_delta)
                graph2, stats = dg.optimise(
                    graph, cons, frozen=frozen, rel=bank.cons
                )
                accept = stats.mean_cons_error <= cfg.loop_cons_err_thresh
                n_src = cons.src.shape[0] // 2  # [actives..., pins...]

                def apply_fn(op3):
                    d3, c3 = op3
                    d4 = dg.apply_to_map(d3, c3, graph2)
                    npse = dg.apply_to_pose(graph2, state.pose, t_f)
                    d4 = _reactivate_in_view(
                        d4, c3, npse, t_now, intr, W, H,
                        depth_max=cfg.max_depth,
                    )
                    return d4, npse, graph2, _emit_relative(
                        bank, graph2, cons, n_src
                    )

                def no_apply(op3):
                    d3, _ = op3
                    return (
                        d3, state.pose, dg.empty_graph(cfg.max_deform_nodes),
                        bank,
                    )

                d5, npse, g_out, bank_out = jax.lax.cond(
                    accept, apply_fn, no_apply, (d2, c2)
                )
                return d5, npse, accept, stats.mean_cons_error, g_out, bank_out

            def no_deform(op2):
                d2, _ = op2
                return (
                    d2, state.pose, jnp.asarray(False), jnp.float32(0.0),
                    dg.empty_graph(cfg.max_deform_nodes), bank,
                )

            d6, npse, closed, cons_err, g_out, bank_out = jax.lax.cond(
                go, deform, no_deform, (data, count)
            )
            return (
                d6, npse, closed, cons_err, inlier_frac, res.icp_error,
                g_out, bank_out,
            )

        def skip(op):
            data, _ = op
            return (
                data, state.pose, jnp.asarray(False), jnp.float32(0.0),
                jnp.float32(0.0), jnp.float32(0.0),
                dg.empty_graph(cfg.max_deform_nodes), bank,
            )

        (
            data, new_pose, closed, cons_err, inlier_frac, icp_err, g_out,
            bank_out,
        ) = jax.lax.cond(
            inact_frac >= cfg.loop_min_inactive_frac, attempt, skip,
            (state.map_data, state.map_count),
        )
        new_state = state._replace(
            map_data=data,
            pose=new_pose,
            model_age=jnp.where(
                closed, stepmod.MODEL_INVALID_AGE, state.model_age
            ).astype(jnp.int32),
        )
        info_vec = jnp.stack(
            [
                closed.astype(jnp.float32), inact_frac, inlier_frac,
                icp_err, cons_err,
            ]
        )
        return new_state, info_vec, g_out, bank_out

    _LOCAL_LOOP_CACHE[key] = run
    return run


def try_local_loop(
    state: stepmod.SlamState,
    camera: CameraConfig,
    cfg: EngineConfig,
    rel_bank: Optional[RelBank] = None,
) -> Tuple[stepmod.SlamState, LoopInfo, dg.DeformGraph, RelBank]:
    """Attempt a local (active-vs-inactive) loop closure at the current pose.

    Mirrors `ElasticFusion.cpp:399-495`: INACTIVE combinedPredict ->
    model-to-model `getIncrementalTransformation` -> covariance/inlier/error
    gates -> constraints -> `localDeformation.constrain` -> apply.  One
    jitted device program; a single scalar-vector fetch reports the outcome.

    Also returns the applied deformation graph (all-invalid when not closed)
    so the caller can correct its pose history and fern poses, mirroring
    `Deformation::constrain` binding the pose graph (`Deformation.cpp:106-124`).
    """
    run = _make_local_loop(
        camera.intrinsics, camera.resolution.width, camera.resolution.height,
        cfg,
    )
    if rel_bank is None:
        rel_bank = make_rel_bank()
    state, info_vec, graph, rel_bank = run(state, rel_bank)
    v = np.asarray(info_vec)
    return state, LoopInfo(
        attempted=True,
        closed=bool(v[0] > 0),
        inactive_frac=float(v[1]),
        inlier_frac=float(v[2]),
        icp_error=float(v[3]),
        cons_error=float(v[4]),
    ), graph, rel_bank


class FernLoopState(NamedTuple):
    coder: fernmod.FernCoder
    db: fernmod.FernDB


def fern_factor(cfg: EngineConfig) -> int:
    """Fern downsampling factor (reference operates at pyramid level
    `fern_pyr_level`, default 3 = 8x)."""
    return 1 << cfg.fern_pyr_level


def make_fern_state(
    camera: CameraConfig, cfg: EngineConfig, capacity: Optional[int] = None
) -> FernLoopState:
    f = fern_factor(cfg)
    w8, h8 = camera.resolution.width // f, camera.resolution.height // f
    return FernLoopState(
        coder=fernmod.make_coder(
            w8, h8, cfg.depth_cutoff, num_ferns=cfg.num_ferns
        ),
        db=fernmod.empty_db(
            capacity or cfg.fern_db_capacity, h8, w8, num_ferns=cfg.num_ferns
        ),
    )


def update_ferns(
    fs: FernLoopState,
    rgb: jnp.ndarray,
    depth_m: jnp.ndarray,
    intensity: jnp.ndarray,
    pose: jnp.ndarray,
    t_now: int,
    thresh: float,
    factor: int = 8,
    max_capacity: int = 4096,
) -> Tuple[FernLoopState, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Encode the frame, query the DB (excluding the recent past), and insert
    if novel.  Returns (state, code, best_idx, best_dissim).  The DB doubles
    in capacity when full (up to `max_capacity`), mirroring the reference's
    unbounded keyframe vector; once at `max_capacity` novel frames EVICT the
    most redundant stored keyframe instead of being refused (the reference
    never stops accepting — `Ferns.h:76-89` — so neither do we)."""
    db = fs.db
    if (
        db.codes.shape[0] < max_capacity
        and int(db.count) >= db.codes.shape[0] - 1
    ):
        db = fernmod.grow_db(db)
    rgb8 = fernmod.downsample_for_ferns(jnp.asarray(rgb, jnp.float32), factor)
    d8 = fernmod.downsample_for_ferns(depth_m, factor)
    i8 = fernmod.downsample_for_ferns(intensity, factor)
    code = fernmod.encode(fs.coder, rgb8, d8)
    idx, dis = fernmod.best_match(db, code)
    db, _added = fernmod.add_frame(
        db, code, pose, i8, d8, time=t_now, min_dissim=dis, thresh=thresh,
        evict=db.codes.shape[0] >= max_capacity,
    )
    return FernLoopState(coder=fs.coder, db=db), code, idx, dis


def fern_recovery_pose(fs: FernLoopState, idx: int) -> np.ndarray:
    return np.asarray(fs.db.poses[idx])


def apply_hybrid_loop(
    state: stepmod.SlamState,
    correction: np.ndarray,  # [4,4] world-frame transform: corrected = C @ current
    camera: CameraConfig,
    cfg: EngineConfig,
    rel_bank: Optional[RelBank] = None,
) -> Tuple[stepmod.SlamState, LoopInfo, dg.DeformGraph]:
    """Global loop closure driven by an external (sparse-tracker) pose pair
    (reference hybrid path, `ElasticFusion.cpp:292-355`: an ORB loop-closure
    candidate supplies orbTcwOld/orbTcwNew; surface constraints built on a
    sparse grid of the predicted view drive the *global* deformation with the
    old epoch anchored).

    `correction` is the world-frame rigid transform mapping the current
    (drifted) layout onto the loop-consistent one: it comes from the sparse
    tracker's (pose_estimate, pose_corrected) pair as
    ``C = pose_corrected @ inv(pose_estimate)``.
    """
    run = _make_hybrid_loop(
        camera.intrinsics, camera.resolution.width, camera.resolution.height,
        cfg,
    )
    if rel_bank is None:
        rel_bank = make_rel_bank()
    state, info_vec, graph = run(
        state, jnp.asarray(correction, jnp.float32), rel_bank
    )
    v = np.asarray(info_vec)
    return state, LoopInfo(
        attempted=True, closed=bool(v[0] > 0), inactive_frac=0.0,
        inlier_frac=1.0, icp_error=0.0, cons_error=float(v[1]),
    ), graph


_HYBRID_LOOP_CACHE: dict = {}


def _make_hybrid_loop(intr, W: int, H: int, cfg: EngineConfig):
    """Fully-jitted hybrid/global loop device program (one dispatch, as
    `_make_local_loop`)."""
    key = (intr, W, H, cfg)
    if key in _HYBRID_LOOP_CACHE:
        return _HYBRID_LOOP_CACHE[key]
    stride = cfg.loop_constraint_stride
    win = cfg.active_window if cfg.active_window < cfg.max_surfels else 0

    @jax.jit
    def run(state: stepmod.SlamState, C: jnp.ndarray, bank: RelBank):
        t_now = state.tick
        t_f = t_now.astype(jnp.float32)
        pred_act = splat.render(
            state.map_data, state.map_count, state.pose, intr, W, H,
            t_now, time_delta=cfg.time_delta, mode=splat.MODE_ACTIVE,
            window=win,
        )
        pred_in = splat.render(
            state.map_data, state.map_count, state.pose, intr, W, H,
            t_now, time_delta=cfg.time_delta, mode=splat.MODE_INACTIVE,
        )
        src_cam = warp.decimate(pred_act.vmap, stride).reshape(-1, 3)
        t_src = warp.decimate(pred_act.time, stride).reshape(-1)
        valid = src_cam[:, 2] > 0
        src_w = se3.transform_points(state.pose, src_cam)
        dst_w = se3.transform_points(C, src_w)
        pin_cam = warp.decimate(pred_in.vmap, stride).reshape(-1, 3)
        t_pin = warp.decimate(pred_in.time, stride).reshape(-1)
        pin_w = se3.transform_points(state.pose, pin_cam)
        pin_ok = pin_cam[:, 2] > 0
        cons = dg.Constraint(
            src=jnp.concatenate([src_w, pin_w]),
            dst=jnp.concatenate([dst_w, pin_w]),
            time=jnp.concatenate([t_src, t_pin]),
            valid=jnp.concatenate([valid, pin_ok]),
            pinned=jnp.concatenate(
                [jnp.zeros_like(valid), jnp.ones_like(pin_ok)]
            ),
        )
        graph = dg.sample_graph(
            state.map_data, state.map_count,
            max_nodes=cfg.max_deform_nodes,
            sample_rate=cfg.deform_graph_sample_rate,
        )
        frozen = graph.time < (t_f - cfg.time_delta)
        graph2, stats = dg.optimise(graph, cons, frozen=frozen, rel=bank.cons)
        # the reference relaxes acceptance for hybrid/global matches
        # (`Deformation.cpp:165`: meanConsError < 3e-4 && error < 0.12 in
        # their units; we scale our gate by 2x vs local loops)
        accept = stats.mean_cons_error <= 2.0 * cfg.loop_cons_err_thresh

        def apply_fn(op):
            d2, c2 = op
            d3 = dg.apply_to_map(d2, c2, graph2)
            npse = C @ state.pose
            d3 = _reactivate_in_view(
                d3, c2, npse, t_now, intr, W, H, depth_max=cfg.max_depth
            )
            return d3, npse, graph2

        def no_apply(op):
            d2, _ = op
            return d2, state.pose, dg.empty_graph(cfg.max_deform_nodes)

        data, new_pose, g_out = jax.lax.cond(
            accept, apply_fn, no_apply, (state.map_data, state.map_count)
        )
        new_state = state._replace(
            map_data=data,
            pose=new_pose,
            model_age=jnp.where(
                accept, stepmod.MODEL_INVALID_AGE, state.model_age
            ).astype(jnp.int32),
        )
        info_vec = jnp.stack(
            [accept.astype(jnp.float32), stats.mean_cons_error]
        )
        return new_state, info_vec, g_out

    _HYBRID_LOOP_CACHE[key] = run
    return run


# ---------------------------------------------------------------------------
# Inter-map (collaborative) merging — reference `ReferenceFrame`:
# `resolveRelativeTransformationFern` (:34-119) finds another map's fern
# keyframe matching the current view and ICP-refines the relative transform;
# `consumeReferenceFrame` (:121-150) then transforms and absorbs the other
# map's surfels, ferns, poses and constraints.
# ---------------------------------------------------------------------------


@jax.jit
def _transform_rows(data_a: jnp.ndarray, count_a: jnp.ndarray, T: jnp.ndarray):
    """Transform map A's live rows into another map's world frame and compact
    them to the front.  Returns (rows [Na,16], n_alive)."""
    Na = data_a.shape[0] - 1
    rows = data_a[:-1]
    idx = jnp.arange(Na)
    alive = (rows[:, sm.CONF] > 0) & (idx < count_a)
    pos = se3.transform_points(T, rows[:, sm.POS])
    nrm = se3.rotate_vectors(T, rows[:, sm.NORMAL])
    rows = rows.at[:, sm.POS].set(pos)
    rows = rows.at[:, sm.NORMAL].set(nrm)
    rows = rows.at[:, sm.CONF].set(jnp.where(alive, rows[:, sm.CONF], 0.0))
    order = jnp.argsort(~alive, stable=True)
    return rows[order], jnp.sum(alive.astype(jnp.int32))


@jax.jit
def merge_maps(
    data_b: jnp.ndarray,
    count_b: jnp.ndarray,
    data_a: jnp.ndarray,
    count_a: jnp.ndarray,
    T_ab: jnp.ndarray,  # map-A world -> map-B world
):
    """Absorb map A into map B (reference `GlobalModel::consume` /
    `mergePointClouds`): transform A's surfels by T_ab, append after B's
    count, then re-sort the combined map by creation tick so the deformation
    graph's time-ordered node sampling stays valid."""
    Nb = data_b.shape[0] - 1
    rows_a, n_alive = _transform_rows(data_a, count_a, T_ab)
    S = min(rows_a.shape[0], Nb)
    n_take = jnp.minimum(n_alive, jnp.maximum(Nb - count_b - 1, 0))
    dropped = n_alive - n_take  # overflow accounting (surfaced, not silent)
    start = jnp.clip(count_b, 0, Nb - S)
    off = count_b - start
    existing = jax.lax.dynamic_slice(data_b, (start, 0), (S, 16))
    i_rows = jax.lax.broadcasted_iota(jnp.int32, (S, 1), 0)[:, 0]
    keep = (i_rows >= off) & (i_rows - off < n_take)
    packed = jnp.roll(rows_a[:S], off, axis=0)
    blended = jnp.where(keep[:, None], packed, existing)
    data = jax.lax.dynamic_update_slice(data_b, blended, (start, 0))
    count = jnp.minimum(count_b + n_take, Nb).astype(jnp.int32)
    # NO global temporal re-sort: the deformation graph sorts its sampled
    # NODES by time (`deformation.sample_graph`), so map rows need not be
    # time-ordered — an O(N log N) argsort+gather over the full capacity per
    # merge would be hostile at the reference's 32.5M-surfel scale.  The
    # next periodic compaction restores the [inactive..., active...]
    # partition the windowed hot passes rely on.
    return data, count, dropped


@jax.jit
def consume_ferns(db_b: fernmod.FernDB, db_a: fernmod.FernDB, T_ab: jnp.ndarray) -> fernmod.FernDB:
    """Absorb map A's fern keyframes into B's DB with poses transformed
    (reference `Ferns::consume`, `Ferns.cpp:170-177`)."""
    K = db_b.codes.shape[0]
    room = K - db_b.count
    take = jnp.minimum(db_a.count, room)
    ka = db_a.codes.shape[0]
    src_idx = jnp.arange(ka)
    dest = jnp.where(src_idx < take, db_b.count + src_idx, K)  # K = drop

    def put(arr_b, arr_a, transform=None):
        vals = arr_a if transform is None else transform(arr_a)
        return arr_b.at[dest].set(vals, mode="drop")

    return fernmod.FernDB(
        codes=put(db_b.codes, db_a.codes),
        poses=put(db_b.poses, db_a.poses, lambda p: jnp.einsum("ij,kjl->kil", T_ab, p)),
        intensity=put(db_b.intensity, db_a.intensity),
        depth=put(db_b.depth, db_a.depth),
        times=put(db_b.times, db_a.times),
        count=db_b.count + take,
    )


def verify_recovery(
    frame_pyr,
    recovery: jnp.ndarray,  # [4,4] candidate camera pose in the map's frame
    map_data: jnp.ndarray,
    map_count: jnp.ndarray,
    camera: CameraConfig,
    cfg: EngineConfig,
    info: Optional[dict] = None,
):
    """Geometric verification of a candidate pose: render the map at the
    recovery pose, dense-track the live frame onto the render, and gate on
    inlier count (`icp_count_thresh`), ICP error (`icp_err_thresh` scale) and
    pose covariance (`cov_thresh`) — the reference `Ferns::findFrame` ICP
    refinement + acceptance (`Ferns.cpp:277-423`: ICPerr<3e-4, inliers>400,
    covariance gate in `ElasticFusion.cpp:359-394,427-442` and
    `ReferenceFrame.h:98-110`).

    Returns (refined pose [4,4] np or None, ok: bool, info dict)."""
    intr = camera.intrinsics
    W, H = camera.resolution.width, camera.resolution.height
    info = {} if info is None else info
    pred = splat.render(
        map_data, map_count, recovery, intr, W, H, 0, mode=splat.MODE_ALL,
    )
    coverage = float(jnp.mean((pred.depth > 0).astype(jnp.float32)))
    info["coverage"] = coverage
    if coverage < 0.2:
        return None, False, info
    model = odometry.build_model_pyramid(
        pred.intensity, pred.vmap, pred.nmap, cfg.pyramid_levels
    )
    res = odometry.track(
        model, frame_pyr, jnp.eye(4, dtype=jnp.float32), intr,
        iterations=cfg.iterations_for_levels(),
        icp_weight=cfg.icp_weight,
        use_so3=True,
    )
    n_valid = float(jnp.sum((frame_pyr.vmap[0][..., 2] > 0).astype(jnp.float32)))
    inlier_frac = float(res.icp_inliers) / max(n_valid, 1.0)
    # the reference's absolute inlier-count gate, scaled from its VGA
    # operating point (icpCountThresh=35000 at 640x480)
    count_gate = cfg.icp_count_thresh * (W * H) / (640.0 * 480.0)
    cov_diag = np.asarray(jnp.diag(odometry.covariance(res)))
    info.update(
        inlier_frac=inlier_frac,
        icp_error=float(res.icp_error),
        icp_inliers=float(res.icp_inliers),
        cov_max=float(cov_diag.max()),
    )
    if (
        bool(res.failed)
        or inlier_frac < cfg.loop_inlier_frac
        or float(res.icp_inliers) < count_gate
        or float(res.icp_error) > cfg.loop_icp_err_thresh
        or cov_diag.max() > cfg.cov_thresh
    ):
        return None, False, info
    return np.asarray(recovery @ res.A), True, info


def resolve_intermap(
    frame_pyr,
    fern_code: jnp.ndarray,
    other_db: fernmod.FernDB,
    other_map_data: jnp.ndarray,
    other_map_count: jnp.ndarray,
    camera: CameraConfig,
    cfg: EngineConfig,
    dissim_thresh: float = 0.45,
):
    """Try to localise the current frame inside ANOTHER map (reference
    `resolveRelativeTransformationFern`): fern retrieval in the other map ->
    render its model at the recovery pose -> dense ICP refinement -> gates.

    Returns (pose_in_other_map [4,4] np, ok: bool, info dict)."""
    idx, dis = fernmod.best_match(other_db, fern_code)
    info = {"dissim": float(dis)}
    if float(dis) > dissim_thresh:
        return None, False, info
    return verify_recovery(
        frame_pyr, other_db.poses[idx], other_map_data, other_map_count,
        camera, cfg, info,
    )
