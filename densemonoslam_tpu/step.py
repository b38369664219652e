"""The fused per-frame SLAM step: one jitted device function per camera tick.

This is the answer to the reference's `processFrame` state machine
(`Core/src/ElasticFusion.cpp:99-637`): where the reference interleaves GPU
kernels with host logic every frame (texture uploads, 29-float reduction
downloads, Eigen solves, GUI state), here the ENTIRE per-frame pipeline —
preprocess, model prediction, fill-in, SO3+ICP+RGB tracking, the NID fuse
gate, fusion, cleaning, keyframe promotion — is a single jitted function over
a device-resident `SlamState`.  The host feeds frames and receives a small
stats vector + pose without ever blocking mid-sequence (JAX async dispatch
pipelines the whole run).

Data-dependent decisions (fuse or not, tracking failed, bootstrap) are
`lax.cond`/`jnp.where` branches on device — the reference's host `if`s.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from densemonoslam_tpu.config import CameraIntrinsics, EngineConfig
from densemonoslam_tpu.mapping import fillin, fusion, keyframe as kfmod
from densemonoslam_tpu.mapping import surfel_map as sm
from densemonoslam_tpu.ops import geometry, preprocess, reductions, splat
from densemonoslam_tpu.tracking import odometry
from densemonoslam_tpu.utils import se3


class SlamState(NamedTuple):
    """Device-resident per-camera SLAM state."""

    map_data: jnp.ndarray  # [N+1, 16]
    map_count: jnp.ndarray  # [] i32
    pose: jnp.ndarray  # [4,4] camera-to-world
    tick: jnp.ndarray  # [] i32
    kf_pose: jnp.ndarray  # [4,4]
    kf_intensity: jnp.ndarray  # [H,W]
    kf_depth: jnp.ndarray  # [H,W]
    kf_count: jnp.ndarray  # [] i32 number of keyframes so far (0 = none yet)
    # stored map prediction (last ACTIVE-mode render, reference predict,
    # `ElasticFusion.cpp:586,688-746`).  Each frame composites it with its own
    # live data (FillIn) and tracks against the result WITHOUT re-rendering
    # the map; the render refreshes on fusion / large motion / age (see
    # `make_step`).  Camera-frame maps at `model_pose`.
    pred_intensity: jnp.ndarray  # [H,W]
    pred_vmap: jnp.ndarray  # [H,W,3]
    pred_nmap: jnp.ndarray  # [H,W,3]
    pred_depth: jnp.ndarray  # [H,W] (0 = hole)
    model_pose: jnp.ndarray  # [4,4] render pose of the stored prediction
    model_rel: jnp.ndarray  # [4,4] pose relative to model_pose (tracked
    # incrementally so the GN warm start is EXACTLY identity right after a
    # refresh — recomputing inv(model_pose) @ pose would inject float noise)
    model_age: jnp.ndarray  # [] i32 frames since refresh (big = invalid)
    consec_bad: jnp.ndarray  # [] i32 consecutive badly-tracked frames
    # (reference lost-detection counter, `ElasticFusion.cpp:204-244`: >10
    # consecutive bad frames => lost).  Device-resident so relocalisation
    # mode costs no per-frame host sync; the engine reads it (via the stats
    # vector) only at the loop-check cadence.


# stats vector layout (host-side decoding)
STAT_TRACK_OK = 0
STAT_ICP_ERR = 1
STAT_ICP_INL = 2
STAT_RGB_ERR = 3
STAT_NID = 4
STAT_FUSED = 5
STAT_MATCHED = 6
STAT_ADDED = 7
STAT_CULLED = 8
STAT_SURFELS = 9
STAT_KEYFRAMES = 10
STAT_CONSEC_BAD = 11
STAT_DROPPED = 12
N_STATS = 13
# the tracked pose rides the stats vector (rows 13:29, row-major 4x4): stats
# is a FRESH per-frame device output (never donated), so the engine's pose
# history can queue these rows host-side and flush them in one batched
# scatter — holding `state.pose` instead would reference a buffer the next
# step's donation deletes, and appending per frame costs a dispatch gap.
# (The reference similarly downloads one fused stats+pose readback per frame,
# `ElasticFusion.cpp:204-244`.)
STAT_POSE0 = 13
N_STATS_TOTAL = N_STATS + 16


MODEL_INVALID_AGE = 1 << 20  # marks the stored model as unusable


def init_state(
    capacity: int, height: int, width: int, levels: int = 3
) -> SlamState:
    del levels  # kept for call-site compatibility
    return SlamState(
        map_data=jnp.zeros((capacity + 1, sm.COLS), jnp.float32),
        map_count=jnp.array(0, jnp.int32),
        pose=jnp.eye(4, dtype=jnp.float32),
        tick=jnp.array(0, jnp.int32),
        kf_pose=jnp.eye(4, dtype=jnp.float32),
        kf_intensity=jnp.zeros((height, width), jnp.float32),
        kf_depth=jnp.zeros((height, width), jnp.float32),
        kf_count=jnp.array(0, jnp.int32),
        pred_intensity=jnp.zeros((height, width), jnp.float32),
        pred_vmap=jnp.zeros((height, width, 3), jnp.float32),
        pred_nmap=jnp.zeros((height, width, 3), jnp.float32),
        pred_depth=jnp.zeros((height, width), jnp.float32),
        model_pose=jnp.eye(4, dtype=jnp.float32),
        model_rel=jnp.eye(4, dtype=jnp.float32),
        model_age=jnp.array(MODEL_INVALID_AGE, jnp.int32),
        consec_bad=jnp.array(0, jnp.int32),
    )


def make_step(
    intr: CameraIntrinsics,
    height: int,
    width: int,
    config: EngineConfig,
    sensor: int = 0,
):
    """Build the jitted per-frame step for a camera geometry + config."""
    cfg = config
    levels = cfg.pyramid_levels
    iterations = cfg.iterations_for_levels()
    # per-sensor tracking weight (`--ipt`): this camera's ICP-vs-RGB weight
    pss = cfg.icp_weight_per_sensor
    icp_weight = (
        pss[sensor] if pss is not None and sensor < len(pss) else cfg.icp_weight
    )
    # hot ACTIVE-mode passes stream only the active tail block
    win = cfg.active_window if cfg.active_window < cfg.max_surfels else 0

    def step(
        state: SlamState,
        rgb: jnp.ndarray,  # [H,W,3] u8/f32
        depth_raw: jnp.ndarray,  # [H,W] raw units
        in_pose: jnp.ndarray,  # [4,4] external pose (GT/ORB), identity if unused
        use_in_pose: jnp.ndarray,  # [] bool
        weight_mult: jnp.ndarray,  # [] f32
        cluster_id: jnp.ndarray = jnp.float32(0.0),  # [] per-frame cluster
    ) -> Tuple[SlamState, jnp.ndarray]:
        t_now = state.tick
        # ---------------- preprocess ----------------------------------
        # tracking sees depth out to `max_depth` (reference maxDepthProcessed
        # = 25 m, `ElasticFusion.cpp:56,178-184`); fusion and the NID gate are
        # cut at `depth_cutoff` (`--d`, default 3 m)
        depth_track = preprocess.metricise_depth(
            depth_raw, cfg.depth_factor, max(cfg.max_depth, cfg.depth_cutoff)
        )
        depth_m = jnp.where(depth_track <= cfg.depth_cutoff, depth_track, 0.0)
        depth_f = preprocess.bilateral_filter_depth(depth_track)
        vmap_f = geometry.backproject(depth_m, intr)
        nmap_f = geometry.normal_map(vmap_f)
        if cfg.icl_nuim:
            nmap_f = -nmap_f
        intensity = preprocess.rgb_to_intensity(rgb)
        frame_pyr = odometry.build_frame_pyramid(rgb, depth_f, intr, levels)

        first = state.map_count == 0

        # ---------------- track against the stored prediction ----------
        # The tracking model is the stored prediction AS-IS: hole pixels stay
        # INVALID and contribute no residual rows.  Filling holes with the
        # live frame (reference `FillIn` before tracking) would create
        # self-matching rows with zero residual at the warm start — with
        # partial model coverage those rows act as an anchor on the previous
        # pose and systematically shrink the estimated motion (measured:
        # centimetre-per-frame drift at 60% coverage).  The model pixels
        # alone constrain all 6 DoF whenever the map covers a usable fraction
        # of the view; when it covers (almost) nothing, tracking fails
        # honestly and the lost/relocalisation machinery takes over instead
        # of silently free-running.  (The post-fuse refresh below still
        # composites via `fillin.fill_in` — after fusion the frame content
        # genuinely IS map content.)  A_init warm-starts GN at the previous
        # frame's pose relative to the prediction's render pose.
        model_pyr = odometry.build_model_pyramid(
            state.pred_intensity, state.pred_vmap, state.pred_nmap, levels
        )
        A_init = state.model_rel
        res = odometry.track(
            model_pyr, frame_pyr, A_init,
            intr,
            iterations=iterations,
            icp_weight=icp_weight,
            rgb_only=cfg.rgb_only,
            pyramid=cfg.pyramid,
            use_so3=cfg.so3,
            row_stride=cfg.track_row_stride,
        )
        tracked_pose = state.model_pose @ res.A
        tracking_ok = ~res.failed & (state.model_age < MODEL_INVALID_AGE)
        new_pose = jnp.where(first | ~tracking_ok, state.pose, tracked_pose)
        new_pose = jnp.where(use_in_pose, in_pose, new_pose)
        ok = first | tracking_ok | use_in_pose
        # lost-detection (reference `--rl` ok-test: ICP error < 1e-4 AND all
        # six covariance diagonals < 1e-4, `ElasticFusion.cpp:204-244`; >10
        # consecutive bad frames => lost).  Stays on device: the engine polls
        # the counter through the stats vector at loop-check cadence only.
        # fraction of the tracked view actually covered by the model render
        # (used by the lost detector, and by the fuse gate below)
        model_cover = jnp.mean((state.pred_depth > 0).astype(jnp.float32))
        if cfg.relocalisation:
            # closed-form diag of the 6x6 covariance: a handful of vector ops
            # instead of jnp.linalg.inv's LU
            cov_d = reductions.diag_inv_6x6(res.JtJ)
            # when the map renders to (almost) nothing at the current pose,
            # the fill-in composite degrades tracking to frame-to-frame —
            # residuals look healthy but say nothing about the map, so low
            # model coverage must count as a bad frame or a teleported/lost
            # camera would never trip the counter
            bad = (
                (
                    (~tracking_ok)
                    | (res.icp_error > 1e-4)
                    | jnp.any(cov_d > 1e-4)
                    | (model_cover < 0.1)
                )
                & ~first
                & ~use_in_pose
            )
            consec_bad = jnp.where(bad, state.consec_bad + 1, 0).astype(jnp.int32)
            lost = consec_bad > 10
        else:
            consec_bad = jnp.array(0, jnp.int32)
            lost = jnp.asarray(False)
        # velocity-based fusion weighting (reference ElasticFusion.cpp:252-268)
        vel = jnp.linalg.norm(new_pose[:3, 3] - state.pose[:3, 3])
        weight_mult = weight_mult * jnp.clip(1.0 - vel / 0.3, 0.25, 1.0)

        # tracking support: fraction of the valid frame pixels that became
        # ICP inliers against the model prediction — the direct measure of
        # how much of the view the stored model still explains (reference
        # reaches the same quantity through denseEnough/icpCountThresh,
        # `ElasticFusion.cpp:166-167,204-244`)
        # normalise by the EFFECTIVE row count: `_gn_level` only decimates
        # residual rows when the finest level keeps >= 4096 of them, so at
        # small resolutions the inlier count is unstrided and dividing by
        # stride^2 would inflate support ~stride^2 (disabling the force-fuse
        # and model-refresh gates exactly when they matter)
        stride_eff = (
            cfg.track_row_stride
            if (height * width) // (cfg.track_row_stride ** 2) >= 4096
            else 1
        )
        n_frame_valid = jnp.sum(
            (frame_pyr.vmap[0][..., 2] > 0).astype(jnp.float32)
        ) / float(stride_eff ** 2)
        support = res.icp_inliers / jnp.maximum(n_frame_valid, 1.0)

        # ---------------- NID fuse gate -------------------------------
        if cfg.nid_keyframing:
            n_img, n_depth, overlap = kfmod.nid_against_keyframe(
                kfmod.KeyFrame(
                    pose=state.kf_pose,
                    intensity=state.kf_intensity,
                    depth=state.kf_depth,
                ),
                intensity, vmap_f, new_pose, intr,
                depth_max=cfg.depth_cutoff,
                bins_img=cfg.nid_bins_img,
                bins_depth=cfg.nid_bins_depth,
                stride=cfg.nid_stride,
            )
            nid = kfmod.nid_score(n_img, n_depth, cfg.nid_depth_weight)
            # low TRACKING SUPPORT forces fusion regardless of the NID score:
            # the NID measures appearance novelty against the keyframe, but a
            # partially built map can slide out from under the camera even
            # when the appearance looks familiar — once the inlier fraction
            # of the frame decays, the solve degenerates (few DoF observable)
            # and the pose jumps.  Fusing while support is still healthy
            # keeps the model under the camera (the reference reaches the
            # same end through denseEnough/shouldFillIn + icpCountThresh,
            # `ElasticFusion.cpp:166-167,204-244`).
            novel = (
                (nid > cfg.nid_threshold)
                | (overlap < 0.1)
                | (support < 0.75)
                | (model_cover < 0.5)
            )
            do_fuse = ok & (first | (state.kf_count == 0) | novel)
        else:
            nid = jnp.array(0.0, jnp.float32)
            do_fuse = ok
        # a lost camera must not corrupt the map (reference stops fusing
        # when lost, `ElasticFusion.cpp:204-244`).  In reloc mode fusion also
        # requires the model to have been VISIBLE in the tracked frame —
        # otherwise a teleported/lost camera whose fill-in degraded tracking
        # to frame-to-frame would fuse a phantom copy of the scene at the
        # wrong pose (and that phantom would then reset the bad-frame
        # counter by giving the next render full coverage).
        do_fuse = do_fuse & ~lost
        if cfg.relocalisation:
            do_fuse = do_fuse & ((model_cover >= 0.1) | first)

        # ---------------- render + fuse + clean (conditional) ----------
        # One ACTIVE-mode render serves association AND refreshes the stored
        # tracking model (its fill-in composite); it only runs when fusing,
        # after large motion, or when the model ages out — most frames skip
        # the map pass entirely (the map did not change and the view barely
        # moved, so the stored model is still the correct tracking target).
        d_pose = jnp.where(
            use_in_pose,
            se3.se3_inverse(state.model_pose) @ new_pose,
            jnp.where(tracking_ok & ~first, res.A, state.model_rel),
        )
        trans_delta = jnp.linalg.norm(d_pose[:3, 3])
        rot_delta = jnp.arccos(
            jnp.clip((jnp.trace(d_pose[:3, :3]) - 1.0) * 0.5, -1.0, 1.0)
        )
        need_render = (
            first
            | do_fuse
            | (support < cfg.model_min_support)
            | (trans_delta > cfg.model_trans_delta)
            | (rot_delta > cfg.model_rot_delta)
            | (state.model_age + 1 >= cfg.model_max_age)
        )

        # The full-capacity map tensor must never be an OUTPUT of a lax.cond:
        # a conditional that returns the map forces XLA to materialise
        # full-buffer copies that scale with capacity.  So the branches
        # exchange only window-sized blocks; the map itself flows through
        # plain dynamic slice/update ops below, which alias in place.
        N_cap = state.map_data.shape[0] - 1  # shape-derived, not cfg: callers
        # may size the state tensor independently (collab/dryrun harnesses)
        win_n = win if (win > 0 and win < N_cap) else N_cap
        data, count = state.map_data, state.map_count
        win_start = splat.active_window_start(count, N_cap, win_n)
        rows_in = jax.lax.dynamic_slice(
            data, (win_start, 0), (win_n, sm.COLS)
        )
        HW = height * width
        S_pack = min(HW, N_cap)
        # capacity below one frame's pixel count (tiny test maps): the cond
        # output must truncate, so the pack must be sorted new-rows-first
        pack_sorted = S_pack < HW

        def render_branch(rows_op):
            pred = splat.render(
                data, count, new_pose, intr, width, height, t_now,
                time_delta=cfg.time_delta, mode=splat.MODE_ACTIVE, window=win,
            )

            def fuse_br(rows2):
                blk, packed, rank, n_want, matched, culled = fusion.fuse_window(
                    rows2, win_start, count, pred, vmap_f, nmap_f,
                    rgb.astype(jnp.float32), new_pose, intr, time=t_now,
                    sensor=sensor, weight_mult=weight_mult,
                    clean_depth=depth_m,  # inline copy_unstable cull
                    conf_threshold=cfg.confidence_threshold,
                    time_delta=cfg.time_delta,
                    cluster_id=cluster_id,
                    depth_gate_rel=cfg.depth_gate_rel,
                    pack_sorted=pack_sorted,
                )
                return blk, packed[:S_pack], rank[:S_pack], n_want, matched, culled

            def skip_br(rows2):
                zero = jnp.array(0, jnp.int32)
                return (
                    rows2, jnp.zeros((S_pack, sm.COLS), jnp.float32),
                    jnp.full((S_pack,), -1, jnp.int32),
                    zero, zero, zero,
                )

            blk, packed, rank, n_want, matched, culled = jax.lax.cond(
                do_fuse, fuse_br, skip_br, rows_op
            )
            # store the refreshed prediction.  When fused, compositing with
            # the live frame approximates the post-fuse map render: matched
            # pixels moved toward the frame measurement and unmatched valid
            # pixels became new surfels at exactly the frame vertices — so
            # prefer the frame where the pre-fuse prediction has holes.
            # (prediction and frame share `new_pose` here: no transform)
            comp = fillin.fill_in(
                pred.intensity, pred.depth, pred.vmap, pred.nmap,
                intensity, frame_pyr.vmap[0][..., 2],
                frame_pyr.vmap[0], frame_pyr.nmap[0],
            )
            pi = jnp.where(do_fuse, comp.intensity, pred.intensity)
            pv = jnp.where(do_fuse, comp.vmap, pred.vmap)
            pn = jnp.where(do_fuse, comp.nmap, pred.nmap)
            pd = jnp.where(do_fuse, comp.depth, pred.depth)
            return (
                blk, packed, rank, n_want, matched, culled, pi, pv, pn, pd,
                new_pose, jnp.array(0, jnp.int32),
            )

        def keep_branch(rows_op):
            zero = jnp.array(0, jnp.int32)
            return (
                rows_op, jnp.zeros((S_pack, sm.COLS), jnp.float32),
                jnp.full((S_pack,), -1, jnp.int32),
                zero, zero, zero, state.pred_intensity,
                state.pred_vmap, state.pred_nmap, state.pred_depth,
                state.model_pose, state.model_age + 1,
            )

        (
            blk, packed, rank, n_want, matched, culled, pred_int, pred_v,
            pred_n, pred_d, model_pose, model_age,
        ) = jax.lax.cond(need_render, render_branch, keep_branch, rows_in)
        data, count, added, dropped = fusion.place_updates(
            data, count, blk, win_start, packed, n_want, rank
        )
        model_rel = jnp.where(
            need_render, jnp.eye(4, dtype=jnp.float32), d_pose
        )
        # keyframe promotion on fuse.  The NID keyframe snapshots the
        # PREDICTED composite (model render + live fill-in), not the raw
        # frame — the reference KeyFrame captures the predicted
        # active+inactive maps (`KeyFrame.h:83-172`), so the NID gate scores
        # frame-vs-MODEL novelty, not frame-vs-frame.
        kf_pose = jnp.where(do_fuse, new_pose, state.kf_pose)
        kf_int = jnp.where(do_fuse, pred_int, state.kf_intensity)
        kf_dep = jnp.where(
            do_fuse,
            jnp.where(pred_d <= cfg.depth_cutoff, pred_d, 0.0),
            state.kf_depth,
        )
        kf_count = state.kf_count + do_fuse.astype(jnp.int32)

        if cfg.frame_to_frame_rgb:
            # `--ftf`: the RGB model is the raw previous frame, not the map
            # prediction (reference initRGBModel takes the fill-in passthrough
            # image under frameToFrameRGB, `ElasticFusion.cpp:179-181`);
            # geometry (ICP) still tracks frame-to-model.
            pred_int = intensity

        new_state = SlamState(
            map_data=data,
            map_count=count,
            pose=new_pose,
            tick=t_now + 1,
            kf_pose=kf_pose,
            kf_intensity=kf_int,
            kf_depth=kf_dep,
            kf_count=kf_count,
            pred_intensity=pred_int,
            pred_vmap=pred_v,
            pred_nmap=pred_n,
            pred_depth=pred_d,
            model_pose=model_pose,
            model_rel=model_rel,
            model_age=model_age,
            consec_bad=consec_bad,
        )
        stats = jnp.zeros((N_STATS,), jnp.float32)
        stats = stats.at[STAT_TRACK_OK].set(ok.astype(jnp.float32))
        stats = stats.at[STAT_ICP_ERR].set(res.icp_error)
        stats = stats.at[STAT_ICP_INL].set(res.icp_inliers)
        stats = stats.at[STAT_RGB_ERR].set(res.rgb_error)
        stats = stats.at[STAT_NID].set(nid)
        stats = stats.at[STAT_FUSED].set(do_fuse.astype(jnp.float32))
        stats = stats.at[STAT_MATCHED].set(matched.astype(jnp.float32))
        stats = stats.at[STAT_ADDED].set(added.astype(jnp.float32))
        stats = stats.at[STAT_CULLED].set(culled.astype(jnp.float32))
        stats = stats.at[STAT_SURFELS].set(count.astype(jnp.float32))
        stats = stats.at[STAT_KEYFRAMES].set(kf_count.astype(jnp.float32))
        stats = stats.at[STAT_CONSEC_BAD].set(consec_bad.astype(jnp.float32))
        stats = stats.at[STAT_DROPPED].set(dropped.astype(jnp.float32))
        stats = jnp.concatenate([stats, new_pose.reshape(-1)])
        return new_state, stats

    return jax.jit(step, donate_argnums=(0,))
