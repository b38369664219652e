"""Collective inter-map loop closures for collaborative/multi-host sessions.

Reference: `ReferenceFrame::resolveRelativeTransformationFern` finds another
map's fern keyframe matching the current view and ICP-refines the relative
transform; `consumeReferenceFrame` then absorbs the other map
(`Core/src/ReferenceFrame.h:34-150`, `ElasticFusion.cpp:597-631`).  The
host-side sequential engine already mirrors this (`engine._try_intermap` /
`merge_into`); THIS module is the SPMD version for the one-camera-per-device
collaborative layout (`parallel.collab`, BASELINE config 5), where each
camera's map lives on its own device and no host ever holds two maps:

1. every camera keeps a small on-device fern keyframe DB; one collective
   round encodes the current view and inserts it if novel;
2. codes/poses/map-ids are `all_gather`ed (tiny) and every camera picks its
   best candidate among OTHER maps' keyframes — proposals are all-gathered so
   every device sees the same proposal table (replicated decisions, no host);
3. each camera then acts as a SERVER: it renders its own map at the keyframe
   pose a requester asked about (reduced resolution), and the renders ride
   ONE `all_gather`;
4. requesters dense-align their live view onto the received render
   (`odometry.track` at the reduced resolution, the reference's fern-
   resolution ICP refinement) and gate on inliers/error;
5. the lowest-id accepted proposal wins the round; every camera in the
   source map rigidly moves its shard + poses into the destination map's
   frame and adopts its map id.

After a merge the cameras share ONE world frame and map id but keep their
surfels on their own devices — a map SHARDED BY CREATING CAMERA.  This is
the deliberate deviation from the reference's physical
`consumeReferenceFrame` copy (its contexts share one GPU's VBO; our maps are
device-resident).  `consume=True` additionally performs the physical move —
the source camera's rows are routed over the mesh (masked psum) and appended
to the destination camera's map, zeroing the source — which matches the
reference semantics exactly at the cost of one full-map collective.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from densemonoslam_tpu import step as stepmod
from densemonoslam_tpu.config import CameraIntrinsics, EngineConfig
from densemonoslam_tpu.mapping import ferns as fernmod
from densemonoslam_tpu.mapping import surfel_map as sm
from densemonoslam_tpu.ops import splat, warp
from densemonoslam_tpu.tracking import odometry
from densemonoslam_tpu.utils import se3

FERN_K = 32  # keyframes per camera's on-device DB


class IntermapState(NamedTuple):
    """Per-camera device state (leading `cam` axis when batched)."""

    codes: jnp.ndarray  # [K, F] i32
    poses: jnp.ndarray  # [K, 4, 4] keyframe poses (in this camera's map frame)
    times: jnp.ndarray  # [K]
    count: jnp.ndarray  # [] i32
    map_id: jnp.ndarray  # [] i32 — which map this camera currently lives in


def init_state(n_cams: int, num_ferns: int = 500) -> IntermapState:
    one = IntermapState(
        codes=jnp.zeros((FERN_K, num_ferns), jnp.int32),
        poses=jnp.broadcast_to(jnp.eye(4, dtype=jnp.float32), (FERN_K, 4, 4)),
        times=jnp.full((FERN_K,), -1.0, jnp.float32),
        count=jnp.array(0, jnp.int32),
        map_id=jnp.array(0, jnp.int32),
    )
    out = jax.tree.map(lambda v: jnp.stack([v] * n_cams), one)
    # every camera starts in its OWN map
    return out._replace(map_id=jnp.arange(n_cams, dtype=jnp.int32))


def fern_insert(
    ist: IntermapState,
    code: jnp.ndarray,  # [F] i32
    pose: jnp.ndarray,  # [4,4]
    t_now: jnp.ndarray,  # [] f32
    fern_thresh: float,
) -> IntermapState:
    """Novelty-gated keyframe insert into ONE camera's on-device fern DB
    (no leading cam axis).

    Full DB: EVICT the most redundant entry (min NN-dissimilarity to another
    stored entry) instead of freezing — mirrors the host DB's eviction
    (`ferns.add_frame evict`); the reference's keyframe vector is unbounded
    (`Ferns.h:76-89`), so place recognition must keep learning new places on
    long collaborative sessions."""
    k = jnp.arange(FERN_K)
    dis_own = jnp.where(
        k < ist.count,
        jnp.mean((ist.codes != code[None]).astype(jnp.float32), -1),
        1.0,
    )
    min_dis = jnp.min(dis_own)
    add = (min_dis > fern_thresh) | (ist.count == 0)
    full = ist.count >= FERN_K
    pair = jnp.mean(
        (ist.codes[:, None, :] != ist.codes[None, :, :]).astype(jnp.float32),
        -1,
    )  # [K, K]
    stored = k < ist.count
    pair = jnp.where(
        (k[:, None] != k[None, :]) & stored[:, None] & stored[None, :],
        pair, jnp.inf,
    )
    redundancy = jnp.min(pair, axis=1)  # low = near-duplicate of another
    slot = jnp.where(full, jnp.argmin(redundancy), ist.count)
    sel = (k == slot) & add
    return ist._replace(
        codes=jnp.where(sel[:, None], code[None], ist.codes),
        poses=jnp.where(sel[:, None, None], pose[None], ist.poses),
        times=jnp.where(sel, t_now, ist.times),
        count=jnp.minimum(ist.count + add.astype(jnp.int32), FERN_K),
    )


class MergeInfo(NamedTuple):
    merged: jnp.ndarray  # [] bool — did a merge happen this round
    src_map: jnp.ndarray  # [] i32
    dst_map: jnp.ndarray  # [] i32
    requester: jnp.ndarray  # [] i32
    target: jnp.ndarray  # [] i32
    map_ids: jnp.ndarray  # [n_cams] i32 post-round map ids
    T: jnp.ndarray  # [n_cams, 4, 4] per-camera applied transform
    # per-camera verification stats [n_cams, 4]:
    # (proposing, inlier_frac, icp_error, best_dissim)
    stats: jnp.ndarray
    dropped: jnp.ndarray  # [] i32 rows lost to capacity in a consume append


def make_intermap_round(
    mesh: Mesh,
    intr: CameraIntrinsics,
    height: int,
    width: int,
    config: EngineConfig | None = None,
    verify_scale: int = 4,
    fern_factor: int = 4,
    dissim_thresh: float = 0.35,
    min_inlier_frac: float = 0.5,
    icp_err_thresh: float = 5e-4,
    consume: bool = False,
):
    """Build the jitted collective inter-map round (see module docstring)."""
    cfg = config or EngineConfig()
    n_cams = mesh.shape["cam"]
    Hv, Wv = height // verify_scale, width // verify_scale
    intr_v = CameraIntrinsics(
        intr.fx / verify_scale, intr.fy / verify_scale,
        (intr.cx + 0.5) / verify_scale - 0.5,
        (intr.cy + 0.5) / verify_scale - 0.5,
    )
    hf, wf = height // fern_factor, width // fern_factor
    coder = fernmod.make_coder(wf, hf, cfg.depth_cutoff, num_ferns=cfg.num_ferns)
    levels = 3

    def local(state_b, ist_b, rgb_b, depth_b):
        state: stepmod.SlamState = jax.tree.map(lambda v: v[0], state_b)
        ist: IntermapState = jax.tree.map(lambda v: v[0], ist_b)
        rgb = rgb_b[0].astype(jnp.float32)
        depth = depth_b[0]
        me = jax.lax.axis_index("cam")
        t_now = state.tick.astype(jnp.float32)

        # ---- 1. encode + novelty insert into my on-device DB -------------
        rgb8 = fernmod.downsample_for_ferns(rgb, fern_factor)
        d8 = fernmod.downsample_for_ferns(depth, fern_factor)
        code = fernmod.encode(coder, rgb8, d8)
        k = jnp.arange(FERN_K)
        ist = fern_insert(ist, code, state.pose, t_now, cfg.fern_thresh)

        # ---- 2. propose against other maps' keyframes --------------------
        codes_all = jax.lax.all_gather(ist.codes, "cam")  # [n, K, F]
        poses_all = jax.lax.all_gather(ist.poses, "cam")
        counts_all = jax.lax.all_gather(ist.count, "cam")
        mapid_all = jax.lax.all_gather(ist.map_id, "cam")
        diff = jnp.mean(
            (codes_all != code[None, None, :]).astype(jnp.float32), -1
        )  # [n, K]
        cam_ax = jnp.arange(n_cams)
        eligible = (
            (cam_ax[:, None] != me)
            & (mapid_all[:, None] != ist.map_id)
            & (k[None, :] < counts_all[:, None])
        )
        diff = jnp.where(eligible, diff, 1.0)
        flat = jnp.argmin(diff.reshape(-1))
        tgt_cam = (flat // FERN_K).astype(jnp.int32)
        tgt_entry = (flat % FERN_K).astype(jnp.int32)
        best_dis = diff.reshape(-1)[flat]
        proposing = best_dis < dissim_thresh
        props = jax.lax.all_gather(
            jnp.stack(
                [
                    tgt_cam,
                    tgt_entry,
                    proposing.astype(jnp.int32),
                ]
            ),
            "cam",
        )  # [n, 3] replicated

        # ---- 3. serve: render MY map at the asked keyframe pose ----------
        # lowest-id requester asking ME this round
        asks_me = (props[:, 0] == me) & (props[:, 2] > 0)
        any_ask = jnp.any(asks_me)
        req_id = jnp.argmax(asks_me)  # first True (lowest id)
        entry = props[req_id, 1]
        pose_req = ist.poses[entry]
        pred = splat.render(
            state.map_data, state.map_count, pose_req, intr_v, Wv, Hv,
            state.tick, time_delta=cfg.time_delta, mode=splat.MODE_ALL,
            depth_max=cfg.max_depth,
        )
        render_pack = jnp.concatenate(
            [
                pred.intensity[..., None], pred.vmap, pred.nmap,
                pred.depth[..., None],
            ],
            axis=-1,
        )  # [Hv, Wv, 8]
        renders = jax.lax.all_gather(render_pack, "cam")  # [n, Hv, Wv, 8]

        # ---- 4. verify: align my live view onto the target's render ------
        srv = renders[tgt_cam]
        model = odometry.build_model_pyramid(
            srv[..., 0], srv[..., 1:4], srv[..., 4:7], levels
        )
        d_v = warp.decimate(depth, verify_scale)
        i_v = warp.decimate(
            0.299 * rgb[..., 0] + 0.587 * rgb[..., 1] + 0.114 * rgb[..., 2],
            verify_scale,
        )
        frame = odometry.frame_pyramid_from_depth_intensity(
            i_v, d_v, intr_v, levels
        )
        res = odometry.track(
            model, frame, jnp.eye(4, dtype=jnp.float32), intr_v,
            iterations=odometry.ITERATIONS_INTERMAP,
            icp_weight=cfg.icp_weight, use_so3=True,
            # inter-map baselines legitimately exceed the frame-to-model
            # guard; the inlier/error/covariance gates carry the rejection
            trans_fail_thresh=2.0,
        )
        n_valid = jnp.sum((d_v > 0).astype(jnp.float32))
        inlier_frac = res.icp_inliers / jnp.maximum(n_valid, 1.0)
        # my request was served iff my target's chosen requester == me (each
        # server renders for exactly one requester per round)
        served_me = jax.lax.all_gather(
            jnp.stack([any_ask.astype(jnp.int32), req_id]), "cam"
        )
        was_served = (
            proposing
            & (served_me[tgt_cam, 0] > 0)
            & (served_me[tgt_cam, 1] == me)
        )
        # covariance gate (reference `ElasticFusion.cpp:427-442` applies the
        # same to inter-map candidates via ReferenceFrame.h:98-110): a false
        # minimum on ambiguous geometry leaves some twist directions barely
        # constrained even when the residual gates pass
        from densemonoslam_tpu.ops import reductions as _red

        cov_ok = jnp.all(_red.diag_inv_6x6(res.JtJ) < cfg.cov_thresh)
        ok = (
            was_served
            & ~res.failed
            & (inlier_frac >= min_inlier_frac)
            & (res.icp_error <= icp_err_thresh)
            & cov_ok
        )
        # A maps my current camera frame -> target's keyframe camera frame;
        # my map -> target map: T = pose_kf @ A @ inv(my_pose)
        T_ab = poses_all[tgt_cam, tgt_entry] @ res.A @ se3.se3_inverse(
            state.pose
        )

        # ---- 5. replicated decision + apply ------------------------------
        oks = jax.lax.all_gather(ok, "cam")  # [n]
        Ts = jax.lax.all_gather(T_ab, "cam")  # [n, 4, 4]
        tgts = props[:, 0]
        any_merge = jnp.any(oks)
        winner = jnp.argmax(oks)  # lowest accepted requester
        src_map = mapid_all[winner]
        dst_map = mapid_all[tgts[winner]]
        T_win = Ts[winner]
        in_src = any_merge & (ist.map_id == src_map)

        def apply_T(op):
            data, pose, kf_pose = op
            R, t = T_win[:3, :3], T_win[:3, 3]
            pos = data[:-1, sm.POS] @ R.T + t
            nrm = data[:-1, sm.NORMAL] @ R.T
            alive = data[:-1, sm.CONF] > 0
            data = data.at[:-1, sm.POS].set(
                jnp.where(alive[:, None], pos, data[:-1, sm.POS])
            )
            data = data.at[:-1, sm.NORMAL].set(
                jnp.where(alive[:, None], nrm, data[:-1, sm.NORMAL])
            )
            return data, T_win @ pose, T_win @ kf_pose

        def no_T(op):
            return op

        data, pose, kf_pose = jax.lax.cond(
            in_src, apply_T, no_T, (state.map_data, state.pose, state.kf_pose)
        )
        new_map_id = jnp.where(in_src, dst_map, ist.map_id)
        # fern keyframe poses move with the map
        new_fern_poses = jnp.where(
            in_src,
            jnp.einsum("ij,kjl->kil", T_win, ist.poses),
            ist.poses,
        )
        state = state._replace(
            map_data=data, pose=pose, kf_pose=kf_pose,
            model_age=jnp.where(
                in_src, stepmod.MODEL_INVALID_AGE, state.model_age
            ).astype(jnp.int32),
        )
        ist = ist._replace(map_id=new_map_id, poses=new_fern_poses)

        dropped = jnp.array(0, jnp.int32)
        if consume:
            # physical consumeReferenceFrame: route the winning requester's
            # rows to its target and append; the source camera's map empties.
            is_src_cam = any_merge & (me == winner)
            is_dst_cam = any_merge & (me == tgts[winner])
            contrib = jnp.where(
                is_src_cam, state.map_data[:-1], jnp.zeros_like(state.map_data[:-1])
            )
            routed = jax.lax.psum(contrib, "cam")  # only the source is nonzero

            def absorb(op):
                data, count = op
                m = sm.SurfelMap(data=data, count=count)
                valid = routed[:, sm.CONF] > 0
                n_valid = jnp.sum(valid.astype(jnp.int32))
                room = jnp.maximum(m.capacity - m.count, 0)
                m = sm.append_surfels(m, routed, valid)
                # capacity overflow is surfaced, not silent (engine.merge_into
                # parity): rows past capacity landed in the dump slot
                return m.data, m.count, jnp.maximum(n_valid - room, 0)

            def clear(op):
                data, _count = op
                return (
                    jnp.zeros_like(data), jnp.array(0, jnp.int32),
                    jnp.array(0, jnp.int32),
                )

            def keep(op):
                data, count = op
                return data, count, jnp.array(0, jnp.int32)

            data2, count2, dropped_local = jax.lax.cond(
                is_dst_cam, absorb,
                lambda op: jax.lax.cond(is_src_cam, clear, keep, op),
                (state.map_data, state.map_count),
            )
            dropped = jax.lax.psum(dropped_local, "cam")  # replicated
            state = state._replace(map_data=data2, map_count=count2)
            # the source camera's map moved away: its fern keyframes now
            # advertise views whose surfels live on the destination device,
            # and its next render is empty — clear the DB so it re-learns
            # places in the merged frame, and let the bootstrap path reseed
            # its (empty) map from the next live frame (model_age is already
            # invalidated above)
            ist = jax.tree.map(
                lambda cur, init: jnp.where(
                    jnp.broadcast_to(
                        is_src_cam.reshape((1,) * cur.ndim), cur.shape
                    ),
                    init, cur,
                ),
                ist,
                ist._replace(
                    codes=jnp.zeros_like(ist.codes),
                    poses=jnp.broadcast_to(
                        jnp.eye(4, dtype=jnp.float32), ist.poses.shape
                    ),
                    times=jnp.full_like(ist.times, -1.0),
                    count=jnp.zeros_like(ist.count),
                ),
            )

        info = MergeInfo(
            merged=any_merge,
            src_map=src_map,
            dst_map=dst_map,
            requester=winner.astype(jnp.int32),
            target=tgts[winner].astype(jnp.int32),
            map_ids=jax.lax.all_gather(new_map_id, "cam"),
            T=jax.lax.all_gather(jnp.where(in_src, T_win, jnp.eye(4)), "cam"),
            stats=jax.lax.all_gather(
                jnp.stack(
                    [
                        proposing.astype(jnp.float32), inlier_frac,
                        res.icp_error, best_dis,
                    ]
                ),
                "cam",
            ),
            dropped=dropped,
        )
        out_state = jax.tree.map(lambda v: v[None], state)
        out_ist = jax.tree.map(lambda v: v[None], ist)
        return out_state, out_ist, info

    sharded = shard_map(
        local,
        mesh=mesh,
        in_specs=(P("cam"), P("cam"), P("cam"), P("cam")),
        out_specs=(P("cam"), P("cam"), P()),
        check_vma=False,
    )

    @jax.jit
    def round_fn(state, ist, rgb_batch, depth_batch):
        return sharded(state, ist, rgb_batch, depth_batch)

    return round_fn
