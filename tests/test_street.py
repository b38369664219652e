"""Street-scale long-trajectory tests (BASELINE config 3 stand-in): the
KITTI-shaped procedural loop driving the sparse
tracker with local BA, pose-graph loop closure, and the FULL monocular hybrid
stack (predicted depth + orb tracking + hybrid loops) end-to-end.

Reference behaviours matched: ORB-SLAM3 LocalMapping windowed BA
(`GUI/src/MainController.cpp:131-135`), the monocular KITTI command
(`/root/reference/README.md:128-133`), hybrid loop pose pairs
(`MainController.cpp:338-369`).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from densemonoslam_tpu.config import EngineConfig
from densemonoslam_tpu.engine import Engine
from densemonoslam_tpu.io.street import StreetSequence
from densemonoslam_tpu.tracking.sparse import SparseTracker


def _intensity(rgb):
    return (
        0.299 * rgb[..., 0] + 0.587 * rgb[..., 1] + 0.114 * rgb[..., 2]
    ).astype(np.float32)


@pytest.fixture(scope="module")
def street_frames():
    """150 street frames with sensor-model noise, pre-rendered once."""
    seq = StreetSequence(num_frames=520, depth_noise=0.005, exposure_jitter=0.03)
    frames = []
    for i in range(150):
        rgb, depth = seq.frame(i)
        frames.append((jnp.asarray(_intensity(rgb)), jnp.asarray(depth)))
    return seq, frames


def test_local_ba_cuts_drift_2x(street_frames):
    """Sliding-window RGB-D local BA must reduce long-range drift >=2x vs the
    motion-only chain (measured ~5-10x)."""
    seq, frames = street_frames
    errs = {}
    for ba_on in (False, True):
        trk = SparseTracker(
            seq.camera.intrinsics, run_local_ba=ba_on, keyframe_min_disp=1.0
        )
        trk.pose = seq.gt_pose(0).astype(np.float32)
        for i in range(150):
            pose, _ = trk.track(*frames[i])
        p = np.asarray(trk.pose)
        errs[ba_on] = float(np.linalg.norm(p[:3, 3] - seq.gt_pose(149)[:3, 3]))
        if ba_on:
            assert trk.local_ba_runs > 10
    assert errs[True] < 0.5 * errs[False], errs
    # absolute sanity: < 1% of the ~90 m travelled
    assert errs[True] < 0.9, errs


def test_street_full_lap_sparse_loop_closure():
    """One full 520-frame lap (~314 m): the sparse tracker must recognise the
    loop, close it, and the PGO correction must reach the LIVE pose (the r4
    delta fix) — final error far below the pre-closure drift."""
    seq = StreetSequence(num_frames=520, depth_noise=0.005, exposure_jitter=0.03)
    trk = SparseTracker(
        seq.camera.intrinsics, run_local_ba=True, keyframe_min_disp=1.0,
        loop_min_gap=100,
    )
    trk.pose = seq.gt_pose(0).astype(np.float32)
    for i in range(520):
        rgb, depth = seq.frame(i)
        trk.track(jnp.asarray(_intensity(rgb)), jnp.asarray(depth))
    trk.flush()
    assert trk.loops_closed >= 1
    p = np.asarray(trk.pose)
    final_err = float(np.linalg.norm(p[:3, 3] - seq.gt_pose(519)[:3, 3]))
    assert final_err < 0.5, final_err  # measured 0.02 m; drift-only was ~8 m


def test_street_monocular_full_stack():
    """The flagship monocular pipeline end-to-end on a full lap: CNN depth
    prediction -> sparse tracking w/ local BA -> dense fusion with the
    windowed map -> hybrid loop closure deforming the dense map.  Asserts a
    closed hybrid loop and a bounded post-closure ATE (the reference KITTI
    mode, `--predict_depth --orb_tracking`)."""
    from densemonoslam_tpu.models.depthnet import DepthPredictor

    seq = StreetSequence(num_frames=520, exposure_jitter=0.03)
    cfg = EngineConfig(
        max_surfels=1 << 21,
        depth_cutoff=40.0,  # reference KITTI `--d 40`
        max_depth=80.0,
        depth_factor=1.0,
        depth_gate_rel=0.1,
        nid_keyframing=True,
        nid_threshold=0.85,
        open_loop=True,  # local (dense) loops off; hybrid loops drive deforms
        predict_depth=True,
        orb_tracking=True,
        hybrid_loops=True,
        time_delta=200,
        # street-scale deformation acceptance: the residual after folding a
        # whole lap's drift is metres-scale geometry moved by tens of metres;
        # the indoor 1 cm gate would reject every true closure
        loop_cons_err_thresh=1.0,
    )
    eng = Engine(seq.camera, cfg)
    eng.frontend("cam0")
    eng.set_depth_predictor(DepthPredictor.pretrained_street())
    fe = eng.frontends["cam0"]
    fe.pose = seq.gt_pose(0).astype(np.float32)
    fe.sparse_tracker = SparseTracker(
        seq.camera.intrinsics, run_local_ba=True, keyframe_min_disp=1.0,
        loop_min_gap=100,
    )
    fe.sparse_tracker.pose = np.asarray(fe.state.pose)
    for i in range(520):
        rgb, _ = seq.frame(i)
        eng.process_frame("cam0", rgb, None, float(i), sync=False)
    jax.block_until_ready(fe.state.map_data)

    assert fe.sparse_tracker.loops_closed >= 1, "no sparse loop recognised"
    assert fe.loops_closed >= 1, "hybrid closure never accepted"
    # post-closure live pose lands back near the start (lap closes);
    # monocular scale rides the CNN depth, so the bound is metres, not mm
    p = np.asarray(fe.state.pose)
    final_err = float(np.linalg.norm(p[:3, 3] - seq.gt_pose(519)[:3, 3]))
    assert final_err < 3.0, final_err
    # the trajectory export reflects the closure (pose history rewritten)
    est = [q for _, q in fe.trajectory]
    late = np.stack([q[:3, 3] for q in est[-30:]])
    gt_late = np.stack([seq.gt_pose(i)[:3, 3] for i in range(490, 520)])
    late_rmse = float(np.sqrt(np.mean(np.sum((late - gt_late) ** 2, -1))))
    # pre-closure the late drift is ~50 m; the PGO history rewrite must pull
    # it down an order of magnitude (exact value wobbles with platform
    # reduction order on this chaotic 520-frame pipeline)
    assert late_rmse < 12.0, late_rmse
    # map stayed within capacity and holds street-scale structure
    assert int(fe.state.map_count) > 100_000


def test_distributed_ba_in_pipeline_matches_single(street_frames):
    """BASELINE config 4: the sparse tracker's sliding-window RGB-D Schur BA
    runs landmark-sharded over the 8-device mesh (`parallel.ba.
    make_distributed_ba`, normal equations psum-reduced over the mesh) inside a
    real street run — not just the `test_ba.py` random-problem parity — and
    lands on the single-device trajectory."""
    from densemonoslam_tpu.parallel.mesh import make_mesh

    seq, frames = street_frames
    finals = {}
    for use_mesh in (False, True):
        mesh = make_mesh(n_cams=8) if use_mesh else None
        trk = SparseTracker(
            seq.camera.intrinsics, run_local_ba=True, keyframe_min_disp=1.0,
            mesh=mesh,
        )
        trk.pose = seq.gt_pose(0).astype(np.float32)
        for i in range(150):
            trk.track(*frames[i])
        trk.flush()
        assert trk.local_ba_runs > 10
        if use_mesh:
            assert trk._dist_ba is not None, "distributed BA never invoked"
        finals[use_mesh] = np.asarray(trk.pose)
    diff = float(
        np.linalg.norm(finals[True][:3, 3] - finals[False][:3, 3])
    )
    # same optimum modulo collective reduction order, compounded over ~25
    # BA windows
    assert diff < 0.1, diff
    gt_err = float(
        np.linalg.norm(finals[True][:3, 3] - seq.gt_pose(149)[:3, 3])
    )
    assert gt_err < 0.9, gt_err


def test_distributed_pgo_closes_street_loop():
    """BASELINE config 4, pose-graph half: a full 520-frame lap where the
    loop-closure pose-graph solve runs edge-sharded over the 8-device mesh
    (`parallel.ba.make_distributed_pgo`) — the correction must still reach
    the live pose."""
    from densemonoslam_tpu.parallel.mesh import make_mesh

    seq = StreetSequence(num_frames=520, depth_noise=0.005, exposure_jitter=0.03)
    trk = SparseTracker(
        seq.camera.intrinsics, run_local_ba=True, keyframe_min_disp=1.0,
        loop_min_gap=100, mesh=make_mesh(n_cams=8),
    )
    trk.pose = seq.gt_pose(0).astype(np.float32)
    for i in range(520):
        rgb, depth = seq.frame(i)
        trk.track(jnp.asarray(_intensity(rgb)), jnp.asarray(depth))
    trk.flush()
    assert trk.loops_closed >= 1
    assert trk._dist_pgo is not None, "distributed PGO never invoked"
    p = np.asarray(trk.pose)
    final_err = float(np.linalg.norm(p[:3, 3] - seq.gt_pose(519)[:3, 3]))
    assert final_err < 0.5, final_err


def test_street_second_geometry_rpe():
    """A SECOND street geometry (different seed, radius,
    lap length) with per-segment relative-pose-error bounds, so a 2x drift
    regression fails CI instead of hiding inside a loose endpoint bound."""
    seq = StreetSequence(
        num_frames=420, radius=40.0, seed=13,
        depth_noise=0.005, exposure_jitter=0.03,
    )
    trk = SparseTracker(
        seq.camera.intrinsics, run_local_ba=True, keyframe_min_disp=1.0,
        loop_min_gap=80,
    )
    trk.pose = seq.gt_pose(0).astype(np.float32)
    for i in range(420):
        rgb, depth = seq.frame(i)
        trk.track(jnp.asarray(_intensity(rgb)), jnp.asarray(depth))
    trk.flush()
    assert trk.loops_closed >= 1
    p = np.asarray(trk.pose)
    final_err = float(np.linalg.norm(p[:3, 3] - seq.gt_pose(419)[:3, 3]))
    assert final_err < 0.7, final_err  # measured 0.33 m on a ~251 m lap
    # per-segment RPE over the post-PGO keyframe chain (segments of 10
    # keyframes ~ 12 m): measured max 4.9% / 0.61 m — the bounds are ~2x
    kfs = trk.keyframes
    seg = 10
    assert len(kfs) > 3 * seg
    for a in range(0, len(kfs) - seg, seg):
        _, pa, ta = kfs[a]
        _, pb, tb = kfs[a + seg]
        est_rel = np.linalg.inv(np.asarray(pa)) @ np.asarray(pb)
        gt_rel = np.linalg.inv(seq.gt_pose(ta)) @ seq.gt_pose(tb)
        dt = float(np.linalg.norm(est_rel[:3, 3] - gt_rel[:3, 3]))
        seg_len = float(np.linalg.norm(gt_rel[:3, 3]))
        assert dt < max(0.10 * seg_len, 0.1), (a, dt, seg_len)
        assert dt < 1.2, (a, dt)


def test_street_aliasing_no_false_closure():
    """Perceptual aliasing stressor: the prop layout of
    the first half-ring repeats rotated by pi (`StreetSequence(aliased=
    True)`), so the lap contains visually similar but geometrically distinct
    places ~2*radius apart.  Loop retrieval + geometric verification must
    reject the aliased candidates (no false closure) while still finding the
    true revisit.  Reference analogue: DBoW2's robustness (X1)."""
    seq = StreetSequence(
        num_frames=520, depth_noise=0.005, exposure_jitter=0.03,
        aliased=True,
    )
    trk = SparseTracker(
        seq.camera.intrinsics, run_local_ba=True, keyframe_min_disp=1.0,
        loop_min_gap=100,
    )
    trk.pose = seq.gt_pose(0).astype(np.float32)
    for i in range(520):
        rgb, depth = seq.frame(i)
        trk.track(jnp.asarray(_intensity(rgb)), jnp.asarray(depth))
    trk.flush()
    assert trk.loops_closed >= 1, "true closure missed on the aliased lap"
    # every accepted loop edge must connect a TRUE revisit: the aliased
    # twin regions are ~2*radius (~100 m) apart in GT, true revisits are
    # within metres
    for (i, j, _A, w) in trk._edges:
        if w < 2.5:  # odometry edges carry weight 1, loop edges 3
            continue
        ti, tj = trk.keyframes[i][2], trk.keyframes[j][2]
        d = float(
            np.linalg.norm(seq.gt_pose(ti)[:3, 3] - seq.gt_pose(tj)[:3, 3])
        )
        assert d < 15.0, f"false closure across aliased places: kf {i}->{j}, {d:.1f} m apart"
    p = np.asarray(trk.pose)
    final_err = float(np.linalg.norm(p[:3, 3] - seq.gt_pose(519)[:3, 3]))
    assert final_err < 0.5, final_err
