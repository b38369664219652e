"""Headline benchmark: dense SLAM frames/s on one GPU — multi-metric.

Emits ONE JSON line whose headline is open-loop 640x480 fps (the reference's
TUM/ICL operating point; its real-time gate is 30 Hz on a ">=3.5 TFLOPS
nVidia GPU", `GUI/src/MainController.cpp:389-395`,
`elasticfusion/README.md:46-60`; `vs_baseline` = fps / 30).  The `extra`
block carries the full matrix:

- `closed_loop_fps`: same config with the loop-closure machinery enabled at
  its cadence (fern encode/insert + local-loop attempt every 8 frames);
- `reloc_fps`: relocalisation mode on (device-side lost counter);
- `kitti_fps`: 1024x320 (the ECMR'21 KITTI operating point);
- `mono_street_kitti`: the monocular street lap with CNN depth, sparse BA
  and hybrid loops.

Refuses to run without a GPU; every result carries the card's name and
power limit.
"""

import json
import os
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

BASELINE_FPS = 30.0

# the revisit-lap leg: local loops at cadence with `time_delta` shorter than
# the 40-frame lap, so revisits land in the INACTIVE map and closures fire
CLOSED_LOOP_CFG = dict(
    open_loop=False, loop_check_interval=8, time_delta=30,
    deform_graph_sample_rate=2000, max_deform_nodes=256,
    loop_min_inactive_frac=0.05, loop_cons_err_thresh=0.02,
)


def run_slam(W, H, n_frames, warmup, cfg_kw, intr=None, lap=0,
             base_cfg=None):
    """Run one benchmark leg.  `lap` > 0 replays a `lap`-frame orbit
    repeatedly (frame i = orbit frame i % lap) so revisits land in the
    INACTIVE map and the loop-closure machinery actually fires; returns
    (fps, ate_mm, engine, loops_closed_in_timed_region)."""
    import numpy as np
    import jax
    import jax.numpy as jnp

    from densemonoslam_tpu.config import (
        CameraConfig, CameraIntrinsics, EngineConfig, FrameResolution,
    )
    from densemonoslam_tpu.engine import Engine
    from densemonoslam_tpu.eval import ate_rmse
    from densemonoslam_tpu.io.synthetic import SyntheticSequence

    camera = CameraConfig(
        FrameResolution(W, H),
        intr or CameraIntrinsics(528.0 * W / 640, 528.0 * H / 480,
                                 W / 2 - 0.5, H / 2 - 0.5),
        "bench",
    )
    n_orbit = lap if lap > 0 else n_frames + warmup
    radius = 0.35 if lap > 0 else 0.12
    seq = SyntheticSequence(
        camera=camera, num_frames=n_orbit, radius=radius,
        max_angle=0.12 if lap == 0 else 0.3,
    )
    frames = [seq.frame(i) for i in range(n_orbit)]
    base = dict(
        max_surfels=1 << 20,
        depth_cutoff=8.0,
        depth_factor=1.0,
        nid_keyframing=True,
        nid_threshold=0.85,
        pyramid_levels=4,
        track_row_stride=2,
    )
    if base_cfg:
        base.update(base_cfg)
    cfg = EngineConfig(**{**base, **cfg_kw})
    eng = Engine(camera, cfg)
    eng.frontend("cam0")
    eng.frontends["cam0"].pose = seq.gt_pose(0).astype(np.float32)
    frames = [
        (jax.device_put(jnp.asarray(r)), jax.device_put(jnp.asarray(d)))
        for r, d in frames
    ]
    jax.block_until_ready(frames)
    for i in range(warmup):
        rgb, depth = frames[i % n_orbit]
        eng.process_frame("cam0", rgb, depth, float(i), sync=False)
    jax.block_until_ready(eng.frontends["cam0"].state.map_data)
    loops_pre = eng.frontends["cam0"].loops_closed
    # time every local-loop invocation inside the timed region so the bench
    # reports the end-to-end per-closure cost
    import densemonoslam_tpu.loops as loopsmod

    loop_s = [0.0, 0]
    orig_try = loopsmod.try_local_loop

    def timed_try(*a, **k):
        t = time.perf_counter()
        out = orig_try(*a, **k)
        loop_s[0] += time.perf_counter() - t
        loop_s[1] += 1
        return out

    loopsmod.try_local_loop = timed_try
    try:
        t0 = time.perf_counter()
        for i in range(warmup, warmup + n_frames):
            rgb, depth = frames[i % n_orbit]
            eng.process_frame("cam0", rgb, depth, float(i), sync=False)
        jax.block_until_ready(eng.frontends["cam0"].state.map_data)
        fps = n_frames / (time.perf_counter() - t0)
    finally:
        loopsmod.try_local_loop = orig_try
    loops_timed = eng.frontends["cam0"].loops_closed - loops_pre
    ms_per_closure = (
        1e3 * loop_s[0] / loops_timed if loops_timed else 0.0
    )
    est = [p for _, p in eng.frontends["cam0"].trajectory]
    gt = [seq.gt_pose(i % n_orbit) for i in range(len(est))]
    return fps, ate_rmse(est, gt) * 1000.0, eng, loops_timed, ms_per_closure


def run_mono_street(n: int = 520, warm: int = 70):
    """Flagship monocular street lap at the KITTI operating point (BASELINE
    config 3 stand-in): CNN depth prediction -> sparse tracking with local
    RGB-D BA -> windowed dense fusion -> hybrid loop closure over a ~314 m
    closing lap (`n` = 520 frames is one full lap; the first `warm` frames
    are untimed).  Reference command: `--predict_depth --orb_tracking ...`
    (reference `README.md:128-133`)."""
    import numpy as np
    import jax

    from densemonoslam_tpu.config import CameraConfig, EngineConfig
    from densemonoslam_tpu.engine import Engine
    from densemonoslam_tpu.eval import ate_rmse
    from densemonoslam_tpu.io.street import StreetSequence
    from densemonoslam_tpu.models.depthnet import DepthPredictor
    from densemonoslam_tpu.tracking.sparse import SparseTracker

    seq = StreetSequence(
        camera=CameraConfig.kitti_default(), num_frames=n,
        exposure_jitter=0.03,
    )
    cfg = EngineConfig(
        max_surfels=1 << 22, depth_cutoff=40.0, max_depth=80.0,
        depth_factor=1.0, depth_gate_rel=0.1, nid_keyframing=True,
        open_loop=True, predict_depth=True, orb_tracking=True,
        hybrid_loops=True, time_delta=200, pyramid_levels=4,
        track_row_stride=2,
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
    frames = [seq.frame(i)[0] for i in range(n)]  # host render pre-paid
    # pre-warm programs that otherwise first COMPILE mid-sequence (the
    # persistent cache makes this a once-per-machine cost, but the first
    # bench on a fresh machine must not count compiles as frame time):
    # the hybrid-loop deformation program and a lap-scale PGO solve.  Both
    # are pure functions of throwaway inputs — engine state is untouched.
    from densemonoslam_tpu import loops as loopsmod
    from densemonoslam_tpu.parallel import ba as bamod
    import jax.numpy as jnp

    hl = loopsmod._make_hybrid_loop(
        seq.camera.intrinsics, seq.camera.resolution.width,
        seq.camera.resolution.height, cfg,
    )
    jax.block_until_ready(
        hl(fe.state, jnp.eye(4, dtype=jnp.float32), loopsmod.make_rel_bank())[1]
    )
    for kcap in (256, 512):  # kf counts a 520-frame lap plausibly reaches
        jax.block_until_ready(
            bamod.optimise_pose_graph(
                jnp.broadcast_to(jnp.eye(4, dtype=jnp.float32), (kcap, 4, 4)),
                bamod.PoseGraphEdges(
                    i=jnp.zeros((kcap,), jnp.int32),
                    j=jnp.ones((kcap,), jnp.int32),
                    Z=jnp.broadcast_to(
                        jnp.eye(4, dtype=jnp.float32), (kcap, 4, 4)
                    ),
                    weight=jnp.ones((kcap,), jnp.float32),
                ),
                cg_iters=128,
            )[1]
        )
    # the warm replay should be long enough that the BA window shapes
    # (kf 3..6) and the first periodic compaction (tick 64) have all
    # executed once
    for i in range(warm):
        eng.process_frame("cam0", frames[i], None, float(i), sync=False)
    jax.block_until_ready(fe.state.map_data)
    t0 = time.perf_counter()
    for i in range(warm, n):
        eng.process_frame("cam0", frames[i], None, float(i), sync=False)
    jax.block_until_ready(fe.state.map_data)
    fps = (n - warm) / (time.perf_counter() - t0)
    est = [p for _, p in fe.trajectory]
    gt = [seq.gt_pose(i) for i in range(len(est))]
    return {
        "fps": fps,
        "ate_m": float(ate_rmse(est, gt)),
        "hybrid_loops": fe.loops_closed,
        "sparse_loops": fe.sparse_tracker.loops_closed,
        "surfels": int(fe.state.map_count),
        "frames": n,
    }


def main() -> None:
    import jax

    from densemonoslam_tpu.utils.device import card_lines, require_gpu

    dev = require_gpu()
    card = card_lines()[0]
    print(f"card: {card}")
    n_frames = int(os.environ.get("BENCH_FRAMES", "30"))
    warmup = 4
    # 1) headline: open-loop 640x480 (loop machinery's one-off compiles would
    # dominate a cold benchmark process; measured separately below)
    fps_open, ate_mm, eng, _, _ = run_slam(
        640, 480, n_frames, warmup, dict(open_loop=True)
    )
    # 2) closed loop over a revisit lap: fern updates + local-loop attempts
    # at cadence with `time_delta` SHORTER than the lap, so the second lap
    # revisits land in the INACTIVE map and real closures (render + track +
    # deform + pose-history rewrite + compaction) execute inside the timed
    # region.  Warmup spans the first lap + one closure so every loop
    # program's one-off compile lands outside the timing.
    fps_closed, _, _, loops_timed, ms_closure = run_slam(
        640, 480, 60, 45, CLOSED_LOOP_CFG, lap=40,
    )
    # 3) relocalisation mode (device-side lost counter; <10%% headline cost)
    fps_reloc, _, _, _, _ = run_slam(
        640, 480, n_frames, warmup, dict(open_loop=True, relocalisation=True)
    )
    # 4) KITTI operating point 1024x320
    from densemonoslam_tpu.config import CameraIntrinsics

    fps_kitti, _, _, _, _ = run_slam(
        1024, 320, n_frames, warmup, dict(open_loop=True),
        intr=CameraIntrinsics(707.09, 707.09, 601.89, 183.11),
    )
    # 4b) DEFAULT-config operating point (pyramid_levels=3, row_stride=1):
    # what a user gets without the benchmarked tuning
    fps_default, _, _, _, _ = run_slam(
        640, 480, n_frames, warmup, dict(open_loop=True),
        base_cfg=dict(pyramid_levels=3, track_row_stride=1),
    )
    # 4d) reference-capacity demonstration: 1<<25 = 33.5M surfels (the
    # reference's 5700^2 ~= 32.5M, `GlobalModel.cpp:22-24`).  The windowed
    # design argues per-frame cost is capacity-independent; this proves it
    # (and that a reference-sized map fits device memory: 2.1 GB at
    # 64 B/row).
    fps_32m, _, _, _, _ = run_slam(
        640, 480, max(n_frames // 2, 10), warmup,
        dict(open_loop=True, max_surfels=1 << 25),
    )
    # 4c) flagship monocular street lap (KITTI operating point, full stack)
    try:
        mono_street = run_mono_street()
    except Exception as e:  # pragma: no cover — report, don't die
        mono_street = {"error": str(e)[:200]}
    print(
        json.dumps(
            {
                "metric": "slam_fps_640x480_1gpu",
                "device": {"platform": dev.platform, "kind": dev.device_kind,
                           "count": len(jax.devices()), "card": card},
                "value": round(fps_open, 2),
                "unit": "frames/s",
                "vs_baseline": round(fps_open / BASELINE_FPS, 3),
                "extra": {
                    "ate_mm": round(ate_mm, 2),
                    "surfels": eng.surfel_count("cam0"),
                    "frames": n_frames,
                    "closed_loop": {
                        "fps": round(fps_closed, 2),
                        "loops_closed": int(loops_timed),
                        "ms_per_closure": round(ms_closure, 1),
                    },
                    "closed_loop_fps": round(fps_closed, 2),
                    "default_cfg_fps": round(fps_default, 2),
                    "reloc_fps": round(fps_reloc, 2),
                    "reloc_overhead_pct": round(
                        100.0 * (1.0 - fps_reloc / max(fps_open, 1e-9)), 1
                    ),
                    "kitti_fps_1024x320": round(fps_kitti, 2),
                    "mono_street_kitti": mono_street,
                    "fps_at_32M_capacity": round(fps_32m, 2),
                },
            }
        )
    )


if __name__ == "__main__":
    main()
