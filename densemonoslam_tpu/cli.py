"""Command-line interface: dataset replay through the full SLAM engine.

Equivalent of the reference GUI application's headless replay mode
(`GUI/src/Main.cpp` + `MainController` with `--l <log> --q`): process a
sequence, export `.freiburg` trajectory / `.ply` map / `.stats` /
`.timings.csv`, optionally evaluate ATE against ground truth.  Flag names are
spelled out; the reference's two-letter flags are noted per option
(reference `README.md:56-126`).

Usage examples:
    python -m densemonoslam_tpu.cli --dataset synthetic --frames 60 --out /tmp/run
    python -m densemonoslam_tpu.cli --dataset tum --path ~/data/fr1_desk --out out/
    python -m densemonoslam_tpu.cli --dataset icl --path lr0 --icl --out out/
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="densemonoslam_tpu dataset replay")
    ap.add_argument("--dataset", choices=["synthetic", "tum", "icl", "kitti"], default="synthetic")
    ap.add_argument("--path", default=None, help="dataset root (`--l` log path)")
    ap.add_argument("--out", default=None, help="export directory")
    ap.add_argument("--frames", type=int, default=60, help="max frames (`--e` end)")
    ap.add_argument("--skip", type=int, default=0, help="skip first N (`--s`)")
    ap.add_argument("--platform", default=None, choices=[None, "cpu", "gpu"],
                    help="cpu forces the CPU backend; gpu fails unless JAX's "
                         "default device is a GPU")
    # engine flags (reference two-letter names in help)
    ap.add_argument("--open-loop", action="store_true", help="`--o` disable loops")
    ap.add_argument("--no-nid", action="store_true", help="`--nkf` disable NID keyframing")
    ap.add_argument("--rgb-only", action="store_true", help="`--rgb`")
    ap.add_argument("--fast-odom", action="store_true", help="`--fo`")
    ap.add_argument("--no-so3", action="store_true", help="`--nso`")
    ap.add_argument("--relocalisation", action="store_true", help="`--rl`")
    ap.add_argument("--ftf", action="store_true",
                    help="`--ftf` frame-to-frame RGB tracking model")
    ap.add_argument("--orb-tracking", action="store_true",
                    help="`--orb_tracking` pose from the sparse tracker")
    ap.add_argument("--hybrid-loops", action="store_true",
                    help="`--hybrid_loops` sparse loop pairs drive deformations")
    ap.add_argument("--predict-depth", action="store_true",
                    help="`--predict_depth` monocular: depth from the CNN "
                         "(dataset depth, if any, is ignored)")
    ap.add_argument("--depth-weights", default=None,
                    help="depth-net weights (.npz saved by DepthPredictor, "
                         "default: packaged synthetic weights)")
    ap.add_argument("--icl", action="store_true", help="`--icl` normal flip")
    ap.add_argument("--time-delta", type=int, default=200, help="`--t`")
    ap.add_argument("--confidence", type=float, default=10.0, help="`--c`")
    ap.add_argument("--depth-cutoff", type=float, default=3.0, help="`--d`")
    ap.add_argument("--icp-weight", type=float, default=10.0, help="`--i`")
    ap.add_argument("--ipt", default=None, metavar="W0,W1,...",
                    help="per-sensor ICP weights (`--ipt`), comma-separated "
                         "by sensor id; missing sensors use --icp-weight")
    ap.add_argument("--nid-threshold", type=float, default=0.85, help="`--nid`")
    ap.add_argument("--max-surfels", type=int, default=1 << 20)
    ap.add_argument("--pyramid-levels", type=int, default=None)
    ap.add_argument("--gt", default=None, help="freiburg ground-truth file for ATE")
    ap.add_argument("--poses", default=None,
                    help="`--poses` freiburg file: inject GT poses, bypass tracking")
    ap.add_argument("--clusters", default=None,
                    help="`--clusters` time,cluster CSV: tag surfels with GT cluster ids")
    ap.add_argument("--stopwatch-udp", action="store_true",
                    help="stream section timings to 127.0.0.1:45454 (StopwatchViewer)")
    ap.add_argument("--checkpoint", default=None, help="save state here at the end")
    ap.add_argument("--resume", default=None, help="restore state before starting")
    ap.add_argument("--viewer", type=int, default=None, metavar="PORT",
                    help="serve the live web viewer on this port (0 = auto); "
                         "the headless substitute for the reference Pangolin "
                         "GUI (`GUI/src/Tools/GUI.h`)")
    ap.add_argument("--viewer-interval", type=int, default=4,
                    help="publish viewer artefacts every N frames")
    ap.add_argument("--viewer-hold", action="store_true",
                    help="keep serving the viewer after the sequence ends")
    ap.add_argument("--logs", nargs="+", default=None, metavar="LOG",
                    help="multi-camera session: one .klg (or TUM/ICL dir) per "
                         "camera, replayed round-robin (reference `--l log1 "
                         "--l log2` / MultiLogCameraManager)")
    ap.add_argument("--live-port", type=int, default=None,
                    help="also accept live UDP camera streams on this port "
                         "(MultiLive/MultiMixedCameraManager role)")
    ap.add_argument("--num-sensors", type=int, default=None,
                    help="cameras to wait for before starting (reference "
                         "MainController camera wait loop)")
    ap.add_argument("--width", type=int, default=None,
                    help="frame width for synthetic and --logs sessions "
                         "(default: dataset operating point; intrinsics "
                         "scale with it)")
    ap.add_argument("--height", type=int, default=None,
                    help="frame height for synthetic and --logs sessions")
    return ap


def _scaled_camera(camera, width, height):
    """`camera` resampled to width x height, intrinsics scaled with it."""
    from densemonoslam_tpu.config import (
        CameraConfig, CameraIntrinsics, FrameResolution,
    )

    r0 = camera.resolution
    sx, sy = width / r0.width, height / r0.height
    i0 = camera.intrinsics
    return CameraConfig(
        FrameResolution(width, height),
        CameraIntrinsics(i0.fx * sx, i0.fy * sy,
                         (i0.cx + 0.5) * sx - 0.5,
                         (i0.cy + 0.5) * sy - 0.5),
        camera.name,
    )


def make_reader(args):
    from densemonoslam_tpu.config import CameraConfig
    from densemonoslam_tpu.io.synthetic import SyntheticSequence

    if args.dataset == "synthetic":
        # keep the orbit dense regardless of how few frames are replayed
        seq = SyntheticSequence(
            num_frames=max(args.frames + args.skip, 40), radius=0.35, max_angle=0.3
        )
        if args.width and args.height:
            seq.camera = _scaled_camera(seq.camera, args.width, args.height)
        return seq, seq.camera, 1.0
    if args.dataset == "tum":
        from densemonoslam_tpu.io.datasets import TumRgbdReader

        return TumRgbdReader(args.path), CameraConfig.tum_default(), 1.0
    if args.dataset == "icl":
        from densemonoslam_tpu.io.datasets import IclNuimReader

        return IclNuimReader(args.path), CameraConfig.tum_default(), 1.0
    if args.dataset == "kitti":
        from densemonoslam_tpu.io.datasets import KittiOdometryReader

        depth_dir = os.path.join(args.path, "depth") if args.path else None
        if depth_dir and not os.path.isdir(depth_dir):
            depth_dir = None
        return (
            KittiOdometryReader(args.path, depth_dir),
            CameraConfig.kitti_default(),
            1.0,
        )
    raise ValueError(args.dataset)


def _run_multi(args) -> int:
    """Multi-camera session over a camera manager (reference MainController
    multi-camera run loop + MultiCameraManagerFactory): every camera gets its
    own frontend/map; maps merge when inter-map fern loops resolve."""
    from densemonoslam_tpu.config import CameraConfig, EngineConfig
    from densemonoslam_tpu.engine import Engine
    from densemonoslam_tpu.io.camera_manager import (
        make_camera_manager, run_session,
    )

    camera = (
        CameraConfig.kitti_default()
        if args.dataset == "kitti" else CameraConfig.tum_default()
    )
    if args.width and args.height:
        camera = _scaled_camera(camera, args.width, args.height)
    res = camera.resolution
    cfg = EngineConfig(
        time_delta=args.time_delta,
        confidence_threshold=args.confidence,
        depth_cutoff=args.depth_cutoff,
        icp_weight=args.icp_weight,
        icp_weight_per_sensor=(
            tuple(float(w) for w in args.ipt.split(","))
            if args.ipt else None
        ),
        nid_threshold=args.nid_threshold,
        nid_keyframing=not args.no_nid,
        open_loop=args.open_loop,
        fast_odom=args.fast_odom,
        relocalisation=args.relocalisation,
        max_surfels=args.max_surfels,
        depth_factor=1.0,  # managers deliver metric depth
        pyramid_levels=args.pyramid_levels
        or (4 if res.height >= 480 else 3),
    )
    eng = Engine(camera, cfg)
    mgr = make_camera_manager(
        args.logs or [], res.width, res.height,
        n_sensors=args.num_sensors, live_port=args.live_port,
    )
    n_wait = args.num_sensors or len(args.logs or []) or 1
    if not mgr.wait_for_cameras(n_wait, timeout=30.0):
        print(f"timed out waiting for {n_wait} cameras "
              f"(found {len(mgr.cameras())})")
    viewer = None
    if args.viewer is not None:
        from densemonoslam_tpu.viewer import ViewerServer

        viewer = ViewerServer(eng, port=args.viewer, out_dir=args.out or ".")
        viewer.start()
        print(f"viewer: {viewer.url()}")
    t0 = time.perf_counter()
    processed = run_session(
        eng, mgr, args.frames, viewer=viewer,
        viewer_interval=args.viewer_interval,
    )
    import jax

    for name in eng.frontends:
        jax.block_until_ready(eng.frontends[name].state.map_data)
    dt = time.perf_counter() - t0
    total = sum(processed.values())
    print(
        f"processed {total} frames over {len(processed)} cameras "
        f"at {total / max(dt, 1e-9):.1f} fps; maps: "
        + ", ".join(f"{m}={eng.surfel_count(m)}" for m in eng.maps)
    )
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        for name in eng.frontends:
            eng.save_trajectory(
                name, os.path.join(args.out, f"{name}.freiburg")
            )
        for m in list(eng.maps):
            eng.save_ply(m, os.path.join(args.out, f"{m}.ply"),
                         stable_only=False)
        print(f"exports in {args.out}")
    if viewer is not None:
        for name in eng.frontends:
            viewer.publish(name)
        if args.viewer_hold:
            print("session done; viewer still serving (Ctrl-C to exit)")
            try:
                while True:
                    viewer.sync(list(eng.frontends))
                    time.sleep(0.5)
            except KeyboardInterrupt:
                pass
        viewer.stop()
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.platform == "cpu" or (args.platform is None and os.environ.get("JAX_PLATFORMS") == "cpu"):
        os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
        import jax

        jax.config.update("jax_platforms", "cpu")
    if args.platform == "gpu":
        from densemonoslam_tpu.utils.device import require_gpu

        require_gpu()

    if args.logs or args.live_port is not None:
        return _run_multi(args)
    run_sequence(args)
    return 0


def run_sequence(args) -> dict:
    """Replay one camera's sequence through the engine; prints progress and
    returns a summary (frames, fps, surfels, and ATE in mm when ground truth
    is available)."""
    import numpy as np

    from densemonoslam_tpu.config import EngineConfig
    from densemonoslam_tpu.engine import Engine

    reader, camera, depth_factor = make_reader(args)
    cfg = EngineConfig(
        time_delta=args.time_delta,
        confidence_threshold=args.confidence,
        depth_cutoff=args.depth_cutoff if args.dataset != "synthetic" else 8.0,
        icp_weight=args.icp_weight,
        icp_weight_per_sensor=(
            tuple(float(w) for w in args.ipt.split(","))
            if args.ipt else None
        ),
        nid_threshold=args.nid_threshold,
        nid_keyframing=not args.no_nid,
        open_loop=args.open_loop,
        rgb_only=args.rgb_only,
        fast_odom=args.fast_odom,
        so3=not args.no_so3,
        relocalisation=args.relocalisation,
        frame_to_frame_rgb=args.ftf,
        orb_tracking=args.orb_tracking,
        hybrid_loops=args.hybrid_loops,
        predict_depth=args.predict_depth,
        icl_nuim=args.icl,
        max_surfels=args.max_surfels,
        depth_factor=depth_factor if args.dataset != "synthetic" else 1.0,
        pyramid_levels=args.pyramid_levels
        or (4 if camera.resolution.height >= 480 else 3),
    )
    eng = Engine(camera, cfg)
    eng.frontend("cam0")
    if args.predict_depth:
        from densemonoslam_tpu.models.depthnet import DepthPredictor

        if args.depth_weights:
            pred = DepthPredictor()
            pred.load(
                args.depth_weights, camera.resolution.height,
                camera.resolution.width,
            )
        else:
            pred = DepthPredictor.pretrained_synthetic()
        eng.set_depth_predictor(pred)
    if args.stopwatch_udp:
        eng.timer.enable_udp()
    gt_odom = None
    if args.poses:
        from densemonoslam_tpu.io.datasets import GroundTruthOdometry

        gt_odom = GroundTruthOdometry(args.poses)
    gt_clusters = None
    if args.clusters:
        from densemonoslam_tpu.io.datasets import GroundTruthClusters

        gt_clusters = GroundTruthClusters(args.clusters)
    if args.resume:
        eng.load_checkpoint("cam0", args.resume)
        print(f"resumed from {args.resume} at tick {eng.frontends['cam0'].tick}")
    viewer = None
    if args.viewer is not None:
        from densemonoslam_tpu.viewer import ViewerServer

        viewer = ViewerServer(eng, port=args.viewer, out_dir=args.out or ".")
        viewer.start()
        print(f"viewer: {viewer.url()}")

    for _ in range(args.skip):
        if not reader.has_more():
            break
        reader.get_next()

    n = 0
    t0 = None
    while reader.has_more() and n < args.frames:
        if args.dataset == "synthetic":
            rgb, depth = reader.frame(n + args.skip)
            ts = float(n + args.skip)
        else:
            rgb, depth, ts = reader.get_next()
        in_pose = gt_odom.pose_at(ts).astype(np.float32) if gt_odom else None
        cluster = gt_clusters.cluster_at(ts) if gt_clusters else 0
        if args.predict_depth:
            depth = None  # monocular: the CNN supplies depth
        if viewer is not None:
            viewer.sync(["cam0"])  # pause/step/params/saves
        eng.process_frame(
            "cam0", rgb, depth, ts, in_pose=in_pose, sync=False, cluster=cluster
        )
        n += 1
        if viewer is not None and n % args.viewer_interval == 0:
            viewer.publish("cam0")
        if n == 2:
            t0 = time.perf_counter()
    import jax

    jax.block_until_ready(eng.frontends["cam0"].state.map_data)
    fps = (n - 2) / (time.perf_counter() - t0) if t0 and n > 2 else 0.0

    summary = {"frames": n, "fps": fps, "surfels": eng.surfel_count("cam0")}
    print(f"processed {n} frames at {fps:.1f} fps; surfels={summary['surfels']}")
    if args.dataset == "synthetic":
        from densemonoslam_tpu.eval import ate_rmse

        gt = [reader.gt_pose(i + args.skip) for i in range(n)]
        est = [p for _, p in eng.frontends["cam0"].trajectory]
        summary["ate_mm"] = ate_rmse(est, gt) * 1000
        print(f"ATE RMSE vs analytic GT: {summary['ate_mm']:.2f} mm")
    elif args.gt:
        from densemonoslam_tpu.eval import ate_rmse
        from densemonoslam_tpu.io.datasets import load_freiburg_trajectory

        _, gt_poses = load_freiburg_trajectory(args.gt)
        est = [p for _, p in eng.frontends["cam0"].trajectory]
        k = min(len(gt_poses), len(est))
        summary["ate_mm"] = ate_rmse(est[:k], list(gt_poses[:k])) * 1000
        print(f"ATE RMSE: {summary['ate_mm']:.2f} mm")

    if args.out:
        os.makedirs(args.out, exist_ok=True)
        eng.save_trajectory("cam0", os.path.join(args.out, "trajectory.freiburg"))
        n_ply = eng.save_ply("cam0", os.path.join(args.out, "map.ply"), stable_only=False)
        eng.save_stats("cam0", os.path.join(args.out, "run.stats"))
        eng.save_times(os.path.join(args.out, "timings.csv"))
        print(f"exports in {args.out} (map: {n_ply} surfels)")
    if args.checkpoint:
        eng.save_checkpoint("cam0", args.checkpoint)
        print(f"checkpoint: {args.checkpoint}")
    if viewer is not None:
        viewer.publish("cam0")
        if args.viewer_hold:
            print("sequence done; viewer still serving (Ctrl-C to exit)")
            try:
                while True:
                    viewer.sync(["cam0"])
                    viewer.publish("cam0")  # keep status/params fresh
                    time.sleep(0.5)
            except KeyboardInterrupt:
                pass
        viewer.stop()
    return summary


if __name__ == "__main__":
    sys.exit(main())
