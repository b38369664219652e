"""Run the framework on the synthetic sequence and report ATE + frames/s.

Usage:
    python examples/run_synthetic.py [--frames N] [--platform cpu|gpu] [--odometry-only]

This is the equivalent of the reference's log-replay evaluation run
(`./ElasticFusion --l log --q`): process every frame, export a `.freiburg`
trajectory, and score it against ground truth.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=30)
    ap.add_argument("--platform", default="cpu", choices=["cpu", "gpu"])
    ap.add_argument("--odometry-only", action="store_true", help="frame-to-frame tracking, no map")
    ap.add_argument("--out", default=None, help="directory for .freiburg/.ply exports")
    args = ap.parse_args()

    if args.platform == "cpu":
        os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
    import jax

    if args.platform == "cpu":
        jax.config.update("jax_platforms", "cpu")
    else:
        from densemonoslam_tpu.utils.device import require_gpu

        require_gpu()
    import jax.numpy as jnp
    import numpy as np

    from densemonoslam_tpu.config import EngineConfig
    from densemonoslam_tpu.engine import Engine
    from densemonoslam_tpu.eval import ate_rmse
    from densemonoslam_tpu.io import SyntheticSequence, save_freiburg
    from densemonoslam_tpu.tracking import odometry
    from densemonoslam_tpu.utils import Stopwatch

    seq = SyntheticSequence(num_frames=args.frames, radius=0.35, max_angle=0.3)
    intr = seq.camera.intrinsics
    gt = [seq.gt_pose(i) for i in range(args.frames)]

    if args.odometry_only:
        sw = Stopwatch()
        poses = [seq.gt_pose(0)]
        tss = [0.0]
        prev = None
        t_start = None
        for i in range(args.frames):
            rgb, depth = seq.frame(i)
            with sw.section("pyramid"):
                cur = odometry.build_frame_pyramid(
                    jnp.asarray(rgb), jnp.asarray(depth), intr, 3
                )
                jax.block_until_ready(cur.vmap[0])
            if prev is not None:
                with sw.section("track"):
                    res = odometry.track(
                        odometry.model_pyramid_from_frame(prev),
                        cur,
                        jnp.eye(4, dtype=jnp.float32),
                        intr,
                    )
                    jax.block_until_ready(res.A)
                poses.append(poses[-1] @ np.asarray(res.A))
                tss.append(float(i))
            prev = cur
            if i == 1:
                t_start = time.perf_counter()
        fps = (args.frames - 2) / (time.perf_counter() - t_start)
        err = ate_rmse(poses, gt)
        print(f"[odometry] frames: {args.frames}  ATE: {err*1000:.2f} mm  fps: {fps:.1f}")
        print("stage means (ms):", {k: round(v, 2) for k, v in sw.summary().items()})
        return 0 if err < 0.02 else 1

    # ---- full SLAM engine -------------------------------------------------
    cfg = EngineConfig(
        max_surfels=1 << 18,
        depth_cutoff=8.0,
        depth_factor=1.0,
        nid_keyframing=False,  # config-1 equivalent: always fuse (reference --nkf)
    )
    eng = Engine(seq.camera, cfg)
    eng.frontend("cam0")
    eng.frontends["cam0"].pose = seq.gt_pose(0).astype(np.float32)
    t_start = None
    for i in range(args.frames):
        rgb, depth = seq.frame(i)
        info = eng.process_frame("cam0", rgb, depth, float(i))
        if info["tracking_ok"] != 1.0:
            print(f"frame {i}: TRACKING FAILED")
        if i == 1:
            t_start = time.perf_counter()
    fps = (args.frames - 2) / (time.perf_counter() - t_start)
    est = [p for _, p in eng.frontends["cam0"].trajectory]
    err = ate_rmse(est, gt)
    print(
        f"[slam] frames: {args.frames}  ATE: {err*1000:.2f} mm  fps: {fps:.1f}  "
        f"surfels: {eng.surfel_count('cam0')}"
    )
    print("stage means (ms):", {k: round(v, 2) for k, v in eng.timer.summary().items()})

    if args.out:
        os.makedirs(args.out, exist_ok=True)
        eng.save_trajectory("cam0", os.path.join(args.out, "synthetic.freiburg"))
        n = eng.save_ply("cam0", os.path.join(args.out, "map.ply"), stable_only=False)
        eng.save_times(os.path.join(args.out, "timings.csv"))
        eng.save_stats("cam0", os.path.join(args.out, "run.stats"))
        print(f"wrote {args.out}/: trajectory, map.ply ({n} surfels), timings, stats")
    return 0 if err < 0.02 else 1


if __name__ == "__main__":
    sys.exit(main())
