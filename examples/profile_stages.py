"""Per-stage timing of the fused SLAM step on the GPU.

Times each pipeline stage (preprocess, tracking GN, splat render, fusion,
NID) as its own jitted function over realistic 640x480 state, then the full
fused step, so optimisation effort lands where the frame time actually goes
(the reference's per-category Stopwatch breakdown, `ElasticFusion.cpp:898-931`,
plays the same role).

Usage: python examples/profile_stages.py [--width 640 --height 480]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp
import numpy as np

from densemonoslam_tpu.config import (
    CameraConfig, CameraIntrinsics, EngineConfig, FrameResolution,
)
from densemonoslam_tpu.engine import Engine
from densemonoslam_tpu.io.synthetic import SyntheticSequence
from densemonoslam_tpu.mapping import fusion, keyframe as kfmod
from densemonoslam_tpu.ops import geometry, preprocess, splat
from densemonoslam_tpu.mapping import surfel_map as sm
from densemonoslam_tpu.tracking import odometry


def timeit(fn, *args, iters=30, warmup=3):
    for _ in range(warmup):
        out = fn(*args)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / iters * 1000.0


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--height", type=int, default=480)
    ap.add_argument("--frames", type=int, default=24)
    args = ap.parse_args()
    W, H = args.width, args.height

    camera = CameraConfig(
        FrameResolution(W, H),
        CameraIntrinsics(528.0 * W / 640, 528.0 * H / 480, W / 2 - 0.5, H / 2 - 0.5),
        "prof",
    )
    cfg = EngineConfig(
        max_surfels=1 << 20, depth_cutoff=8.0, depth_factor=1.0,
        nid_keyframing=True, pyramid_levels=4, track_row_stride=2,
        open_loop=True,
    )
    seq = SyntheticSequence(camera=camera, num_frames=args.frames, radius=0.12,
                            max_angle=0.12)
    eng = Engine(camera, cfg)
    eng.frontend("cam0")
    frames = [
        (jax.device_put(jnp.asarray(r)), jax.device_put(jnp.asarray(d)))
        for r, d in (seq.frame(i) for i in range(args.frames))
    ]
    jax.block_until_ready(frames)
    # build up a real mid-sequence state
    for i in range(args.frames):
        eng.process_frame("cam0", *frames[i], float(i), sync=False)
    st = eng.frontends["cam0"].state
    jax.block_until_ready(st.map_data)
    intr = camera.intrinsics
    rgb, depth_raw = frames[-1]
    levels = cfg.pyramid_levels

    # --- stages ---
    @jax.jit
    def stage_preprocess(rgb, depth_raw):
        depth_track = preprocess.metricise_depth(
            depth_raw, cfg.depth_factor, max(cfg.max_depth, cfg.depth_cutoff))
        depth_m = jnp.where(depth_track <= cfg.depth_cutoff, depth_track, 0.0)
        depth_f = preprocess.bilateral_filter_depth(depth_track)
        vmap_f = geometry.backproject(depth_m, intr)
        nmap_f = geometry.normal_map(vmap_f)
        intensity = preprocess.rgb_to_intensity(rgb)
        pyr = odometry.build_frame_pyramid(rgb, depth_f, intr, levels)
        return depth_m, vmap_f, nmap_f, intensity, pyr

    depth_m, vmap_f, nmap_f, intensity, frame_pyr = stage_preprocess(rgb, depth_raw)

    @jax.jit
    def stage_model_pyr(pi, pv, pn):
        return odometry.build_model_pyramid(pi, pv, pn, levels)

    model_pyr = stage_model_pyr(st.pred_intensity, st.pred_vmap, st.pred_nmap)

    @jax.jit
    def stage_track(model_pyr, frame_pyr, A):
        return odometry.track(
            model_pyr, frame_pyr, A, intr,
            iterations=cfg.iterations_for_levels(), icp_weight=cfg.icp_weight,
            row_stride=cfg.track_row_stride)

    res = stage_track(model_pyr, frame_pyr, st.model_rel)

    win = cfg.active_window if cfg.active_window < cfg.max_surfels else 0

    @jax.jit
    def stage_render(data, count, pose, t):
        return splat.render(data, count, pose, intr, W, H, t,
                            time_delta=cfg.time_delta,
                            mode=splat.MODE_ACTIVE, window=win)

    pred = stage_render(st.map_data, st.map_count, st.pose, st.tick)

    N_cap = st.map_data.shape[0] - 1
    win_n = win if (win > 0 and win < N_cap) else N_cap

    @jax.jit
    def stage_fuse(data, count, pred, vmap_f, nmap_f, rgb, pose, t):
        win_start = splat.active_window_start(count, N_cap, win_n)
        rows = jax.lax.dynamic_slice(data, (win_start, 0), (win_n, sm.COLS))
        blk, packed, rank, n_want, matched, culled = fusion.fuse_window(
            rows, win_start, count, pred, vmap_f, nmap_f,
            rgb.astype(jnp.float32), pose, intr, time=t, sensor=0,
            weight_mult=jnp.float32(1.0), clean_depth=depth_m,
            conf_threshold=cfg.confidence_threshold, time_delta=cfg.time_delta,
            cluster_id=jnp.float32(0.0))
        data2, count2, added, dropped = fusion.place_updates(
            data, count, blk, win_start, packed[: H * W], n_want,
            rank[: H * W])
        return data2, count2

    @jax.jit
    def stage_nid(kf_pose, kf_int, kf_dep, intensity, vmap_f, pose):
        n_img, n_depth, overlap = kfmod.nid_against_keyframe(
            kfmod.KeyFrame(pose=kf_pose, intensity=kf_int, depth=kf_dep),
            intensity, vmap_f, pose, intr, depth_max=cfg.depth_cutoff,
            bins_img=cfg.nid_bins_img, bins_depth=cfg.nid_bins_depth,
            stride=cfg.nid_stride)
        return kfmod.nid_score(n_img, n_depth, cfg.nid_depth_weight)

    out = {}
    out["preprocess"] = timeit(stage_preprocess, rgb, depth_raw)
    out["model_pyramid"] = timeit(
        stage_model_pyr, st.pred_intensity, st.pred_vmap, st.pred_nmap)
    out["track_gn"] = timeit(stage_track, model_pyr, frame_pyr, st.model_rel)
    out["splat_render"] = timeit(
        stage_render, st.map_data, st.map_count, st.pose, st.tick)
    # fuse donates nothing here (data reused), so time it with fresh copies
    out["fuse+place"] = timeit(
        stage_fuse, st.map_data, st.map_count, pred, vmap_f, nmap_f, rgb,
        st.pose, st.tick)
    out["nid"] = timeit(
        stage_nid, st.kf_pose, st.kf_intensity, st.kf_depth, intensity,
        vmap_f, st.pose)

    # full fused step, steady-state (replay last frame repeatedly)
    step = eng.frontends["cam0"].step_fn

    def full(state):
        s2, stats = step(state, rgb, depth_raw, jnp.eye(4), jnp.asarray(False),
                         jnp.float32(1.0), jnp.float32(0.0))
        return s2, stats

    state = st
    for _ in range(3):
        state, stats = full(state)
    jax.block_until_ready(stats)
    t0 = time.perf_counter()
    iters = 60
    for _ in range(iters):
        state, stats = full(state)
    jax.block_until_ready(stats)
    out["FULL_STEP"] = (time.perf_counter() - t0) / iters * 1000.0

    total = sum(v for k, v in out.items() if k != "FULL_STEP")
    print(f"{'stage':<16} ms")
    for k, v in out.items():
        print(f"{k:<16} {v:7.3f}")
    print(f"{'sum(stages)':<16} {total:7.3f}")
    print(f"platform={jax.devices()[0].platform} {jax.devices()[0]}")


if __name__ == "__main__":
    main()
