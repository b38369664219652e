"""Per-stage breakdown of one accepted local loop closure.

Builds a map + state in exactly the bench's closed-loop configuration,
forces the INACTIVE overlap a closure needs, then times each stage of
`loops._make_local_loop` SEPARATELY (each as its own jitted program, queued
5x and blocked once, so completion lag does not pollute attribution):

  render INACTIVE (full map) / render ACTIVE (windowed) / model-to-model
  track / constraint build + graph sample / GN-CG optimise / apply_to_map /
  reactivate + compact

and the fused closure program end-to-end.  Run on the GPU:
`python examples/profile_closure.py`.
"""

import functools
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import jax
import jax.numpy as jnp
import numpy as np

from densemonoslam_tpu import loops as loopsmod
from densemonoslam_tpu import step as stepmod
from densemonoslam_tpu.config import (
    CameraConfig, CameraIntrinsics, EngineConfig, FrameResolution,
)
from densemonoslam_tpu.mapping import deformation as dg
from densemonoslam_tpu.mapping import surfel_map as sm
from densemonoslam_tpu.ops import splat
from densemonoslam_tpu.tracking import odometry

N_SURFELS = int(os.environ.get("PROFILE_SURFELS", str(1 << 21)))
CAPACITY = 1 << 22
W, H = 640, 480


def timed(name, fn, *args, n=5):
    out = fn(*args)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(n):
        out = fn(*args)
    jax.block_until_ready(out)
    print(f"{name:36s} {(time.perf_counter() - t0) / n * 1e3:9.2f} ms")
    return out


def main():
    intr = CameraIntrinsics.default_for(FrameResolution(W, H))
    cfg = EngineConfig(
        max_surfels=CAPACITY, depth_cutoff=8.0, depth_factor=1.0,
        nid_keyframing=True, open_loop=False, loop_check_interval=8,
        time_delta=30, deform_graph_sample_rate=2000, max_deform_nodes=256,
        loop_min_inactive_frac=0.05, loop_cons_err_thresh=0.02,
        pyramid_levels=4, track_row_stride=2,
    )
    rng = np.random.default_rng(0)

    # map: half old epoch (inactive), half recent (active), same scene region
    # so the INACTIVE render overlaps the view
    data = np.zeros((CAPACITY + 1, 16), np.float32)
    n = N_SURFELS
    pts = rng.normal(0, 1.5, (n, 3)).astype(np.float32)
    pts[:, 2] = np.abs(pts[:, 2]) + 1.5
    data[:n, 0:3] = pts
    data[:n, sm.CONF] = 15.0
    nm = rng.normal(0, 1, (n, 3)); nm /= np.linalg.norm(nm, axis=1, keepdims=True)
    data[:n, 8:11] = nm
    data[:n, sm.RADIUS] = 0.02
    half = n // 2
    data[:half, 12] = 10.0     # old epoch: inactive at t=500
    data[half:n, 12] = 495.0   # recent: active
    data[:half, sm.INIT_TIME] = np.linspace(0, 20, half)
    data[half:n, sm.INIT_TIME] = np.linspace(460, 495, n - half)
    t_now = 500

    state = stepmod.init_state(CAPACITY, H, W)
    state = state._replace(
        map_data=jnp.asarray(data),
        map_count=jnp.asarray(n, jnp.int32),
        tick=jnp.asarray(t_now, jnp.int32),
    )
    bank = loopsmod.make_rel_bank()
    win = cfg.active_window

    # ---- fused closure program (what the engine actually runs) ------------
    run = loopsmod._make_local_loop(intr, W, H, cfg)
    s2, info, g, b2 = run(state, bank)
    closed = float(np.asarray(info)[0])
    print(f"fused closure program: closed={closed}  "
          f"inactive_frac={float(np.asarray(info)[1]):.3f}  "
          f"inlier_frac={float(np.asarray(info)[2]):.3f}")
    timed("FULL fused closure", run, state, bank)

    # ---- stage-by-stage ----------------------------------------------------
    pose = state.pose
    r_in = functools.partial(
        splat.render, mode=splat.MODE_INACTIVE, time_delta=cfg.time_delta
    )
    pred_in = timed("render INACTIVE (full map)", r_in,
                    state.map_data, state.map_count, pose, intr, W, H, t_now)
    r_act = functools.partial(
        splat.render, mode=splat.MODE_ACTIVE, window=win,
        time_delta=cfg.time_delta,
    )
    pred_act = timed("render ACTIVE (windowed)", r_act,
                     state.map_data, state.map_count, pose, intr, W, H, t_now)

    model = odometry.build_model_pyramid(
        pred_in.intensity, pred_in.vmap, pred_in.nmap, cfg.pyramid_levels
    )
    frame = odometry.frame_pyramid_from_maps(
        pred_act.intensity, pred_act.vmap, pred_act.nmap, cfg.pyramid_levels
    )
    trk = functools.partial(
        odometry.track, iterations=cfg.iterations_for_levels(),
        icp_weight=cfg.icp_weight, use_so3=False,
    )
    res = timed("model-to-model track", trk, model, frame,
                jnp.eye(4, dtype=jnp.float32), intr)

    sg = functools.partial(
        dg.sample_graph, max_nodes=cfg.max_deform_nodes,
        sample_rate=cfg.deform_graph_sample_rate,
    )
    graph = timed("sample_graph", sg, state.map_data, state.map_count)

    cons = loopsmod._constraints_from_alignment(
        pred_act.vmap, pred_act.time, pred_in.depth, pred_in.vmap,
        pred_in.time, res.A, pose, cfg.loop_constraint_stride,
    )
    frozen = graph.time < (t_now - cfg.time_delta)
    opt = functools.partial(dg.optimise)
    graph2, stats = timed("GN-CG optimise (3x64)", opt, graph, cons, frozen)
    print(f"  mean_cons_error={float(stats.mean_cons_error):.4f}")

    atm = jax.jit(dg.apply_to_map, donate_argnums=())
    timed("apply_to_map", atm, state.map_data, state.map_count, graph2)

    rv = jax.jit(functools.partial(
        loopsmod._reactivate_in_view, intr=intr, width=W, height=H,
        depth_max=cfg.max_depth,
    ))
    timed("reactivate_in_view", rv, state.map_data, state.map_count, pose,
          t_now)

    cp = jax.jit(functools.partial(
        sm.compact, time_delta=cfg.time_delta, max_active=win,
    ), donate_argnames=())
    timed("compact (engine post-closure)", cp,
          sm.SurfelMap(data=state.map_data, count=state.map_count),
          float(t_now))


if __name__ == "__main__":
    main()
