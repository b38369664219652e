"""Smoke test of the SLAM engine's main path on NVIDIA GPUs.

    python chip_smoke.py               # one card
    python chip_smoke.py --four-cards  # the sharded paths on four cards

With one card the phases run in order:

1. device   — JAX's default device must be a GPU (no CPU fallback);
2. kernels  — the deformation apply and the Gram reduction at real widths
              against float64 numpy references, with their times;
3. rgbd     — the CLI path on the synthetic sequence at 640x480 with the
              reference's 32M-surfel map capacity, NID keyframing, open loop;
4. closure  — the revisit lap at 640x480 with local loop closures on;
5. mono     — the 1024x320 street lap with CNN depth, the sparse tracker,
              local BA and hybrid loops.

With ``--four-cards`` only the paths that exist across cards run, each
against its single-card twin: the collaborative step, distributed PGO and
landmark-sharded BA, the map-sharded deformation apply, and one inter-map
round.

Every number printed is labelled with the card's name and power limit.  A
phase that fails prints its traceback; the script then exits non-zero and
prints no result.  Only when every phase passed is the last line of stdout
one JSON object ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
import traceback

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

# ATE of the closure and mono phases run on XLA's CPU backend (same code,
# same frames, same seeds).  The card must stay within a factor of them: sums
# run in another order per backend, and both pipelines amplify last-bit
# differences (which frames close a loop, which keyframes BA keeps) — two
# CPU runs of the closure lap on neighbouring code read 96.96 and 101.93 mm.
CLOSURE_ATE_MM_CPU = 101.93
MONO_ATE_M_CPU = 6.0097
CLOSURE_ATE_MARGIN = 2.0
MONO_ATE_FACTOR = 2.0

MAP_ROWS = 1 << 22  # the monocular config's map capacity
RGBD_ARGS = ["--frames", "60", "--width", "640", "--height", "480",
             "--max-surfels", str(1 << 25)]  # the reference's 5700^2 surfels
DEFORM_SAMPLE = 131072  # live rows checked against the float64 reference
GRAM_ROWS = 640 * 480
COLLAB_RES = (640, 480)


def _median_ms(fn, reps):
    import jax

    times = []
    for _ in range(reps):
        t = time.perf_counter()
        jax.block_until_ready(fn())
        times.append((time.perf_counter() - t) * 1e3)
    return float(np.median(times))


# ---------------------------------------------------------------- references


def blend_reference(pos, time_, valid, A, t, pts, times, nrm):
    """float64 numpy evaluation of `deformation._blend_weights` +
    `deform_points`: k=4 nearest of the 20-node temporal look-back window,
    Sumner weights (1 - d/d_max)^2 normalised, phi(p) = sum w (A(p-g)+g+t),
    normals co-rotated by the blended A and renormalised."""
    from densemonoslam_tpu.mapping import deformation as dg

    L, k = dg.LOOKBACK, dg.K_NEIGHBOURS
    K = pos.shape[0]
    n_valid = int(valid.sum())
    ins = np.searchsorted(time_, times, side="right")  # float32 on both sides
    start = np.clip(ins - L, 0, max(n_valid - L, 0))
    cand = np.clip(start[:, None] + np.arange(L)[None], 0, K - 1)
    ok = (cand < n_valid) & valid[cand]
    p64 = pts.astype(np.float64)
    g = pos.astype(np.float64)[cand]
    d = np.linalg.norm(g - p64[:, None], axis=-1)
    d = np.where(ok, d, np.inf)
    order = np.argsort(d, axis=1, kind="stable")[:, : k + 1]
    dk = np.take_along_axis(d, order, axis=1)
    dmax = np.maximum(dk[:, -1:], 1e-6)
    with np.errstate(invalid="ignore"):
        w = np.square(1.0 - dk[:, :-1] / dmax)
    w = np.where(np.isfinite(dk[:, :-1]), w, 0.0)
    wsum = w.sum(axis=1, keepdims=True)
    has = wsum[:, 0] > 1e-9
    w = np.where(has[:, None], w / np.maximum(wsum, 1e-9), 0.0)
    nn = np.take_along_axis(cand, order[:, :-1], axis=1)
    A64, t64, pos64 = A.astype(np.float64), t.astype(np.float64), pos.astype(np.float64)
    Ab = np.einsum("pk,pkij->pij", w, A64[nn])
    c = pos64 + t64 - np.einsum("kij,kj->ki", A64, pos64)
    out = np.einsum("pij,pj->pi", Ab, p64) + np.einsum("pk,pki->pi", w, c[nn])
    n_out = np.einsum("pij,pj->pi", Ab, nrm.astype(np.float64))
    n_out /= np.maximum(np.linalg.norm(n_out, axis=-1, keepdims=True), 1e-9)
    out = np.where(has[:, None], out, p64)
    n_out = np.where(has[:, None], n_out, nrm)
    return out, n_out


def random_map(seed, rows, count, scale):
    """A [rows+1, COLS] surfel map made on the device: `count` rows in
    temporal append order inside a cube of half-size `scale` metres, unit
    normals, about 3% of them culled (zero confidence)."""
    import jax
    import jax.numpy as jnp

    from densemonoslam_tpu.mapping import surfel_map as sm

    k = jax.random.split(jax.random.PRNGKey(seed), 4)
    idx = jnp.arange(rows + 1)
    live = idx < count
    pos = jax.random.uniform(k[0], (rows + 1, 3), minval=-scale, maxval=scale)
    nrm = jax.random.normal(k[1], (rows + 1, 3))
    nrm = nrm / jnp.linalg.norm(nrm, axis=-1, keepdims=True)
    conf = jnp.where(jax.random.uniform(k[2], (rows + 1,)) < 0.03, 0.0, 5.0)
    data = jnp.zeros((rows + 1, sm.COLS), jnp.float32)
    data = data.at[:, sm.POS].set(pos).at[:, sm.NORMAL].set(nrm)
    data = data.at[:, sm.CONF].set(jnp.where(live, conf, 0.0))
    data = data.at[:, sm.INIT_TIME].set(
        jnp.where(live, idx.astype(jnp.float32) * (1000.0 / count), 0.0)
    )
    return data.at[-1].set(0.0)


def random_graph(data, count, nodes, scale, seed):
    """`sample_graph` over the map, then a non-rigid perturbation: node
    affines I + 0.05 N(0,1), translations 1% of the map's extent."""
    import jax
    import jax.numpy as jnp

    from densemonoslam_tpu.mapping import deformation as dg

    g = dg.sample_graph(data, count, max_nodes=nodes, sample_rate=1000)
    ka, kt = jax.random.split(jax.random.PRNGKey(seed))
    A = g.A + 0.05 * jax.random.normal(ka, g.A.shape)
    t = 0.01 * scale * jax.random.normal(kt, g.t.shape)
    return g._replace(A=A, t=t)


# ------------------------------------------------------------------- phases


def phase_kernels(say):
    import jax
    import jax.numpy as jnp

    from densemonoslam_tpu.mapping import deformation as dg
    from densemonoslam_tpu.mapping import surfel_map as sm
    from densemonoslam_tpu.ops import reductions

    rng = np.random.default_rng(0)
    count = MAP_ROWS - MAP_ROWS // 8  # a partly filled map
    # room scale with the 256-node graph the closure configs use, street
    # scale with the reference's 2048-node buffer
    for nodes, scale, tol_p in ((256, 3.0, "abs"), (2048, 300.0, "rel")):
        data = random_map(nodes, MAP_ROWS, count, scale)
        cnt = jnp.asarray(count, jnp.int32)
        graph = random_graph(data, cnt, nodes, scale, seed=nodes + 1)
        live = rng.choice(count, DEFORM_SAMPLE, replace=False)
        tail = rng.integers(count, MAP_ROWS, 4096)
        sample = np.sort(np.concatenate([live, tail]))
        before = np.asarray(data[jnp.asarray(sample)])
        g = jax.tree.map(np.asarray, graph)
        t0 = time.perf_counter()
        out = dg.apply_to_map(data, cnt, graph)  # donates `data`
        after = np.asarray(out[jnp.asarray(sample)])
        first_s = time.perf_counter() - t0
        alive = before[:, sm.CONF] > 0
        ref_p, ref_n = blend_reference(
            g.pos, g.time, g.valid, g.A, g.t,
            before[alive][:, sm.POS], before[alive][:, sm.INIT_TIME],
            before[alive][:, sm.NORMAL],
        )
        dp = np.abs(after[alive][:, sm.POS] - ref_p).max(axis=1)
        dn = np.abs(after[alive][:, sm.NORMAL] - ref_n).max()
        # f32 carries ~7 digits: 1e-4 m is ~30 ulps of a 3 m coordinate, and
        # 1e-5 |p| the same share of a street-scale one
        bound = 1e-4 if tol_p == "abs" else 1e-5 * np.maximum(
            np.abs(ref_p).max(axis=1), 1.0
        )
        dead_same = np.array_equal(after[~alive], before[~alive])
        moved = float(np.abs(ref_p - before[alive][:, sm.POS]).max())
        times = []
        for _ in range(5):  # compiled by the first call; each call donates
            t0 = time.perf_counter()
            out = jax.block_until_ready(dg.apply_to_map(out, cnt, graph))
            times.append((time.perf_counter() - t0) * 1e3)
        ms = float(np.median(times))
        say(
            f"kernels: apply_to_map rows={MAP_ROWS} live={count} K={nodes} "
            f"scale={scale} m: max|dp|={dp.max():.3e} m (bound "
            f"{'1e-4 m' if tol_p == 'abs' else '1e-5|p|'}), "
            f"max|dn|={dn:.3e} (bound 1e-5), max reference move={moved:.3f} m, "
            f"dead rows untouched={dead_same}, checked rows={int(alive.sum())}; "
            f"first call {first_s:.2f} s, median {ms:.3f} ms"
        )
        assert np.all(dp <= bound), "deformed positions off the reference"
        assert dn <= 1e-5, "deformed normals off the reference"
        assert dead_same, "apply_to_map touched dead rows"
        del out

    gram = jax.jit(reductions.gram)
    gram_tf = jax.jit(
        lambda M: jax.lax.dot_general(
            M, M, (((0,), (0,)), ((), ())), precision=jax.lax.Precision.DEFAULT,
            preferred_element_type=jnp.float32,
        )
    )
    for C in (8, 16):
        M = jax.random.normal(jax.random.PRNGKey(C), (GRAM_ROWS, C))
        M64 = np.asarray(M).astype(np.float64)
        ref = M64.T @ M64
        # f32 summation error is bounded relative to sum_p |m_pi m_pj|
        scale = np.abs(M64).T @ np.abs(M64)
        err = float(np.max(np.abs(np.asarray(gram(M)) - ref) / scale))
        err_default = float(np.max(np.abs(np.asarray(gram_tf(M)) - ref) / scale))
        us = 1e3 * _median_ms(lambda: gram(M), 20)
        say(
            f"kernels: gram P={GRAM_ROWS} C={C}: max|dG|/(|M|^T|M|)={err:.3e} "
            f"(bound 1e-5) at precision=highest, {err_default:.3e} at "
            f"precision=default (not asserted); median {us:.1f} us"
        )
        assert err <= 1e-5, "Gram off the float64 reference"


def phase_rgbd(say):
    from densemonoslam_tpu import cli

    args = cli.build_parser().parse_args(
        ["--dataset", "synthetic", "--open-loop"] + RGBD_ARGS
    )
    s = cli.run_sequence(args)
    say(
        f"rgbd: cli synthetic {args.width}x{args.height} frames={s['frames']} "
        f"capacity={args.max_surfels} NID on, open loop: {s['fps']:.2f} "
        f"frames/s (frame synthesis on the host included), ATE "
        f"{s['ate_mm']:.3f} mm, surfels {s['surfels']}"
    )
    # the bounds of tests/test_engine.py::test_engine_slam_synthetic_ate
    assert s["ate_mm"] < 10.0, "rgbd ATE above 10 mm"
    assert s["surfels"] > 10000, "rgbd map too small"


def run_closure():
    import bench

    return bench.run_slam(640, 480, 75, 45, bench.CLOSED_LOOP_CFG, lap=40)


def phase_closure(say):
    fps, ate_mm, eng, loops_timed, ms_closure = run_closure()
    closed = eng.frontends["cam0"].loops_closed
    say(
        f"closure: revisit lap 640x480 lap=40 frames=120: {fps:.2f} frames/s "
        f"over the last 75, loops closed {closed} ({loops_timed} timed, "
        f"{ms_closure:.1f} ms each), ATE {ate_mm:.3f} mm "
        f"(CPU {CLOSURE_ATE_MM_CPU} mm)"
    )
    assert closed >= 1, "no local loop closed"
    assert ate_mm <= CLOSURE_ATE_MARGIN * CLOSURE_ATE_MM_CPU, "closure ATE"


def run_mono():
    import bench

    return bench.run_mono_street(160, 70)


def phase_mono(say):
    r = run_mono()
    say(
        f"mono: street lap 1024x320 frames={r['frames']}: {r['fps']:.2f} "
        f"frames/s over the last 90, ATE {r['ate_m']:.4f} m (CPU "
        f"{MONO_ATE_M_CPU} m), hybrid_loops={r['hybrid_loops']} "
        f"sparse_loops={r['sparse_loops']} (not asserted), surfels "
        f"{r['surfels']}"
    )
    assert math.isfinite(r["ate_m"]), "non-finite poses"
    assert r["ate_m"] <= MONO_ATE_FACTOR * MONO_ATE_M_CPU, "mono ATE"


# --------------------------------------------------------------- four cards


def _ring(K, radius):
    poses = []
    for k in range(K):
        a = 2 * np.pi * k / K
        T = np.eye(4, dtype=np.float32)
        c, s = np.cos(a), np.sin(a)
        T[:3, :3] = [[c, -s, 0], [s, c, 0], [0, 0, 1]]
        T[:3, 3] = [radius * np.sin(a), 0.1 * np.sin(2 * a), radius * (np.cos(a) - 1)]
        poses.append(T)
    return np.stack(poses)


def phase_collab(say, devices):
    import jax
    import jax.numpy as jnp

    from densemonoslam_tpu.config import CameraConfig, EngineConfig
    from densemonoslam_tpu.io.synthetic import SyntheticSequence
    from densemonoslam_tpu.parallel import collab, intermap, mesh as meshmod

    n, steps = len(devices), 6
    from densemonoslam_tpu import cli

    camera = cli._scaled_camera(CameraConfig.tum_default(), *COLLAB_RES)
    H, W = camera.resolution.height, camera.resolution.width
    intr = camera.intrinsics
    seq = SyntheticSequence(camera=camera, num_frames=24, radius=0.3, max_angle=0.25)
    frames = [seq.frame(i) for i in range(steps + 2 * n)]
    cfg = EngineConfig(max_surfels=1 << 20, depth_cutoff=8.0, depth_factor=1.0,
                       max_depth=8.0, nid_keyframing=True, open_loop=True)

    def run(mesh, step, cams):
        state = collab.init_state(len(cams), cfg.max_surfels, H, W)
        state = jax.device_put(
            state, jax.tree.map(lambda _: meshmod.cam_sharding(mesh), state)
        )
        t0 = time.perf_counter()
        for i in range(steps):
            # camera c follows the orbit 2c frames ahead
            rgb = jnp.asarray(np.stack([frames[i + 2 * c][0] for c in cams]))
            dep = jnp.asarray(np.stack([frames[i + 2 * c][1] for c in cams]))
            state, stats, total = step(state, rgb, dep)
        jax.block_until_ready(state)
        return state, int(total), time.perf_counter() - t0

    mesh = meshmod.make_mesh(n_cams=n, n_map=1, devices=devices)
    step = collab.make_collab_step(mesh, intr, H, W, cfg)
    state, total, wall = run(mesh, step, list(range(n)))
    shard_devs = {s.device for s in state.map_data.addressable_shards}
    say(f"collab: {n} cameras {W}x{H}, {steps} steps: map_data shards on "
        f"{len(shard_devs)} distinct cards; wall {wall:.1f} s incl. compile")
    assert len(shard_devs) == n, "camera shards not spread over the cards"
    poses = np.asarray(state.pose)
    counts = np.asarray(state.map_count)
    assert total == counts.sum()
    mesh1 = meshmod.make_mesh(n_cams=1, n_map=1, devices=devices[:1])
    step1 = collab.make_collab_step(mesh1, intr, H, W, cfg)
    for c in range(n):
        twin, _, _ = run(mesh1, step1, [c])
        dt = float(np.abs(poses[c] - np.asarray(twin.pose)[0]).max())
        tc = int(np.asarray(twin.map_count)[0])
        say(f"collab: camera {c}: max|pose - 1-card twin|={dt:.3e}, surfels "
            f"{int(counts[c])} vs {tc}")
        assert dt <= 1e-4, "camera pose differs from its single-card twin"
        assert abs(int(counts[c]) - tc) <= max(10, tc // 1000)

    rgb = jnp.asarray(np.stack([frames[2 * c][0] for c in range(n)]))
    dep = jnp.asarray(np.stack([frames[2 * c][1] for c in range(n)]))
    round_fn = intermap.make_intermap_round(mesh, intr, H, W, cfg,
                                            verify_scale=4, fern_factor=4)
    ist = intermap.init_state(n, num_ferns=cfg.num_ferns)
    state, ist, info = round_fn(state, ist, rgb, dep)
    say(f"intermap: one round ran, map_ids {np.asarray(info.map_ids).tolist()} "
        "(merges not asserted)")


def phase_ba(say, devices):
    import jax.numpy as jnp

    from densemonoslam_tpu.config import CameraIntrinsics
    from densemonoslam_tpu.parallel import ba, mesh as meshmod
    from densemonoslam_tpu.utils import se3

    n = len(devices)
    mesh = meshmod.make_mesh(n_cams=n, n_map=1, devices=devices)
    rng = np.random.default_rng(0)

    # pose graph: a 16-keyframe ring with drifting odometry and one loop
    # edge, padded with zero-weight self-edges to a multiple of the cards
    K = 16
    gt = _ring(K, 1.0)
    Z = [np.linalg.inv(gt[k]) @ gt[k + 1] for k in range(K - 1)]
    Z.append(np.linalg.inv(gt[-1]) @ gt[0])
    est = [gt[0]]
    for k in range(K - 1):
        xi = rng.normal(0, 0.03, 6).astype(np.float32)
        est.append(est[-1] @ Z[k] @ np.asarray(se3.se3_exp(jnp.asarray(xi))))
    est = jnp.asarray(np.stack(est), jnp.float32)
    pad = (-K) % n
    edges = ba.PoseGraphEdges(
        i=jnp.asarray(np.r_[np.arange(K - 1), K - 1, np.zeros(pad)], jnp.int32),
        j=jnp.asarray(np.r_[np.arange(1, K), 0, np.zeros(pad)], jnp.int32),
        Z=jnp.asarray(np.concatenate([np.stack(Z), np.broadcast_to(np.eye(4), (pad, 4, 4))]),
                      jnp.float32),
        weight=jnp.asarray(np.r_[np.ones(K), np.zeros(pad)], jnp.float32),
    )
    single, _ = ba.optimise_pose_graph(est, edges)
    dist, _ = ba.make_distributed_pgo(mesh)(est, edges)
    terr = lambda P: float(np.mean(np.linalg.norm(np.asarray(P)[:, :3, 3] - gt[:, :3, 3], axis=1)))
    say(f"pgo: {K} keyframes, edges over {n} cards: mean |t - gt| "
        f"{terr(est):.4f} m before, {terr(single):.4f} single-card, "
        f"{terr(dist):.4f} distributed")
    assert abs(terr(single) - terr(dist)) < 5e-3, "distributed PGO differs"

    # landmark-sharded Schur BA
    intr = CameraIntrinsics(100.0, 100.0, 63.5, 47.5)
    Kc, Pn = 6, 256
    poses_gt = _ring(Kc, 0.4)
    pts = rng.uniform(-1.0, 1.0, (Pn, 3)).astype(np.float32)
    pts[:, 2] += 3.0
    cam_idx, pnt_idx, uv = [], [], []
    for c in range(Kc):
        Ti = np.linalg.inv(poses_gt[c])
        X = pts @ Ti[:3, :3].T + Ti[:3, 3]
        u = X[:, 0] / X[:, 2] * intr.fx + intr.cx
        v = X[:, 1] / X[:, 2] * intr.fy + intr.cy
        vis = (X[:, 2] > 0.2) & (u >= 0) & (u < 128) & (v >= 0) & (v < 96)
        cam_idx += [c] * int(vis.sum())
        pnt_idx += list(np.nonzero(vis)[0])
        uv += list(np.stack([u, v], -1)[vis])
    noisy = []
    for c in range(Kc):
        xi = rng.normal(0, 0.02, 6).astype(np.float32) * (c > 1)
        noisy.append(poses_gt[c] @ np.asarray(se3.se3_exp(jnp.asarray(xi))))
    prob = ba.BAProblem(
        poses=jnp.asarray(np.stack(noisy), jnp.float32),
        points=jnp.asarray(pts + rng.normal(0, 0.02, pts.shape).astype(np.float32)),
        cam_idx=jnp.asarray(cam_idx, jnp.int32), pnt_idx=jnp.asarray(pnt_idx, jnp.int32),
        uv=jnp.asarray(np.array(uv), jnp.float32), valid=jnp.ones((len(uv),), bool),
    )
    single, err_s = ba.bundle_adjust(prob, intr, iters=4, fix_cameras=2)
    run = ba.make_distributed_ba(mesh, intr, iters=4, fix_cameras=2)
    poses_d, _, err_d = run(prob.poses, *ba.shard_ba_problem(prob, n))
    dpose = float(np.abs(np.asarray(poses_d) - np.asarray(single.poses)).max())
    say(f"ba: {Kc} cameras, {Pn} landmarks over {n} cards: max|pose - "
        f"single-card|={dpose:.3e}, reprojection {float(err_d):.4f} vs "
        f"{float(err_s):.4f} px")
    assert dpose <= 1e-3 and abs(float(err_d) - float(err_s)) < 0.05


def phase_map_shard(say, devices):
    import jax
    import jax.numpy as jnp

    from densemonoslam_tpu.mapping import deformation as dg
    from densemonoslam_tpu.parallel import mesh as meshmod
    from densemonoslam_tpu.parallel.map_shard import make_sharded_apply_to_map

    n = len(devices)
    count = MAP_ROWS - MAP_ROWS // 8
    data = random_map(7, MAP_ROWS, count, 3.0)
    cnt = jnp.asarray(count, jnp.int32)
    graph = random_graph(data, cnt, 256, 3.0, seed=8)
    run = make_sharded_apply_to_map(meshmod.make_mesh(n_cams=1, n_map=n, devices=devices))
    out = run(data, cnt, graph)
    rows_devs = {s.device for s in out.addressable_shards}
    ref = np.asarray(dg.apply_to_map(data, cnt, graph))
    d = float(np.abs(np.asarray(out) - ref).max())
    say(f"map_shard: apply_to_map {MAP_ROWS} rows over a map axis of {n}: "
        f"max|sharded - single-card|={d:.3e} (bit-identical={d == 0.0}), "
        f"output on {len(rows_devs)} card(s)")
    assert d <= 1e-5, "sharded apply differs from apply_to_map"


# --------------------------------------------------------------------- main


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded paths, on four cards")
    args = ap.parse_args(argv)
    if not os.path.isdir(os.path.join(REPO, "densemonoslam_tpu")):
        print("chip_smoke: the densemonoslam_tpu package is not beside this "
              "script", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import jax

    from densemonoslam_tpu.utils import jax_cache
    from densemonoslam_tpu.utils.device import card_lines, require_gpu

    # phase 1: device
    try:
        dev = require_gpu()
    except RuntimeError as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 1
    need = 4 if args.four_cards else 1
    devices = jax.devices()
    if len(devices) < need:
        print(f"chip_smoke: {need} GPUs needed, {len(devices)} found", file=sys.stderr)
        return 1
    cards = card_lines()
    for line in cards:
        print(f"nvidia-smi: {line}")
    print(f"jax.devices(): {devices}")
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    print(f"compile cache: {jax_cache.enable()} "
          f"({'from' if env else 'JAX_COMPILATION_CACHE_DIR not set; fixed path, not'} "
          f"JAX_COMPILATION_CACHE_DIR)")
    label = cards[0]

    def say(msg):
        print(f"[{label}] {msg}", flush=True)

    compile_s = [0.0]  # host time in XLA compiles (cache hits skip them)

    def on_duration(event, duration, **_):
        if event == "/jax/core/compile/backend_compile_duration":
            compile_s[0] += duration

    jax.monitoring.register_event_duration_secs_listener(on_duration)

    if args.four_cards:
        devs = devices[:4]
        phases = [
            ("collab", lambda: phase_collab(say, devs)),
            ("ba", lambda: phase_ba(say, devs)),
            ("map_shard", lambda: phase_map_shard(say, devs)),
        ]
    else:
        phases = [
            ("kernels", lambda: phase_kernels(say)),
            ("rgbd", lambda: phase_rgbd(say)),
            ("closure", lambda: phase_closure(say)),
            ("mono", lambda: phase_mono(say)),
        ]
    failed = []
    for name, fn in phases:
        t0, c0 = time.perf_counter(), compile_s[0]
        try:
            fn()
        except Exception:  # report every phase, then fail the run
            traceback.print_exc()
            failed.append(name)
        say(f"phase {name}: {'FAILED' if name in failed else 'ok'}, wall "
            f"{time.perf_counter() - t0:.1f} s, of which XLA compiles "
            f"{compile_s[0] - c0:.1f} s")
    if failed:
        print(f"chip_smoke: failed phases: {', '.join(failed)}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind, "count": len(devices),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
