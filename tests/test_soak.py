"""Long-sequence soak: 1000 frames of repeated scene laps through the FULL
engine (tracking + fusion + NID + windowing + loop machinery).

Asserts the properties that only show up at length:
bounded memory (surfel count plateaus under the active-window/compaction
scheme instead of growing linearly), flat per-frame cost (late batches are
not slower than early ones), and bounded trajectory error across laps.
"""

import time

import numpy as np
import pytest

import jax

from densemonoslam_tpu.config import EngineConfig
from densemonoslam_tpu.engine import Engine
from densemonoslam_tpu.eval import ate_rmse
from densemonoslam_tpu.io.synthetic import SyntheticSequence

N_FRAMES = 1000
LAP = 40  # frames per orbit lap; frame i revisits frame i % LAP


def test_soak_1000_frames_bounded():
    seq = SyntheticSequence(num_frames=LAP, radius=0.35, max_angle=0.3)
    cfg = EngineConfig(
        max_surfels=1 << 18,
        depth_cutoff=8.0,
        depth_factor=1.0,
        nid_keyframing=True,
        nid_threshold=0.80,
        time_delta=60,  # a lap and a half: revisits land in the inactive map
        loop_check_interval=16,
        deform_graph_sample_rate=600,
        max_deform_nodes=128,
        loop_min_inactive_frac=0.05,
        loop_cons_err_thresh=0.02,
        confidence_threshold=1.0,
    )
    eng = Engine(seq.camera, cfg)
    eng.frontend("cam0")
    fe = eng.frontends["cam0"]
    fe.pose = seq.gt_pose(0).astype(np.float32)

    frames = [seq.frame(i) for i in range(LAP)]  # pre-render (host cost out)
    batch_wall = []
    counts = []
    dropped_total = 0.0
    t0 = time.perf_counter()
    for i in range(N_FRAMES):
        rgb, depth = frames[i % LAP]
        eng.process_frame("cam0", rgb, depth, float(i), sync=False)
        if (i + 1) % 100 == 0:
            jax.block_until_ready(fe.state.map_count)
            t1 = time.perf_counter()
            batch_wall.append(t1 - t0)
            counts.append(int(fe.state.map_count))
            t0 = t1
    rows = np.stack([np.asarray(s) for s in fe.stats_log])
    dropped_total = float(rows[:, 12].sum())  # STAT_DROPPED

    # memory bounded: the map plateaus instead of growing ~linearly with
    # frames (25 laps over the same scene must mostly re-fuse, not re-insert)
    assert counts[-1] < 0.8 * cfg.max_surfels, counts
    assert counts[-1] < 2.0 * counts[2], counts
    # flat per-frame cost: the last batches are not much slower than the
    # early ones (compaction keeps the hot window small)
    early = np.mean(batch_wall[1:4])
    late = np.mean(batch_wall[-3:])
    assert late < 2.0 * early, batch_wall
    # trajectory stays sane across 25 laps of pure dense tracking
    est = [p for _, p in fe.trajectory]
    gt = [seq.gt_pose(i % LAP) for i in range(N_FRAMES)]
    err = ate_rmse(est, gt)
    assert err < 0.03, f"soak ATE {err*100:.1f} cm"
    # capacity accounting: any clamped insertions are SURFACED in stats
    assert dropped_total >= 0.0  # column exists and is finite
    assert np.isfinite(dropped_total)
