"""Post-closure reactivation vs the windowed hot passes.

The reference reactivates only surfels the deformation moved into the current
view (`copy_unstable.vert:150-156`).  Round-3 bumped EVERY live surfel, so on
maps with more live surfels than `active_window` the active set overflowed the
tail block that the windowed ACTIVE-mode render/fusion streams — the overflow
silently fell out of fusion and duplicate geometry accumulated on revisited
regions.  These tests pin the fix:

1. `_reactivate_in_view` bumps only in-frustum surfels;
2. `compact(max_active=...)` demotes active-set overflow back to inactive;
3. end-to-end: a session whose live count exceeds `active_window` closes a
   loop and keeps every ACTIVE surfel inside the streamed tail window, with
   no duplicate-fusion blow-up on the subsequent revisit.
"""

import jax.numpy as jnp
import numpy as np

from densemonoslam_tpu import loops
from densemonoslam_tpu.config import CameraIntrinsics, EngineConfig
from densemonoslam_tpu.engine import Engine
from densemonoslam_tpu.io.synthetic import SyntheticSequence
from densemonoslam_tpu.mapping import surfel_map as sm


def _mk_map(positions, t_seen=0.0):
    n = len(positions)
    data = np.zeros((n + 1, sm.COLS), np.float32)
    data[:n, 0:3] = positions
    data[:n, sm.CONF] = 5.0
    data[:n, 8:11] = [0, 0, -1]
    data[:n, 12:15] = t_seen
    return jnp.asarray(data), jnp.asarray(n, jnp.int32)


def test_reactivate_only_in_frustum():
    intr = CameraIntrinsics(100.0, 100.0, 39.5, 29.5)  # 80x60 view
    W, H = 80, 60
    pos = np.array(
        [
            [0.0, 0.0, 1.0],   # dead centre, in view
            [0.0, 0.0, -1.0],  # behind the camera
            [10.0, 0.0, 1.0],  # projects far off-screen
            [0.3, 0.2, 2.0],   # in view
            [0.0, 0.0, 50.0],  # beyond depth_max
        ],
        np.float32,
    )
    data, count = _mk_map(pos, t_seen=3.0)
    out = loops._reactivate_in_view(
        data, count, jnp.eye(4), 100, intr, W, H, depth_max=25.0
    )
    seen = np.asarray(out)[:-1, 12]
    assert seen[0] == 100.0
    assert seen[3] == 100.0
    assert seen[1] == 3.0  # behind: untouched
    assert seen[2] == 3.0  # off-screen: untouched
    assert seen[4] == 3.0  # too far: untouched


def test_compact_max_active_demotes_overflow():
    n = 40
    pos = np.random.default_rng(0).uniform(-1, 1, (n, 3)).astype(np.float32)
    data, count = _mk_map(pos, t_seen=99.0)  # everything recently seen
    m = sm.SurfelMap(data=data, count=count)
    out = sm.compact(m, time=100.0, time_delta=50, max_active=16)
    assert int(out.count) == n  # nothing culled, only demoted
    d = np.asarray(out.data)[:-1]
    seen = d[:n, 12:15].max(axis=1)
    active = 100.0 - seen < 50
    assert active.sum() == 16, active.sum()
    # layout invariant: all active rows are the LAST rows (inside any tail
    # window of >= 16 rows)
    assert np.all(np.where(active)[0] >= n - 16)


def test_compact_max_active_noop_when_under_cap():
    n = 10
    pos = np.zeros((n, 3), np.float32)
    data, count = _mk_map(pos, t_seen=99.0)
    out = sm.compact(
        sm.SurfelMap(data=data, count=count),
        time=100.0, time_delta=50, max_active=16,
    )
    d = np.asarray(out.data)[:-1]
    seen = d[:n, 12:15].max(axis=1)
    assert np.all(100.0 - seen < 50)  # nothing demoted


def _active_overflow(state, t_now, time_delta, window):
    """(#active surfels, #active surfels OUTSIDE the streamed tail window)."""
    data = np.asarray(state.map_data)[:-1]
    count = int(state.map_count)
    idx = np.arange(data.shape[0])
    alive = (data[:, sm.CONF] > 0) & (idx < count)
    seen = data[:, 12:15].max(axis=1)
    active = alive & (t_now - seen < time_delta)
    start = max(count - window, 0)
    return int(active.sum()), int((active & (idx < start)).sum())


def test_closure_keeps_active_set_inside_window():
    """Live count > active_window + an accepted loop closure: every ACTIVE
    surfel must stay inside the windowed tail block, and the post-closure
    revisit must re-fuse (not duplicate) the revisited region."""
    window = 1 << 15  # 32768: > one 160x120 view, < the map we build
    cfg = EngineConfig(
        max_surfels=1 << 18,
        active_window=window,
        depth_cutoff=8.0,
        depth_factor=1.0,
        nid_keyframing=False,
        open_loop=False,
        loop_check_interval=5,
        time_delta=50,
        deform_graph_sample_rate=600,
        max_deform_nodes=128,
        loop_min_inactive_frac=0.05,
        loop_cons_err_thresh=0.02,
        confidence_threshold=1.0,
    )
    # wide orbit => many distinct views => live count above the window
    seq = SyntheticSequence(num_frames=48, radius=0.6, max_angle=0.6)
    eng = Engine(seq.camera, cfg)
    eng.frontend("cam0")
    fe = eng.frontends["cam0"]
    fe.pose = seq.gt_pose(0).astype(np.float32)
    for i in range(48):
        rgb, depth = seq.frame(i)
        eng.process_frame(
            "cam0", rgb, depth, float(i),
            in_pose=seq.gt_pose(i).astype(np.float32),
        )
    live0 = int(
        np.sum(np.asarray(fe.state.map_data)[: int(fe.state.map_count), sm.CONF] > 0)
    )
    assert live0 > window, f"fixture too small: {live0} live <= {window} window"

    # age everything out, then revisit the start with an 8 cm drift
    eng.global_tick += 100
    drift = np.array([0.08, 0.0, 0.0], np.float32)
    i_closed = None
    for i in range(10):
        rgb, depth = seq.frame(i)
        pose = seq.gt_pose(i).astype(np.float32).copy()
        pose[:3, 3] += drift
        eng.process_frame("cam0", rgb, depth, float(148 + i), in_pose=pose)
        if fe.loops_closed:
            i_closed = i
            break
    assert fe.loops_closed >= 1, fe.last_loop_info

    # invariant: no ACTIVE surfel outside the streamed tail window (with the
    # old bump-all reactivation, n_active jumped to ~live0 > window here and
    # the overflow fell out of the windowed fusion pass)
    n_active, overflow = _active_overflow(
        fe.state, eng.global_tick, cfg.time_delta, window
    )
    assert overflow == 0, (n_active, overflow)
    assert n_active <= window

    # re-fuse the CLOSURE view at its corrected pose: the closure reactivated
    # exactly the in-frustum region, so fusion must MATCH it, not re-insert
    # it.  (Views outside the closure frustum stay inactive until their own
    # closure — the reference behaves the same, reactivating per deformation.)
    count_before = int(fe.state.map_count)
    rgb, depth = seq.frame(i_closed)
    eng.process_frame(
        "cam0", rgb, depth, float(158),
        in_pose=seq.gt_pose(i_closed).astype(np.float32),
    )
    added = int(fe.state.map_count) - count_before
    assert added < 0.15 * 19200, (
        f"re-fusing the reactivated view re-inserted {added} surfels — "
        "duplicate fusion"
    )
    # the engine-level invariant is "no overflow after a compaction" (appends
    # between compactions are always inside the tail by construction)
    eng._compact_now(fe, eng.backend_of("cam0"))
    n_active, overflow = _active_overflow(
        fe.state, eng.global_tick, cfg.time_delta, window
    )
    assert overflow == 0, (n_active, overflow)
