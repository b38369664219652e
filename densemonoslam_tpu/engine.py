"""The SLAM engine: host-side orchestration around the fused device step.

Equivalent of the reference orchestrator stack
(`Core/src/ElasticFusion.{h,cpp}` processFrame state machine,
`Core/src/Context.h` per-camera frontend, `Core/src/ReferenceFrame.h` per-map
backend).  All per-frame compute is ONE jitted device function
(`densemonoslam_tpu.step.make_step`); the host only uploads frames, appends
device handles (poses/stats) to logs, and triggers occasional maintenance
(map compaction, loop-closure optimisation).  Nothing blocks mid-sequence:
JAX's asynchronous dispatch keeps the device queue full while the host
prepares the next frame.

Multi-camera collaborative sessions mirror the reference: each camera is a
`Frontend` (Context) with its own device `SlamState`; frontends are created
dynamically (`Engine.frontend(name)`, reference `ElasticFusion::frontend`,
`ElasticFusion.cpp:1069-1085`).  Batched/sharded multi-camera execution lives
in `densemonoslam_tpu.parallel`.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from densemonoslam_tpu import loops as loopsmod
from densemonoslam_tpu import step as stepmod
from densemonoslam_tpu.config import CameraConfig, EngineConfig
from densemonoslam_tpu.mapping import deformation as dg
from densemonoslam_tpu.mapping import surfel_map as sm
from densemonoslam_tpu.ops import splat
from densemonoslam_tpu.utils.stats import SessionStats
from densemonoslam_tpu.utils.timer import Stopwatch

_HIST_INITIAL_CAP = 1024


@jax.jit
def _intensity_and_depth(rgb, depth_raw, depth_factor):
    """One fused device program for the per-frame conversions (luma +
    metric depth) — replaces several eager channel-slice dispatches."""
    r = rgb.astype(jnp.float32)
    inten = 0.299 * r[..., 0] + 0.587 * r[..., 1] + 0.114 * r[..., 2]
    return inten, depth_raw.astype(jnp.float32) / depth_factor


@functools.partial(jax.jit, donate_argnums=(0, 1))
def _hist_append(hist, times, poses, idxs, ts):
    """Record a BATCH of poses in the device pose history.

    One scatter per flush instead of one tiny dispatch per frame: each
    per-frame device call costs a fixed launch gap that serialises with the
    SLAM step, so appends accumulate host-side and land in one chunked
    scatter at read time / cadence."""
    return hist.at[idxs].set(poses), times.at[idxs].set(ts)


_HIST_FLUSH_CHUNK = 64


@dataclasses.dataclass
class Frontend:
    """Per-camera state (reference `Context`, `Core/src/Context.h`)."""

    name: str
    sensor_id: int
    camera: CameraConfig
    state: stepmod.SlamState
    step_fn: object
    tick: int = 0
    map_name: str = ""
    # device-resident pose history [cap,4,4] + per-pose session ticks [cap]
    # (reference per-context poseGraph, `Context.h:117-156`): appends queue
    # host-side and flush as one chunked device scatter whenever the history
    # is read (loop closure, export, checkpoint) — zero per-frame dispatches.
    # REWRITTEN through the deformation graph on every accepted loop closure
    # (`Deformation.cpp:106-124,167` applyGraphToPoses over the whole pose
    # graph) — so exported trajectories reflect closures, not raw odometry.
    _pose_hist_buf: Optional[jnp.ndarray] = None
    _hist_times_buf: Optional[jnp.ndarray] = None
    _hist_pending: List = dataclasses.field(default_factory=list)
    ts_log: List[float] = dataclasses.field(default_factory=list)
    stats_log: List[jnp.ndarray] = dataclasses.field(default_factory=list)
    stats: SessionStats = dataclasses.field(default_factory=SessionStats)
    fern_state: Optional[loopsmod.FernLoopState] = None
    loops_closed: int = 0
    last_loop_info: Optional[loopsmod.LoopInfo] = None
    sparse_tracker: Optional[object] = None
    lost: bool = False
    consecutive_bad: int = 0

    @property
    def pose(self) -> np.ndarray:
        return np.asarray(self.state.pose)

    @pose.setter
    def pose(self, value: np.ndarray) -> None:
        self.state = self.state._replace(pose=jnp.asarray(value, jnp.float32))

    @property
    def trajectory(self) -> List[Tuple[float, np.ndarray]]:
        n = len(self.ts_log)
        if n == 0 or self.pose_hist is None:
            return []
        arr = np.asarray(self.pose_hist[:n])
        return [(t, arr[i]) for i, t in enumerate(self.ts_log)]

    @property
    def pose_hist(self) -> Optional[jnp.ndarray]:
        self._flush_hist()
        return self._pose_hist_buf

    @pose_hist.setter
    def pose_hist(self, value: Optional[jnp.ndarray]) -> None:
        # land queued appends in the OLD buffer first so a direct assignment
        # can never silently drop recorded poses from the trajectory
        self._flush_hist()
        self._pose_hist_buf = value

    @property
    def hist_times(self) -> Optional[jnp.ndarray]:
        self._flush_hist()
        return self._hist_times_buf

    @hist_times.setter
    def hist_times(self, value: Optional[jnp.ndarray]) -> None:
        self._flush_hist()
        self._hist_times_buf = value

    def record_pose(self, stats_row: jnp.ndarray, session_tick: int) -> None:
        """Queue one pose for the device history (no device dispatch).

        `stats_row` is the step's fresh stats output (the pose rides rows
        13:29, `step.STAT_POSE0`); a bare [4,4] pose array is also accepted
        (loop-closure/reloc paths that synthesise poses host-side)."""
        n = len(self.ts_log)  # caller appends ts_log right after
        self._hist_pending.append((stats_row, n, float(session_tick)))

    def _flush_hist(self) -> None:
        """Land queued poses in one chunked device scatter per ≤64 entries."""
        if not self._hist_pending:
            return
        pending, self._hist_pending = self._hist_pending, []
        max_n = max(n for _, n, _ in pending)
        if self._pose_hist_buf is None:
            cap = _HIST_INITIAL_CAP
            while cap <= max_n:
                cap *= 2
            self._pose_hist_buf = jnp.zeros((cap, 4, 4), jnp.float32)
            self._hist_times_buf = jnp.zeros((cap,), jnp.float32)
        while max_n >= self._pose_hist_buf.shape[0]:
            self._pose_hist_buf = jnp.concatenate(
                [self._pose_hist_buf, jnp.zeros_like(self._pose_hist_buf)]
            )
            self._hist_times_buf = jnp.concatenate(
                [self._hist_times_buf, jnp.zeros_like(self._hist_times_buf)]
            )
        for i in range(0, len(pending), _HIST_FLUSH_CHUNK):
            chunk = pending[i : i + _HIST_FLUSH_CHUNK]
            # pad to the fixed chunk size (jit cache: one shape) by repeating
            # the last entry — duplicate same-value scatters are harmless
            while len(chunk) < _HIST_FLUSH_CHUNK:
                chunk.append(chunk[-1])
            poses = jnp.stack(
                [
                    p[stepmod.STAT_POSE0 :].reshape(4, 4)
                    if p.ndim == 1
                    else p
                    for p, _, _ in chunk
                ]
            )
            idxs = jnp.asarray([n for _, n, _ in chunk], jnp.int32)
            ts = jnp.asarray([t for _, _, t in chunk], jnp.float32)
            self._pose_hist_buf, self._hist_times_buf = _hist_append(
                self._pose_hist_buf, self._hist_times_buf, poses, idxs, ts
            )

    def finalize_stats(self) -> None:
        """Realise accumulated device stats into SessionStats."""
        if not self.stats_log:
            return
        arr = np.stack([np.asarray(s) for s in self.stats_log])
        self.stats = SessionStats()
        for row in arr:
            self.stats.record(
                nid_score=float(row[stepmod.STAT_NID]),
                surfel_count=int(row[stepmod.STAT_SURFELS]),
                fused=bool(row[stepmod.STAT_FUSED] > 0),
            )
        self.stats.keyframes = int(arr[-1][stepmod.STAT_KEYFRAMES])

    @property
    def num_keyframes(self) -> int:
        return int(self.state.kf_count)


@dataclasses.dataclass
class MapBackend:
    """Per-map state (reference `ReferenceFrame`): owns the canonical surfel
    tensor.  Frontends sharing this map have the arrays swapped into their
    device `SlamState` for the duration of their step (zero-copy), and the
    updated arrays land back here — that is how several cameras fuse into one
    map after a merge (reference collaborative sessions)."""

    name: str
    map_data: object = None  # jnp [N+1, 16]
    map_count: object = None  # jnp []
    contexts: List[str] = dataclasses.field(default_factory=list)
    deforms: int = 0
    dropped: int = 0  # surfels lost to capacity clamps (merge overflow)
    # carried relative constraints (reference per-context `relativeCons()`,
    # `ElasticFusion.cpp:337,373,489-492`): emitted by accepted local
    # deformations, consumed by every subsequent deformation of this map
    rel_bank: Optional[loopsmod.RelBank] = None

    def get_rel_bank(self) -> loopsmod.RelBank:
        if self.rel_bank is None:
            self.rel_bank = loopsmod.make_rel_bank()
        return self.rel_bank


class Engine:
    """The SLAM engine (reference `ElasticFusion`)."""

    def __init__(self, camera: CameraConfig, config: Optional[EngineConfig] = None):
        self.camera = camera
        self.config = config or EngineConfig()
        self.frontends: Dict[str, Frontend] = {}
        self.maps: Dict[str, MapBackend] = {}
        self.global_tick = 0
        self.timer = Stopwatch()
        self._compact_interval = 64
        self._step_cache: Dict[Tuple, object] = {}
        self._depth_predictor = None

    def set_depth_predictor(self, predictor) -> None:
        """Attach a monocular depth network (reference `DepthPrediction`,
        used with `predict_depth=True` / `--predict_depth`)."""
        self._depth_predictor = predictor

    def update_config(self, **kw) -> None:
        """Live parameter sync (reference GUI→engine slider sync,
        `GUI/src/MainController.cpp:768-781`).  Config is baked into the
        jitted step, so each frontend's step function is re-derived through
        the step cache: the first use of a new value compiles once, after
        that the swap is a dictionary lookup."""
        self.config = self.config.replace(**kw)
        for fe in self.frontends.values():
            res = fe.camera.resolution
            key = (
                fe.camera.intrinsics, res.width, res.height,
                fe.sensor_id, self.config,
            )
            if key not in self._step_cache:
                self._step_cache[key] = stepmod.make_step(
                    fe.camera.intrinsics, res.height, res.width,
                    self.config, fe.sensor_id,
                )
            fe.step_fn = self._step_cache[key]

    # ------------------------------------------------------------------ API
    def frontend(self, name: str, sensor_id: Optional[int] = None) -> Frontend:
        """Create a camera frontend in its own new map (reference
        `ElasticFusion::frontend`)."""
        if name in self.frontends:
            return self.frontends[name]
        sensor_id = len(self.frontends) if sensor_id is None else sensor_id
        sensor_id = min(sensor_id, self.config.max_sensors - 1)
        res = self.camera.resolution
        key = (self.camera.intrinsics, res.width, res.height, sensor_id, self.config)
        if key not in self._step_cache:
            self._step_cache[key] = stepmod.make_step(
                self.camera.intrinsics, res.height, res.width, self.config, sensor_id
            )
        fe = Frontend(
            name=name,
            sensor_id=sensor_id,
            camera=self.camera,
            state=stepmod.init_state(
                self.config.max_surfels, res.height, res.width,
                levels=self.config.pyramid_levels,
            ),
            step_fn=self._step_cache[key],
            map_name=name,
        )
        self.frontends[name] = fe
        self.maps[name] = MapBackend(
            name=name,
            map_data=fe.state.map_data,
            map_count=fe.state.map_count,
            contexts=[name],
        )
        return fe

    def backend_of(self, name: str) -> MapBackend:
        return self.maps[self.frontends[name].map_name]

    def _compact_now(self, fe: Frontend, be: MapBackend) -> None:
        """Re-partition the map [inactive..., active...] immediately.

        Must run right after a closed loop: the deformation reactivates old
        surfels (bumps their last-seen to now, reference
        `copy_unstable.vert:150-156`), but the hot ACTIVE-mode passes only
        stream the active *tail window* — without a compaction the revived
        rows would sit in the inactive front block until the next periodic
        compaction and post-closure tracking/fusion would never see them,
        fusing duplicate geometry over the revisited region."""
        m = sm.compact(
            sm.SurfelMap(data=be.map_data, count=be.map_count),
            time=float(self.global_tick),
            time_delta=self.config.time_delta,
            max_active=self._max_active(),
        )
        be.map_data, be.map_count = m.data, m.count
        fe.state = fe.state._replace(map_data=m.data, map_count=m.count)

    def _max_active(self) -> int:
        """Active-set cap for compaction: the windowed hot passes stream only
        `active_window` tail rows, so compaction must never leave more than
        that many surfels inside the time window (overflow would silently
        fall out of fusion — see `surfel_map.compact` demotion)."""
        cfg = self.config
        return cfg.active_window if cfg.active_window < cfg.max_surfels else 0

    def _rewrite_history_from_pgo(self, fe: Frontend, ev) -> None:
        """Apply the sparse tracker's PGO keyframe corrections to this
        frontend's pose history (reference role: ORB-SLAM3's corrected
        trajectory after a loop; the export should be loop-consistent).

        `ev` = (kf_ticks, kf_poses_before, kf_poses_after); keyframe ticks
        index this camera's frames, which align 1:1 with the history rows."""
        n = len(fe.ts_log)
        if n == 0 or fe.pose_hist is None:
            return
        kf_ticks, before, after = ev
        if len(kf_ticks) == 0:
            return
        deltas = np.einsum(
            "kij,kjl->kil", after, np.linalg.inv(before)
        ).astype(np.float32)
        # each history row takes the delta of the last keyframe at/before it
        j = np.clip(
            np.searchsorted(kf_ticks, np.arange(n), side="right") - 1, 0, None
        )
        hist = np.asarray(fe.pose_hist[:n])
        hist = np.einsum("nij,njl->nil", deltas[j], hist)
        fe.pose_hist = fe.pose_hist.at[:n].set(jnp.asarray(hist))

    def _on_loop_closed(
        self, fe: Frontend, be: MapBackend, graph,
        rewrite_history: bool = True,
    ) -> None:
        """Everything an accepted deformation must touch beyond the map:
        rewrite the pose history and the fern keyframe poses through the
        graph (reference `Deformation::constrain` binds fern poses + the full
        pose graph, `Deformation.cpp:106-124,167`), then re-partition the map
        so reactivated surfels enter the hot active tail window.

        `rewrite_history=False` when the trajectory was ALREADY corrected
        this frame by the sparse tracker's pose-graph optimum (hybrid path):
        the deformation graph was built against the DRIFTED layout, so
        applying it on top of the PGO-corrected history would double-apply
        the loop correction."""
        if rewrite_history and fe.pose_hist is not None:
            fe.pose_hist = dg.apply_to_poses(graph, fe.pose_hist, fe.hist_times)
        if fe.fern_state is not None:
            db = fe.fern_state.db
            fe.fern_state = loopsmod.FernLoopState(
                coder=fe.fern_state.coder,
                db=db._replace(
                    poses=dg.apply_to_poses(graph, db.poses, db.times)
                ),
            )
        self._compact_now(fe, be)

    def map_of(self, map_name: str) -> sm.SurfelMap:
        be = self.maps[map_name]
        return sm.SurfelMap(data=be.map_data, count=be.map_count)

    def process_frame(
        self,
        name: str,
        rgb: np.ndarray,
        depth_raw: np.ndarray,
        timestamp: float,
        in_pose: Optional[np.ndarray] = None,
        sync: bool = True,
        cluster: int = 0,
    ) -> Dict[str, float]:
        """Process one frame for camera `name` (reference
        `ElasticFusion::processFrame`, `ElasticFusion.cpp:99-637`).

        `in_pose` (camera-to-world) bypasses dense tracking — the reference's
        ground-truth/ORB pose injection path (`--poses` / `--orb_tracking`).
        With `sync=False` nothing is fetched from device; stats land in the
        frontend's logs and the call returns an empty dict (benchmark mode:
        keeps the device pipeline full)."""
        fe = self.frontends[name]
        t0 = self.timer.tick("frame_dispatch")
        cfg = self.config
        # upload the frame ONCE; every consumer below (depth CNN, sparse
        # tracker intensity, dense step, fern encode) reuses the device copy
        # — per-channel host slices were 3 extra ~0.4 MB transfers per frame
        rgb = jnp.asarray(rgb)
        if depth_raw is not None:
            depth_raw = jnp.asarray(depth_raw, jnp.float32)
        if depth_raw is None:
            # monocular: the depth CNN supplies depth BEFORE tracking
            # (reference order: DepthPrediction::predict then TrackRGBD,
            # `MainController.cpp:319-338`)
            if not (cfg.predict_depth and self._depth_predictor is not None):
                raise ValueError(
                    "no depth given and no depth predictor attached "
                    "(set predict_depth=True and call set_depth_predictor)"
                )
            depth_raw = self._depth_predictor.predict(rgb)
        sparse_pose_dev = sparse_ok_dev = None
        if cfg.orb_tracking and in_pose is None:
            # hybrid mode: the sparse tracker supplies the pose (reference
            # `--orb_tracking`, MainController.cpp:338-359).  The tracker
            # returns DEVICE values — the step consumes them directly, so
            # hybrid mode adds no per-frame host sync (tracker host decisions
            # batch at its flush cadence).
            if fe.sparse_tracker is None:
                from densemonoslam_tpu.tracking.sparse import SparseTracker

                fe.sparse_tracker = SparseTracker(fe.camera.intrinsics)
                fe.sparse_tracker.pose = np.asarray(fe.state.pose)
            inten, d_m = _intensity_and_depth(rgb, depth_raw, cfg.depth_factor)
            sparse_pose_dev, sparse_ok_dev = fe.sparse_tracker.track(inten, d_m)
            ev = fe.sparse_tracker.pop_pgo_event()
            pgo_rewrote = ev is not None
            if ev is not None:
                # a sparse loop closed and the pose graph re-optimised:
                # rewrite the dense trajectory with the per-keyframe
                # corrections (each history entry takes the delta of the
                # last keyframe at or before it).  The deformation graph's
                # own pose rewrite (on accepted hybrid closures) handles the
                # MAP; this handles the long-range trajectory, which view-
                # local deformation constraints cannot encode.
                self._rewrite_history_from_pgo(fe, ev)
            if cfg.hybrid_loops:
                pair = fe.sparse_tracker.pop_loop()
                if pair is not None:
                    pose_est, pose_corr = pair
                    C = pose_corr @ np.linalg.inv(pose_est)
                    be0 = self.backend_of(name)
                    fe.state = fe.state._replace(
                        map_data=be0.map_data, map_count=be0.map_count
                    )
                    fe.state, linfo, lgraph = loopsmod.apply_hybrid_loop(
                        fe.state, C.astype(np.float32), fe.camera, cfg,
                        rel_bank=be0.get_rel_bank(),
                    )
                    be0.map_data, be0.map_count = (
                        fe.state.map_data, fe.state.map_count,
                    )
                    fe.last_loop_info = linfo
                    if linfo.closed:
                        fe.loops_closed += 1
                        fe.sparse_tracker.pose = np.asarray(fe.state.pose)
                        self._on_loop_closed(
                            fe, be0, lgraph,
                            rewrite_history=not pgo_rewrote,
                        )
        if sparse_pose_dev is not None:
            pose_in = sparse_pose_dev
            use_in = sparse_ok_dev  # device bool: no host branch
        else:
            use_in = in_pose is not None
            pose_in = jnp.asarray(
                in_pose if use_in else np.eye(4), jnp.float32
            )
        be = self.backend_of(name)
        # (velocity-based fusion weighting happens on device inside the step —
        # a host-side pose fetch here would force a sync every frame)
        weight = self.config.fusion_weight_multiplier
        # install the backend's canonical map + the shared session tick
        fe.state = fe.state._replace(
            map_data=be.map_data,
            map_count=be.map_count,
            tick=jnp.asarray(self.global_tick, jnp.int32),
        )
        fe.state, stats = fe.step_fn(
            fe.state,
            jnp.asarray(rgb),
            jnp.asarray(depth_raw, jnp.float32),
            pose_in,
            jnp.asarray(use_in),
            jnp.asarray(weight, jnp.float32),
            jnp.asarray(cluster, jnp.float32),
        )
        be.map_data, be.map_count = fe.state.map_data, fe.state.map_count
        fe.record_pose(stats, self.global_tick)
        self.global_tick += 1
        fe.ts_log.append(timestamp)
        fe.stats_log.append(stats)
        fe.tick += 1
        # bounded pacing: cap the async queue at ~8 frames by waiting on a
        # LONG-FINISHED frame's stats.  A free-running host queues unbounded
        # work; waiting on t-8 costs nothing in steady state (it already
        # executed) but back-pressures the host when the device falls
        # behind.  Its effect on the H100 is not measured yet.
        if fe.tick % 4 == 0 and len(fe.stats_log) > 8:
            jax.block_until_ready(fe.stats_log[-8])
        self.timer.tock("frame_dispatch", t0)
        if fe.tick % self._compact_interval == 0:
            # reclaims culled slots AND re-partitions [inactive..., active...]
            # so the hot passes' tail block stays a superset of the ACTIVE set.
            # No stale-culling here: the reference culls ONLY during fused
            # frames (clean runs inside the fusion branch) — sweeping on a
            # wall-clock cadence wipes NID-gated maps during long no-fuse
            # stretches when every surfel's age drifts into the cull window.
            m = sm.compact(
                sm.SurfelMap(data=be.map_data, count=be.map_count),
                time=float(self.global_tick),
                time_delta=self.config.time_delta,
                max_active=self._max_active(),
            )
            be.map_data, be.map_count = m.data, m.count
            fe.state = fe.state._replace(map_data=m.data, map_count=m.count)
        # lost-tracking state machine (reference `--rl`,
        # ElasticFusion.cpp:204-244: >10 consecutive bad frames => lost;
        # recovery via fern relocalisation).  The bad-frame counter lives in
        # the device SlamState (`consec_bad`) and fusion is gated on device,
        # so this path syncs only at the loop-check cadence — NOT per frame.
        # Runs BEFORE the fern block so a struggling camera stops polluting
        # the fern DB with wrong-pose keyframes.
        if cfg.relocalisation and (
            fe.tick % cfg.loop_check_interval == 0 or fe.lost
        ):
            # read the counter from a frame two cadences BACK: that step has
            # long finished, so the fetch returns without draining the
            # in-flight pipeline (polling the current frame would stall the
            # async queue every interval; the lag's cost on the H100 is not
            # measured yet).  Detection latency worst-case is ~3 cadences,
            # well inside the reference's own >10-bad-frames trip wire.
            lag = 0 if fe.lost else 2 * cfg.loop_check_interval
            idx = len(fe.stats_log) - 1 - lag
            row_rl = np.asarray(fe.stats_log[max(idx, 0)])
            fe.consecutive_bad = int(row_rl[stepmod.STAT_CONSEC_BAD])
            fe.lost = fe.consecutive_bad > 10
            if fe.lost and self.relocalise(name, rgb, depth_raw):
                fe.lost = False
                fe.consecutive_bad = 0
                fe.state = fe.state._replace(
                    consec_bad=jnp.asarray(0, jnp.int32)
                )
        # ---- loop closure / place recognition at host cadence -------------
        if (
            not cfg.open_loop
            and fe.tick % cfg.loop_check_interval == 0
            and fe.tick > 2
        ):
            if fe.fern_state is None:
                fe.fern_state = loopsmod.make_fern_state(fe.camera, cfg)
            tracking_healthy = not (
                cfg.relocalisation and (fe.lost or fe.consecutive_bad > 0)
            )
            intensity, depth_m = _intensity_and_depth(
                rgb, depth_raw, cfg.depth_factor
            )
            if tracking_healthy:
                # the reference only encodes fern keyframes on well-tracked
                # fused frames (`processFerns` runs inside the ok path)
                fe.fern_state, _, _, _ = loopsmod.update_ferns(
                    fe.fern_state, rgb, depth_m, intensity, fe.state.pose,
                    # stamp with the SESSION tick (the surfel/deformation-node
                    # timeline) so loop closures can deform fern poses by time
                    self.global_tick, cfg.fern_thresh,
                    factor=loopsmod.fern_factor(cfg),
                    max_capacity=cfg.fern_db_max,
                )
            if self.global_tick > cfg.time_delta and tracking_healthy:
                fe.state, linfo, lgraph, be.rel_bank = loopsmod.try_local_loop(
                    fe.state, fe.camera, cfg, rel_bank=be.get_rel_bank()
                )
                be.map_data, be.map_count = fe.state.map_data, fe.state.map_count
                fe.last_loop_info = linfo
                if linfo.closed:
                    fe.loops_closed += 1
                    be.deforms += 1
                    self._on_loop_closed(fe, be, lgraph)
            # inter-map: other maps' fern DBs may recognise this view
            if tracking_healthy and len(
                {f.map_name for f in self.frontends.values()}
            ) > 1:
                self._try_intermap(name, rgb, depth_raw)

        if not sync:
            return {}
        row = np.asarray(stats)
        return {
            "tracking_ok": float(row[stepmod.STAT_TRACK_OK]),
            "icp_error": float(row[stepmod.STAT_ICP_ERR]),
            "icp_inliers": float(row[stepmod.STAT_ICP_INL]),
            "nid": float(row[stepmod.STAT_NID]),
            "fused": float(row[stepmod.STAT_FUSED]),
            "fuse_matched": float(row[stepmod.STAT_MATCHED]),
            "fuse_added": float(row[stepmod.STAT_ADDED]),
            "culled": float(row[stepmod.STAT_CULLED]),
            "dropped": float(row[stepmod.STAT_DROPPED]),
            "surfels": float(row[stepmod.STAT_SURFELS]),
        }

    # ------------------------------------------------------------- exports
    def predict_view(self, name: str, mode: int = splat.MODE_ALL) -> splat.Prediction:
        fe = self.frontends[name]
        res = fe.camera.resolution
        m = self.map_of(fe.map_name)
        return splat.render(
            m.data,
            m.count,
            fe.state.pose,
            fe.camera.intrinsics,
            res.width,
            res.height,
            time=fe.tick,
            time_delta=self.config.time_delta,
            mode=mode,
        )

    def save_trajectory(self, name: str, path: str) -> None:
        from densemonoslam_tpu.io.writers import save_freiburg

        fe = self.frontends[name]
        ts = [t for t, _ in fe.trajectory]
        ps = [p for _, p in fe.trajectory]
        save_freiburg(path, ts, ps)

    def save_ply(
        self, map_name: str, path: str, stable_only: bool = True,
        cluster: Optional[int] = None,
    ) -> int:
        """Export the map as PLY; `cluster` filters to one cluster id
        (reference per-cluster VBO export, `GlobalModel.h:100-101`)."""
        from densemonoslam_tpu.io.writers import save_ply

        thr = self.config.confidence_threshold if stable_only else 0.0
        snap = sm.snapshot(self.map_of(map_name), conf_threshold=thr)
        keep = (
            slice(None) if cluster is None
            else np.asarray(snap.clusters) == cluster
        )
        save_ply(
            path, snap.positions[keep], snap.normals[keep],
            snap.colors[keep], snap.radii[keep],
        )
        return int(np.asarray(snap.positions[keep]).shape[0])

    def save_times(self, path: str) -> None:
        self.timer.write_csv(path)

    def save_stats(self, name: str, path: str) -> None:
        fe = self.frontends[name]
        fe.finalize_stats()
        fe.stats.write(path)

    def save_view_images(self, name: str, out_dir: str, prefix: str = "view") -> None:
        """Export predicted RGB / depth / normal images at the current pose
        (the reference GUI's `save_images` dumps of live vs predicted maps,
        `MainController.cpp:667-731`) — the headless substitute for the
        Pangolin viewer."""
        import os

        from PIL import Image

        os.makedirs(out_dir, exist_ok=True)
        pred = self.predict_view(name)
        rgb = np.clip(np.asarray(pred.color), 0, 255).astype(np.uint8)
        depth = np.asarray(pred.depth)
        d_vis = np.clip(depth / max(depth.max(), 1e-6) * 255, 0, 255).astype(np.uint8)
        nrm = ((np.asarray(pred.nmap) * 0.5 + 0.5) * 255).astype(np.uint8)
        Image.fromarray(rgb).save(os.path.join(out_dir, f"{prefix}_rgb.png"))
        Image.fromarray(d_vis).save(os.path.join(out_dir, f"{prefix}_depth.png"))
        Image.fromarray(nrm).save(os.path.join(out_dir, f"{prefix}_normals.png"))

    def save_checkpoint(self, name: str, path: str) -> None:
        from densemonoslam_tpu.utils.checkpoint import save_frontend

        fe = self.frontends[name]
        be = self.backend_of(name)
        fe.state = fe.state._replace(map_data=be.map_data, map_count=be.map_count)
        save_frontend(path, fe)

    def load_checkpoint(self, name: str, path: str) -> None:
        from densemonoslam_tpu.utils.checkpoint import load_frontend

        fe = self.frontends[name]
        load_frontend(path, fe)
        be = self.backend_of(name)
        be.map_data, be.map_count = fe.state.map_data, fe.state.map_count
        self.global_tick = max(self.global_tick, fe.tick)

    def surfel_count(self, map_name: str) -> int:
        return int(self.map_of(map_name).count)

    def _try_intermap(self, name: str, rgb: np.ndarray, depth_raw: np.ndarray) -> None:
        """Attempt to localise this camera inside another map and merge the
        maps on success (reference inter-map path, `ElasticFusion.cpp:597-631`:
        `resolveRelativeTransformationFern` -> `consumeReferenceFrame`)."""
        from densemonoslam_tpu import loops as loopsmod
        from densemonoslam_tpu.tracking import odometry as odo

        fe = self.frontends[name]
        cfg = self.config
        if fe.fern_state is None:
            return
        depth_m = jnp.asarray(depth_raw, jnp.float32) / cfg.depth_factor
        rgb8 = jnp.asarray(rgb, jnp.float32)
        from densemonoslam_tpu.mapping import ferns as fernmod

        ff = loopsmod.fern_factor(cfg)
        code = fernmod.encode(
            fe.fern_state.coder,
            fernmod.downsample_for_ferns(rgb8, ff),
            fernmod.downsample_for_ferns(depth_m, ff),
        )
        frame_pyr = odo.build_frame_pyramid(
            jnp.asarray(rgb), depth_m, fe.camera.intrinsics, cfg.pyramid_levels
        )
        for other_name, other_be in list(self.maps.items()):
            if other_name == fe.map_name:
                continue
            other_fe = next(
                (f for f in self.frontends.values()
                 if f.map_name == other_name and f.fern_state is not None),
                None,
            )
            if other_fe is None:
                continue
            pose_in_b, ok, info = loopsmod.resolve_intermap(
                frame_pyr, code, other_fe.fern_state.db,
                other_be.map_data, other_be.map_count, fe.camera, cfg,
            )
            if not ok:
                continue
            # T maps this camera's map coordinates into the other map's
            T_ab = (pose_in_b @ np.linalg.inv(np.asarray(fe.state.pose))).astype(
                np.float32
            )
            self.merge_into(fe.map_name, other_name, T_ab)
            return

    def batch_align(
        self, name_a: str, name_b: str, merge: bool = False,
        min_inliers: int = 30, max_rms: float = 0.25,
    ):
        """Initialisation-free wide-baseline alignment of camera `name_a`'s
        map onto camera `name_b`'s (the reference GUI's "Batch Align"
        button, `MainController.cpp:815-817` -> `batchAlign` -> FGR): ORB
        correspondences between the two cameras' CURRENT predicted views,
        graduated-non-convexity Geman-McClure rigid solve
        (`tracking.registration.global_registration` — FGR's optimiser), no
        initial guess.

        Returns (T_ab world transform src-map -> dst-map, inliers, rms), or
        None when the solve fails the inlier/rms gates (the reference gates
        its FGR result the same way).  With `merge=True` an accepted
        alignment is applied via `merge_into`."""
        from densemonoslam_tpu.tracking import registration

        fa = self.frontends[name_a]
        fb = self.frontends[name_b]
        T_cam, inl, rms = registration.global_registration(
            fa.state.pred_intensity, fa.state.pred_depth,
            fb.state.pred_intensity, fb.state.pred_depth,
            fa.camera.intrinsics,
        )
        if inl < min_inliers or rms > max_rms:
            return None
        # frame-a camera -> frame-b camera; lift to world:
        # p_worldB = pose_b @ T_cam @ pose_a^-1 @ p_worldA
        T_ab = (
            np.asarray(fb.state.pose)
            @ np.asarray(T_cam)
            @ np.linalg.inv(np.asarray(fa.state.pose))
        ).astype(np.float32)
        if merge and fa.map_name != fb.map_name:
            self.merge_into(fa.map_name, fb.map_name, T_ab)
        return T_ab, int(inl), float(rms)

    def merge_into(self, src_map: str, dst_map: str, T_ab: np.ndarray) -> None:
        """Merge map `src_map` into `dst_map` with world transform T_ab
        (reference `consumeReferenceFrame`)."""
        from densemonoslam_tpu import loops as loopsmod

        src = self.maps[src_map]
        dst = self.maps[dst_map]
        T = jnp.asarray(T_ab, jnp.float32)
        dst.map_data, dst.map_count, merge_dropped = loopsmod.merge_maps(
            dst.map_data, dst.map_count, src.map_data, src.map_count, T
        )
        dst.dropped += int(merge_dropped)  # overflow is surfaced, not silent
        # merge_maps no longer re-sorts the map; restore the
        # [inactive..., active...] partition (and the active-set cap) NOW so
        # the windowed hot passes stream a valid tail block on the very next
        # frame
        m = sm.compact(
            sm.SurfelMap(data=dst.map_data, count=dst.map_count),
            time=float(self.global_tick),
            time_delta=self.config.time_delta,
            max_active=self._max_active(),
        )
        dst.map_data, dst.map_count = m.data, m.count
        if src.rel_bank is not None:
            dst.rel_bank = loopsmod.merge_rel_banks(
                dst.get_rel_bank(), src.rel_bank, T
            )
        # move every member camera over: transform poses, switch map, merge ferns
        dst_fe = next(
            f for f in self.frontends.values() if f.map_name == dst_map
        )
        for f in self.frontends.values():
            if f.map_name != src_map:
                continue
            f.state = f.state._replace(
                pose=T @ f.state.pose,
                kf_pose=T @ f.state.kf_pose,
                model_age=jnp.asarray(stepmod.MODEL_INVALID_AGE, jnp.int32),
            )
            if f.pose_hist is not None:
                # the whole trajectory moves into the destination map's frame
                # (reference transforms member contexts' poseGraphs,
                # `ReferenceFrame.h:129-149`)
                f.pose_hist = jnp.einsum("ij,kjl->kil", T, f.pose_hist)
            if f.fern_state is not None and dst_fe.fern_state is not None:
                dst_fe.fern_state = loopsmod.FernLoopState(
                    coder=dst_fe.fern_state.coder,
                    db=loopsmod.consume_ferns(
                        dst_fe.fern_state.db, f.fern_state.db, T
                    ),
                )
            f.map_name = dst_map
            dst.contexts.append(f.name)
        del self.maps[src_map]

    def relocalise(self, name: str, rgb: np.ndarray, depth_raw: np.ndarray) -> bool:
        """Fern relocalisation (reference lost-mode `Ferns::findFrame` path,
        `ElasticFusion.cpp:359-394` + `Ferns.cpp:277-423`): query the fern DB
        with the current frame, photometric-check the candidate, then
        GEOMETRICALLY verify it — render the map at the stored pose, dense-
        track the frame onto the render, and accept only if the inlier count,
        ICP error and pose covariance pass (`loops.verify_recovery`).  The
        accepted pose is the ICP-refined one, not the raw keyframe pose."""
        from densemonoslam_tpu.mapping import ferns as fernmod
        from densemonoslam_tpu.tracking import odometry as odo

        fe = self.frontends[name]
        if fe.fern_state is None or int(fe.fern_state.db.count) == 0:
            return False
        cfg = self.config
        ff = loopsmod.fern_factor(cfg)
        depth_m = jnp.asarray(depth_raw, jnp.float32) / cfg.depth_factor
        rgb8 = fernmod.downsample_for_ferns(jnp.asarray(rgb, jnp.float32), ff)
        d8 = fernmod.downsample_for_ferns(depth_m, ff)
        code = fernmod.encode(fe.fern_state.coder, rgb8, d8)
        idx, dis = fernmod.best_match(fe.fern_state.db, code)
        if float(dis) > 0.9:
            return False
        i8 = (
            0.299 * rgb8[..., 0] + 0.587 * rgb8[..., 1] + 0.114 * rgb8[..., 2]
        )
        photo = fernmod.photometric_check(
            fe.fern_state.db.intensity[idx], i8, fe.fern_state.db.depth[idx], d8
        )
        if float(photo) > cfg.photo_thresh:
            return False
        be = self.backend_of(name)
        frame_pyr = odo.build_frame_pyramid(
            jnp.asarray(rgb), depth_m, fe.camera.intrinsics, cfg.pyramid_levels
        )
        pose, ok, _info = loopsmod.verify_recovery(
            frame_pyr, fe.fern_state.db.poses[idx], be.map_data, be.map_count,
            fe.camera, cfg,
        )
        if not ok:
            return False
        fe.state = fe.state._replace(
            pose=jnp.asarray(pose, jnp.float32),
            model_age=jnp.asarray(stepmod.MODEL_INVALID_AGE, jnp.int32),
        )
        return True
