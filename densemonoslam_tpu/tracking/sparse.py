"""Sparse ORB-style feature tracker: FAST corners + oriented BRIEF over a
scale pyramid + Hamming matching + motion-only pose optimisation + pose-graph
optimisation + keyframe loop detection.

The reference outsources sparse tracking to ORB-SLAM3 (git submodule; consumed
through `System::TrackRGBD`, `GetLastPose`, and
`loopClosing()->getLoopClosureCandidate()` — `GUI/src/MainController.cpp:
131-135,327-371`).  This module provides the equivalent capability surface the
hybrid pipeline needs — a pose per frame and loop-closure pose pairs — built
as dense array programs:

- **FAST-9/16 detection** is fully dense: the 16 Bresenham-circle taps are
  static shifts, the >=9-contiguous test is 16-bit mask rotation arithmetic,
  non-max suppression is a shifted max — no data-dependent control flow; the
  two-threshold policy (iniThFAST=20, minThFAST=7 in the reference yaml) is a
  sort-key bias instead of a host-side retry, so detection never syncs;
- **scale pyramid**: detection runs over `octaves` levels at scale factor 1.2
  (reference `KITTI_RGBD_template_params.yaml`: 8 levels x 1.2; we default to
  4), with per-octave feature quotas proportional to image area;
- **orientation** (intensity centroid) comes from dense moment maps;
- **BRIEF-256** is steered by the corner orientation and sampled with one
  fused gather per octave;
- **matching** is a dense Hamming matrix via XOR + `population_count` with
  mutual-best + ratio gating;
- **pose** is motion-only Gauss-Newton on 3D->2D reprojection errors with a
  Huber weight, using the same Gram-matrix normal-equation trick as the dense
  tracker (`ops.reductions`);
- **loop retrieval** is a single device matvec against per-keyframe
  descriptor-bit summaries (the DBoW role) — per-frame cost is one [K,256]
  product, flat in wall-time for any realistic K;
- **pose-graph optimisation** (`parallel.ba.optimise_pose_graph`) runs over
  the whole keyframe graph (odometry + loop edges) whenever a loop closes,
  so the sparse trajectory itself is globally consistent — the corrected
  (old, new) pose pair drives the dense hybrid deformation.

The tracker's per-frame path produces only device values; keyframe insertion
and loop decisions are deferred to a batched `flush()` every
`flush_interval` frames, so hybrid tracking costs ONE host sync per interval
instead of several per frame.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from densemonoslam_tpu.config import CameraIntrinsics
from densemonoslam_tpu.ops import warp
from densemonoslam_tpu.utils import se3

FAST_THRESHOLD = 20.0  # reference yaml iniThFAST
FAST_THRESHOLD_MIN = 7.0  # reference yaml minThFAST (fallback)
FAST_ARC = 9
MAX_KEYPOINTS = 512
DESC_WORDS = 8  # 256 bits as 8 x uint32
MATCH_MAX_DIST = 64  # Hamming acceptance
MATCH_RATIO = 0.9  # best/second-best gate
SCALE_FACTOR = 1.2  # reference yaml ORBextractor.scaleFactor
OCTAVES = 4

# Bresenham circle of radius 3 (the 16 FAST taps, standard order)
_CIRCLE = np.array(
    [
        (0, 3), (1, 3), (2, 2), (3, 1), (3, 0), (3, -1), (2, -2), (1, -3),
        (0, -3), (-1, -3), (-2, -2), (-3, -1), (-3, 0), (-3, 1), (-2, 2), (-1, 3),
    ],
    dtype=np.int32,
)  # (dy, dx)


def _brief_pattern(seed: int = 7, n: int = 256, radius: int = 13) -> np.ndarray:
    """Random BRIEF test pairs ~N(0, (radius/2)^2), clipped (the classic
    BRIEF-256 generator)."""
    rng = np.random.default_rng(seed)
    pts = np.clip(
        rng.normal(0.0, radius / 2.0, (n, 2, 2)), -radius, radius
    )
    return pts.astype(np.float32)  # [256, 2 (pair), 2 (y,x)]


_PATTERN = _brief_pattern()


class Keypoints(NamedTuple):
    uv: jnp.ndarray  # [K, 2] float pixel coords (x, y) at level-0 scale
    score: jnp.ndarray  # [K] FAST score
    angle: jnp.ndarray  # [K] orientation (radians)
    desc: jnp.ndarray  # [K, 8] uint32 BRIEF-256
    depth: jnp.ndarray  # [K] metric depth at the corner (0 = unknown)
    valid: jnp.ndarray  # [K] bool


@functools.partial(jax.jit, static_argnames=("max_kp",))
def detect_and_describe(
    intensity: jnp.ndarray,  # [H, W] f32 0..255
    depth: jnp.ndarray,  # [H, W] metric (0 invalid)
    threshold: float = FAST_THRESHOLD_MIN,
    high_threshold: float = FAST_THRESHOLD,
    max_kp: int = MAX_KEYPOINTS,
) -> Keypoints:
    """Dense FAST-9 + orientation + steered BRIEF for one frame.

    Corners are detected at `threshold`; top-K selection prefers corners that
    also pass `high_threshold` (the reference's iniThFAST/minThFAST two-pass
    policy as a single ranking — no data-dependent host retry)."""
    H, W = intensity.shape

    # --- FAST-9/16: dense circle comparisons + mask-rotation arc test ------
    center = intensity
    brighter = jnp.zeros((H, W), jnp.int32)
    darker = jnp.zeros((H, W), jnp.int32)
    brighter_hi = jnp.zeros((H, W), jnp.int32)
    darker_hi = jnp.zeros((H, W), jnp.int32)
    score_acc = jnp.zeros((H, W), jnp.float32)
    for bit, (dy, dx) in enumerate(_CIRCLE):
        tap = warp.shift(intensity, int(dy), int(dx))
        diff = tap - center
        brighter = brighter | ((diff > threshold).astype(jnp.int32) << bit)
        darker = darker | ((diff < -threshold).astype(jnp.int32) << bit)
        brighter_hi = brighter_hi | (
            (diff > high_threshold).astype(jnp.int32) << bit
        )
        darker_hi = darker_hi | (
            (diff < -high_threshold).astype(jnp.int32) << bit
        )
        score_acc = score_acc + jnp.abs(diff)

    def has_arc(mask16: jnp.ndarray) -> jnp.ndarray:
        """Any run of >= FAST_ARC consecutive set bits on the 16-bit ring."""
        run = mask16
        for k in range(1, FAST_ARC):
            rot = ((mask16 << k) | (mask16 >> (16 - k))) & 0xFFFF
            run = run & rot
        return run != 0

    is_corner = has_arc(brighter) | has_arc(darker)
    is_strong = has_arc(brighter_hi) | has_arc(darker_hi)
    score = jnp.where(is_corner, score_acc, 0.0)
    # border guard (circle + descriptor support)
    x_pix, y_pix = warp.pixel_grid(H, W)
    margin = 16.0
    inb = (
        (x_pix >= margin) & (x_pix < W - margin)
        & (y_pix >= margin) & (y_pix < H - margin)
    )
    score = jnp.where(inb, score, 0.0)
    # non-max suppression over 3x3 (dense shifted max)
    neigh_max = score
    for dy in range(-1, 2):
        for dx in range(-1, 2):
            if dy == 0 and dx == 0:
                continue
            neigh_max = jnp.maximum(neigh_max, warp.shift(score, dy, dx))
    score = jnp.where(score >= neigh_max, score, 0.0)

    # --- top-K corners (strong-threshold corners rank first) ---------------
    rank_key = score + jnp.where(is_strong & (score > 0), 1e6, 0.0)
    flat = rank_key.reshape(-1)
    top_rank, top_idx = jax.lax.top_k(flat, max_kp)
    top_score = score.reshape(-1)[top_idx]
    ky = (top_idx // W).astype(jnp.float32)
    kx = (top_idx % W).astype(jnp.float32)
    valid = top_rank > 0

    # --- orientation: intensity centroid from dense moment maps ------------
    # m10/m01 over a 15x15 patch via shifted sums, then gathered per corner
    m10 = jnp.zeros((H, W), jnp.float32)
    m01 = jnp.zeros((H, W), jnp.float32)
    R = 7
    for dy in range(-R, R + 1):
        for dx in range(-R, R + 1):
            if dx * dx + dy * dy > R * R:
                continue
            tap = warp.shift(intensity, dy, dx)
            m10 = m10 + dx * tap
            m01 = m01 + dy * tap
    g10 = m10.reshape(-1)[top_idx]
    g01 = m01.reshape(-1)[top_idx]
    angle = jnp.arctan2(g01, g10)

    # --- steered BRIEF ------------------------------------------------------
    ca, sa = jnp.cos(angle), jnp.sin(angle)  # [K]
    pat = jnp.asarray(_PATTERN)  # [256, 2, 2] (y, x)
    py, px = pat[..., 0], pat[..., 1]  # [256, 2]
    rx = ca[:, None, None] * px[None] - sa[:, None, None] * py[None]
    ry = sa[:, None, None] * px[None] + ca[:, None, None] * py[None]
    sx = jnp.clip(jnp.round(kx[:, None, None] + rx), 0, W - 1).astype(jnp.int32)
    sy = jnp.clip(jnp.round(ky[:, None, None] + ry), 0, H - 1).astype(jnp.int32)
    samples = intensity.reshape(-1)[(sy * W + sx).reshape(-1)].reshape(
        max_kp, 256, 2
    )
    bits = (samples[:, :, 0] < samples[:, :, 1]).astype(jnp.uint32)  # [K, 256]
    words = bits.reshape(max_kp, DESC_WORDS, 32)
    shifts = jnp.arange(32, dtype=jnp.uint32)
    desc = jnp.sum(words << shifts[None, None, :], axis=-1, dtype=jnp.uint32)

    kd = depth.reshape(-1)[top_idx]
    return Keypoints(
        uv=jnp.stack([kx, ky], axis=-1),
        score=top_score,
        angle=angle,
        desc=desc,
        depth=jnp.where(valid, kd, 0.0),
        valid=valid,
    )


def _octave_shapes(H: int, W: int, octaves: int, scale: float):
    return [
        (max(int(round(H / scale**o)), 48), max(int(round(W / scale**o)), 64))
        for o in range(octaves)
    ]


def _octave_quotas(octaves: int, scale: float, max_kp: int):
    """Per-octave feature budgets ~ image area (the reference distributes
    nfeatures over levels the same way)."""
    w = np.array([1.0 / (scale * scale) ** o for o in range(octaves)])
    q = np.maximum((w / w.sum() * max_kp).astype(int), 16)
    q[0] += max_kp - q.sum()  # exact total
    return [int(x) for x in q]


@functools.partial(
    jax.jit, static_argnames=("octaves", "scale", "max_kp")
)
def detect_pyramid(
    intensity: jnp.ndarray,
    depth: jnp.ndarray,
    threshold: float = FAST_THRESHOLD_MIN,
    high_threshold: float = FAST_THRESHOLD,
    octaves: int = OCTAVES,
    scale: float = SCALE_FACTOR,
    max_kp: int = MAX_KEYPOINTS,
) -> Keypoints:
    """Multi-octave detection (reference ORB yaml: nLevels x scaleFactor 1.2).

    Each octave detects on a 1.2^o-downscaled image; keypoint coordinates are
    mapped back to level-0 pixels, descriptors keep their octave's support
    (coarse octaves see larger patches = scale invariance)."""
    H, W = intensity.shape
    shapes = _octave_shapes(H, W, octaves, scale)
    quotas = _octave_quotas(octaves, scale, max_kp)
    parts = []
    for o, ((h, w), q) in enumerate(zip(shapes, quotas)):
        if o == 0:
            inten_o, depth_o = intensity, depth
        else:
            inten_o = jax.image.resize(intensity, (h, w), "linear")
            # nearest for depth: interpolation across silhouettes invents
            # geometry
            depth_o = jax.image.resize(depth, (h, w), "nearest")
        kp = detect_and_describe(
            inten_o, depth_o, threshold, high_threshold, max_kp=q
        )
        sx = W / w
        sy = H / h
        parts.append(
            kp._replace(
                uv=kp.uv * jnp.asarray([sx, sy], jnp.float32)[None, :]
            )
        )
    return Keypoints(
        uv=jnp.concatenate([p.uv for p in parts]),
        score=jnp.concatenate([p.score for p in parts]),
        angle=jnp.concatenate([p.angle for p in parts]),
        desc=jnp.concatenate([p.desc for p in parts]),
        depth=jnp.concatenate([p.depth for p in parts]),
        valid=jnp.concatenate([p.valid for p in parts]),
    )


@jax.jit
def match(a: Keypoints, b: Keypoints) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Mutual-best Hamming matching with ratio test.

    Returns (idx_b [K] i32: match in b for each a, -1 none; dist [K])."""
    x = a.desc[:, None, :] ^ b.desc[None, :, :]  # [Ka, Kb, 8]
    dist = jnp.sum(jax.lax.population_count(x), axis=-1).astype(jnp.int32)
    big = jnp.int32(10**6)
    dist = jnp.where(a.valid[:, None] & b.valid[None, :], dist, big)
    best_b = jnp.argmin(dist, axis=1)
    d1 = jnp.min(dist, axis=1)
    # second best for the ratio test
    d_wo = dist.at[jnp.arange(dist.shape[0]), best_b].set(big)
    d2 = jnp.min(d_wo, axis=1)
    best_a_of_b = jnp.argmin(dist, axis=0)
    mutual = best_a_of_b[best_b] == jnp.arange(dist.shape[0])
    ok = (
        mutual
        & (d1 <= MATCH_MAX_DIST)
        & (d1.astype(jnp.float32) <= MATCH_RATIO * jnp.maximum(d2, 1).astype(jnp.float32))
    )
    return jnp.where(ok, best_b, -1), d1


@functools.partial(jax.jit, static_argnames=("intr", "iters"))
def motion_only_pose(
    kp_prev: Keypoints,
    kp_cur: Keypoints,
    matches: jnp.ndarray,  # [K] index into kp_cur (or -1)
    intr: CameraIntrinsics,
    A_init: jnp.ndarray,  # [4,4] cur-cam -> prev-cam initial guess
    iters: int = 10,
    huber_px: float = 3.0,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Gauss-Newton on reprojection error of previous-frame 3D points into the
    current frame (ORB-SLAM's motion-only BA, depth from RGB-D).

    Solves for A (current camera -> previous camera); the previous 3D points
    are back-projected from kp_prev depth.  Returns (A, inliers, mean_err_px).
    """
    m_safe = jnp.maximum(matches, 0)
    u_p, v_p = kp_prev.uv[:, 0], kp_prev.uv[:, 1]
    z_p = kp_prev.depth
    X = jnp.stack(
        [(u_p - intr.cx) / intr.fx * z_p, (v_p - intr.cy) / intr.fy * z_p, z_p],
        axis=-1,
    )  # [K,3] previous-camera 3D
    uv_c = kp_cur.uv[m_safe]  # observed pixels in current frame
    base_ok = (matches >= 0) & (z_p > 0.05) & kp_prev.valid

    def body(_, carry):
        A, _stats = carry
        Ainv = se3.se3_inverse(A)
        p = se3.transform_points(Ainv, X)  # into current camera
        z = jnp.maximum(p[:, 2], 1e-6)
        u = p[:, 0] / z * intr.fx + intr.cx
        v = p[:, 1] / z * intr.fy + intr.cy
        ru = u - uv_c[:, 0]
        rv = v - uv_c[:, 1]
        err = jnp.sqrt(ru * ru + rv * rv)
        w_huber = jnp.where(err > huber_px, huber_px / jnp.maximum(err, 1e-9), 1.0)
        ok = base_ok & (p[:, 2] > 0.05) & (err < 30.0)
        wgt = jnp.sqrt(w_huber) * ok
        # d(residual)/d(xi) for left-update on A: p = Ainv exp(-xi) X
        # => dp = -Ainv_R (omega x X + v); chain through projection
        fu_z = intr.fx / z
        fv_z = intr.fy / z
        Ju = jnp.stack(
            [fu_z, jnp.zeros_like(z), -intr.fx * p[:, 0] / (z * z)], axis=-1
        )
        Jv = jnp.stack(
            [jnp.zeros_like(z), fv_z, -intr.fy * p[:, 1] / (z * z)], axis=-1
        )
        Rinv = Ainv[:3, :3]

        def rows(Jpix, r):
            g = -jnp.einsum("pi,ij->pj", Jpix, Rinv)  # dr/d(dp in prev frame)
            Jw = jnp.cross(X, g)
            M = jnp.concatenate(
                [Jw, g, r[:, None], jnp.ones_like(r)[:, None]], axis=-1
            )
            return M * wgt[:, None]

        M = jnp.concatenate([rows(Ju, ru), rows(Jv, rv)], axis=0)
        G = jax.lax.dot_general(
            M, M, (((0,), (0,)), ((), ())), preferred_element_type=jnp.float32
        )
        JtJ, Jtr = G[:6, :6], G[:6, 6]
        xi = jnp.linalg.solve(JtJ + 1e-4 * jnp.eye(6), -Jtr)
        good = jnp.all(jnp.isfinite(xi)) & (jnp.sum(ok) > 6)
        A_new = jnp.where(good, se3.se3_exp(xi) @ A, A)
        stats = (jnp.sum(ok.astype(jnp.float32)), jnp.sum(err * ok) / jnp.maximum(jnp.sum(ok), 1.0))
        return A_new, stats

    A, (inl, err) = jax.lax.fori_loop(
        0, iters, body, (A_init, (jnp.array(0.0), jnp.array(0.0)))
    )
    return A, inl, err


@jax.jit
def desc_summary(kp: Keypoints) -> jnp.ndarray:
    """[256] mean descriptor bit over valid keypoints — the keyframe's
    retrieval signature (the DBoW bag-of-words role, one row per keyframe)."""
    shifts = jnp.arange(32, dtype=jnp.uint32)
    bits = (
        (kp.desc[:, :, None] >> shifts[None, None, :]) & jnp.uint32(1)
    ).reshape(kp.desc.shape[0], 256)
    v = kp.valid.astype(jnp.float32)[:, None]
    return jnp.sum(bits * v, axis=0) / jnp.maximum(jnp.sum(v), 1.0)


@functools.partial(jax.jit, static_argnames=("top_k",))
def retrieve(
    summaries: jnp.ndarray,  # [Kcap, 256]
    n_kf: jnp.ndarray,  # [] i32
    query: jnp.ndarray,  # [256]
    max_idx: jnp.ndarray,  # [] i32 only keyframes with index < max_idx
    top_k: int = 4,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Top-k loop candidates by cosine similarity of bit summaries — ONE
    matvec regardless of keyframe count (flat per-frame retrieval cost)."""
    q = query - 0.5
    s = summaries - 0.5
    num = s @ q
    den = jnp.linalg.norm(s, axis=-1) * jnp.maximum(jnp.linalg.norm(q), 1e-9)
    sim = num / jnp.maximum(den, 1e-9)
    idx = jnp.arange(summaries.shape[0])
    sim = jnp.where((idx < n_kf) & (idx < max_idx), sim, -2.0)
    best_sims, best_idx = jax.lax.top_k(sim, top_k)
    return best_idx, best_sims


class SparseTracker:
    """Host-side tracker state machine (the `ORB_SLAM3::System` role for the
    hybrid path): per-frame pose from motion-only GN against the last
    keyframe, keyframe insertion by baseline, loop candidates by summary
    retrieval + geometric verification, pose-graph optimisation on closure.

    Per-frame work is pure device dispatch; host decisions (keyframe
    insertion, loop closing, PGO) happen in `flush()` every `flush_interval`
    frames with ONE batched scalar realisation."""

    def __init__(
        self,
        intr: CameraIntrinsics,
        keyframe_min_disp: float = 0.08,
        loop_min_gap: int = 30,
        loop_min_votes: int = 60,
        octaves: int = OCTAVES,
        flush_interval: int = 4,
        run_pgo: bool = True,
        local_ba_window: int = 6,
        run_local_ba: bool = True,
        local_ba_min_baseline: float = 0.25,
        mesh=None,
    ):
        self.intr = intr
        self._pose = jnp.eye(4, dtype=jnp.float32)  # camera-to-world
        self.keyframes: list = []  # (Keypoints, pose_np [4,4], tick)
        self.tick = 0
        self.kf_min_disp = keyframe_min_disp
        self.loop_min_gap = loop_min_gap
        self.loop_min_votes = loop_min_votes
        self.octaves = octaves
        self.flush_interval = flush_interval
        self.run_pgo = run_pgo
        self.local_ba_window = local_ba_window
        self.run_local_ba = run_local_ba
        self.local_ba_min_baseline = local_ba_min_baseline
        # BASELINE config 4: when a `jax.sharding.Mesh` with a `cam` axis is
        # given, the pose-graph solve runs edge-sharded and the sliding-
        # window BA landmark-sharded across the mesh (Schur/normal equations
        # psum-reduced over the mesh) instead of on one device — same optimum,
        # parity-tested in tests/test_street.py.
        self.mesh = mesh
        self._dist_pgo = None
        self._dist_ba = None
        self.last_loop: Optional[Tuple[np.ndarray, np.ndarray]] = None
        self.last_loop_tick: int = -1  # tick of the loop pair's keyframe
        # (kf_ticks, kf_poses_before, kf_poses_after) of the last PGO run
        self.pgo_event: Optional[Tuple] = None
        self._pending: list = []  # (kp, pose_dev, ok_dev, disp_dev, tick)
        # one-interval-old pending batch: its device values have certainly
        # executed, so the flush's batched fetch returns WITHOUT draining the
        # in-flight frame queue (see `flush`)
        self._prev_pending: list = []
        # cumulative world correction (PGO / BA / external pose override).
        # Every pending entry snapshots it at append time; at processing the
        # fetched pose is left-multiplied by (current @ inv(snapshot)) — the
        # corrections applied WHILE it was in flight.  Without this,
        # keyframes inserted from an in-flight batch land in the
        # PRE-correction world and their odometry edges fight every later
        # optimisation (measured: indoor baselines inflated past the BA gate
        # and per-batch cost doubled).
        self._corr_cum: np.ndarray = np.eye(4, dtype=np.float32)
        self._acc_disp = 0.0  # keyframe displacement accumulator (host)
        # FIFO of deferred host decisions whose device dispatches were issued
        # a flush ago: ("retrieve" | "verify" | "ba_fetch" | "ba_apply",
        # payload dict).  Each flush advances every op one stage.
        self._async: list = []
        self._ba_inflight = False  # one BA window in flight at a time
        self._prev: Optional[tuple] = None  # (Keypoints, pose_dev)
        self._summaries = jnp.zeros((64, 256), jnp.float32)
        self._edges: list = []  # (i, j, Z np [4,4], weight)
        self.loops_closed = 0
        self.local_ba_runs = 0

    # ---------------------------------------------------------------- pose
    @property
    def pose(self) -> np.ndarray:
        return np.asarray(self._pose)

    @pose.setter
    def pose(self, value) -> None:
        old = np.asarray(self._pose)
        self._pose = jnp.asarray(value, jnp.float32)
        if self._prev is not None:
            # the next frame composes off the previous frame's pose — keep
            # it consistent with an externally-imposed correction
            self._prev = (self._prev[0], self._pose)
        if np.all(np.isfinite(old)):
            self._correct_inflight(
                np.asarray(value, np.float32) @ np.linalg.inv(old)
            )

    def _correct_inflight(self, delta: np.ndarray) -> None:
        """Record a world correction for poses still in the flush pipeline."""
        self._corr_cum = delta.astype(np.float32) @ self._corr_cum

    # --------------------------------------------------------------- track
    def detect(self, intensity: jnp.ndarray, depth: jnp.ndarray) -> Keypoints:
        return detect_pyramid(
            intensity, depth, FAST_THRESHOLD_MIN, FAST_THRESHOLD,
            octaves=self.octaves,
        )

    def track(self, intensity: jnp.ndarray, depth: jnp.ndarray):
        """Process one frame; returns DEVICE values (pose_cam_to_world [4,4],
        tracked_ok bool) — nothing syncs here.

        Tracking is frame-to-frame motion-only GN (ORB-SLAM's constant-
        velocity front-end); keyframes exist for loop retrieval and the pose
        graph, and are inserted retroactively at the flush cadence."""
        kp = self.detect(intensity, depth)
        if self._prev is None:
            self._prev = (kp, self._pose)
            self._insert_keyframe(kp, np.asarray(self._pose), self.tick)
            self.tick += 1
            return self._pose, jnp.asarray(True)
        prev_kp, prev_pose = self._prev
        matches, _ = match(prev_kp, kp)
        A, inl, err = motion_only_pose(
            prev_kp, kp, matches, self.intr, jnp.eye(4, dtype=jnp.float32)
        )
        ok = (inl >= 15) & (err < 5.0)
        pose_new = jnp.where(ok, prev_pose @ A, self._pose)
        self._pose = pose_new
        self._prev = (kp, pose_new)
        disp = jnp.where(ok, jnp.linalg.norm(A[:3, 3]), 0.0)
        self._pending.append(
            (kp, pose_new, ok, disp, self.tick, self._corr_cum.copy())
        )
        self.tick += 1
        if len(self._pending) >= self.flush_interval:
            self.flush(drain=False)
        return pose_new, ok

    # --------------------------------------------------------------- flush
    def flush(self, drain: bool = True) -> None:
        """Advance the tracker's host decisions WITHOUT stalling the device.

        The per-frame path queues device work only; this runs the host-side
        state machine (keyframe insertion, loop retrieval + verification,
        PGO, sliding-window BA) as a SOFTWARE PIPELINE lagged by one flush
        interval: every value fetched here was dispatched at least one
        interval ago, so with the dense steps of the current interval still
        in the device queue, each `device_get` returns already-finished
        results instead of draining the queue (a fetch-what-you-just-
        dispatched flush serialises host and device).

        Stages per decision:
        - keyframes: batch-fetch the PREVIOUS interval's (ok, disp, pose)
          in one transfer, insert keyframes, dispatch retrieval;
        - loop closure: retrieval fetched one flush later; candidate
          verification dispatched then, fetched the flush after; PGO runs
          synchronously on a confirmed hit (rare);
        - local BA: match/uv/depth fetch, host track building + solve
          dispatch, and correction application each advance one flush.

        `drain=True` (the default for explicit calls; `track()` passes
        False) processes everything synchronously — end-of-sequence
        semantics and the behaviour the tests rely on."""
        batch, self._prev_pending = self._prev_pending, self._pending
        self._pending = []
        if drain:
            batch = batch + self._prev_pending
            self._prev_pending = []
        self._advance_async()
        if batch:
            self._process_batch(batch)
        if drain:
            while self._async:
                self._advance_async()

    def _process_batch(self, batch) -> None:
        scal, poses = jax.device_get(
            (
                jnp.stack(
                    [
                        jnp.stack([o.astype(jnp.float32), d])
                        for _, _, o, d, _, _ in batch
                    ]
                ),
                jnp.stack([p for _, p, _, _, _, _ in batch]),
            )
        )  # ONE device fetch for the whole interval, poses included
        inserted = False
        for (kp, _pd, _o, _d, tick, corr0), (ok_f, disp), pose_np in zip(
            batch, scal, poses
        ):
            if ok_f < 1.0:
                self._acc_disp = 0.0
                continue
            self._acc_disp += float(disp)
            if self._acc_disp > self.kf_min_disp:
                # bring the in-flight pose into the CURRENT (post-PGO/BA)
                # world: apply the corrections recorded since it was queued
                corr = self._corr_cum @ np.linalg.inv(corr0)
                pose_np = (corr @ np.asarray(pose_np)).astype(np.float32)
                self._schedule_loop_check(kp, pose_np, tick)
                self._insert_keyframe(kp, pose_np, tick)
                inserted = True
                self._acc_disp = 0.0
        if inserted and self.run_local_ba:
            self._schedule_local_ba()

    def _advance_async(self) -> None:
        """Advance every in-flight deferred op by one stage (new stages the
        handlers schedule land in the NEXT advance)."""
        ops, self._async = self._async, []
        for kind, payload in ops:
            getattr(self, "_adv_" + kind)(payload)

    # ----------------------------------------------------------- local BA
    def _schedule_local_ba(self) -> None:
        """Stage 1 of the sliding-window local bundle adjustment (the
        ORB-SLAM3 LocalMapping role the reference consumes,
        `MainController.cpp:131-135`): dispatch the consecutive-keyframe
        matches + keypoint tables the host track builder needs; the fetch
        happens one flush later (`_adv_ba_fetch`)."""
        if self._ba_inflight:  # overlapping windows would fight on write-back
            return
        W = min(self.local_ba_window, len(self.keyframes))
        if W < 3:
            return
        base = len(self.keyframes) - W
        window = self.keyframes[base:]
        kps = [kf[0] for kf in window]
        poses = np.stack([np.asarray(kf[1]) for kf in window]).astype(np.float32)
        # BA needs parallax: with consecutive-keyframe baselines far below
        # the scene depth (indoor orbits), the reprojection problem is
        # rotation/translation-ambiguous and 'refinement' random-walks the
        # poses (measured 0.04 -> 0.93 m ATE on the orbit fixture); motion-
        # only GN + PGO already handle that regime.  Street/KITTI-scale
        # keyframes (metre baselines) are where windowed BA pays.
        bl = np.mean(
            np.linalg.norm(np.diff(poses[:, :3, 3], axis=0), axis=-1)
        )
        if bl < self.local_ba_min_baseline:
            return
        m_dev = jnp.stack([match(kps[i - 1], kps[i])[0] for i in range(1, W)])
        uv_dev = jnp.stack([k.uv for k in kps])
        d_dev = jnp.stack([k.depth for k in kps])
        v_dev = jnp.stack([k.valid for k in kps])
        self._ba_inflight = True
        self._async.append(
            ("ba_fetch", dict(base=base, W=W, handles=(m_dev, uv_dev, d_dev, v_dev)))
        )

    def _adv_ba_fetch(self, p) -> None:
        """Stage 2: fetch the match/keypoint tables (dispatched a flush ago,
        so the transfer does not drain the frame queue), build landmark
        tracks on the host, and dispatch the Schur-complement solve.
        Landmarks are initialised by depth backprojection at their first
        observation and jointly refined with the window poses
        (`parallel.ba.bundle_adjust`).  The first window camera is pinned
        (6-DoF gauge); scale stays observable with a single pin because
        every track's seed observation carries measured depth (the z
        residuals of the RGB-D BA) and depthless tracks never open."""
        from densemonoslam_tpu.parallel import ba

        W, base = p["W"], p["base"]
        m_np, uv_np, d_np, v_np = jax.device_get(p["handles"])
        poses = np.stack(
            [np.asarray(self.keyframes[base + i][1]) for i in range(W)]
        ).astype(np.float32)
        kps = [self.keyframes[base + i][0] for i in range(W)]
        KP = kps[0].uv.shape[0]
        P_CAP = KP  # at most one track per seed keypoint slot
        m_all = [m_np[i] for i in range(W - 1)]
        uvs = [uv_np[i] for i in range(W)]
        deps = [d_np[i] for i in range(W)]
        vals = [v_np[i] for i in range(W)]

        track_ids = [np.full(KP, -1, np.int32) for _ in range(W)]
        points = np.zeros((P_CAP, 3), np.float32)
        n_tracks = 0
        fx, fy = self.intr.fx, self.intr.fy
        cx, cy = self.intr.cx, self.intr.cy
        for i in range(W - 1):
            m = m_all[i]
            # a match only extends a track when BOTH endpoints are valid
            # keypoint slots — stale uv/depth from invalid slots in frame i+1
            # must not enter the BA problem
            fwd = (m >= 0) & vals[i] & vals[i + 1][np.maximum(m, 0)]
            # propagate live tracks to the next keyframe
            has_id = fwd & (track_ids[i] >= 0)
            track_ids[i + 1][m[has_id]] = track_ids[i][has_id]
            # open new tracks at their first matched observation (needs depth
            # for the world-point seed)
            new = fwd & (track_ids[i] < 0) & (deps[i] > 0)
            idx_new = np.where(new)[0]
            room = P_CAP - n_tracks
            idx_new = idx_new[:room]
            if idx_new.size:
                u, v = uvs[i][idx_new, 0], uvs[i][idx_new, 1]
                z = deps[i][idx_new]
                p_cam = np.stack(
                    [(u - cx) / fx * z, (v - cy) / fy * z, z], axis=-1
                )
                R, t = poses[i][:3, :3], poses[i][:3, 3]
                ids = np.arange(n_tracks, n_tracks + idx_new.size, dtype=np.int32)
                points[ids] = p_cam @ R.T + t
                track_ids[i][idx_new] = ids
                track_ids[i + 1][m[idx_new]] = ids
                n_tracks += idx_new.size
        if n_tracks < 30:
            self._ba_inflight = False
            return

        # flatten observations (every keyframe slot carrying a track id);
        # each observation also carries its MEASURED depth, turning the solve
        # into RGB-D BA — pure reprojection BA cannot observe scale or the
        # along-ray landmark position under forward motion
        O_CAP = W * KP
        cam_idx = np.zeros((O_CAP,), np.int32)
        pnt_idx = np.zeros((O_CAP,), np.int32)
        uv_obs = np.zeros((O_CAP, 2), np.float32)
        z_obs = np.zeros((O_CAP,), np.float32)
        valid = np.zeros((O_CAP,), bool)
        o = 0
        for i in range(W):
            sel = np.where((track_ids[i] >= 0) & vals[i])[0]
            n = sel.size
            cam_idx[o : o + n] = i
            pnt_idx[o : o + n] = track_ids[i][sel]
            uv_obs[o : o + n] = uvs[i][sel]
            z_obs[o : o + n] = deps[i][sel]
            valid[o : o + n] = True
            o += n

        problem = ba.BAProblem(
            poses=jnp.asarray(poses),
            points=jnp.asarray(points),
            cam_idx=jnp.asarray(cam_idx),
            pnt_idx=jnp.asarray(pnt_idx),
            uv=jnp.asarray(uv_obs),
            valid=jnp.asarray(valid),
            z=jnp.asarray(z_obs),
        )
        # the >8 px outlier pregate (wrong matches propagated through the
        # track chain would dominate the quadratic solve) runs INSIDE the
        # jitted solve now (`bundle_adjust pregate_px`): no extra round trip
        if self.mesh is not None:
            # landmark-sharded Schur BA over the mesh (same robustness
            # options as the single-device solve)
            if self._dist_ba is None:
                self._dist_ba = ba.make_distributed_ba(
                    self.mesh, self.intr, iters=4, fix_cameras=1,
                    damping=1e-2, huber=3.0, pregate_px=8.0,
                )
            n_dev = int(np.prod(self.mesh.devices.shape))
            pts_p, ci, pi, uvp, vp, zp = ba.shard_ba_problem(problem, n_dev)
            out_poses, _pts, _err = self._dist_ba(
                problem.poses, pts_p, ci, pi, uvp, vp, zp
            )
        else:
            refined, _err = ba.bundle_adjust(
                problem, self.intr, iters=4, fix_cameras=1, damping=1e-2,
                huber=3.0, pregate_px=8.0,
            )
            out_poses = refined.poses
        self._async.append(
            ("ba_apply", dict(base=base, W=W, poses_in=poses, out=out_poses))
        )

    def _adv_ba_apply(self, p) -> None:
        """Stage 3: fetch the refined window poses (solve dispatched a flush
        ago) and apply — write back to the keyframes, refresh the odometry
        edges between window members (they feed later PGO runs), and carry
        the live pose with the last keyframe's correction."""
        base, W, poses = p["base"], p["W"], p["poses_in"]
        out = np.asarray(p["out"])
        self._ba_inflight = False
        if not np.all(np.isfinite(out)):
            return
        for wi in range(W):
            kp, _, tick = self.keyframes[base + wi]
            self.keyframes[base + wi] = (kp, out[wi], tick)
        for e, (i, j, Z, wgt) in enumerate(self._edges):
            if base <= i < base + W and base <= j < base + W and wgt == 1.0:
                Znew = np.linalg.inv(out[i - base]) @ out[j - base]
                self._edges[e] = (i, j, Znew.astype(np.float32), wgt)
        # live-pose delta measured against the estimate AT SOLVE TIME: the
        # correction composes correctly even though odometry advanced while
        # the solve was in flight
        delta = out[W - 1] @ np.linalg.inv(poses[W - 1])
        self._pose = jnp.asarray(delta @ np.asarray(self._pose), jnp.float32)
        if self._prev is not None:
            self._prev = (self._prev[0], self._pose)
        self._correct_inflight(delta)
        self.local_ba_runs += 1

    def _insert_keyframe(self, kp: Keypoints, pose_np, tick: int) -> None:
        k = len(self.keyframes)
        if k > 0:
            prev_pose = self.keyframes[-1][1]
            Z = np.linalg.inv(prev_pose) @ pose_np
            self._edges.append((k - 1, k, Z.astype(np.float32), 1.0))
        if k >= self._summaries.shape[0]:
            self._summaries = jnp.concatenate(
                [self._summaries, jnp.zeros_like(self._summaries)]
            )
        self._summaries = self._summaries.at[k].set(desc_summary(kp))
        self.keyframes.append((kp, np.asarray(pose_np), tick))

    def _schedule_loop_check(self, kp: Keypoints, pose_np, tick: int) -> None:
        """Stage 1 of loop closing: dispatch summary retrieval (one matvec)
        for the about-to-be-inserted keyframe; the result is fetched one
        flush later.  The reference consumes the same pipeline's output via
        `getLoopClosureCandidate` (`MainController.cpp:360-369`)."""
        n_kf = len(self.keyframes)
        # eligible: keyframes at least loop_min_gap ticks older
        max_idx = 0
        for i, (_, _, kf_tick) in enumerate(self.keyframes):
            if tick - kf_tick >= self.loop_min_gap:
                max_idx = i + 1
        if max_idx == 0:
            return
        q = desc_summary(kp)
        cand = retrieve(
            self._summaries, jnp.asarray(n_kf), q, jnp.asarray(max_idx)
        )
        self._async.append(
            ("retrieve", dict(
                kp=kp, pose_np=np.asarray(pose_np).copy(), tick=tick,
                k=len(self.keyframes), cand=cand,
            ))
        )

    def _adv_retrieve(self, p) -> None:
        """Stage 2: fetch the retrieval scores; for candidates above the
        similarity bar dispatch geometric verification (Hamming matching +
        motion-only GN) — fetched next flush."""
        cand_idx, cand_sim = jax.device_get(p["cand"])
        cands = [
            int(j) for j, sim in zip(cand_idx, cand_sim) if sim >= 0.35
        ]
        if not cands:
            return
        handles = []
        for j in cands:
            kf_kp = self.keyframes[j][0]
            matches, _ = match(kf_kp, p["kp"])
            votes = jnp.sum((matches >= 0).astype(jnp.int32))
            A, inl, err = motion_only_pose(
                kf_kp, p["kp"], matches, self.intr,
                jnp.eye(4, dtype=jnp.float32),
            )
            handles.append((votes, A, inl, err))
        self._async.append(("verify", dict(handles=handles, cands=cands, **{
            key: p[key] for key in ("pose_np", "tick", "k")
        })))

    def _adv_verify(self, p) -> None:
        """Stage 3: fetch all candidates' verification results in one
        transfer; on a confirmed hit add the loop edge and run PGO (rare —
        this one blocks)."""
        fetched = jax.device_get(p["handles"])
        hit = None
        for j, (votes, A, inl, err) in zip(p["cands"], fetched):
            if int(votes) < self.loop_min_votes:
                continue
            if int(inl) < 20 or float(err) >= 4.0:
                continue
            hit = (j, np.asarray(A).astype(np.float32))
            break
        if hit is None:
            return
        j, A = hit
        k = p["k"]  # the keyframe this check belongs to (already inserted)
        if k >= len(self.keyframes):
            return  # keyframe vanished (defensive)
        # corrected pose of keyframe k implied by the match against j's
        # CURRENT pose (PGO/BA may have refined it while this was in flight);
        # the pair's drifted half is likewise k's CURRENT estimate — the
        # consumer computes the world correction as corr @ inv(est), which
        # must span exactly the drift the optimiser is about to remove
        kf_pose = np.asarray(self.keyframes[j][1])
        corrected = (kf_pose @ A).astype(np.float32)
        pose_est = np.asarray(self.keyframes[k][1]).astype(np.float32).copy()
        self.last_loop = (pose_est, corrected)
        # which frame the pair describes: the loop KEYFRAME's tick (the
        # verification pipeline lags insertion by ~two flushes, so consumers
        # must not assume the pair refers to the current frame)
        self.last_loop_tick = p["tick"]
        self.loops_closed += 1
        self._edges.append((j, k, A, 3.0))
        if self.run_pgo:
            self._optimise_graph(
                k=k, corrected=corrected, old_pose=pose_est,
                anchor_idx=j,
            )

    def _optimise_graph(
        self, k: int, corrected: np.ndarray, old_pose: np.ndarray,
        anchor_idx: int,
    ) -> None:
        """Pose-graph GN over all keyframes (odometry + loop edges) via
        `parallel.ba.optimise_pose_graph`; keyframe poses and the live pose
        are rewritten from the optimum.

        `k` is the loop's NEW keyframe (already inserted — the verification
        pipeline runs a flush behind insertion), `corrected` its
        loop-implied pose and `old_pose` its PRE-correction estimate: the
        live-pose delta must map the drifted estimate onto the optimum —
        measuring it against the already-corrected pose would make the
        delta ~identity and silently leave the live pose drifted.

        `anchor_idx` (the loop's old keyframe) enables the distributed warm
        start: the loop correction is interpolated in se(3) along the chain
        from the anchor to `k` (keyframes past `k` get the full correction)
        BEFORE GN runs.  Without it, a loop closing tens of metres of drift
        leaves GN's first step so far outside the quadratic basin that every
        iteration is rejected by the divergence rollback — the loop keyframe
        corrects (its loop edge is direct) while all other keyframes
        silently keep their drift."""
        from densemonoslam_tpu.parallel import ba

        K = len(self.keyframes)
        poses = np.stack([p for _, p, _ in self.keyframes]).astype(np.float32)
        poses_orig = poses.copy()
        poses[k] = corrected
        C = (corrected @ np.linalg.inv(old_pose)).astype(np.float32)
        xi = np.asarray(se3.se3_log(jnp.asarray(C)))
        span = max(k - anchor_idx, 1)
        for idx in range(anchor_idx + 1, K):
            if idx == k:
                continue
            s = min((idx - anchor_idx) / span, 1.0)
            D = np.asarray(se3.se3_exp(jnp.asarray(s * xi, jnp.float32)))
            poses[idx] = D @ poses[idx]
        # pad to power-of-two capacity so recompiles are logarithmic
        Kcap = 8
        while Kcap < K:
            Kcap *= 2
        Ecap = 8
        while Ecap < len(self._edges):
            Ecap *= 2
        poses_p = np.tile(np.eye(4, dtype=np.float32), (Kcap, 1, 1))
        poses_p[:K] = poses
        ei = np.zeros((Ecap,), np.int32)
        ej = np.zeros((Ecap,), np.int32)
        Z = np.tile(np.eye(4, dtype=np.float32), (Ecap, 1, 1))
        w = np.zeros((Ecap,), np.float32)
        for e, (i, j, Ze, we) in enumerate(self._edges):
            ei[e], ej[e], Z[e], w[e] = i, j, Ze, we
        # the distributed warm start above carries the LONG-RANGE correction
        # (CG propagates information one edge-hop per iteration, so without
        # it ~2K iterations would be needed and cost would grow
        # quadratically with trajectory length); a fixed modest CG budget
        # then polishes locally, keeping per-closure cost linear in the
        # graph size
        edges_dev = ba.PoseGraphEdges(
            i=jnp.asarray(ei), j=jnp.asarray(ej),
            Z=jnp.asarray(Z), weight=jnp.asarray(w),
        )
        if self.mesh is not None:
            # edge-sharded PGO over the mesh (Ecap is a power of two >= 8,
            # so it divides evenly over any power-of-two `cam` axis)
            if self._dist_pgo is None:
                self._dist_pgo = ba.make_distributed_pgo(
                    self.mesh, cg_iters=128
                )
            out, _err = self._dist_pgo(jnp.asarray(poses_p), edges_dev)
        else:
            out, _err = ba.optimise_pose_graph(
                jnp.asarray(poses_p), edges_dev, cg_iters=128,
            )
        out = np.asarray(out)
        # record the per-keyframe corrections (from the ORIGINAL, pre-warm-
        # start poses) so the engine can rewrite its own pose history (the
        # dense trajectory) to the loop-consistent sparse optimum — the
        # deformation graph alone cannot encode tens of metres of drift
        # correction along a whole lap from view-local constraints
        self.pgo_event = (
            np.array([t for _, _, t in self.keyframes], np.int64),
            poses_orig[: len(self.keyframes)].copy(),
            out[: len(self.keyframes)].copy(),
        )
        for idx in range(len(self.keyframes)):
            kp, _, tick = self.keyframes[idx]
            self.keyframes[idx] = (kp, out[idx], tick)
        # carry the live pose with the LAST keyframe's correction, measured
        # from its PRE-warm-start estimate (the live pose composed off it);
        # poses still in the flush pipeline take the same correction
        delta = out[K - 1] @ np.linalg.inv(poses_orig[K - 1])
        self._pose = jnp.asarray(
            delta @ np.asarray(self._pose), jnp.float32
        )
        if self._prev is not None:
            self._prev = (self._prev[0], self._pose)
        self._correct_inflight(delta)
        if self.last_loop is not None:
            # the hybrid pair's corrected half is keyframe k's OPTIMISED pose
            self.last_loop = (self.last_loop[0], out[k].astype(np.float32))

    def pop_loop(self) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """(pose_old_estimate, pose_corrected) pair, once (the reference's
        `getLoopClosureCandidate`)."""
        out = self.last_loop
        self.last_loop = None
        return out

    def pop_pgo_event(self) -> Optional[Tuple]:
        """(kf_ticks, kf_poses_before, kf_poses_after) of the last pose-graph
        optimisation, once — consumed by the engine to rewrite its exported
        trajectory to the loop-consistent optimum."""
        out = self.pgo_event
        self.pgo_event = None
        return out
