"""Surfel splat rasterisation via scatter-min z-buffering.

Replacement for the reference's `IndexMap` render passes
(`Core/src/IndexMap.cpp`: `predictIndices` renders surfel IDs + attributes for
data association; `combinedPredict` splat-renders predicted image/vertex/
normal/time maps in ACTIVE/INACTIVE time-window modes; splat geometry in
`Shaders/splat.vert` / `combo_splat.frag`).

The design minimises scatter *ops*, whose cost scales with the update
count:

1. ONE scatter-min of depth per surfel centre pixel (the z-test);
2. ONE scatter-min of surfel index among depth-equal candidates
   (deterministic tie-break);
3. ONE fused row-gather of the winning surfels' attribute rows;
4. disk splatting resolved DENSELY: each pixel inspects the 3x3
   neighbouring cells' winners via static shifts (pure data movement) and
   keeps the nearest surfel whose screen-space disk covers it — equivalent
   to the reference's point-sprite footprint without per-offset scatters.

Depth at each covered pixel is refined by intersecting the pixel ray with the
winner's tangent plane (the ray-disk intersection of `combo_splat.frag`),
which kills the half-pixel splat quantisation that otherwise biases ICP.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from densemonoslam_tpu.config import CameraIntrinsics
from densemonoslam_tpu.mapping import surfel_map as sm
from densemonoslam_tpu.ops import warp
from densemonoslam_tpu.utils import se3

MODE_ACTIVE = 0  # surfels seen within the time window (tracking/fusion view)
MODE_INACTIVE = 1  # surfels older than the window (loop-closure view)
MODE_ALL = 2

_BIG_INDEX = jnp.int32(2**30)
_FAR = jnp.float32(1e9)

# int32 view of the 0.05 m near-plane float (the z gate floor): positive IEEE
# floats compare identically as ints, so truncated (bits(z) - floor) is a
# monotone RELATIVE-precision depth key
_Z_FLOOR_BITS = int(np.float32(0.05).view(np.int32))


def packed_key_params(
    n_rows: int, depth_max: float, windowed: bool
) -> tuple[int, int] | None:
    """Static (idx_bits, shift) layout of the packed z-buffer key, or None when
    the exact two-scatter path must be used.

    The key is `depth_key * 2^idx_bits + idx` with
    `depth_key = (bitcast_i32(z) - bitcast_i32(0.05)) >> shift` — positive
    float bits are monotone in value, so truncating mantissa bits yields a
    RELATIVE-precision bucket: the scatter-min tie-break can prefer a surfel at
    most `z * 2^(shift-23)` farther than the true nearest (vs the quadratic
    `z^2 * dinv` blow-up of inverse-depth buckets, which reached metres at
    street/KITTI ranges).

    idx_bits: windowed passes derive it from the window size (which is
    capacity-independent); full-map passes always use the 21-bit cap so two
    maps holding the same surfels at different capacities <= 2^21 compare the
    same lexicographic (depth_key, idx) and pick bit-identical winners
    (capacity invariance).  shift then uses whatever bits remain, refusing the
    packed path (-> exact) when the relative error would exceed 2^-6 ~ 1.6%.
    """
    if n_rows > (1 << 21):
        return None
    if windowed:
        idx_bits = max(int(np.ceil(np.log2(max(n_rows, 2)))), 1)
    else:
        idx_bits = 21
    span = int(np.float32(min(depth_max, 1e9)).view(np.int32)) - _Z_FLOOR_BITS
    shift = max(0, int(span).bit_length() - (31 - idx_bits))
    if shift > 17:  # relative tie-break error 2^(shift-23) would exceed ~1.6%
        return None
    max_key = ((span >> shift) + 1) * (1 << idx_bits) + (n_rows - 1)
    if max_key >= np.iinfo(np.int32).max:
        return None
    return idx_bits, shift


class Prediction(NamedTuple):
    """Predicted view of the map from a pose (camera-frame maps).  Equivalent
    of the reference's `IndexMap` texture set."""

    index: jnp.ndarray  # [H,W] i32 surfel id, -1 where empty
    vmap: jnp.ndarray  # [H,W,3] camera-frame vertices (z=0 invalid)
    nmap: jnp.ndarray  # [H,W,3] camera-frame normals
    color: jnp.ndarray  # [H,W,3] 0..255
    intensity: jnp.ndarray  # [H,W] luminance
    depth: jnp.ndarray  # [H,W] z (0 invalid)
    time: jnp.ndarray  # [H,W] last-seen tick of the winning surfel
    conf: jnp.ndarray  # [H,W] confidence of the winning surfel
    cell: jnp.ndarray  # [H,W] i32 raw per-cell z-buffer winner BEFORE the
    # disk resolve (-1 none).  Every surfel visible anywhere in `index` won
    # its own centre cell here (it only ever scattered to that cell), so
    # accumulation passes keyed on `cell` can always be gathered back by the
    # winning surfel — `index` cannot guarantee that (a nearer overlapping
    # neighbour may cover the winner's own centre pixel after the resolve).


def active_window_start(
    count: jnp.ndarray, capacity: int, window: int
) -> jnp.ndarray:
    """Start row of the active tail block.

    The map is append-only and the periodic compaction partitions rows as
    [inactive..., active...] (see `surfel_map.compact`), so the surfels inside
    the reference's time window (`splat.vert:60-66`) live in the last `window`
    allocated rows — hot ACTIVE-mode passes (tracking render, fusion, clean)
    slice this block instead of streaming the whole capacity, which is what
    makes per-frame cost scale with the *working set*, not the map size."""
    return jnp.clip(count - window, 0, max(capacity - window, 0)).astype(jnp.int32)


@functools.partial(
    jax.jit,
    static_argnames=(
        "intr", "width", "height", "splat_k", "mode", "window", "packed_zbuffer",
        "depth_max",  # static: the packed-key layout is derived from it
    ),
)
def render(
    data: jnp.ndarray,  # [N+1, 16] surfel rows (sm layout)
    count: jnp.ndarray,  # [] i32
    pose: jnp.ndarray,  # [4,4] camera-to-world of the view to render
    intr: CameraIntrinsics,
    width: int,
    height: int,
    time: jnp.ndarray | int,
    time_delta: int = 200,
    conf_threshold: float = 0.0,
    mode: int = MODE_ALL,
    splat_k: int = 3,
    depth_max: float = 100.0,
    window: int = 0,
    packed_zbuffer: bool = True,
) -> Prediction:
    """Render the surfel map from `pose`.

    Time-window gating follows the reference (`splat.vert:60-66`,
    `IndexMap.cpp` ACTIVE/INACTIVE): ACTIVE keeps surfels whose last-seen tick
    is within `time_delta` of `time`; INACTIVE keeps the complement.
    `conf_threshold` > 0 restricts to stable surfels.

    `window` > 0 (ACTIVE mode only) restricts the pass to the active tail
    block of `window` rows (see `active_window_start`); `Prediction.index`
    stays a *global* row index either way."""
    N = data.shape[0] - 1
    HW = height * width
    windowed = window > 0 and window < N and mode == MODE_ACTIVE
    if windowed:
        start = active_window_start(count, N, window)
        rows = jax.lax.dynamic_slice(data, (start, 0), (window, sm.COLS))
        n_rows = window
    else:
        start = jnp.array(0, jnp.int32)
        rows = data[:-1]
        n_rows = N
    idx = jnp.arange(n_rows)
    conf = rows[:, sm.CONF]
    seen = jnp.max(rows[:, sm.LAST_SEEN], axis=-1)

    Tinv = se3.se3_inverse(pose)
    p_c = se3.transform_points(Tinv, rows[:, sm.POS])
    z = p_c[:, 2]
    zsafe = jnp.maximum(z, 1e-6)
    u = p_c[:, 0] / zsafe * intr.fx + intr.cx
    v = p_c[:, 1] / zsafe * intr.fy + intr.cy

    alive = (conf > 0) & (idx < count - start)
    if conf_threshold > 0:
        alive = alive & (conf >= conf_threshold)
    t_now = jnp.asarray(time, jnp.float32)
    if mode == MODE_ACTIVE:
        alive = alive & (t_now - seen < time_delta)
    elif mode == MODE_INACTIVE:
        alive = alive & (t_now - seen >= time_delta)
    visible = alive & (z > 0.05) & (z < depth_max)

    ui = jnp.round(u).astype(jnp.int32)
    vi = jnp.round(v).astype(jnp.int32)
    inb = (ui >= 0) & (ui < width) & (vi >= 0) & (vi < height)
    ok = visible & inb
    tid = jnp.where(ok, vi * width + ui, HW)

    pkp = packed_key_params(n_rows, depth_max, windowed) if packed_zbuffer else None
    if pkp is not None:
        # phase 1+2 fused: ONE scatter-min of a packed (depth-bucket, index)
        # key, half the scatters of the exact path.  The bucket is the truncated
        # float32 bit pattern of z (monotone for positive floats), so it only
        # decides the winner among surfels within a RELATIVE z * 2^(shift-23)
        # band (<= ~1.6%; the output depth is the winner's EXACT z, gathered
        # in phase 3) — see `packed_key_params` for the static layout rules
        # and the capacity-invariance argument.  Larger maps (32M capacity)
        # fall back to the exact two-scatter path.
        idx_bits, z_shift = pkp
        zc = jnp.clip(z, 0.05, depth_max).astype(jnp.float32)
        zbits = jax.lax.bitcast_convert_type(zc, jnp.int32)
        depth_key = (zbits - _Z_FLOOR_BITS) >> z_shift
        key = depth_key * (1 << idx_bits) + idx
        i32_max = jnp.iinfo(jnp.int32).max
        kbuf = jnp.full((HW + 1,), i32_max, jnp.int32).at[tid].min(
            jnp.where(ok, key, i32_max)
        )
        win = kbuf[:HW] & ((1 << idx_bits) - 1)
        has_win = kbuf[:HW] < i32_max
    else:
        # exact two-phase: scatter-min z, then deterministic min-index
        # tie-break among exact-z winners
        zbuf = jnp.full((HW + 1,), _FAR, jnp.float32).at[tid].min(
            jnp.where(ok, z, _FAR)
        )
        is_win = ok & (z <= zbuf[tid])
        ibuf = jnp.full((HW + 1,), _BIG_INDEX, jnp.int32).at[tid].min(
            jnp.where(is_win, idx, _BIG_INDEX)
        )
        win = ibuf[:HW]
        has_win = win < _BIG_INDEX
    win_safe = jnp.where(has_win, win, n_rows - 1)  # any in-range row; masked below
    cell_map = jnp.where(
        has_win, (start + win).astype(jnp.int32), -1
    ).reshape(height, width)

    # phase 3: ONE wide row-gather of winner attributes: all per-surfel
    # columns (u, v, z, p_c, attribute rows) are packed into one [n_rows, 16]
    # table first (dense, cheap) and fetched in a single gather instead of
    # several narrow ones.
    n_cam = se3.rotate_vectors(Tinv, rows[:, sm.NORMAL])
    r_px_all = jnp.clip(
        rows[:, sm.RADIUS] * intr.fx / jnp.maximum(z, 1e-6), 0.5, splat_k * 0.75
    )
    tbl = jnp.concatenate(
        [
            u[:, None],
            v[:, None],
            z[:, None],
            p_c,
            n_cam,
            r_px_all[:, None],
            (start + idx).astype(jnp.float32)[:, None],  # global row index
            rows[:, sm.COLOR],
            jnp.max(rows[:, sm.LAST_SEEN], axis=-1)[:, None],
            rows[:, sm.CONF][:, None],
        ],
        axis=-1,
    )
    g = tbl[win_safe]  # [HW, 16] — the only gather in phase 3
    invalid_row = jnp.concatenate(
        [
            jnp.array([-1e9, -1e9], jnp.float32),
            jnp.array([_FAR], jnp.float32),
            jnp.zeros((13,), jnp.float32),
        ]
    )
    cand = jnp.where(has_win[:, None], g, invalid_row).reshape(height, width, 16)

    # phase 4: dense 3x3 disk resolve — each pixel adopts the nearest
    # neighbouring-cell winner whose screen disk covers it
    x_pix, y_pix = warp.pixel_grid(height, width)
    half = splat_k // 2
    best_z = jnp.full((height, width), _FAR, jnp.float32)
    best = jnp.zeros((height, width, 16), jnp.float32)
    for dy in range(-half, half + 1):
        for dx in range(-half, half + 1):
            c = warp.shift(cand, dy, dx)
            du = c[..., 0] - x_pix
            dv = c[..., 1] - y_pix
            r_px = c[..., 9]
            covers = (du * du + dv * dv) <= r_px * r_px
            # z > 0.05 also rejects the zero rows shift() pads in at borders
            valid = (c[..., 2] > 0.05) & (c[..., 2] < depth_max) & covers
            better = valid & (c[..., 2] < best_z)
            best_z = jnp.where(better, c[..., 2], best_z)
            best = jnp.where(better[..., None], c, best)

    valid_px = best_z < _FAR
    # ray/tangent-plane depth refinement (combo_splat ray-disk intersection)
    ray = jnp.stack(
        [
            (x_pix - intr.cx) / intr.fx,
            (y_pix - intr.cy) / intr.fy,
            jnp.ones_like(x_pix),
        ],
        axis=-1,
    )
    n_w = best[..., 6:9]
    p_w = best[..., 3:6]
    denom = jnp.sum(ray * n_w, axis=-1)
    z_plane = jnp.sum(p_w * n_w, axis=-1) / jnp.where(
        jnp.abs(denom) > 0.05, denom, jnp.inf
    )
    z_c = best[..., 2]
    r_m = best[..., 9] * jnp.maximum(z_c, 1e-6) / intr.fx  # back to metres-ish
    z_ref = jnp.where(jnp.abs(z_plane - z_c) < 2.0 * r_m + 1e-3, z_plane, z_c)
    z_out = jnp.where(valid_px, z_ref, 0.0)

    vmap = jnp.where(valid_px[..., None], ray * z_out[..., None], 0.0)
    nmap = jnp.where(valid_px[..., None], n_w, 0.0)
    color = jnp.where(valid_px[..., None], best[..., 11:14], 0.0)
    tmap = jnp.where(valid_px, best[..., 14], -1.0)
    cmap = jnp.where(valid_px, best[..., 15], 0.0)
    index = jnp.where(valid_px, best[..., 10].astype(jnp.int32), -1)
    intensity = (
        0.299 * color[..., 0] + 0.587 * color[..., 1] + 0.114 * color[..., 2]
    )
    return Prediction(
        index=index,
        vmap=vmap,
        nmap=nmap,
        color=color,
        intensity=intensity,
        depth=z_out,
        time=tmap,
        conf=cmap,
        cell=cell_map,
    )
