"""Surfel fusion: data association, weighted-average update, new-surfel
insertion, and map cleaning.

Replacement for the reference's transform-feedback fusion passes
(`Core/src/GlobalModel.cpp`): `fuse` = the data-association render
(`Shaders/data.vert:18-190`) followed by the update pass
(`Shaders/update.vert:18-120`: confidence-weighted running averages);
`clean` = the copy_unstable pass (`Shaders/copy_unstable.vert:18-320`:
free-space violation and stale-unstable culling).

The update pass is **pull-based**, so fusion needs no scatter: the
association render resolves, per pixel, the nearest map surfel covering it
(`ops.splat.render`'s 3x3 disk resolve is exactly the reference data-pass
window search); each pixel then publishes its weighted contribution into a
dense payload image, and every surfel *gathers* the 3x3 payload neighbourhood
around its own projection, accumulating the contributions addressed to it.
Gathers amortise across fused lanes; the only scatter left in fusion is the
z-buffer inside the render.  New surfels are appended with a sort-compact +
`dynamic_update_slice` (contiguous write), not a scatter.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from densemonoslam_tpu.config import CameraIntrinsics
from densemonoslam_tpu.mapping import surfel_map as sm
from densemonoslam_tpu.ops import splat, warp
from densemonoslam_tpu.utils import se3

# association gates (reference `data.vert`: depth window +-0.05,
# normal agreement)
DEPTH_GATE = 0.05
NORMAL_DOT_GATE = 0.5
# new-surfel radius = sqrt(2) * z / fx, inflated for oblique views but clamped
# (reference `Shaders/surfels.glsl` radius equation)
RADIUS_OBLIQUE_CLAMP = 0.5
# don't fuse geometry from a sample much coarser than the surfel
# (reference update.vert fuses only when the new radius < (1+.5) * old)
RADIUS_FUSE_FACTOR = 1.5
# unstable surfels older than this many ticks get culled
UNSTABLE_TTL = 20
FREE_SPACE_MARGIN = 0.1


class FuseStats(NamedTuple):
    matched: jnp.ndarray  # pixels fused into existing surfels
    added: jnp.ndarray  # new surfels created
    culled: jnp.ndarray  # surfels removed by clean()
    dropped: jnp.ndarray  # insertions discarded by the capacity headroom
    # guard — silent data loss unless surfaced


def sample_confidence(
    u: jnp.ndarray, v: jnp.ndarray, intr: CameraIntrinsics, weight_mult: jnp.ndarray | float
) -> jnp.ndarray:
    """Per-pixel fusion weight: Gaussian in radial distance from the principal
    point (reference `Shaders/surfels.glsl` confidence())."""
    sigma = 0.6 * jnp.maximum(intr.cx, intr.cy) * 2.0
    r2 = (u - intr.cx) ** 2 + (v - intr.cy) ** 2
    return jnp.exp(-r2 / (2.0 * sigma * sigma)) * weight_mult


def _new_radius(z: jnp.ndarray, nz: jnp.ndarray, fx: float) -> jnp.ndarray:
    r = 1.41421356 * z / fx
    return r / jnp.maximum(jnp.abs(nz), RADIUS_OBLIQUE_CLAMP)


@functools.partial(
    jax.jit,
    static_argnames=("intr", "time_delta", "splat_k", "window", "packed_zbuffer"),
    donate_argnames=("m",),
)
def fuse(
    m: sm.SurfelMap,
    vmap_c: jnp.ndarray,  # [H,W,3] current frame camera-space vertices
    nmap_c: jnp.ndarray,  # [H,W,3]
    rgb_c: jnp.ndarray,  # [H,W,3] 0..255
    pose: jnp.ndarray,  # [4,4] camera-to-world
    intr: CameraIntrinsics,
    time: jnp.ndarray | int,
    sensor: int = 0,
    weight_mult: jnp.ndarray | float = 1.0,
    time_delta: int = 200,
    splat_k: int = 3,
    window: int = 0,
    packed_zbuffer: bool = True,
    cluster_id: jnp.ndarray | float = 0.0,
) -> Tuple[sm.SurfelMap, FuseStats]:
    """Fuse one RGB-D frame into the map at `pose`.

    `window` > 0 restricts association + update to the active tail block
    (`splat.active_window_start`) — fusion only ever touches ACTIVE surfels
    (the reference fuses against the ACTIVE-mode prediction only), so with
    the compaction-maintained [inactive..., active...] layout the update pass
    need not stream the whole map."""
    # --- association render (reference predictIndices + data.vert search) --
    pred = splat.render(
        m.data, m.count, pose, intr, vmap_c.shape[1], vmap_c.shape[0],
        jnp.asarray(time, jnp.float32),
        time_delta=time_delta, mode=splat.MODE_ACTIVE, splat_k=splat_k,
        window=window, packed_zbuffer=packed_zbuffer,
    )
    return fuse_with_pred(
        m, pred, vmap_c, nmap_c, rgb_c, pose, intr, time, sensor=sensor,
        weight_mult=weight_mult, splat_k=splat_k, window=window,
        cluster_id=cluster_id,
    )


def fuse_window(
    rows: jnp.ndarray,  # [n_rows, 16] the block of map rows to update
    row_start: jnp.ndarray,  # [] i32 global index of rows[0]
    count: jnp.ndarray,  # [] i32 allocated map rows
    pred: splat.Prediction,  # ACTIVE-mode prediction at `pose` (global indices)
    vmap_c: jnp.ndarray,
    nmap_c: jnp.ndarray,
    rgb_c: jnp.ndarray,
    pose: jnp.ndarray,
    intr: CameraIntrinsics,
    time: jnp.ndarray | int,
    sensor: int = 0,
    weight_mult: jnp.ndarray | float = 1.0,
    splat_k: int = 3,
    clean_depth: jnp.ndarray | None = None,
    conf_threshold: float = 10.0,
    unstable_ttl: int = UNSTABLE_TTL,
    time_delta: int = 200,
    cluster_id: jnp.ndarray | float = 0.0,
    depth_gate_rel: float = 0.0,
    pack_sorted: bool = False,
):
    """The window-level fusion core: association + weighted update + inline
    clean + new-row packing, WITHOUT touching the full map tensor.

    Returns ``(blk, packed, rank, n_want, matched, culled)`` where `blk` is
    the updated row block, `packed` the [HW,16] candidate new-surfel rows,
    `rank` [HW] i32 each row's insertion rank (scanline-stable; -1 = not a
    new surfel) and `n_want` how many are real.  Callers place these with
    `place_updates` — keeping the full-capacity buffer out of this function
    (and out of any `lax.cond` wrapping it) lets XLA alias the big tensor
    through plain dynamic_update_slice ops, so per-frame cost stays bound by
    the window even at the reference's 32.5M-surfel capacity (a conditional
    that *returns* the map forces full-buffer copies that scale with N).

    `pack_sorted=False` (the default) leaves `packed` in pixel order and the
    placement is ONE row scatter keyed on `rank`, which replaces an argsort
    over HW rows outright.  Callers
    that must TRUNCATE `packed` before placing (map capacity < HW: the
    truncation would drop real new rows from arbitrary pixels) pass
    `pack_sorted=True` to get the old new-rows-first stable sort, with
    `rank` built positionally so the same placement code works on both."""
    H, W, _ = vmap_c.shape
    HW = H * W
    t_now = jnp.asarray(time, jnp.float32)
    n_rows = rows.shape[0]
    start = row_start

    z_f = vmap_c[..., 2]
    valid_f = (z_f > 0) & (jnp.linalg.norm(nmap_c, axis=-1) > 0.5)
    # depth-proportional gate for street-scale / CNN-predicted depth
    # (`depth_gate_rel`, see EngineConfig); 0 = reference absolute window
    gate = jnp.maximum(DEPTH_GATE, depth_gate_rel * z_f)
    depth_ok = jnp.abs(pred.depth - z_f) < gate
    norm_ok = jnp.sum(pred.nmap * nmap_c, axis=-1) > NORMAL_DOT_GATE
    matched = valid_f & (pred.index >= 0) & depth_ok & norm_ok

    # --- per-pixel contribution payload ------------------------------------
    x_pix, y_pix = warp.pixel_grid(H, W)
    a = sample_confidence(x_pix, y_pix, intr, weight_mult) * matched
    p_w = se3.transform_points(pose, vmap_c)
    n_w = se3.rotate_vectors(pose, nmap_c)
    r_new = _new_radius(z_f, nmap_c[..., 2], intr.fx)
    a3 = a[..., None]
    payload = jnp.concatenate(
        [
            jnp.where(matched, pred.index, -1).astype(jnp.float32)[..., None],
            a[..., None],
            a3 * p_w,
            a3 * n_w,
            a3 * rgb_c.astype(jnp.float32),
            (a * r_new)[..., None],
        ],
        axis=-1,
    )  # [H, W, 12]

    # --- pull pass: each surfel gathers contributions addressed to it ------
    idx = start + jnp.arange(n_rows)  # global row ids (payload indices are global)
    alive = (rows[:, sm.CONF] > 0) & (idx < count)
    Tinv = se3.se3_inverse(pose)
    p_s = se3.transform_points(Tinv, rows[:, sm.POS])
    z_s = p_s[:, 2]
    zsafe = jnp.maximum(z_s, 1e-6)
    u_s = p_s[:, 0] / zsafe * intr.fx + intr.cx
    v_s = p_s[:, 1] / zsafe * intr.fy + intr.cy
    ui = jnp.clip(jnp.round(u_s).astype(jnp.int32), 0, W - 1)
    vi = jnp.clip(jnp.round(v_s).astype(jnp.int32), 0, H - 1)
    in_view = alive & (z_s > 0.05) & (u_s >= 0) & (u_s <= W - 1) & (v_s >= 0) & (v_s <= H - 1)

    # Dense image-space pre-accumulation: for each pixel CELL, sum the 3x3
    # neighbourhood's payload rows addressed to that cell's winning surfel
    # (static shifts — pure elementwise work).  Every matched pixel lies
    # within splat_k//2 of its winner's centre cell by construction of the
    # render's disk resolve, so each surfel then needs exactly ONE gather (its
    # centre cell) instead of nine.
    # Key the accumulation cells on the RAW pre-resolve z-buffer winner, not
    # the post-disk-resolve `pred.index`: a surfel that won its cell but whose
    # centre pixel resolved to a nearer overlapping neighbour would otherwise
    # gather nothing at its centre cell while its pixels stayed `matched` —
    # silently dropping those measurements.  Every surfel appearing in
    # `pred.index` won its own centre cell in `pred.cell` by construction, so
    # this guarantees the single per-surfel gather below always lands.
    win_f = pred.cell.astype(jnp.float32)  # [H,W] raw winner per cell (-1 none)
    acc = jnp.zeros((H, W, 12), jnp.float32)
    half = splat_k // 2
    for dy in range(-half, half + 1):
        for dx in range(-half, half + 1):
            t = warp.shift(payload, dy, dx)
            hit = (t[..., 0] == win_f) & (win_f >= 0)
            acc = acc + jnp.where(hit[..., None], t, 0.0)
    obs_depth = (
        clean_depth if clean_depth is not None else jnp.zeros((H, W), jnp.float32)
    )
    gtab = jnp.concatenate(
        [win_f[..., None], acc[..., 1:12], obs_depth[..., None]], axis=-1
    ).reshape(HW, 13)

    g = gtab[vi * W + ui]  # the ONE per-surfel gather
    mine = in_view & (g[:, 0] == idx.astype(jnp.float32))
    sum_pay = jnp.where(mine[:, None], g[:, 1:12], 0.0)

    sum_a = sum_pay[:, 0]
    touched = sum_a > 0
    mean_p = sum_pay[:, 1:4] / jnp.maximum(sum_a, 1e-12)[:, None]
    mean_n = sum_pay[:, 4:7] / jnp.maximum(sum_a, 1e-12)[:, None]
    mean_c = sum_pay[:, 7:10] / jnp.maximum(sum_a, 1e-12)[:, None]
    mean_r = sum_pay[:, 10] / jnp.maximum(sum_a, 1e-12)

    conf_old = rows[:, sm.CONF]
    r_old = rows[:, sm.RADIUS]
    geo_ok = touched & (mean_r < RADIUS_FUSE_FACTOR * r_old)
    blend = jnp.where(
        geo_ok, sum_a / jnp.maximum(conf_old + sum_a, 1e-12), 0.0
    )[:, None]
    new_pos = rows[:, sm.POS] * (1 - blend) + mean_p * blend
    new_col = rows[:, sm.COLOR] * (1 - blend) + mean_c * blend
    nrm_mix = rows[:, sm.NORMAL] * (1 - blend) + mean_n * blend
    nrm_mix = nrm_mix / jnp.maximum(
        jnp.linalg.norm(nrm_mix, axis=-1, keepdims=True), 1e-9
    )
    new_rad = rows[:, sm.RADIUS] * (1 - blend[:, 0]) + mean_r * blend[:, 0]

    upd = jnp.concatenate(
        [
            new_pos,
            (conf_old + sum_a)[:, None],
            new_col,
            new_rad[:, None],
            nrm_mix,
            rows[:, sm.INIT_TIME][:, None],
            rows[:, sm.LAST_SEEN],
            rows[:, 15:16],
        ],
        axis=-1,
    )
    seen_col = 12 + sensor
    upd = upd.at[:, seen_col].set(t_now)
    blk = jnp.where(touched[:, None], upd, rows)

    # --- inline clean (reference copy_unstable outlier cull) ---------------
    if clean_depth is not None:
        d_obs = g[:, 12]
        fs_margin = jnp.maximum(FREE_SPACE_MARGIN, 2.0 * depth_gate_rel * d_obs)
        free_space = (
            in_view & (d_obs > 0) & (z_s < d_obs - fs_margin)
        )
        new_conf = blk[:, sm.CONF]
        last = jnp.max(blk[:, sm.LAST_SEEN], axis=-1)
        age = t_now - last
        # stale-unstable culling applies only within the active epoch: the
        # reference resurrects surfels older than timeDelta regardless of
        # confidence (copy_unstable.vert:140-156, test=1 for inactive)
        stale = (
            alive
            & (new_conf < conf_threshold)
            & (age > unstable_ttl)
            & (age <= time_delta)
        )
        kill = alive & (stale | free_space)
        blk = blk.at[:, sm.CONF].set(jnp.where(kill, 0.0, new_conf))
        culled = jnp.sum(kill.astype(jnp.int32))
    else:
        culled = jnp.array(0, jnp.int32)

    # --- pack unmatched pixels as candidate new surfels ---------------------
    is_new = (valid_f & ~matched).reshape(HW)
    new_rows = jnp.zeros((HW, 16), jnp.float32)
    a_flat = sample_confidence(x_pix, y_pix, intr, weight_mult).reshape(HW)
    new_rows = new_rows.at[:, sm.POS].set(p_w.reshape(HW, 3))
    new_rows = new_rows.at[:, sm.CONF].set(jnp.maximum(a_flat, 1e-3))
    new_rows = new_rows.at[:, sm.COLOR].set(rgb_c.reshape(HW, 3).astype(jnp.float32))
    new_rows = new_rows.at[:, sm.RADIUS].set(r_new.reshape(HW))
    new_rows = new_rows.at[:, sm.NORMAL].set(n_w.reshape(HW, 3))
    new_rows = new_rows.at[:, sm.INIT_TIME].set(t_now)
    new_rows = new_rows.at[:, seen_col].set(t_now)
    new_rows = new_rows.at[:, sm.CLUSTER].set(
        jnp.asarray(cluster_id, jnp.float32)
    )

    n_want = jnp.sum(is_new.astype(jnp.int32))
    if pack_sorted:
        order = jnp.argsort(~is_new, stable=True)  # new pixels first
        packed = new_rows[order]
        i = jnp.arange(HW)
        rank = jnp.where(i < n_want, i, -1).astype(jnp.int32)
    else:
        packed = new_rows
        rank = jnp.where(
            is_new, jnp.cumsum(is_new.astype(jnp.int32)) - 1, -1
        ).astype(jnp.int32)
    return blk, packed, rank, n_want, jnp.sum(matched.astype(jnp.int32)), culled


def place_updates(
    data: jnp.ndarray,  # [N+1, 16] full map tensor
    count: jnp.ndarray,  # [] i32
    blk: jnp.ndarray,  # [n_rows, 16] updated block from fuse_window
    row_start: jnp.ndarray,  # [] i32 where blk goes
    packed: jnp.ndarray,  # [S, 16] candidate new rows
    n_want: jnp.ndarray,  # [] i32 how many packed rows are real
    rank: jnp.ndarray,  # [S] i32 insertion rank per row (-1 = not new)
):
    """Write a fused block + append the frame's new rows into the map tensor.

    Pure dynamic-update + gather placement, no full-buffer scatter
    (alias-friendly — keep these OUTSIDE any lax.cond; see `fuse_window`).
    Appends land at ``count + rank``; rows past the headroom guard are
    dropped (surfaced in the returned count).

    The insertion region [count, count+n_new) is CONTIGUOUS and `rank` is
    monotone in pixel order, so the appended block can be assembled with a
    `searchsorted` + row gather and written with ONE dynamic_update_slice,
    bit-identical to a row scatter on every allocated row (only the dump
    slot N, defined as garbage, differs).  Capacities smaller than one frame
    keep the scatter path (the slice window would exceed the buffer).  Which
    of the two is faster on the H100 is not measured yet.
    Returns ``(data, new_count, n_new, dropped)``."""
    N = data.shape[0] - 1
    S = packed.shape[0]
    data = jax.lax.dynamic_update_slice(data, blk, (row_start, 0))
    # headroom guard: drop the frame's insertions if the map is nearly full
    room = N - count
    n_new = jnp.minimum(n_want, jnp.maximum(room - 1, 0))
    if N + 1 > S:
        is_new = (rank >= 0).astype(jnp.int32)
        csum = jnp.cumsum(is_new)
        # clamp the slice window inside the buffer; slots below `count`
        # keep their original rows via the `take` mask
        start = jnp.minimum(count, N + 1 - S).astype(jnp.int32)
        k = start + jnp.arange(S) - count  # target rank per slot
        src = jnp.clip(
            jnp.searchsorted(csum, k + 1, side="left"), 0, S - 1
        ).astype(jnp.int32)
        take = (k >= 0) & (k < n_new)
        orig = jax.lax.dynamic_slice(data, (start, 0), (S, sm.COLS))
        merged = jnp.where(take[:, None], packed[src], orig)
        data = jax.lax.dynamic_update_slice(data, merged, (start, 0))
    else:
        dest = jnp.where((rank >= 0) & (rank < n_new), count + rank, N)
        data = data.at[dest].set(packed)
    new_count = jnp.minimum(count + n_new, N).astype(jnp.int32)
    return data, new_count, n_new, n_want - n_new


@functools.partial(
    jax.jit,
    static_argnames=("intr", "splat_k", "window", "time_delta"),
    donate_argnames=("m",),
)
def fuse_with_pred(
    m: sm.SurfelMap,
    pred: splat.Prediction,  # ACTIVE-mode prediction at `pose` (global indices)
    vmap_c: jnp.ndarray,
    nmap_c: jnp.ndarray,
    rgb_c: jnp.ndarray,
    pose: jnp.ndarray,
    intr: CameraIntrinsics,
    time: jnp.ndarray | int,
    sensor: int = 0,
    weight_mult: jnp.ndarray | float = 1.0,
    splat_k: int = 3,
    window: int = 0,
    clean_depth: jnp.ndarray | None = None,
    conf_threshold: float = 10.0,
    unstable_ttl: int = UNSTABLE_TTL,
    time_delta: int = 200,
    cluster_id: jnp.ndarray | float = 0.0,
) -> Tuple[sm.SurfelMap, FuseStats]:
    """Fusion given an already-rendered association prediction (lets the
    caller share one render between association and tracking fill-in).

    With `clean_depth` (the frame's metric depth), the copy_unstable outlier
    cull (`clean`) runs inline: the observed depth rides the same per-surfel
    gather the update pass needs anyway, so cleaning costs no extra pass.

    This wrapper = window slice -> `fuse_window` -> `place_updates`; step.py
    calls the pieces directly so the full map never crosses a lax.cond."""
    N = m.capacity
    if window > 0 and window < N:
        start = splat.active_window_start(m.count, N, window)
        rows = jax.lax.dynamic_slice(m.data, (start, 0), (window, sm.COLS))
    else:
        start = jnp.array(0, jnp.int32)
        rows = m.data[:-1]
    blk, packed, rank, n_want, matched, culled = fuse_window(
        rows, start, m.count, pred, vmap_c, nmap_c, rgb_c, pose, intr, time,
        sensor=sensor, weight_mult=weight_mult, splat_k=splat_k,
        clean_depth=clean_depth, conf_threshold=conf_threshold,
        unstable_ttl=unstable_ttl, time_delta=time_delta,
        cluster_id=cluster_id,
    )
    data, new_count, n_new, dropped = place_updates(
        m.data, m.count, blk, start, packed, n_want, rank
    )
    m2 = sm.SurfelMap(data=data, count=new_count)
    stats = FuseStats(
        matched=matched, added=n_new, culled=culled, dropped=dropped
    )
    return m2, stats


@functools.partial(
    jax.jit,
    static_argnames=("intr", "conf_threshold", "window", "time_delta"),
    donate_argnames=("m",),
)
def clean(
    m: sm.SurfelMap,
    depth_frame: jnp.ndarray,  # [H,W] metric depth of the current frame
    pose: jnp.ndarray,
    intr: CameraIntrinsics,
    time: jnp.ndarray | int,
    conf_threshold: float = 10.0,
    unstable_ttl: int = UNSTABLE_TTL,
    window: int = 0,
    time_delta: int = 200,
) -> Tuple[sm.SurfelMap, jnp.ndarray]:
    """Cull bad surfels (reference `copy_unstable.vert` outlier logic):

    - unstable surfels (conf < threshold) not refreshed within `unstable_ttl`
      ticks of their creation;
    - free-space violators: surfels projecting well in front of the currently
      observed depth (the sensor saw through them).

    Returns (map, culled_count).  Culled = conf set to 0; slots are reclaimed
    by `surfel_map.compact`.
    """
    H, W = depth_frame.shape
    t_now = jnp.asarray(time, jnp.float32)
    N = m.capacity
    if window > 0 and window < N:
        # unstable + free-space-violating surfels are recent observations =>
        # they live in the active tail block (layout kept by compaction)
        start = splat.active_window_start(m.count, N, window)
        rows = jax.lax.dynamic_slice(m.data, (start, 0), (window, sm.COLS))
        n_rows = window
    else:
        start = jnp.array(0, jnp.int32)
        rows = m.data[:-1]
        n_rows = N
    idx = start + jnp.arange(n_rows)
    alive = (rows[:, sm.CONF] > 0) & (idx < m.count)

    Tinv = se3.se3_inverse(pose)
    p_c = se3.transform_points(Tinv, rows[:, sm.POS])
    z = p_c[:, 2]
    zsafe = jnp.maximum(z, 1e-6)
    u = p_c[:, 0] / zsafe * intr.fx + intr.cx
    v = p_c[:, 1] / zsafe * intr.fy + intr.cy
    ui = jnp.clip(jnp.round(u).astype(jnp.int32), 0, W - 1)
    vi = jnp.clip(jnp.round(v).astype(jnp.int32), 0, H - 1)
    inb = (u >= 0) & (u <= W - 1) & (v >= 0) & (v <= H - 1) & (z > 0.05)
    d_obs = depth_frame[vi, ui]
    free_space = inb & (d_obs > 0) & (z < d_obs - FREE_SPACE_MARGIN)

    unstable = rows[:, sm.CONF] < conf_threshold
    last = jnp.max(rows[:, sm.LAST_SEEN], axis=-1)
    age = t_now - last
    # only cull inside the active epoch (reference resurrects inactive
    # surfels, copy_unstable.vert:140-156)
    stale = unstable & (age > unstable_ttl) & (age <= time_delta)

    kill = alive & (stale | free_space)
    blk = rows.at[:, sm.CONF].set(jnp.where(kill, 0.0, rows[:, sm.CONF]))
    data = jax.lax.dynamic_update_slice(m.data, blk, (start, 0))
    return sm.SurfelMap(data=data, count=m.count), jnp.sum(kill.astype(jnp.int32))
