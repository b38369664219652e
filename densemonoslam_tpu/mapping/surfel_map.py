"""Fixed-capacity surfel map as a functional SoA tensor.

Replacement for the reference `GlobalModel`
(`Core/src/GlobalModel.{h,cpp}`): there the map is a double-buffered OpenGL
VBO pair updated by transform-feedback passes (TEXTURE_DIMENSION=5700 ->
~32.5M surfels, 60 B each: pos+conf, packed color+initTime, normal+radius,
per-sensor last-seen times — `Shaders/Vertex.cpp:21-50`).  Here it is a single
packed ``f32[N+1, 16]`` array (row N is a write-dump slot for masked
scatters) plus an allocation counter, updated purely functionally with buffer
donation — XLA's equivalent of the VBO ping-pong without the copy.

Column layout (f32):
    0:3   position (world frame)
    3     confidence (0 = free slot / culled)
    4:7   rgb color (0..255)
    7     radius (metres)
    8:11  normal (unit, world frame)
    11    init_time (tick of creation)
    12:15 last-seen tick per sensor (MAX_SENSORS = 3, reference size.glsl)
    15    cluster id (reference per-cluster VBOs, `GlobalModel.h:100-101`;
          fed from GroundTruthClusters or any per-frame segmentation id)
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import chex
import jax
import jax.numpy as jnp

# column indices
POS = slice(0, 3)
CONF = 3
COLOR = slice(4, 7)
RADIUS = 7
NORMAL = slice(8, 11)
INIT_TIME = 11
LAST_SEEN = slice(12, 15)
CLUSTER = 15
PAD = 15  # legacy alias
COLS = 16
MAX_SENSORS = 3


@chex.dataclass(frozen=True)
class SurfelMap:
    """The map state.  `data` has capacity+1 rows; `count` is the number of
    allocated slots (allocated does not imply alive — culled surfels have
    conf == 0 until the next compaction)."""

    data: jnp.ndarray  # [N+1, 16] f32
    count: jnp.ndarray  # [] i32

    @property
    def capacity(self) -> int:
        return self.data.shape[0] - 1

    # --- convenience views (gather-free slices) ---------------------------
    @property
    def positions(self) -> jnp.ndarray:
        return self.data[:-1, POS]

    @property
    def confidences(self) -> jnp.ndarray:
        return self.data[:-1, CONF]

    @property
    def colors(self) -> jnp.ndarray:
        return self.data[:-1, COLOR]

    @property
    def radii(self) -> jnp.ndarray:
        return self.data[:-1, RADIUS]

    @property
    def normals(self) -> jnp.ndarray:
        return self.data[:-1, NORMAL]

    @property
    def init_times(self) -> jnp.ndarray:
        return self.data[:-1, INIT_TIME]

    @property
    def last_seen(self) -> jnp.ndarray:
        return self.data[:-1, LAST_SEEN]

    @property
    def alive(self) -> jnp.ndarray:
        """Boolean [N]: slot holds a live surfel."""
        n = self.capacity
        idx = jnp.arange(n)
        return (self.data[:-1, CONF] > 0) & (idx < self.count)

    def num_alive(self) -> jnp.ndarray:
        return jnp.sum(self.alive.astype(jnp.int32))


def empty_map(capacity: int) -> SurfelMap:
    return SurfelMap(
        data=jnp.zeros((capacity + 1, COLS), jnp.float32),
        count=jnp.array(0, jnp.int32),
    )


def last_seen_any(m: SurfelMap) -> jnp.ndarray:
    """Latest tick any sensor saw each surfel (drives the active/inactive
    time window, reference `splat.vert:60-66`)."""
    return jnp.max(m.data[:-1, LAST_SEEN], axis=-1)


@functools.partial(jax.jit, donate_argnames=("m",))
def append_surfels(
    m: SurfelMap,
    attrs: jnp.ndarray,  # [K, 16] candidate rows
    valid: jnp.ndarray,  # [K] bool
) -> SurfelMap:
    """Append `valid` rows after `count` (stream-compacting scatter).

    Replaces the reference's transform-feedback append of new unstable surfels
    (`GlobalModel::clean` merge step / `initialise`).  Invalid rows and rows
    beyond capacity land in the dump slot.
    """
    offsets = jnp.cumsum(valid.astype(jnp.int32)) - 1
    dest = m.count + offsets
    cap = m.capacity
    dest = jnp.where(valid & (dest < cap), dest, cap)  # cap row = dump slot
    data = m.data.at[dest].set(attrs, mode="drop")
    new_count = jnp.minimum(
        m.count + jnp.sum(valid.astype(jnp.int32)), cap
    ).astype(jnp.int32)
    return SurfelMap(data=data, count=new_count)


@functools.partial(
    jax.jit,
    donate_argnames=("m",),
    static_argnames=(
        "time_delta", "stale_conf_threshold", "unstable_ttl", "max_active",
    ),
)
def compact(m: SurfelMap, time: jnp.ndarray | float | None = None,
            time_delta: int = 0, stale_conf_threshold: float = 0.0,
            unstable_ttl: int = 20, max_active: int = 0) -> SurfelMap:
    """Compact live surfels to the front (reference: the copy_unstable pass
    simply skips culled surfels during feedback; with static shapes we sort by
    liveness instead — a stable argsort keeps temporal ordering, which the
    deformation graph's time-sequential sampling relies on).

    With `time`/`time_delta` given, live rows are additionally partitioned
    [inactive..., active...] (active = last seen within `time_delta` of
    `time`, the reference's `splat.vert:60-66` window) so the hot ACTIVE-mode
    passes can stream just the tail block (`splat.active_window_start`).
    Inactive surfels are old and active ones recent, so the stable partition
    still keeps rows approximately time-ordered within each group.

    `stale_conf_threshold` > 0 additionally culls never-stabilised surfels not
    refreshed within `unstable_ttl` ticks during the sweep — the whole-map
    part of the reference copy_unstable outlier cull, which the per-frame
    windowed `fusion.clean` can only apply to the active tail block."""
    alive = m.alive
    if time is None:
        key = jnp.where(alive, 0, 1)  # live rows first, order preserved
    else:
        t_now = jnp.asarray(time, jnp.float32)
        if stale_conf_threshold > 0:
            age = t_now - last_seen_any(m)
            # cull only inside the active epoch — the reference preserves
            # inactive surfels regardless of confidence
            # (copy_unstable.vert:140-156)
            stale = (
                (m.data[:-1, CONF] < stale_conf_threshold)
                & (age > unstable_ttl)
                & (age <= time_delta)
            )
            alive = alive & ~stale
        active = alive & (t_now - last_seen_any(m) < time_delta)
        key = jnp.where(active, 1, jnp.where(alive, 0, 2))
    order = jnp.argsort(key, stable=True)
    data = m.data.at[:-1].set(m.data[:-1][order])
    count = jnp.sum(alive.astype(jnp.int32))
    # zero the confidences of everything past the new count so stale rows
    # cannot resurface
    idx = jnp.arange(m.capacity)
    conf = jnp.where(idx < count, data[:-1, CONF], 0.0)
    data = data.at[:-1, CONF].set(conf)
    if max_active > 0 and time is not None:
        # backstop for the windowed hot passes: if more than `max_active`
        # surfels sit inside the time window (e.g. a loop closure reactivated
        # a large in-view region), demote the OLDEST-appended overflow back to
        # inactive (last-seen = t_now - time_delta) — they stay in the map and
        # in the INACTIVE loop-closure view, but the active tail block the
        # windowed render/fusion streams stays a true superset of the ACTIVE
        # set (no silently-dropped fusion targets / duplicate geometry).
        # Post-sort the layout is [inactive..., active...], so the overflow is
        # the first (n_active - max_active) rows of the active tail; demoted
        # rows remain between the inactive front and the kept active tail,
        # preserving the partition invariant.
        n_active = jnp.sum((key == 1).astype(jnp.int32))
        demote_lo = count - n_active
        demote_hi = count - max_active
        demote = (idx >= demote_lo) & (idx < demote_hi)
        t_inact = jnp.asarray(time, jnp.float32) - jnp.float32(time_delta)
        ls = data[:-1, LAST_SEEN]
        data = data.at[:-1, LAST_SEEN].set(
            jnp.where(demote[:, None], jnp.minimum(ls, t_inact), ls)
        )
    return SurfelMap(data=data, count=count)


class MapSnapshot(NamedTuple):
    """Host-side export of the live surfels (for PLY/eval)."""

    positions: jnp.ndarray
    normals: jnp.ndarray
    colors: jnp.ndarray
    radii: jnp.ndarray
    confidences: jnp.ndarray
    init_times: jnp.ndarray
    clusters: jnp.ndarray


def snapshot(m: SurfelMap, conf_threshold: float = 0.0) -> MapSnapshot:
    """Gather live (optionally stable-only) surfels to host arrays."""
    import numpy as np

    alive = np.asarray(m.alive)
    if conf_threshold > 0:
        alive = alive & (np.asarray(m.confidences) > conf_threshold)
    data = np.asarray(m.data[:-1])[alive]
    return MapSnapshot(
        positions=data[:, POS],
        normals=data[:, NORMAL],
        colors=data[:, COLOR],
        radii=data[:, RADIUS],
        confidences=data[:, CONF],
        init_times=data[:, INIT_TIME],
        clusters=data[:, CLUSTER].astype(int),
    )
