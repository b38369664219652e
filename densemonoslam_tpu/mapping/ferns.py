"""Random-fern keyframe encoding for place recognition and relocalisation.

Equivalent of the reference `Ferns` (`Core/src/Ferns.{h,cpp}`,
Glocker et al.): n=500 ferns at random pixels of the 8x-downsampled frame,
each emitting a 4-bit code by thresholding R, G, B and depth
(`Ferns.cpp:21-81`); a frame is kept as a fern keyframe if its minimum
dissimilarity to the database exceeds `fernThresh` = 0.3095
(`addFrame`, :178-275); retrieval returns the most similar stored frame
(`findFrame`, :277-423) whose pose seeds relocalisation / loop closure, then
an ICP refinement + photometric consistency check validate the match.

Where the reference maintains a per-fern inverted index (`ids[16]`
"conservatory") to scan candidates on CPU, we compare the query against the
WHOLE database densely — [K, 500] byte codes against [500] — which is a
trivial elementwise reduction for any realistic K and removes the index
bookkeeping.

The database is fixed-capacity device arrays; each stored frame keeps its
downsampled intensity/depth maps so the engine can run the reference's
downsampled-ICP refinement (`Ferns.h` fern-resolution RGBDOdometry) and
`photometricCheck` (:625-671) against it.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from densemonoslam_tpu.ops import warp
import numpy as np

NUM_FERNS = 500
FERN_THRESH = 0.3095
PHOTO_THRESH = 115.0


class FernCoder(NamedTuple):
    """Random fern test positions + thresholds (fixed at startup, like the
    reference's ctor-seeded `generateFerns`)."""

    ux: jnp.ndarray  # [F] i32 x pixel in the downsampled frame
    vy: jnp.ndarray  # [F] i32 y pixel
    thresh_rgb: jnp.ndarray  # [F, 3] f32 0..255
    thresh_d: jnp.ndarray  # [F] f32 metres


class FernDB(NamedTuple):
    """Fixed-capacity keyframe database (device arrays)."""

    codes: jnp.ndarray  # [K, F] i32 4-bit codes
    poses: jnp.ndarray  # [K, 4, 4]
    intensity: jnp.ndarray  # [K, h, w] stored downsampled intensity
    depth: jnp.ndarray  # [K, h, w] stored downsampled metric depth
    times: jnp.ndarray  # [K] tick of insertion
    count: jnp.ndarray  # [] i32


def make_coder(
    width: int, height: int, depth_max: float, seed: int = 0,
    num_ferns: int = NUM_FERNS,
) -> FernCoder:
    """Random fern tests over the downsampled resolution (reference seeds
    rand() once; we use a fixed numpy seed for reproducibility).  `num_ferns`
    mirrors the reference `--n` flag (default 500, `Options.h`)."""
    rng = np.random.default_rng(seed)
    return FernCoder(
        ux=jnp.asarray(rng.integers(0, width, num_ferns), jnp.int32),
        vy=jnp.asarray(rng.integers(0, height, num_ferns), jnp.int32),
        thresh_rgb=jnp.asarray(rng.uniform(0, 255, (num_ferns, 3)), jnp.float32),
        thresh_d=jnp.asarray(rng.uniform(0.1, depth_max, num_ferns), jnp.float32),
    )


def empty_db(
    capacity: int, height: int, width: int, num_ferns: int = NUM_FERNS
) -> FernDB:
    return FernDB(
        codes=jnp.zeros((capacity, num_ferns), jnp.int32),
        poses=jnp.broadcast_to(
            jnp.eye(4, dtype=jnp.float32), (capacity, 4, 4)
        ),
        intensity=jnp.zeros((capacity, height, width), jnp.float32),
        depth=jnp.zeros((capacity, height, width), jnp.float32),
        times=jnp.full((capacity,), -1.0, jnp.float32),
        count=jnp.array(0, jnp.int32),
    )


@jax.jit
def encode(
    coder: FernCoder, rgb_small: jnp.ndarray, depth_small: jnp.ndarray
) -> jnp.ndarray:
    """Downsampled frame -> [F] 4-bit codes (reference `badCode`-free path:
    bit k set when channel k exceeds its threshold)."""
    px_rgb = rgb_small[coder.vy, coder.ux].astype(jnp.float32)  # [F, 3]
    px_d = depth_small[coder.vy, coder.ux]
    bits = jnp.concatenate(
        [(px_rgb > coder.thresh_rgb), (px_d > coder.thresh_d)[:, None]], axis=-1
    )
    weights = jnp.array([1, 2, 4, 8], jnp.int32)
    return jnp.sum(bits.astype(jnp.int32) * weights, axis=-1)


@jax.jit
def dissimilarity(db: FernDB, code: jnp.ndarray) -> jnp.ndarray:
    """[K] fraction of ferns whose codes differ (1.0 for empty slots)."""
    diff = jnp.mean((db.codes != code[None, :]).astype(jnp.float32), axis=-1)
    k = jnp.arange(db.codes.shape[0])
    return jnp.where(k < db.count, diff, 1.0)


@jax.jit
def best_match(
    db: FernDB, code: jnp.ndarray, exclude_after: jnp.ndarray | float = jnp.inf
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """(best index, its dissimilarity); frames inserted at or after
    `exclude_after` ticks are ignored (don't match against yourself /
    the recent past — the reference excludes the frame being added)."""
    d = dissimilarity(db, code)
    d = jnp.where(db.times < exclude_after, d, 1.0)
    i = jnp.argmin(d)
    return i, d[i]


@functools.partial(
    jax.jit, donate_argnames=("db",), static_argnames=("evict",)
)
def add_frame(
    db: FernDB,
    code: jnp.ndarray,
    pose: jnp.ndarray,
    intensity_small: jnp.ndarray,
    depth_small: jnp.ndarray,
    time: jnp.ndarray | float,
    min_dissim: jnp.ndarray,
    thresh: float = FERN_THRESH,
    evict: bool = False,
) -> Tuple[FernDB, jnp.ndarray]:
    """Insert the frame if it is novel enough (reference `addFrame`:
    keep when min dissimilarity > fernThresh, or DB empty).  Returns
    (db, added?).

    With `evict=True` a FULL database still accepts novel frames by
    overwriting its most redundant entry — the keyframe with minimum
    dissimilarity to its nearest neighbour, i.e. the one carrying the least
    unique place information.  The reference never needs this (its `frames`
    vector is unbounded, `Ferns.h:76-89`); fixed-capacity device arrays do,
    or place recognition silently freezes in the oldest part of the map once
    `fern_db_max` is reached."""
    K = db.codes.shape[0]
    novel = (min_dissim > thresh) | (db.count == 0)
    full = db.count >= K
    add = novel & ((db.count < K) | (jnp.asarray(evict) & full))

    def append_slot(_):
        return jnp.where(add, db.count, K - 1)

    if evict:
        def evict_slot(_):
            # pairwise code-agreement via one matmul over one-hot codes:
            # eq[i,j] = #ferns on which keyframes i and j agree
            F = db.codes.shape[1]
            oh = jax.nn.one_hot(db.codes, 16, dtype=jnp.bfloat16).reshape(K, -1)
            eq = jnp.dot(oh, oh.T, preferred_element_type=jnp.float32)
            dis = 1.0 - eq / float(F)
            i = jnp.arange(K)
            live = (i < db.count).astype(jnp.float32)
            # self-pairs and empty slots never count as neighbours
            pairmask = live[:, None] * live[None, :] * (1.0 - jnp.eye(K))
            dis = jnp.where(pairmask > 0, dis, jnp.inf)
            nn = jnp.min(dis, axis=1)  # each entry's nearest-neighbour dissim
            nn = jnp.where(i < db.count, nn, jnp.inf)
            return jnp.argmin(nn).astype(jnp.int32)

        slot = jax.lax.cond(full & novel, evict_slot, append_slot, None)
    else:
        slot = append_slot(None)

    def put(arr, val):
        return jax.lax.cond(
            add, lambda a: a.at[slot].set(val), lambda a: a, arr
        )

    db = FernDB(
        codes=put(db.codes, code),
        poses=put(db.poses, pose),
        intensity=put(db.intensity, intensity_small),
        depth=put(db.depth, depth_small),
        times=put(db.times, jnp.asarray(time, jnp.float32)),
        count=jnp.minimum(db.count + add.astype(jnp.int32), K),
    )
    return db, add


@jax.jit
def photometric_check(
    stored_intensity: jnp.ndarray,
    query_intensity: jnp.ndarray,
    stored_depth: jnp.ndarray,
    query_depth: jnp.ndarray,
) -> jnp.ndarray:
    """Mean absolute intensity difference over mutually valid pixels
    (reference `photometricCheck`, `Ferns.cpp:625-671`, vs photoThresh=115).
    Returns the mean abs diff (compare against PHOTO_THRESH outside)."""
    valid = (stored_depth > 0) & (query_depth > 0)
    diff = jnp.abs(stored_intensity - query_intensity) * valid
    return jnp.sum(diff) / jnp.maximum(jnp.sum(valid), 1.0)


def downsample_for_ferns(img: jnp.ndarray, factor: int = 8) -> jnp.ndarray:
    """Decimation for fern encoding (reference encodes in a 2^fernPyrLevel-
    downsampled frame; default level 3 = 8x)."""
    return warp.decimate(img, factor)


def grow_db(db: FernDB) -> FernDB:
    """Double the DB capacity (the reference's `frames` is an unbounded
    std::vector, `Ferns.h:76-89`; we grow the fixed-capacity device arrays
    geometrically instead of silently reusing the last row)."""
    K, F = db.codes.shape
    h, w = db.intensity.shape[1:]
    fresh = empty_db(K, h, w, num_ferns=F)
    return FernDB(
        codes=jnp.concatenate([db.codes, fresh.codes]),
        poses=jnp.concatenate([db.poses, fresh.poses]),
        intensity=jnp.concatenate([db.intensity, fresh.intensity]),
        depth=jnp.concatenate([db.depth, fresh.depth]),
        times=jnp.concatenate([db.times, fresh.times]),
        count=db.count,
    )
