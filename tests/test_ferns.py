"""Fern place-recognition tests on the synthetic oracle."""

import jax.numpy as jnp
import numpy as np
import pytest

from densemonoslam_tpu.io.synthetic import SyntheticSequence
from densemonoslam_tpu.mapping import ferns


@pytest.fixture(scope="module")
def seq():
    return SyntheticSequence(num_frames=40, radius=0.35, max_angle=0.3)


@pytest.fixture(scope="module")
def coder(seq):
    res = seq.camera.resolution
    return ferns.make_coder(res.width // 8, res.height // 8, depth_max=8.0)


def _small(seq, i):
    rgb, depth = seq.frame(i)
    return (
        ferns.downsample_for_ferns(jnp.asarray(rgb, jnp.float32)),
        ferns.downsample_for_ferns(jnp.asarray(depth)),
    )


def test_encode_deterministic_and_discriminative(seq, coder):
    r0, d0 = _small(seq, 0)
    r1, d1 = _small(seq, 20)
    c0a = ferns.encode(coder, r0, d0)
    c0b = ferns.encode(coder, r0, d0)
    c1 = ferns.encode(coder, r1, d1)
    np.testing.assert_array_equal(np.asarray(c0a), np.asarray(c0b))
    assert np.asarray(c0a).min() >= 0 and np.asarray(c0a).max() <= 15
    # different viewpoints -> appreciably different codes
    frac_diff = float(jnp.mean((c0a != c1).astype(jnp.float32)))
    assert frac_diff > 0.2


def test_db_add_and_novelty_gate(seq, coder):
    res = seq.camera.resolution
    db = ferns.empty_db(64, res.height // 8, res.width // 8)
    added_flags = []
    for i in range(0, 40, 4):
        r, d = _small(seq, i)
        code = ferns.encode(coder, r, d)
        intens = 0.299 * r[..., 0] + 0.587 * r[..., 1] + 0.114 * r[..., 2]
        _, dis = ferns.best_match(db, code)
        db, added = ferns.add_frame(
            db,
            code,
            jnp.asarray(seq.gt_pose(i).astype(np.float32)),
            intens,
            d,
            time=i,
            min_dissim=dis,
        )
        added_flags.append(bool(added))
    assert added_flags[0]  # first always kept
    assert 2 <= int(db.count) <= 10  # novelty gate keeps a sparse set
    # re-presenting a stored frame must NOT be added
    r, d = _small(seq, 0)
    code = ferns.encode(coder, r, d)
    _, dis = ferns.best_match(db, code)
    n_before = int(db.count)
    db, added = ferns.add_frame(
        db, code, jnp.eye(4, dtype=jnp.float32),
        jnp.zeros_like(d), d, time=99, min_dissim=dis,
    )
    assert not bool(added) and int(db.count) == n_before


def test_retrieval_returns_nearest_view(seq, coder):
    """Query with a frame close to a stored keyframe: the best match must be
    that keyframe, and its pose a good recovery seed."""
    res = seq.camera.resolution
    db = ferns.empty_db(64, res.height // 8, res.width // 8)
    stored = [0, 8, 16, 24, 32]
    for i in stored:
        r, d = _small(seq, i)
        code = ferns.encode(coder, r, d)
        intens = 0.299 * r[..., 0] + 0.587 * r[..., 1] + 0.114 * r[..., 2]
        db, _ = ferns.add_frame(
            db, code, jnp.asarray(seq.gt_pose(i).astype(np.float32)),
            intens, d, time=i, min_dissim=jnp.asarray(1.0),
        )
    assert int(db.count) == len(stored)
    # query frame 9 (nearest stored: 8)
    r, d = _small(seq, 9)
    code = ferns.encode(coder, r, d)
    idx, dis = ferns.best_match(db, code)
    assert int(idx) == 1, (int(idx), float(dis))
    rec_pose = np.asarray(db.poses[idx])
    gt = seq.gt_pose(9)
    terr = np.linalg.norm(rec_pose[:3, 3] - gt[:3, 3])
    assert terr < 0.15  # recovery seed within ICP convergence range


def test_exclude_recent(seq, coder):
    res = seq.camera.resolution
    db = ferns.empty_db(64, res.height // 8, res.width // 8)
    r, d = _small(seq, 0)
    code = ferns.encode(coder, r, d)
    db, _ = ferns.add_frame(
        db, code, jnp.eye(4, dtype=jnp.float32), jnp.zeros_like(d), d,
        time=50, min_dissim=jnp.asarray(1.0),
    )
    # matching the same code but excluding frames newer than tick 50
    i, dis = ferns.best_match(db, code, exclude_after=jnp.asarray(50.0))
    assert float(dis) == 1.0  # nothing eligible


def test_photometric_check(seq):
    r0, d0 = _small(seq, 0)
    i0 = 0.299 * r0[..., 0] + 0.587 * r0[..., 1] + 0.114 * r0[..., 2]
    same = ferns.photometric_check(i0, i0, d0, d0)
    assert float(same) < 1.0
    r1, d1 = _small(seq, 20)
    i1 = 0.299 * r1[..., 0] + 0.587 * r1[..., 1] + 0.114 * r1[..., 2]
    diff = ferns.photometric_check(i0, i1, d0, d1)
    assert float(diff) > float(same) + 5.0


def test_full_db_evicts_most_redundant(seq, coder):
    """At `fern_db_max` the DB must keep accepting novel keyframes by
    evicting its most redundant entry (min nearest-neighbour dissimilarity)
    — not silently freeze (the reference keeps an unbounded vector,
    `Ferns.h:76-89`)."""
    res = seq.camera.resolution
    K = 8
    db = ferns.empty_db(K, res.height // 8, res.width // 8)
    inserted = []
    for i in range(0, 40, 2):  # 20 distinct views through an 8-slot DB
        r, d = _small(seq, i)
        code = ferns.encode(coder, r, d)
        intens = 0.299 * r[..., 0] + 0.587 * r[..., 1] + 0.114 * r[..., 2]
        _, dis = ferns.best_match(db, code)
        db, added = ferns.add_frame(
            db, code, jnp.asarray(seq.gt_pose(i).astype(np.float32)),
            intens, d, time=i, min_dissim=dis, thresh=0.05, evict=True,
        )
        if bool(added):
            inserted.append(i)
    assert int(db.count) == K  # full, not frozen
    assert len(inserted) > K  # insertions continued past capacity
    # the NEWEST keyframe is retrievable: query with its own frame
    r, d = _small(seq, inserted[-1])
    code = ferns.encode(coder, r, d)
    idx, dis = ferns.best_match(db, code)
    assert float(dis) < 0.05
    assert float(db.times[int(idx)]) == float(inserted[-1])


def test_full_db_without_evict_freezes(seq, coder):
    res = seq.camera.resolution
    db = ferns.empty_db(4, res.height // 8, res.width // 8)
    n_added = 0
    for i in range(0, 40, 4):
        r, d = _small(seq, i)
        code = ferns.encode(coder, r, d)
        intens = 0.299 * r[..., 0] + 0.587 * r[..., 1] + 0.114 * r[..., 2]
        _, dis = ferns.best_match(db, code)
        db, added = ferns.add_frame(
            db, code, jnp.asarray(seq.gt_pose(i).astype(np.float32)),
            intens, d, time=i, min_dissim=dis, thresh=0.05,
        )
        n_added += int(added)
    assert int(db.count) == 4 and n_added == 4
