"""Deformation-graph unit tests: sampling, blending, optimisation, and map
application."""

import jax.numpy as jnp
import numpy as np
import pytest

from densemonoslam_tpu.mapping import deformation as dg
from densemonoslam_tpu.mapping import surfel_map as sm

MAX_NODES = 32


def _line_graph(n=16, spacing=0.2):
    """Nodes along the x axis, timestamps = index (time-ordered)."""
    pos = np.zeros((MAX_NODES, 3), np.float32)
    pos[:n, 0] = np.arange(n) * spacing
    time = np.full((MAX_NODES,), np.inf, np.float32)
    time[:n] = np.arange(n)
    valid = np.zeros(MAX_NODES, bool)
    valid[:n] = True
    return dg.DeformGraph(
        pos=jnp.asarray(pos),
        time=jnp.asarray(time),
        valid=jnp.asarray(valid),
        A=jnp.broadcast_to(jnp.eye(3, dtype=jnp.float32), (MAX_NODES, 3, 3)),
        t=jnp.zeros((MAX_NODES, 3), jnp.float32),
    )


def _no_constraints(c=8):
    return dg.Constraint(
        src=jnp.zeros((c, 3), jnp.float32),
        dst=jnp.zeros((c, 3), jnp.float32),
        time=jnp.zeros((c,), jnp.float32),
        valid=jnp.zeros((c,), bool),
        pinned=jnp.zeros((c,), bool),
    )


def test_identity_graph_is_identity_warp(rng):
    g = _line_graph()
    pts = jnp.asarray(rng.normal(0, 1, (50, 3)).astype(np.float32))
    times = jnp.asarray(rng.uniform(0, 15, 50).astype(np.float32))
    out = dg.deform_points(g, pts, times)
    np.testing.assert_allclose(np.asarray(out), np.asarray(pts), atol=1e-5)


def test_optimise_no_constraints_stays_identity():
    g = _line_graph()
    g2, stats = dg.optimise(g, _no_constraints())
    np.testing.assert_allclose(np.asarray(g2.t), 0.0, atol=1e-4)
    np.testing.assert_allclose(
        np.asarray(g2.A[:16]), np.broadcast_to(np.eye(3), (16, 3, 3)), atol=1e-4
    )
    assert float(stats.final_error) <= float(stats.initial_error) + 1e-6


def test_optimise_translation_constraint(rng):
    """Constraints asking recent geometry to shift by delta must move the
    constrained region by ~delta while keeping the graph smooth."""
    g = _line_graph()
    delta = np.array([0.0, 0.05, 0.0], np.float32)
    # constrain points near nodes 10..15 (recent times)
    src = np.zeros((8, 3), np.float32)
    src[:, 0] = np.linspace(2.0, 3.0, 8)
    tcons = np.linspace(10, 15, 8).astype(np.float32)
    cons = dg.Constraint(
        src=jnp.asarray(src),
        dst=jnp.asarray(src + delta),
        time=jnp.asarray(tcons),
        valid=jnp.ones(8, bool),
        pinned=jnp.zeros(8, bool),
    )
    g2, stats = dg.optimise(g, cons, iters=5)
    assert float(stats.mean_cons_error) < 0.01, float(stats.mean_cons_error)
    # constrained points moved onto their targets
    moved = dg.deform_points(g2, jnp.asarray(src), jnp.asarray(tcons))
    np.testing.assert_allclose(np.asarray(moved), src + delta, atol=0.01)
    # NOTE: without frozen nodes the energy has a global-translation gauge
    # freedom (E_rot/E_reg are shift-invariant), so far geometry may ride
    # along; anchoring is the engine's job via the frozen mask — see
    # test_frozen_nodes_do_not_move.


def test_frozen_nodes_do_not_move():
    g = _line_graph()
    delta = np.array([0.0, 0.08, 0.0], np.float32)
    src = np.zeros((8, 3), np.float32)
    src[:, 0] = np.linspace(2.4, 3.0, 8)
    tcons = np.linspace(12, 15, 8).astype(np.float32)
    cons = dg.Constraint(
        src=jnp.asarray(src),
        dst=jnp.asarray(src + delta),
        time=jnp.asarray(tcons),
        valid=jnp.ones(8, bool),
        pinned=jnp.zeros(8, bool),
    )
    frozen = jnp.asarray(np.arange(MAX_NODES) < 6)
    g2, _ = dg.optimise(g, cons, frozen=frozen, iters=5)
    t = np.asarray(g2.t)
    assert np.abs(t[:6]).max() < 5e-3  # frozen stay put
    assert np.abs(t[10:16, 1]).max() > 0.02  # recent nodes moved


def test_sample_graph_from_map(rng):
    cap = 1 << 12
    m = sm.empty_map(cap)
    n = 2000
    rows = np.zeros((n, sm.COLS), np.float32)
    rows[:, 0:3] = rng.normal(0, 1, (n, 3))
    rows[:, sm.CONF] = 5.0
    rows[:, sm.INIT_TIME] = np.arange(n)  # temporal order
    data = m.data.at[:n].set(jnp.asarray(rows))
    g = dg.sample_graph(data, jnp.array(n, jnp.int32), max_nodes=64, sample_rate=100)
    valid = np.asarray(g.valid)
    assert valid.sum() == 20  # 2000 / 100
    t = np.asarray(g.time)[valid]
    assert np.all(np.diff(t) > 0)  # time-ordered
    np.testing.assert_allclose(np.asarray(g.pos)[0], rows[0, 0:3], atol=0)


def test_apply_to_map_moves_surfels(rng):
    cap = 256
    m = sm.empty_map(cap)
    n = 64
    rows = np.zeros((n, sm.COLS), np.float32)
    rows[:, 0] = np.linspace(0, 3, n)
    rows[:, sm.CONF] = 5.0
    rows[:, 8 + 1] = 1.0  # normal = +y
    rows[:, sm.INIT_TIME] = np.linspace(0, 15, n)
    data = m.data.at[:n].set(jnp.asarray(rows))

    g = _line_graph()
    g = g._replace(t=g.t.at[:16, 1].set(0.1))  # rigid +y shift of all nodes
    new_data = dg.apply_to_map(data, jnp.array(n, jnp.int32), g)
    p = np.asarray(new_data[:n, sm.POS])
    np.testing.assert_allclose(p[:, 1], 0.1, atol=1e-5)
    np.testing.assert_allclose(p[:, 0], rows[:, 0], atol=1e-5)
    # pure translation leaves normals unchanged
    nn = np.asarray(new_data[:n, sm.NORMAL])
    np.testing.assert_allclose(nn[:, 1], 1.0, atol=1e-5)


def test_apply_to_pose():
    g = _line_graph()
    g = g._replace(t=g.t.at[:16, 2].set(0.2))
    pose = jnp.eye(4, dtype=jnp.float32).at[:3, 3].set(jnp.array([1.0, 0.0, 0.0]))
    out = dg.apply_to_pose(g, pose, 8.0)
    out = np.asarray(out)
    np.testing.assert_allclose(out[:3, 3], [1.0, 0.0, 0.2], atol=1e-4)
    np.testing.assert_allclose(out[:3, :3], np.eye(3), atol=1e-4)


def test_relative_constraints_preserve_prior_correction():
    """Carried relative constraints (reference `addRelativeConstraint` +
    `Deformation.cpp:171-187`) must stop a later optimisation from dragging
    previously-corrected geometry away: a pair recorded as coincident stays
    coincident while a new point constraint deforms the nearby recent map."""
    n = 32
    pos = np.zeros((n, 3), np.float32)
    pos[:, 0] = np.arange(n) * 0.1
    g = dg.DeformGraph(
        pos=jnp.asarray(pos),
        time=jnp.asarray(np.arange(n, dtype=np.float32)),
        valid=jnp.ones((n,), bool),
        A=jnp.broadcast_to(jnp.eye(3, dtype=jnp.float32), (n, 3, 3)),
        t=jnp.zeros((n, 3), jnp.float32),
    )
    frozen = g.time < 16
    # new closure: pull recent geometry at x=2.8 up by 0.3
    cons = dg.Constraint(
        src=jnp.asarray([[2.8, 0.0, 0.0]], jnp.float32),
        dst=jnp.asarray([[2.8, 0.3, 0.0]], jnp.float32),
        time=jnp.asarray([28.0], jnp.float32),
        valid=jnp.ones((1,), bool),
        pinned=jnp.zeros((1,), bool),
    )
    # prior closure recorded: the point seen at t=26 coincides with the same
    # spot seen at t=10 (old, frozen epoch)
    rel = dg.RelConstraint(
        src=jnp.asarray([[2.6, 0.0, 0.0]], jnp.float32),
        dst=jnp.asarray([[2.6, 0.0, 0.0]], jnp.float32),
        src_time=jnp.asarray([26.0], jnp.float32),
        dst_time=jnp.asarray([10.0], jnp.float32),
        valid=jnp.ones((1,), bool),
    )

    def gap(graph):
        s = dg.deform_points(graph, rel.src, rel.src_time)
        d = dg.deform_points(graph, rel.dst, rel.dst_time)
        return float(jnp.linalg.norm(s - d))

    g_no, _ = dg.optimise(g, cons, frozen=frozen)
    g_rel, _ = dg.optimise(g, cons, frozen=frozen, rel=rel)
    assert gap(g_no) > 0.04  # without carry-over the pair is torn apart
    assert gap(g_rel) < 0.5 * gap(g_no)
    assert gap(g_rel) < 0.03
    # the new closure's own constraint is still honoured
    moved = dg.deform_points(g_rel, cons.src, cons.time)
    assert float(jnp.linalg.norm(moved - cons.dst)) < 0.1


def test_apply_to_map_chunked_tail_matches_float64_reference():
    """A capacity above one `APPLY_CHUNK` block with a partial tail block:
    live rows (a sample of the first block, all of the tail) match the
    float64 numpy evaluation of the blending semantics, and dead rows
    (culled, or at/after `count`) are untouched."""
    from chip_smoke import blend_reference, random_graph, random_map

    rows = dg.APPLY_CHUNK + 3000
    count = dg.APPLY_CHUNK + 1000  # live rows reach into the tail block
    data = random_map(5, rows, count, 3.0)
    cnt = jnp.asarray(count, jnp.int32)
    graph = random_graph(data, cnt, 64, 3.0, seed=6)
    sample = np.r_[np.random.default_rng(0).choice(dg.APPLY_CHUNK, 20000, replace=False),
                   np.arange(dg.APPLY_CHUNK, rows)]
    before = np.asarray(data)[sample]
    after = np.asarray(dg.apply_to_map(data, cnt, graph))[sample]
    g = [np.asarray(a) for a in (graph.pos, graph.time, graph.valid, graph.A, graph.t)]
    alive = before[:, sm.CONF] > 0
    assert alive[-3000:].sum() > 900 and (~alive[-3000:]).sum() >= 2000
    ref_p, ref_n = blend_reference(
        *g, before[alive][:, sm.POS], before[alive][:, sm.INIT_TIME],
        before[alive][:, sm.NORMAL],
    )
    assert np.abs(ref_p - before[alive][:, sm.POS]).max() > 0.01  # it moved
    np.testing.assert_allclose(after[alive][:, sm.POS], ref_p, atol=1e-4)
    np.testing.assert_allclose(after[alive][:, sm.NORMAL], ref_n, atol=1e-5)
    np.testing.assert_array_equal(after[~alive], before[~alive])
