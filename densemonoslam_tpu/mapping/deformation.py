"""Embedded deformation graph for non-rigid map correction (loop closure).

Equivalent of the reference `Deformation` + `DeformationGraph`
(`Core/src/Deformation.cpp`, `Core/src/DeformationGraph.cpp`): Sumner-style
embedded deformation over a *time-ordered* node sequence sampled from the
surfel map (1 node per `sample_rate` surfels, `Deformation.cpp:251-348`),
k=4 temporal-sequential connectivity (`connectGraphSeq`,
`DeformationGraph.cpp:252-288`), energy

    E = w_rot * E_rot + w_reg * E_reg + w_con * E_con   (weights {1, 10, 100},
    `DeformationGraph.h:115-122`)

with 12 variables per node (3x3 A + translation t).

Where the reference builds a sparse Jacobian by hand and factorises with
CHOLMOD on the CPU (`sparseJacobian`, `CholeskyDecomp.cpp`), we solve the
normal equations matrix-free on device: Gauss-Newton with conjugate gradient,
where ``(JtJ + lambda I) v`` is computed as ``vjp(jvp(residual))`` — two
autodiff passes through the batched energy, no materialised Jacobian.
Vertices/poses are blended over the k nearest of a 20-node temporal look-back
window (`DeformationGraph.cpp:133-250`), exactly as the reference's
`copy_unstable.vert` does on the GPU for map surfels.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from densemonoslam_tpu.mapping import surfel_map as sm
from densemonoslam_tpu.utils import se3

W_ROT = 1.0
W_REG = 10.0
W_CON = 100.0
GN_ITERS = 3
CG_ITERS = 64
K_NEIGHBOURS = 4
LOOKBACK = 20  # temporal candidate window for blending weights
DAMPING = 1e-4


class DeformGraph(NamedTuple):
    pos: jnp.ndarray  # [K, 3] node positions (world)
    time: jnp.ndarray  # [K] node timestamps (sorted ascending)
    valid: jnp.ndarray  # [K] bool
    A: jnp.ndarray  # [K, 3, 3] per-node affine (identity at rest)
    t: jnp.ndarray  # [K, 3] per-node translation

    @property
    def n_nodes(self) -> int:
        return self.pos.shape[0]


class Constraint(NamedTuple):
    """Point constraints: deform src (+its timestamp) onto dst
    (reference `Deformation::Constraint`)."""

    src: jnp.ndarray  # [C, 3]
    dst: jnp.ndarray  # [C, 3]
    time: jnp.ndarray  # [C]
    valid: jnp.ndarray  # [C] bool
    pinned: jnp.ndarray  # [C] bool: dst side also constrained to not move


class RelConstraint(NamedTuple):
    """Relative constraints: BOTH endpoints deform, and the energy holds
    their deformed positions together — `phi(src) - phi(dst)` rows at the
    same sqrt(w_con) weight (reference `addRelativeConstraint` +
    `DeformationGraph.cpp:922-931`).  Emitted after each accepted local
    deformation from its point constraints (`Deformation.cpp:171-187`) and
    consumed by every future optimisation, which is what keeps successive
    loop closures from undoing each other's corrections."""

    src: jnp.ndarray  # [R, 3] deformed source positions at emission time
    dst: jnp.ndarray  # [R, 3] the constraint targets they were pulled onto
    src_time: jnp.ndarray  # [R]
    dst_time: jnp.ndarray  # [R]
    valid: jnp.ndarray  # [R] bool


def empty_rel(capacity: int) -> RelConstraint:
    return RelConstraint(
        src=jnp.zeros((capacity, 3), jnp.float32),
        dst=jnp.zeros((capacity, 3), jnp.float32),
        src_time=jnp.zeros((capacity,), jnp.float32),
        dst_time=jnp.zeros((capacity,), jnp.float32),
        valid=jnp.zeros((capacity,), bool),
    )


@functools.partial(jax.jit, static_argnames=("max_nodes", "sample_rate"))
def sample_graph(
    data: jnp.ndarray, count: jnp.ndarray, max_nodes: int, sample_rate: int
) -> DeformGraph:
    """Sample every `sample_rate`-th allocated surfel as a node (reference
    `sample.vert`/`sample.geom`: every 5000th stable surfel; append order is
    temporal, so the node sequence is time-ordered).

    When `max_nodes * sample_rate < count` the stride widens so the node
    sequence always spans the WHOLE allocated map — otherwise the most recent
    (most deformable) epoch would have no nodes and loop closures could not
    move it."""
    stride = jnp.maximum(jnp.asarray(sample_rate, jnp.int32), count // max_nodes + 1)
    idx = jnp.arange(max_nodes) * stride
    ok = (idx < count) & (data[jnp.minimum(idx, data.shape[0] - 2), sm.CONF] > 0)
    idx = jnp.minimum(idx, data.shape[0] - 2)
    pos = data[idx][:, sm.POS]
    time = data[idx][:, sm.INIT_TIME]
    # sort the NODES by time here (max_nodes elements, trivial) instead of
    # requiring the map rows to be globally time-ordered: `_blend_weights`
    # searchsorts node times, and sorting 512 nodes per graph build is free
    # while re-sorting a 32M-row map after every merge is not
    time = jnp.where(ok, time, jnp.inf)  # invalid nodes sort last
    order = jnp.argsort(time)
    pos, time, ok = pos[order], time[order], ok[order]
    eye = jnp.broadcast_to(jnp.eye(3, dtype=jnp.float32), (max_nodes, 3, 3))
    return DeformGraph(
        pos=jnp.where(ok[:, None], pos, 0.0),
        time=time,
        valid=ok,
        A=eye,
        t=jnp.zeros((max_nodes, 3), jnp.float32),
    )


def _blend_weights(
    graph: DeformGraph, points: jnp.ndarray, times: jnp.ndarray
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """k-NN blending weights over the temporal look-back window.

    Returns (indices [P, k], weights [P, k]); weights are zero where the graph
    has no valid support.  Mirrors `DeformationGraph.cpp:133-250` /
    `copy_unstable.vert:150-320`: binary search into the time-sorted node
    array, look back LOOKBACK nodes, weight the k nearest by
    (1 - d/dmax)^2, normalised."""
    P = points.shape[0]
    n_valid = jnp.sum(graph.valid.astype(jnp.int32))
    # insertion point of each point's timestamp in the node time sequence
    ins = jnp.searchsorted(graph.time, times, side="right")
    # candidate window [ins - LOOKBACK, ins) clamped into the valid range;
    # if the window would be empty (early times) look forward instead
    start = jnp.clip(ins - LOOKBACK, 0, jnp.maximum(n_valid - LOOKBACK, 0))
    offs = jnp.arange(LOOKBACK)
    cand = start[:, None] + offs[None, :]  # [P, LOOKBACK]
    cand = jnp.clip(cand, 0, graph.n_nodes - 1)
    cand_ok = (cand < n_valid) & graph.valid[cand]
    g = graph.pos[cand]  # [P, L, 3]
    d = jnp.linalg.norm(g - points[:, None, :], axis=-1)
    d = jnp.where(cand_ok, d, jnp.inf)
    # k+1 nearest for the dmax normaliser (Sumner's weights)
    neg, top_idx = jax.lax.top_k(-d, K_NEIGHBOURS + 1)
    dk = -neg  # [P, k+1] ascending distances
    dmax = jnp.maximum(dk[:, -1:], 1e-6)
    w = jnp.square(1.0 - dk[:, :-1] / dmax)
    w = jnp.where(jnp.isfinite(dk[:, :-1]), w, 0.0)
    wsum = jnp.sum(w, axis=-1, keepdims=True)
    has = wsum[:, 0] > 1e-9
    w = jnp.where(has[:, None], w / jnp.maximum(wsum, 1e-9), 0.0)
    nn = jnp.take_along_axis(cand, top_idx[:, :-1], axis=1)
    return nn, w


def deform_points(
    graph: DeformGraph,
    points: jnp.ndarray,
    times: jnp.ndarray,
    normals: jnp.ndarray | None = None,
):
    """phi(p) = sum_k w_k [A_k (p - g_k) + g_k + t_k]; points with no valid
    support pass through unchanged.  Optionally co-rotates normals.

    Evaluated as ``phi(p) = (sum_k w_k A_k) p + sum_k w_k c_k`` with the
    per-node constant ``c_k = g_k + t_k - A_k g_k``: each point gathers its k
    blending nodes' rows from two small per-node tables."""
    nn, w = _blend_weights(graph, points, times)
    A_blend = jnp.einsum("pk,pkij->pij", w, graph.A[nn])
    c = graph.pos + graph.t - jnp.einsum("kij,kj->ki", graph.A, graph.pos)
    b = jnp.einsum("pk,pki->pi", w, c[nn])
    out = jnp.einsum("pij,pj->pi", A_blend, points) + b
    has = jnp.sum(w, axis=-1) > 1e-9
    out = jnp.where(has[:, None], out, points)
    if normals is None:
        return out
    n_out = jnp.einsum("pij,pj->pi", A_blend, normals)
    n_out = n_out / jnp.maximum(jnp.linalg.norm(n_out, axis=-1, keepdims=True), 1e-9)
    n_out = jnp.where(has[:, None], n_out, normals)
    return out, n_out


def deform_rows(
    graph: DeformGraph, rows: jnp.ndarray, row0: jnp.ndarray, count: jnp.ndarray
) -> jnp.ndarray:
    """Deform the position and normal of every live surfel in a block of map
    rows [R, COLS] whose first row is map row `row0`; rows at or beyond
    `count`, or with zero confidence, pass through unchanged.  The one
    per-row function behind `apply_to_map` and the map-sharded apply
    (`parallel.map_shard`)."""
    pts = rows[:, sm.POS]
    nrm = rows[:, sm.NORMAL]
    idx = row0 + jnp.arange(rows.shape[0])
    alive = ((rows[:, sm.CONF] > 0) & (idx < count))[:, None]
    new_p, new_n = deform_points(graph, pts, rows[:, sm.INIT_TIME], nrm)
    rows = rows.at[:, sm.POS].set(jnp.where(alive, new_p, pts))
    return rows.at[:, sm.NORMAL].set(jnp.where(alive, new_n, nrm))


def _energy_residuals(
    params: Tuple[jnp.ndarray, jnp.ndarray],
    graph: DeformGraph,
    cons: Constraint,
    frozen: jnp.ndarray,
    rel: RelConstraint | None = None,
):
    """All energy residual blocks, flattened (reference `sparseJacobian` row
    structure: 6 rot rows + 3*k reg rows per node + 3 rows per constraint)."""
    A, t = params
    K = graph.n_nodes
    vmask = graph.valid.astype(jnp.float32)

    # E_rot: orthonormality of each node's affine (6 upper-tri rows/node)
    AtA = jnp.einsum("kji,kjl->kil", A, A)
    eye = jnp.eye(3, dtype=jnp.float32)
    diff = AtA - eye
    iu, ju = jnp.triu_indices(3)
    r_rot = diff[:, iu, ju] * vmask[:, None]  # [K, 6]

    # E_reg: sequential k-neighbourhood smoothness (3 rows per edge)
    offsets = jnp.array([-2, -1, 1, 2])
    nb = jnp.clip(jnp.arange(K)[:, None] + offsets[None, :], 0, K - 1)  # [K,4]
    edge_ok = (
        vmask[:, None]
        * graph.valid[nb].astype(jnp.float32)
        * (nb != jnp.arange(K)[:, None]).astype(jnp.float32)
    )
    g_j = graph.pos[:, None, :]  # [K,1,3]
    g_k = graph.pos[nb]  # [K,4,3]
    # E_reg = A_j (g_k - g_j) + g_j + t_j - (g_k + t_k)
    pred = jnp.einsum("kij,knj->kni", A, g_k - g_j) + g_j + t[:, None, :]
    r_reg = (pred - (g_k + t[nb])) * edge_ok[..., None]

    # E_con: point constraints through the blend (3 rows each)
    gtmp = graph._replace(A=A, t=t)
    moved = deform_points(gtmp, cons.src, cons.time)
    r_con = (moved - cons.dst) * cons.valid.astype(jnp.float32)[:, None]

    # freeze old nodes (reference `enabled` flag: nodes older than
    # lastDeformTime don't move) — huge penalty rows on their parameters
    fr = frozen.astype(jnp.float32)
    r_frozen_t = t * fr[:, None] * 10.0
    r_frozen_A = (A - eye).reshape(K, 9) * fr[:, None] * 10.0

    blocks = [
        jnp.sqrt(W_ROT) * r_rot.reshape(-1),
        jnp.sqrt(W_REG) * r_reg.reshape(-1),
        jnp.sqrt(W_CON) * r_con.reshape(-1),
        jnp.sqrt(W_CON) * r_frozen_t.reshape(-1),
        jnp.sqrt(W_ROT) * r_frozen_A.reshape(-1),
    ]
    if rel is not None:
        # relative rows: phi(src) - phi(dst), both endpoints deformable
        # (reference `DeformationGraph.cpp:922-931`, same sqrt(wCon) weight)
        moved_s = deform_points(gtmp, rel.src, rel.src_time)
        moved_d = deform_points(gtmp, rel.dst, rel.dst_time)
        r_rel = (moved_s - moved_d) * rel.valid.astype(jnp.float32)[:, None]
        blocks.append(jnp.sqrt(W_CON) * r_rel.reshape(-1))
    return jnp.concatenate(blocks)


class OptimiseStats(NamedTuple):
    initial_error: jnp.ndarray
    final_error: jnp.ndarray
    mean_cons_error: jnp.ndarray  # mean 2-norm of constraint residuals


@functools.partial(jax.jit, static_argnames=("iters", "cg_iters"))
def optimise(
    graph: DeformGraph,
    cons: Constraint,
    frozen: jnp.ndarray | None = None,
    iters: int = GN_ITERS,
    cg_iters: int = CG_ITERS,
    rel: RelConstraint | None = None,
) -> Tuple[DeformGraph, OptimiseStats]:
    """Gauss-Newton with matrix-free CG on the normal equations
    (reference `optimiseGraphSparse`, `DeformationGraph.cpp:457-535`:
    <=3 GN iterations, CHOLMOD solve, frozen old nodes).  `rel` carries
    relative constraints from previous accepted deformations."""
    if frozen is None:
        frozen = jnp.zeros((graph.n_nodes,), bool)

    def residual_fn(params):
        return _energy_residuals(params, graph, cons, frozen, rel)

    def total_err(params):
        r = residual_fn(params)
        return jnp.sum(r * r)

    def cons_err(params):
        A, t = params
        g = graph._replace(A=A, t=t)
        moved = deform_points(g, cons.src, cons.time)
        d = jnp.linalg.norm(moved - cons.dst, axis=-1) * cons.valid
        return jnp.sum(d) / jnp.maximum(jnp.sum(cons.valid), 1.0)

    params0 = (graph.A, graph.t)
    e0 = total_err(params0)

    def gn_step(_, params):
        r0, pullback = jax.vjp(residual_fn, params)
        g = pullback(r0)[0]  # J^T r

        def JtJv(v):
            _, jv = jax.jvp(residual_fn, (params,), (v,))
            jtjv = pullback(jv)[0]
            return jax.tree.map(
                lambda a, b: a + DAMPING * b, jtjv, v
            )

        neg_g = jax.tree.map(lambda x: -x, g)
        dx, _ = jax.scipy.sparse.linalg.cg(JtJv, neg_g, maxiter=cg_iters)
        # backtracking step control: full GN steps can overshoot on the
        # nonlinear rotation terms; pick the best of {1, 1/2, 1/4} and keep
        # the current params if none improves (the reference rolls back
        # diverging iterations the same way)
        e_cur = total_err(params)
        best = params
        e_best = e_cur
        for alpha in (1.0, 0.5, 0.25):
            cand = jax.tree.map(lambda p, d: p + alpha * d, params, dx)
            e_cand = total_err(cand)
            take = e_cand < e_best
            best = jax.tree.map(lambda c, b: jnp.where(take, c, b), cand, best)
            e_best = jnp.minimum(e_cand, e_best)
        return best

    params = jax.lax.fori_loop(0, iters, gn_step, params0)
    e1 = total_err(params)
    ce = cons_err(params)
    out = graph._replace(A=params[0], t=params[1])
    return out, OptimiseStats(initial_error=e0, final_error=e1, mean_cons_error=ce)


# rows per `apply_to_map` block: bounds the per-row transients ([rows, 20]
# candidate distances and their indices, ~160 MB) at any map capacity.  On
# an H100 a 4M-row apply takes 8.4 ms in 2^20-row blocks and 14.0 ms in
# 2^16-row ones (more, shorter loop steps); unchunked is no faster.
APPLY_CHUNK = 1 << 20


@functools.partial(jax.jit, donate_argnames=("data",))
def apply_to_map(data: jnp.ndarray, count: jnp.ndarray, graph: DeformGraph) -> jnp.ndarray:
    """Deform every live surfel's position+normal (the GPU half of the
    reference's pipeline: `copy_unstable.vert:150-320` applies the serialised
    rawGraph to all map surfels during clean).

    Walks the map in `APPLY_CHUNK`-row blocks through `deform_rows`, with a
    static partial tail block, so any capacity stays chunked."""
    N = data.shape[0] - 1
    if N <= APPLY_CHUNK:
        return data.at[:-1].set(deform_rows(graph, data[:-1], jnp.int32(0), count))

    def body(i, d):
        start = i * APPLY_CHUNK
        blk = jax.lax.dynamic_slice(d, (start, 0), (APPLY_CHUNK, sm.COLS))
        blk = deform_rows(graph, blk, start, count)
        return jax.lax.dynamic_update_slice(d, blk, (start, 0))

    data = jax.lax.fori_loop(0, N // APPLY_CHUNK, body, data)
    rem = N % APPLY_CHUNK
    if rem:
        start = (N // APPLY_CHUNK) * APPLY_CHUNK
        blk = jax.lax.dynamic_slice(data, (start, 0), (rem, sm.COLS))
        blk = deform_rows(graph, blk, jnp.int32(start), count)
        data = jax.lax.dynamic_update_slice(data, blk, (start, 0))
    return data


def empty_graph(max_nodes: int) -> DeformGraph:
    """An all-invalid graph: `deform_points`/`apply_to_pose*` pass everything
    through unchanged.  Used as the no-op branch value in jitted loop-closure
    programs so the optimised graph can be hoisted out through `lax.cond`."""
    return DeformGraph(
        pos=jnp.zeros((max_nodes, 3), jnp.float32),
        time=jnp.full((max_nodes,), jnp.inf, jnp.float32),
        valid=jnp.zeros((max_nodes,), bool),
        A=jnp.broadcast_to(jnp.eye(3, dtype=jnp.float32), (max_nodes, 3, 3)),
        t=jnp.zeros((max_nodes, 3), jnp.float32),
    )


def apply_to_pose(graph: DeformGraph, pose: jnp.ndarray, time: jnp.ndarray) -> jnp.ndarray:
    """Deform a camera pose (reference `applyGraphToPoses`,
    `DeformationGraph.cpp:102-131`): translate the position through phi and
    blend the node rotations, re-orthonormalised by SVD."""
    p = pose[:3, 3][None]
    t_arr = jnp.asarray(time, jnp.float32)[None]
    nn, w = _blend_weights(graph, p, t_arr)
    A_blend = jnp.sum(w[0][:, None, None] * graph.A[nn[0]], axis=0)
    has = jnp.sum(w) > 1e-9
    new_p = deform_points(graph, p, t_arr)[0]
    R_new = se3.orthonormalise(A_blend @ pose[:3, :3])
    out = pose.at[:3, 3].set(jnp.where(has, new_p, pose[:3, 3]))
    out = out.at[:3, :3].set(jnp.where(has, R_new, pose[:3, :3]))
    return out


@jax.jit
def apply_to_poses(
    graph: DeformGraph, poses: jnp.ndarray, times: jnp.ndarray
) -> jnp.ndarray:
    """Deform a whole pose history [K,4,4] with per-pose timestamps [K]
    (reference `applyGraphToPoses`, `DeformationGraph.cpp:102-131`, called
    on the fern poses AND the full per-context pose graph from
    `Deformation::constrain`, `Deformation.cpp:106-124,167` — this is what
    makes accepted loop closures correct the *exported trajectory*, not just
    the current pose)."""
    return jax.vmap(apply_to_pose, in_axes=(None, 0, 0))(
        graph, poses, times.astype(jnp.float32)
    )
