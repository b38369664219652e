"""Distributed pose-graph optimisation and Schur-complement bundle adjustment.

The reference has no global BA of its own (it defers to ORB-SLAM3 and to the
deformation graph); this rebuild makes distributed BA/pose-graph solves a
first-class component: keyframes and landmark blocks sharded across
devices, normal equations reduced with `psum` over the mesh, the
small camera system solved replicated (BASELINE "distributed bundle
adjustment and pose-graph solves done via Schur-complement reduction over
psum/all-gather collectives").

Two solvers:

- **Pose graph** (`optimise_pose_graph` / `make_distributed_pgo`): keyframe
  poses + relative SE(3) edges (odometry + loop closures).  Gauss-Newton with
  matrix-free conjugate gradient: ``(JtJ + lambda I) v`` is computed as
  ``vjp(jvp(residual))`` through the batched edge residual
  ``r_e = log(Z_e^-1 T_i^-1 T_j)`` — no materialised Jacobian.  In the
  distributed variant the edge set is sharded over the mesh and every inner
  product carries a `psum`; JAX differentiates through the collective.
  Gauge freedom is fixed by pinning pose 0.

- **Bundle adjustment** (`bundle_adjust`): cameras + 3D points + pixel
  observations.  The landmark block-diagonal is inverted pointwise and the
  camera system is formed by the Schur complement ``S = U - W V^-1 W^T``;
  points (and their observations) are sharded across devices, each shard
  contributing a partial (S, b) that is `psum`-reduced before the replicated
  6K x 6K solve, then landmarks are back-substituted shard-locally.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from densemonoslam_tpu.config import CameraIntrinsics
from densemonoslam_tpu.utils import se3

PGO_DAMPING = 1e-6
PGO_GN_ITERS = 8
PGO_CG_ITERS = 64


class PoseGraphEdges(NamedTuple):
    i: jnp.ndarray  # [E] i32 source keyframe
    j: jnp.ndarray  # [E] i32 target keyframe
    Z: jnp.ndarray  # [E, 4, 4] measured T_i^-1 T_j
    weight: jnp.ndarray  # [E]


def _apply_xi(poses: jnp.ndarray, xi: jnp.ndarray) -> jnp.ndarray:
    """Right-perturb every pose: T_k <- T_k @ exp(xi_k)."""
    return jnp.einsum("kij,kjl->kil", poses, jax.vmap(se3.se3_exp)(xi))


def _edge_residuals(
    xi: jnp.ndarray, poses: jnp.ndarray, edges: PoseGraphEdges
) -> jnp.ndarray:
    T = _apply_xi(poses, xi)
    Ti = T[edges.i]
    Tj = T[edges.j]
    Zinv = jax.vmap(se3.se3_inverse)(edges.Z)
    Tii = jax.vmap(se3.se3_inverse)(Ti)
    rel = jnp.einsum("eij,ejk,ekl->eil", Zinv, Tii, Tj)
    r = jax.vmap(se3.se3_log)(rel)  # [E, 6]
    # gauge: pin pose 0 with a strong prior row block
    anchor = xi[0] * 100.0
    return jnp.concatenate([(r * edges.weight[:, None]).reshape(-1), anchor])


@functools.partial(jax.jit, static_argnames=("iters", "cg_iters"))
def optimise_pose_graph(
    poses: jnp.ndarray,  # [K, 4, 4]
    edges: PoseGraphEdges,
    iters: int = PGO_GN_ITERS,
    cg_iters: int = PGO_CG_ITERS,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Single-device pose-graph GN.  Returns (poses, final_error)."""
    K = poses.shape[0]

    def gn(_, carry):
        poses_c, _err = carry
        xi0 = jnp.zeros((K, 6), jnp.float32)

        def res(xi):
            return _edge_residuals(xi, poses_c, edges)

        r0, pullback = jax.vjp(res, xi0)
        g = pullback(r0)[0]

        def JtJv(v):
            _, jv = jax.jvp(res, (xi0,), (v,))
            return pullback(jv)[0] + PGO_DAMPING * v

        dx, _ = jax.scipy.sparse.linalg.cg(JtJv, -g, maxiter=cg_iters)
        cand = _apply_xi(poses_c, dx)
        e_new = jnp.sum(jnp.square(_edge_residuals(jnp.zeros_like(xi0), cand, edges)))
        e_old = jnp.sum(r0 * r0)
        better = e_new < e_old
        poses_n = jnp.where(better, cand, poses_c)
        return poses_n, jnp.minimum(e_new, e_old)

    e0 = jnp.sum(
        jnp.square(_edge_residuals(jnp.zeros((K, 6), jnp.float32), poses, edges))
    )
    return jax.lax.fori_loop(0, iters, gn, (poses, e0))


def make_distributed_pgo(mesh: Mesh, iters: int = PGO_GN_ITERS, cg_iters: int = PGO_CG_ITERS):
    """Edge-sharded pose-graph GN: poses replicated, edges split over the
    `cam` mesh axis, normal-equation products psum-reduced over the mesh."""

    def local(poses, ei, ej, Z, w):
        edges = PoseGraphEdges(i=ei, j=ej, Z=Z, weight=w)
        K = poses.shape[0]

        def res(xi, poses_c):
            # local edge residuals only (anchor handled via damping on dev 0)
            T = _apply_xi(poses_c, xi)
            Zinv = jax.vmap(se3.se3_inverse)(Z)
            Tii = jax.vmap(se3.se3_inverse)(T[ei])
            rel = jnp.einsum("eij,ejk,ekl->eil", Zinv, Tii, T[ej])
            return jax.vmap(se3.se3_log)(rel) * w[:, None]

        def gn(_, carry):
            poses_c, _e = carry
            xi0 = jnp.zeros((K, 6), jnp.float32)
            r0, pullback = jax.vjp(lambda x: res(x, poses_c), xi0)
            g = jax.lax.psum(pullback(r0)[0], "cam")
            g = g.at[0].add(100.0 * 100.0 * xi0[0])  # anchor grad (zero at xi=0)

            def JtJv(v):
                _, jv = jax.jvp(lambda x: res(x, poses_c), (xi0,), (v,))
                out = jax.lax.psum(pullback(jv)[0], "cam")
                out = out.at[0].add(100.0 * 100.0 * v[0])  # anchor JtJ block
                return out + PGO_DAMPING * v

            dx, _ = jax.scipy.sparse.linalg.cg(JtJv, -g, maxiter=cg_iters)
            cand = _apply_xi(poses_c, dx)
            e_new = jax.lax.psum(
                jnp.sum(jnp.square(res(jnp.zeros_like(xi0), cand))), "cam"
            )
            e_old = jax.lax.psum(jnp.sum(r0 * r0), "cam")
            better = e_new < e_old
            return jnp.where(better, cand, poses_c), jnp.minimum(e_new, e_old)

        e0 = jax.lax.psum(
            jnp.sum(jnp.square(res(jnp.zeros((K, 6), jnp.float32), poses))), "cam"
        )
        out_poses, err = jax.lax.fori_loop(0, iters, gn, (poses, e0))
        return out_poses, err

    sharded = shard_map(
        local,
        mesh=mesh,
        in_specs=(P(), P("cam"), P("cam"), P("cam"), P("cam")),
        out_specs=(P(), P()),
        check_vma=False,
    )

    @jax.jit
    def run(poses, edges: PoseGraphEdges):
        return sharded(poses, edges.i, edges.j, edges.Z, edges.weight)

    return run


# ---------------------------------------------------------------------------
# Schur-complement bundle adjustment
# ---------------------------------------------------------------------------


class BAProblem(NamedTuple):
    poses: jnp.ndarray  # [K, 4, 4] camera-to-world
    points: jnp.ndarray  # [P, 3] world
    cam_idx: jnp.ndarray  # [O] i32
    pnt_idx: jnp.ndarray  # [O] i32
    uv: jnp.ndarray  # [O, 2] observed pixels
    valid: jnp.ndarray  # [O] bool
    # optional per-observation measured depth (metres; 0 = no measurement).
    # When present, each observation adds a depth residual in pixel-
    # equivalent units (fx/z-weighted) — RGB-D BA: scale and the along-ray
    # landmark direction become directly observable, which pure reprojection
    # BA cannot see under forward motion (the KITTI degeneracy).
    z: jnp.ndarray | None = None


def _project(pose, X, intr: CameraIntrinsics):
    Tinv = se3.se3_inverse(pose)
    p = Tinv[:3, :3] @ X + Tinv[:3, 3]
    z = jnp.maximum(p[2], 1e-6)
    return jnp.array([p[0] / z * intr.fx + intr.cx, p[1] / z * intr.fy + intr.cy]), p


def _ba_blocks(poses, points, cam_idx, pnt_idx, uv, valid, intr, z_obs=None):
    """Per-observation residuals + Jacobians wrt camera twist (right
    perturbation) and point position.  Returns (r [O,R], Jc [O,R,6],
    Jp [O,R,3]) with R=2 (reprojection) or 3 (+ fx/z-weighted depth when
    `z_obs` is given)."""

    use_z = z_obs is not None
    if not use_z:
        z_obs = jnp.zeros(cam_idx.shape, jnp.float32)

    def one(ci, pi, obs_uv, ok, zo):
        pose = poses[ci]
        X = points[pi]
        has_z = (zo > 0).astype(jnp.float32)
        wz = intr.fx / jnp.maximum(zo, 0.5)  # metres -> pixel-equivalent

        def res(xi, dX):
            proj, p = _project(pose @ se3.se3_exp(xi), X + dX, intr)
            r_uv = proj - obs_uv
            if use_z:
                rz = (p[2] - zo) * wz * has_z
                return jnp.concatenate([r_uv, rz[None]])
            return r_uv

        def res_c(xi):
            return res(xi, jnp.zeros(3))

        def res_p(dX):
            return res(jnp.zeros(6), dX)

        r = res_c(jnp.zeros(6))
        Jc = jax.jacfwd(res_c)(jnp.zeros(6))
        Jp = jax.jacfwd(res_p)(jnp.zeros(3))
        m = ok.astype(jnp.float32)
        return r * m, Jc * m, Jp * m

    return jax.vmap(one)(cam_idx, pnt_idx, uv, valid, z_obs)


@functools.partial(jax.jit, static_argnames=("intr",))
def reproj_errors(problem: BAProblem, intr: CameraIntrinsics) -> jnp.ndarray:
    """[O] per-observation reprojection error (px) at the current estimate —
    used to gate outlier matches out of a BA problem before solving."""
    r, _, _ = _ba_blocks(
        problem.poses, problem.points, problem.cam_idx, problem.pnt_idx,
        problem.uv, problem.valid, intr, z_obs=problem.z,
    )
    return jnp.linalg.norm(r, axis=-1)


def _schur_reduce(r, Jc, Jp, cam_idx, pnt_idx, K, Pn, damping):
    """Form the Schur-complement camera system from per-observation blocks.

    V (per-point 3x3) and W-products are accumulated with segment scatters;
    the [6K, 6K] S and [6K] b come from per-point outer products through a
    one-hot camera incidence (one einsum)."""
    # per-point V and b_p
    V = jnp.zeros((Pn, 3, 3)).at[pnt_idx].add(
        jnp.einsum("oij,oik->ojk", Jp, Jp)
    ) + damping * jnp.eye(3)
    b_p = jnp.zeros((Pn, 3)).at[pnt_idx].add(jnp.einsum("oij,oi->oj", Jp, r))
    Vinv = jnp.linalg.inv(V)

    # per-point stacked camera coupling G_p [P, K6, 3] via one-hot cameras
    onehot = jax.nn.one_hot(cam_idx, K, dtype=jnp.float32)  # [O, K]
    JcT_Jp = jnp.einsum("oij,oik->ojk", Jc, Jp)  # [O, 6, 3]
    G = jnp.zeros((Pn, K, 6, 3)).at[pnt_idx].add(
        jnp.einsum("ok,ojl->okjl", onehot, JcT_Jp)
    )
    # U and b_c
    U = jnp.einsum("ok,oij,oil,om->kjml", onehot, Jc, Jc, onehot)  # [K,6,K,6]
    b_c = jnp.zeros((K, 6)).at[cam_idx].add(jnp.einsum("oij,oi->oj", Jc, r))
    # S = U - G Vinv G^T  (block form)
    GV = jnp.einsum("pkjl,plm->pkjm", G, Vinv)
    S_red = jnp.einsum("pkjm,pnim->kjni", GV, G)  # [K,6,K,6]
    S = (U - S_red).reshape(K * 6, K * 6)
    b_red = jnp.einsum("pkjm,pm->kj", GV, b_p)
    b = (b_c - b_red).reshape(K * 6)
    return S, b, Vinv, b_p, G


@functools.partial(
    jax.jit, static_argnames=("intr", "iters", "fix_cameras", "huber", "pregate_px")
)
def bundle_adjust(
    problem: BAProblem,
    intr: CameraIntrinsics,
    iters: int = 5,
    damping: float = 1e-4,
    fix_cameras: int = 1,
    huber: float = 0.0,
    pregate_px: float = 0.0,
) -> Tuple[BAProblem, jnp.ndarray]:
    """Single-device Schur-complement BA.  Returns (problem, mean px error).

    `fix_cameras` pins the first N camera blocks: 1 fixes the 6-DoF gauge;
    projective-only problems (no depth) need 2 to also fix scale.
    `huber` > 0 applies a Huber IRLS weight (px) to each observation —
    required with real feature matches, whose outliers otherwise send the
    quadratic solve off a cliff.
    `pregate_px` > 0 invalidates observations whose error at the INITIAL
    estimate exceeds the gate (wrong matches propagated through track
    chains) — inside the jit, so callers need no extra device round trip."""
    K = problem.poses.shape[0]
    Pn = problem.points.shape[0]
    if pregate_px > 0:
        errs0 = reproj_errors(problem, intr)
        problem = problem._replace(valid=problem.valid & (errs0 < pregate_px))

    def gn(_, carry):
        poses, points = carry
        r, Jc, Jp = _ba_blocks(
            poses, points, problem.cam_idx, problem.pnt_idx, problem.uv,
            problem.valid, intr, z_obs=problem.z,
        )
        if huber > 0:
            w = jnp.sqrt(
                jnp.minimum(
                    1.0,
                    huber
                    / jnp.maximum(jnp.linalg.norm(r, axis=-1), 1e-9),
                )
            )
            r = r * w[:, None]
            Jc = Jc * w[:, None, None]
            Jp = Jp * w[:, None, None]
        S, b, Vinv, b_p, G = _schur_reduce(
            r, Jc, Jp, problem.cam_idx, problem.pnt_idx, K, Pn, damping
        )
        S = S + damping * jnp.eye(K * 6)
        if fix_cameras > 0:
            pin = jnp.zeros((K * 6,)).at[: 6 * fix_cameras].set(1e6)
            S = S + jnp.diag(pin)
        dx = jnp.linalg.solve(S, -b).reshape(K, 6)
        poses_n = _apply_xi(poses, dx)
        # back-substitute landmarks: dX = -Vinv (b_p + G^T dx)
        Gt_dx = jnp.einsum("pkjm,kj->pm", G, dx)
        dX = -jnp.einsum("pij,pj->pi", Vinv, b_p + Gt_dx)
        points_n = points + dX
        return poses_n, points_n

    poses, points = jax.lax.fori_loop(
        0, iters, gn, (problem.poses, problem.points)
    )
    r, _, _ = _ba_blocks(
        poses, points, problem.cam_idx, problem.pnt_idx, problem.uv,
        problem.valid, intr, z_obs=problem.z,
    )
    n = jnp.maximum(jnp.sum(problem.valid), 1)
    err = jnp.sum(jnp.linalg.norm(r, axis=-1)) / n
    return problem._replace(poses=poses, points=points), err


def make_distributed_ba(
    mesh: Mesh, intr: CameraIntrinsics, iters: int = 5, damping: float = 1e-4,
    fix_cameras: int = 1, huber: float = 0.0, pregate_px: float = 0.0,
):
    """Landmark-sharded Schur BA: points + their observations are split over
    the `cam` mesh axis (each shard owns a point block and ALL observations of
    those points — sort observations by point id before sharding, e.g. with
    `shard_ba_problem`); each shard forms its partial (S, b), `psum` reduces
    them over the mesh, every device solves the replicated camera system, and
    landmarks back-substitute locally.  This is BASELINE's
    Schur-complement-over-collectives recipe.

    `huber`/`pregate_px` match `bundle_adjust`'s robustness options so the
    distributed solve is a drop-in for the sparse tracker's RGB-D local BA
    (z residuals via the `z` input; pass zeros for pure reprojection BA).
    """

    def local(poses, points, cam_idx, pnt_idx_local, uv, valid, z):
        K = poses.shape[0]
        Pl = points.shape[0]

        if pregate_px > 0:
            # outlier pregate at the INITIAL estimate, shard-local (each
            # shard owns its observations outright)
            r0, _, _ = _ba_blocks(
                poses, points, cam_idx, pnt_idx_local, uv, valid, intr,
                z_obs=z,
            )
            valid = valid & (jnp.linalg.norm(r0, axis=-1) < pregate_px)

        def gn(_, carry):
            poses_c, pts = carry
            r, Jc, Jp = _ba_blocks(
                poses_c, pts, cam_idx, pnt_idx_local, uv, valid, intr,
                z_obs=z,
            )
            if huber > 0:
                w = jnp.sqrt(
                    jnp.minimum(
                        1.0,
                        huber
                        / jnp.maximum(jnp.linalg.norm(r, axis=-1), 1e-9),
                    )
                )
                r = r * w[:, None]
                Jc = Jc * w[:, None, None]
                Jp = Jp * w[:, None, None]
            S, b, Vinv, b_p, G = _schur_reduce(
                r, Jc, Jp, cam_idx, pnt_idx_local, K, Pl, damping
            )
            S = jax.lax.psum(S, "cam")
            b = jax.lax.psum(b, "cam")
            S = S + damping * jnp.eye(K * 6)
            S = S + jnp.diag(
                jnp.zeros((K * 6,)).at[: 6 * fix_cameras].set(1e6)
            )
            dx = jnp.linalg.solve(S, -b).reshape(K, 6)
            poses_n = _apply_xi(poses_c, dx)
            Gt_dx = jnp.einsum("pkjm,kj->pm", G, dx)
            dX = -jnp.einsum("pij,pj->pi", Vinv, b_p + Gt_dx)
            return poses_n, pts + dX

        poses_o, pts_o = jax.lax.fori_loop(0, iters, gn, (poses, points))
        r, _, _ = _ba_blocks(
            poses_o, pts_o, cam_idx, pnt_idx_local, uv, valid, intr, z_obs=z
        )
        err = jax.lax.psum(jnp.sum(jnp.linalg.norm(r, axis=-1)), "cam")
        n = jax.lax.psum(jnp.sum(valid), "cam")
        return poses_o, pts_o, err / jnp.maximum(n, 1)

    sharded = shard_map(
        local,
        mesh=mesh,
        in_specs=(P(), P("cam"), P("cam"), P("cam"), P("cam"), P("cam"), P("cam")),
        out_specs=(P(), P("cam"), P()),
        check_vma=False,
    )

    @jax.jit
    def run(poses, points, cam_idx, pnt_idx_local, uv, valid, z):
        return sharded(poses, points, cam_idx, pnt_idx_local, uv, valid, z)

    return run


def shard_ba_problem(problem: BAProblem, n_shards: int, obs_align: int = 256):
    """Host-side data layout for `make_distributed_ba`: sort observations by
    point id, pad the point set to a multiple of `n_shards`, give every shard
    an equal observation slab covering exactly its point block (local point
    indices), padding to a common per-shard count rounded up to `obs_align`
    so jit recompiles stay logarithmic in the window size.

    Returns (points_padded [P', 3], cam_idx, pnt_idx_local, uv, valid, z)
    flattened shard-major, plus P' — feed straight into the distributed run;
    refined points come back in the same padded/blocked order (the tracker
    only consumes the replicated poses)."""
    import numpy as np

    Pn = problem.points.shape[0]
    Pp = ((Pn + n_shards - 1) // n_shards) * n_shards
    per = Pp // n_shards
    points = np.zeros((Pp, 3), np.float32)
    points[:Pn] = np.asarray(problem.points)

    order = np.argsort(np.asarray(problem.pnt_idx), kind="stable")
    cam_s = np.asarray(problem.cam_idx)[order]
    pnt_s = np.asarray(problem.pnt_idx)[order]
    uv_s = np.asarray(problem.uv)[order]
    val_s = np.asarray(problem.valid)[order]
    z_all = (
        np.asarray(problem.z)
        if problem.z is not None
        else np.zeros((order.shape[0],), np.float32)
    )
    z_s = z_all[order]

    counts = [
        int(((pnt_s >= s * per) & (pnt_s < (s + 1) * per) & val_s).sum())
        for s in range(n_shards)
    ]
    o_max = max(max(counts), 1)
    o_max = ((o_max + obs_align - 1) // obs_align) * obs_align
    cam_pad = np.zeros((n_shards, o_max), np.int32)
    pnt_pad = np.zeros((n_shards, o_max), np.int32)
    uv_pad = np.zeros((n_shards, o_max, 2), np.float32)
    val_pad = np.zeros((n_shards, o_max), bool)
    z_pad = np.zeros((n_shards, o_max), np.float32)
    for s in range(n_shards):
        sel = (pnt_s >= s * per) & (pnt_s < (s + 1) * per) & val_s
        n = int(sel.sum())
        cam_pad[s, :n] = cam_s[sel]
        pnt_pad[s, :n] = pnt_s[sel] - s * per
        uv_pad[s, :n] = uv_s[sel]
        val_pad[s, :n] = True
        z_pad[s, :n] = z_s[sel]
    return (
        jnp.asarray(points),
        jnp.asarray(cam_pad.reshape(-1)),
        jnp.asarray(pnt_pad.reshape(-1)),
        jnp.asarray(uv_pad.reshape(-1, 2)),
        jnp.asarray(val_pad.reshape(-1)),
        jnp.asarray(z_pad.reshape(-1)),
    )
