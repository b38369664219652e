"""Unit tests for the Gauss-Newton normal-equation builders: every Gram-matrix
JtJ/Jtb is checked against jax autodiff of the same (gate-frozen) residual —
the oracle strategy SURVEY §4 prescribes for the rebuild."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from densemonoslam_tpu.config import CameraIntrinsics
from densemonoslam_tpu.ops import geometry, reductions
from densemonoslam_tpu.utils import se3

INTR = CameraIntrinsics(80.0, 80.0, 39.5, 29.5)
H, W = 60, 80


def _make_scene(rng, A_true):
    """Model maps from a bumpy plane; current frame = the same plane observed
    through A_true^{-1} (so tracking back yields A_true)."""
    uu, vv = np.meshgrid(np.arange(W, dtype=np.float32), np.arange(H, dtype=np.float32))
    depth_m = 1.5 + 0.1 * np.sin(uu / 9.0) * np.cos(vv / 7.0)
    vmap_m = np.asarray(geometry.backproject(jnp.asarray(depth_m), INTR))
    nmap_m = np.asarray(geometry.normal_map(jnp.asarray(vmap_m)))
    # current cloud: transform model points into the current camera frame
    Ainv = np.asarray(se3.se3_inverse(jnp.asarray(A_true)))
    pts_c = (Ainv[:3, :3] @ vmap_m.reshape(-1, 3).T).T + Ainv[:3, 3]
    vmap_c = pts_c.reshape(H, W, 3).astype(np.float32)
    nmap_c = (Ainv[:3, :3] @ nmap_m.reshape(-1, 3).T).T.reshape(H, W, 3).astype(np.float32)
    return (
        jnp.asarray(vmap_c),
        jnp.asarray(nmap_c),
        jnp.asarray(vmap_m),
        jnp.asarray(nmap_m),
    )


def test_icp_gram_matches_autodiff(rng):
    A = jnp.eye(4, dtype=jnp.float32)
    A_true = se3.se3_exp(jnp.asarray([0.02, -0.01, 0.015, 0.01, 0.02, -0.015], jnp.float32))
    vmap_c, nmap_c, vmap_m, nmap_m = _make_scene(rng, A_true)

    M = reductions.icp_rows(vmap_c, nmap_c, vmap_m, nmap_m, A, INTR)
    G = reductions.gram(M)
    st = reductions.unpack_gram(G)

    # freeze association + gates at xi = 0, then autodiff the residual
    p0 = se3.transform_points(A, vmap_c.reshape(-1, 3))
    u, v, z = geometry.project(p0, INTR)
    ui = jnp.clip(jnp.round(u).astype(jnp.int32), 0, W - 1)
    vi = jnp.clip(jnp.round(v).astype(jnp.int32), 0, H - 1)
    v_m = vmap_m[vi, ui]
    n_m = nmap_m[vi, ui]
    mask = M[:, 7]  # reuse the builder's own gate output

    def residuals(xi):
        T = se3.se3_exp(xi) @ A
        p = se3.transform_points(T, vmap_c.reshape(-1, 3))
        return jnp.sum(n_m * (p - v_m), axis=-1) * mask

    J = jax.jacfwd(residuals)(jnp.zeros(6, jnp.float32))
    r0 = residuals(jnp.zeros(6, jnp.float32))
    JtJ_ref = J.T @ J
    Jtr_ref = J.T @ r0
    scale = float(jnp.max(jnp.abs(JtJ_ref))) + 1e-9
    np.testing.assert_allclose(np.asarray(st.JtJ), np.asarray(JtJ_ref), atol=2e-4 * scale)
    np.testing.assert_allclose(
        np.asarray(st.Jtr), np.asarray(Jtr_ref), atol=2e-4 * float(jnp.max(jnp.abs(Jtr_ref)) + 1e-9)
    )
    np.testing.assert_allclose(float(st.residual_sq), float(jnp.sum(r0 * r0)), rtol=1e-4)
    assert float(st.inliers) == float(jnp.sum(mask))


def test_icp_single_newton_step_recovers_small_motion(rng):
    """For a locally linear residual, one GN step should recover most of a
    small perturbation."""
    A_true = se3.se3_exp(jnp.asarray([0.01, -0.008, 0.006, 0.008, -0.005, 0.01], jnp.float32))
    vmap_c, nmap_c, vmap_m, nmap_m = _make_scene(rng, A_true)
    A = jnp.eye(4, dtype=jnp.float32)
    M = reductions.icp_rows(vmap_c, nmap_c, vmap_m, nmap_m, A, INTR)
    st = reductions.unpack_gram(reductions.gram(M))
    xi = reductions.solve_se3(st.JtJ, st.Jtr, damping=1e-10)
    A1 = se3.apply_update(A, xi)
    err0 = float(jnp.linalg.norm(se3.se3_log(se3.se3_inverse(A) @ A_true)))
    err1 = float(jnp.linalg.norm(se3.se3_log(se3.se3_inverse(A1) @ A_true)))
    assert err1 < 0.2 * err0


def _linear_image(a, b, c):
    uu, vv = np.meshgrid(np.arange(W, dtype=np.float32), np.arange(H, dtype=np.float32))
    return jnp.asarray(a * uu + b * vv + c)


def test_rgb_gram_matches_autodiff(rng):
    """With a globally linear model image, Sobel gradients equal the true
    bilinear-sampling gradient, so the builder's Gram must match autodiff of
    the warp residual."""
    A = jnp.eye(4, dtype=jnp.float32)
    depth = jnp.asarray(1.5 + 0.1 * rng.standard_normal((H, W)).astype(np.float32))
    vmap_c = geometry.backproject(depth, INTR)
    i_m = _linear_image(0.8, -0.5, 100.0)
    i_c = _linear_image(0.8, -0.5, 98.0)  # small photometric offset
    gx, gy = jnp.full((H, W), 0.8), jnp.full((H, W), -0.5)

    M = reductions.rgb_rows(vmap_c, i_c, i_m, gx, gy, A, INTR, min_grad=0.1)
    st = reductions.unpack_gram(reductions.gram(M))
    mask = M[:, 7]

    def residuals(xi):
        T = se3.se3_exp(xi) @ A
        p = se3.transform_points(T, vmap_c.reshape(-1, 3))
        u, v, _ = geometry.project(p, INTR)
        return (geometry.bilinear_sample(i_m, u, v) - i_c.reshape(-1)) * mask

    J = jax.jacfwd(residuals)(jnp.zeros(6, jnp.float32))
    r0 = residuals(jnp.zeros(6, jnp.float32))
    JtJ_ref = J.T @ J
    scale = float(jnp.max(jnp.abs(JtJ_ref))) + 1e-9
    np.testing.assert_allclose(np.asarray(st.JtJ), np.asarray(JtJ_ref), atol=3e-3 * scale)
    np.testing.assert_allclose(
        np.asarray(st.Jtr),
        np.asarray(J.T @ r0),
        atol=3e-3 * (float(jnp.max(jnp.abs(J.T @ r0))) + 1e-9),
    )


def test_so3_gram_matches_autodiff():
    R = jnp.eye(3, dtype=jnp.float32)
    i_m = _linear_image(0.6, 0.4, 90.0)
    i_c = _linear_image(0.6, 0.4, 92.0)
    gx, gy = jnp.full((H, W), 0.6), jnp.full((H, W), 0.4)
    M = reductions.so3_rows(i_c, i_m, gx, gy, R, INTR)
    G = reductions.gram(M)
    mask = M[:, 7]

    uu, vv = np.meshgrid(np.arange(W, dtype=np.float32), np.arange(H, dtype=np.float32))
    d = jnp.asarray(
        np.stack([(uu - INTR.cx) / INTR.fx, (vv - INTR.cy) / INTR.fy, np.ones_like(uu)], -1)
    ).reshape(-1, 3)

    def residuals(w):
        Rw = se3.so3_exp(w) @ R
        rd = jnp.einsum("ij,pj->pi", Rw, d)
        u, v, _ = geometry.project(rd, INTR)
        return (geometry.bilinear_sample(i_m, u, v) - i_c.reshape(-1)) * mask

    J = jax.jacfwd(residuals)(jnp.zeros(3, jnp.float32))
    r0 = residuals(jnp.zeros(3, jnp.float32))
    JtJ_ref = J.T @ J
    scale = float(jnp.max(jnp.abs(JtJ_ref))) + 1e-9
    np.testing.assert_allclose(np.asarray(G[:3, :3]), np.asarray(JtJ_ref), atol=3e-3 * scale)
    np.testing.assert_allclose(
        np.asarray(G[:3, 3]),
        np.asarray(J.T @ r0),
        atol=3e-3 * (float(jnp.max(jnp.abs(J.T @ r0))) + 1e-9),
    )


def test_icp_gates_reject_outliers(rng):
    """Corrupt a patch of the model with far geometry — the distance gate must
    exclude it from the system."""
    A_true = se3.se3_exp(jnp.asarray([0.01, 0.0, 0.0, 0.01, 0.0, 0.0], jnp.float32))
    vmap_c, nmap_c, vmap_m, nmap_m = _make_scene(rng, A_true)
    vmap_bad = vmap_m.at[10:30, 10:30, 2].add(5.0)
    A = jnp.eye(4, dtype=jnp.float32)
    M_good = reductions.icp_rows(vmap_c, nmap_c, vmap_m, nmap_m, A, INTR)
    M_bad = reductions.icp_rows(vmap_c, nmap_c, vmap_bad, nmap_m, A, INTR)
    inl_good = float(reductions.gram(M_good)[7, 7])
    inl_bad = float(reductions.gram(M_bad)[7, 7])
    assert inl_bad < inl_good - 300  # the corrupted patch dropped out
    xi = reductions.solve_se3(
        *(lambda s: (s.JtJ, s.Jtr))(reductions.unpack_gram(reductions.gram(M_bad))),
        damping=1e-10,
    )
    # solution still sane despite corruption
    assert float(jnp.linalg.norm(xi)) < 0.1


@pytest.mark.parametrize("P,C", [(4096, 8), (10000, 8), (307200, 8), (100, 16)])
def test_gram_matches_float64(rng, P, C):
    """`gram` against a float64 numpy M^T M; f32 summation error is bounded
    relative to sum_p |m_pi m_pj|, the same bound the GPU smoke asserts."""
    M = rng.normal(0, 1, (P, C)).astype(np.float32)
    M64 = M.astype(np.float64)
    out = np.asarray(reductions.gram(jnp.asarray(M)))
    scale = np.abs(M64).T @ np.abs(M64)
    assert np.max(np.abs(out - M64.T @ M64) / scale) <= 1e-5


def test_gram_zero_row_padding_invariance(rng):
    """Masked rows are zero, so padding with zero rows must not change G
    beyond the reordering of the f32 sum that another row count brings."""
    M = rng.normal(0, 1, (5000, 8)).astype(np.float32)
    out1 = np.asarray(reductions.gram(jnp.asarray(M)))
    out2 = np.asarray(reductions.gram(jnp.asarray(np.concatenate([M, np.zeros((3000, 8), np.float32)]))))
    scale = np.abs(M.astype(np.float64)).T @ np.abs(M.astype(np.float64))
    assert np.max(np.abs(out1 - out2) / scale) <= 1e-6
