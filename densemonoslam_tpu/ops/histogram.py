"""Joint histograms + Normalised Information Distance (NID).

Replacement for the reference's NID CUDA kernels
(`Core/src/Cuda/cudafuncs.cu:999-1358` joint-histogram kernels, host entropy
assembly :1358-1915, orchestrated by `Core/src/MutualInformation.cpp`).

The 64x64 image joint histogram is computed as a one-hot Gram matmul
(``onehot(A)^T @ onehot(B)``) — one matmul; the
500-bin depth histogram would make that one-hot too wide to be
bandwidth-sane, so it uses a scatter-add over flattened bin pairs instead.
Entropy assembly runs on device (the reference downloads the histogram and
assembles on the host).

NID(A,B) = (H(A,B) - I(A;B)) / H(A,B), in [0, 1]; 0 = identical signals.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


def _entropy(p: jnp.ndarray) -> jnp.ndarray:
    p = p / jnp.maximum(jnp.sum(p), 1e-12)
    return -jnp.sum(jnp.where(p > 0, p * jnp.log(jnp.maximum(p, 1e-12)), 0.0))


def nid_from_joint(joint: jnp.ndarray) -> jnp.ndarray:
    """Joint histogram [B, B] -> NID scalar."""
    total = jnp.sum(joint)
    pj = joint / jnp.maximum(total, 1e-12)
    h_ab = _entropy(joint)
    h_a = _entropy(jnp.sum(joint, axis=1))
    h_b = _entropy(joint.sum(axis=0))
    mi = h_a + h_b - h_ab
    nid = jnp.where(h_ab > 1e-9, (h_ab - mi) / jnp.maximum(h_ab, 1e-9), 0.0)
    # no overlap at all -> maximally distant
    return jnp.where(total > 0, jnp.clip(nid, 0.0, 1.0), 1.0)


@functools.partial(jax.jit, static_argnames=("bins",))
def joint_histogram_matmul(
    a: jnp.ndarray, b: jnp.ndarray, valid: jnp.ndarray, bins: int, vmax: float
) -> jnp.ndarray:
    """[P] signals -> [bins, bins] joint histogram via a one-hot matmul.
    Suitable for small bin counts (image: 64)."""
    scale = bins / vmax
    ia = jnp.clip((a * scale).astype(jnp.int32), 0, bins - 1)
    ib = jnp.clip((b * scale).astype(jnp.int32), 0, bins - 1)
    m = valid.astype(jnp.float32)
    oh_a = jax.nn.one_hot(ia, bins, dtype=jnp.float32) * m[:, None]
    oh_b = jax.nn.one_hot(ib, bins, dtype=jnp.float32)
    return jax.lax.dot_general(
        oh_a, oh_b, (((0,), (0,)), ((), ())), preferred_element_type=jnp.float32
    )


@functools.partial(jax.jit, static_argnames=("bins",))
def joint_histogram_scatter(
    a: jnp.ndarray, b: jnp.ndarray, valid: jnp.ndarray, bins: int, vmax: float
) -> jnp.ndarray:
    """[P] signals -> [bins, bins] joint histogram via scatter-add over
    flattened bin pairs.  Used for the 500-bin depth histogram."""
    scale = bins / vmax
    ia = jnp.clip((a * scale).astype(jnp.int32), 0, bins - 1)
    ib = jnp.clip((b * scale).astype(jnp.int32), 0, bins - 1)
    flat = ia * bins + ib
    flat = jnp.where(valid, flat, bins * bins)  # dump slot
    hist = jnp.zeros((bins * bins + 1,), jnp.float32).at[flat].add(1.0)
    return hist[:-1].reshape(bins, bins)


@functools.partial(jax.jit, static_argnames=("bins",))
def nid_image(
    img_a: jnp.ndarray, img_b: jnp.ndarray, valid: jnp.ndarray, bins: int = 64
) -> jnp.ndarray:
    """NID between two intensity images ([H,W] or flat, 0..255), counting only
    `valid` pixels (reference `MutualInformation::nidImg`, 64 bins)."""
    joint = joint_histogram_matmul(
        img_a.reshape(-1), img_b.reshape(-1), valid.reshape(-1), bins, 256.0
    )
    return nid_from_joint(joint)


@functools.partial(jax.jit, static_argnames=("bins",))
def nid_depth(
    d_a: jnp.ndarray,
    d_b: jnp.ndarray,
    valid: jnp.ndarray,
    depth_max: float,
    bins: int = 500,
) -> jnp.ndarray:
    """NID between two metric depth maps (reference
    `MutualInformation::nidDepth`, 500 bins over the depth range)."""
    joint = joint_histogram_scatter(
        d_a.reshape(-1), d_b.reshape(-1), valid.reshape(-1), bins, depth_max
    )
    return nid_from_joint(joint)
