"""Frame preprocessing ops: bilateral depth filter, depth→metric conversion,
Gaussian pyramids, intensity conversion, Sobel gradients.

Replacements for the reference's GLSL compute-via-FBO passes
(`Core/src/Shaders/depth_bilateral.frag`, `depth_metric.frag`,
`depth_norm.frag`; wrapped by `ComputePack`) and CUDA pyramid helpers
(`Core/src/Cuda/cudafuncs.cu`: `pyrDown`, `pyrDownGauss`, `imageBGRToIntensity`,
`computeDerivativeImages`).  Everything here is pure XLA — stencil windows are
expressed as `lax.reduce_window` / explicit shifted adds which XLA fuses and
vectorises into fused elementwise work; no kernel needed at these sizes.

All image tensors are [H, W] or [H, W, C], f32, row-major.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
from densemonoslam_tpu.ops import warp
import numpy as np


def metricise_depth(depth_raw: jnp.ndarray, depth_factor: float, depth_cutoff: float) -> jnp.ndarray:
    """Raw sensor units -> metres, zeroing out-of-range readings
    (reference `depth_metric.frag` + `--d` cutoff semantics)."""
    d = depth_raw.astype(jnp.float32) / depth_factor
    return jnp.where((d > 0.0) & (d < depth_cutoff), d, 0.0)


def rgb_to_intensity(rgb: jnp.ndarray) -> jnp.ndarray:
    """RGB (u8 or f32 [H,W,3]) -> luminance f32 [H,W] in [0,255].

    Uses the same integer-ITU weights as the reference's
    `imageBGRToIntensity` kernel (`cudafuncs.cu`): 0.114/0.299 swapped for BGR
    there; ours takes RGB order."""
    rgb = rgb.astype(jnp.float32)
    return 0.299 * rgb[..., 0] + 0.587 * rgb[..., 1] + 0.114 * rgb[..., 2]


def _shifted(img: jnp.ndarray, dy: int, dx: int) -> jnp.ndarray:
    """Shift with edge clamping (replicate border).

    Implemented as pad+static-slice, which XLA compiles to pure data
    movement instead of a gather."""
    H, W = img.shape[0], img.shape[1]
    py0, py1 = max(dy, 0), max(-dy, 0)
    px0, px1 = max(dx, 0), max(-dx, 0)
    pad_width = [(py1, py0), (px1, px0)] + [(0, 0)] * (img.ndim - 2)
    padded = jnp.pad(img, pad_width, mode="edge")
    return jax.lax.slice(
        padded,
        [py0, px0] + [0] * (img.ndim - 2),
        [py0 + H, px0 + W] + list(img.shape[2:]),
    )


def bilateral_filter_depth(
    depth: jnp.ndarray,
    radius: int = 2,
    sigma_space: float = 4.5,
    sigma_depth: float = 0.03,
) -> jnp.ndarray:
    """Edge-preserving depth smoothing over a (2r+1)^2 window.

    The reference runs this in `depth_bilateral.frag` (sigma-space 4.5-ish,
    depth-range gating) before tracking; invalid (0) depths contribute zero
    weight and pixels with no valid support stay 0.
    """
    valid = (depth > 0.0).astype(jnp.float32)
    acc = jnp.zeros_like(depth)
    wacc = jnp.zeros_like(depth)
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            d_n = _shifted(depth, dy, dx)
            v_n = _shifted(valid, dy, dx)
            w_s = float(np.exp(-(dx * dx + dy * dy) / (2.0 * sigma_space**2)))
            diff = d_n - depth
            w_d = jnp.exp(-(diff * diff) / (2.0 * sigma_depth**2))
            w = w_s * w_d * v_n
            acc = acc + w * d_n
            wacc = wacc + w
    out = jnp.where(wacc > 1e-6, acc / jnp.maximum(wacc, 1e-6), 0.0)
    return out * valid


_GAUSS_5 = np.array([1.0, 4.0, 6.0, 4.0, 1.0], dtype=np.float32) / 16.0


def _sep_conv(img: jnp.ndarray, k: np.ndarray) -> jnp.ndarray:
    """Separable convolution with replicate borders via shifted adds (cheap to
    fuse, avoids conv layout overhead at these sizes)."""
    r = len(k) // 2
    tmp = jnp.zeros_like(img)
    for i, w in enumerate(k):
        tmp = tmp + float(w) * _shifted(img, 0, i - r)
    out = jnp.zeros_like(img)
    for i, w in enumerate(k):
        out = out + float(w) * _shifted(tmp, i - r, 0)
    return out


def pyr_down_gauss(img: jnp.ndarray) -> jnp.ndarray:
    """Gaussian 5-tap blur + 2x decimation (reference `pyrDownGaussF`)."""
    return warp.decimate(_sep_conv(img, _GAUSS_5), 2)


def pyr_down_depth(depth: jnp.ndarray, sigma_depth: float = 0.03) -> jnp.ndarray:
    """Depth-aware 2x downsample: Gaussian over the 5x5 support but only
    averaging samples within a depth band of the centre and ignoring invalid
    zeros (reference `pyrDownKernelF` / `pyrDownUcharGauss` behaviour —
    straight Gaussian blurring across depth edges would hallucinate surfaces).
    """
    centre = warp.decimate(depth, 2)
    acc = jnp.zeros_like(centre)
    wacc = jnp.zeros_like(centre)
    for dy in range(-2, 3):
        for dx in range(-2, 3):
            n = warp.decimate(_shifted(depth, dy, dx), 2)
            w_s = float(_GAUSS_5[dy + 2] * _GAUSS_5[dx + 2])
            ok = (n > 0.0) & (jnp.abs(n - centre) < 3.0 * sigma_depth)
            w = w_s * ok.astype(jnp.float32)
            acc = acc + w * n
            wacc = wacc + w
    return jnp.where((centre > 0.0) & (wacc > 1e-6), acc / jnp.maximum(wacc, 1e-6), 0.0)


def build_pyramid(img: jnp.ndarray, levels: int, depth: bool = False) -> Tuple[jnp.ndarray, ...]:
    """Coarse-to-fine pyramid, level 0 = input resolution."""
    out = [img]
    for _ in range(levels - 1):
        out.append(pyr_down_depth(out[-1]) if depth else pyr_down_gauss(out[-1]))
    return tuple(out)


def sobel_gradients(img: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Sobel x/y derivative images with the reference's 1/8 normalisation
    (`computeDerivativeImages`, `cudafuncs.cu` — Sobel 3x3 scaled so gradients
    are in intensity-per-pixel units)."""
    gx = (
        (_shifted(img, -1, 1) + 2.0 * _shifted(img, 0, 1) + _shifted(img, 1, 1))
        - (_shifted(img, -1, -1) + 2.0 * _shifted(img, 0, -1) + _shifted(img, 1, -1))
    ) * 0.125
    gy = (
        (_shifted(img, 1, -1) + 2.0 * _shifted(img, 1, 0) + _shifted(img, 1, 1))
        - (_shifted(img, -1, -1) + 2.0 * _shifted(img, -1, 0) + _shifted(img, -1, 1))
    ) * 0.125
    return gx, gy
