"""densemonoslam_tpu — a dense collaborative monocular/RGB-D SLAM framework in JAX.

A from-scratch JAX/XLA re-design of the capabilities of
robotvisionmu/DenseMonoSLAM (ElasticFusion-style surfel SLAM + monocular depth
prediction + hybrid sparse tracking + NID keyframing + collaborative multi-map
sessions).  The reference system splits its hot path across GLSL transform
feedback, CUDA kernels, and CPU Eigen/CHOLMOD; here everything is dense-array
functional state transformed by jitted steps:

- the surfel map is a fixed-capacity SoA tensor (``mapping.surfel_map``), not a
  GL VBO ping-pong pair;
- the tracking Gauss-Newton normal equations are built by a single Gram
  matmul (``ops.reductions``), not a warp-shuffle tree reduction;
- map prediction is a scatter-min z-buffer rasteriser (``ops.splat``), not a
  point-sprite render pass;
- the deformation-graph solve is an on-device dense/CG Gauss-Newton
  (``mapping.deformation``), not CHOLMOD on the host;
- collaborative multi-camera sessions shard cameras and surfel blocks over a
  ``jax.sharding.Mesh`` (``parallel``), not LCM UDP multicast into one GPU.
"""

import jax as _jax

# SLAM is a geometry pipeline, not a neural net: poses chain multiplicatively
# and the GN normal equations difference near-equal quantities.  A GPU may
# run f32 matmuls in TF32 (10 mantissa bits, ~5e-4 relative), which would put
# millimetre-level noise into every vertex transform and Gram reduction, so
# true-f32 matmuls are forced package-wide.  Every geometry matmul here is
# skinny (K<=32 Gram factors, 3x3/4x4 poses) and bandwidth-bound, so the
# extra arithmetic is cheap.  Model code that wants reduced precision can
# request precision='default' per op.
_jax.config.update("jax_default_matmul_precision", "highest")

# Persistent XLA compilation cache (see `utils.jax_cache`): programs that
# first run mid-sequence would otherwise stall a live pipeline.
from densemonoslam_tpu.utils import jax_cache as _jax_cache

_jax_cache.enable()

from densemonoslam_tpu.config import (
    CameraIntrinsics,
    EngineConfig,
    FrameResolution,
)

__version__ = "0.1.0"

__all__ = [
    "CameraIntrinsics",
    "EngineConfig",
    "FrameResolution",
    "__version__",
]
