"""Monocular depth prediction network ("normnet" equivalent).

The reference runs a pre-trained ONNX depth CNN ("normnet_float{16,32}
_opset12.onnx") through ONNX Runtime's CUDA EP to turn a single RGB stream
into RGB-D for monocular/KITTI operation
(`GUI/src/Tools/DepthPrediction.cpp:3-169`: input NCHW float RGB/255, output
metric depth scaled x1000 to uint16 mm).  Here the network is plain JAX
(`lax.conv_general_dilated`, group norm, ELU) so it runs on the accelerator
next to the rest of the pipeline, with no runtime boundary:

- a compact U-Net (strided conv encoder, skip-connected decoder) emitting
  a disparity map through a sigmoid, converted to metric depth with the
  monodepth convention ``depth = 1 / (min_disp + (max_disp-min_disp)*s)``;
- weight I/O as npz keyed by parameter path
  (``ConvBlock_i/Conv_0/{kernel,bias}``, ``ConvBlock_i/GroupNorm_0/{scale,bias}``,
  ``Conv_0/{kernel,bias}``; conv kernels HWIO);
- a supervised L1(+gradient) training step for fitting on RGB-D data — the
  path for distilling a reference checkpoint or training on a dataset with
  depth ground truth.
"""

from __future__ import annotations

import itertools
from typing import Any, Dict, Sequence

import jax
import jax.numpy as jnp
import numpy as np

GROUPNORM_EPS = 1e-6


def _conv(p: Dict[str, jnp.ndarray], x: jnp.ndarray, stride: int = 1) -> jnp.ndarray:
    """3x3 'SAME' convolution, NHWC activations, HWIO kernel, plus bias."""
    y = jax.lax.conv_general_dilated(
        x, p["kernel"], (stride, stride), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
    )
    return y + p["bias"]


def _group_norm(p: Dict[str, jnp.ndarray], x: jnp.ndarray, groups: int) -> jnp.ndarray:
    """Group normalisation over (H, W, channels of the group) per sample,
    with per-channel scale and bias."""
    B, H, W, C = x.shape
    g = x.reshape(B, H, W, groups, C // groups)
    mean = jnp.mean(g, axis=(1, 2, 4), keepdims=True)
    var = jnp.maximum(jnp.mean(g * g, axis=(1, 2, 4), keepdims=True) - mean * mean, 0.0)
    y = (g - mean) * jax.lax.rsqrt(var + GROUPNORM_EPS)
    return y.reshape(B, H, W, C) * p["scale"] + p["bias"]


def _conv_block(p: Dict[str, Any], x: jnp.ndarray, stride: int = 1) -> jnp.ndarray:
    x = _conv(p["Conv_0"], x, stride)
    return jax.nn.elu(_group_norm(p["GroupNorm_0"], x, min(8, x.shape[-1])))


class DepthNet:
    """U-Net depth predictor.  `widths` controls capacity; the default is a
    ~1.5M-parameter model suited to 1024x320 KITTI feeds.

    Parameters are a nested dict ``{"ConvBlock_i": {...}, "Conv_0": {...}}``
    with blocks numbered in call order: per width an encoder block and its
    stride-2 block, the bottleneck block, then one decoder block per width."""

    def __init__(
        self,
        widths: Sequence[int] = (32, 64, 128, 256),
        min_depth: float = 0.5,
        max_depth: float = 80.0,
    ):
        self.widths = tuple(widths)
        self.min_depth = min_depth
        self.max_depth = max_depth

    def _block_channels(self):
        """(in, out) channels of each ConvBlock in call order, and the
        head's input channels."""
        io, c = [], 3
        for w in self.widths:
            io += [(c, w), (w, w)]
            c = w
        io.append((c, self.widths[-1]))
        c = self.widths[-1]
        for w in reversed(self.widths):
            io.append((c + w, w))
            c = w
        return io, c

    def init(self, key: jax.Array, rgb: jnp.ndarray) -> Dict[str, Any]:
        """Random parameters (LeCun-normal conv kernels, zero biases, unit
        group-norm scales) as ``{"params": tree}``; `rgb` only fixes dtype."""
        io, c_head = self._block_channels()
        keys = jax.random.split(key, len(io) + 1)
        init = jax.nn.initializers.lecun_normal()
        dt = rgb.dtype

        def conv(k, cin, cout):
            return {"kernel": init(k, (3, 3, cin, cout), dt), "bias": jnp.zeros((cout,), dt)}

        params = {
            f"ConvBlock_{i}": {
                "Conv_0": conv(keys[i], cin, cout),
                "GroupNorm_0": {"scale": jnp.ones((cout,), dt), "bias": jnp.zeros((cout,), dt)},
            }
            for i, (cin, cout) in enumerate(io)
        }
        params["Conv_0"] = conv(keys[-1], c_head, 1)
        return {"params": params}

    def apply(self, variables: Dict[str, Any], rgb: jnp.ndarray) -> jnp.ndarray:
        """rgb f32 [B,H,W,3] in [0,1] -> metric depth [B,H,W]."""
        p = variables["params"]
        blocks = (p[f"ConvBlock_{i}"] for i in itertools.count())
        skips = []
        x = rgb
        for _ in self.widths:
            x = _conv_block(next(blocks), x)
            skips.append(x)
            x = _conv_block(next(blocks), x, stride=2)
        x = _conv_block(next(blocks), x)
        for s in reversed(skips):
            B, H, W, C = s.shape
            x = jax.image.resize(x, (x.shape[0], H, W, x.shape[-1]), "bilinear")
            x = jnp.concatenate([x, s], axis=-1)
            x = _conv_block(next(blocks), x)
        disp = jax.nn.sigmoid(_conv(p["Conv_0"], x)[..., 0])
        min_disp = 1.0 / self.max_depth
        max_disp = 1.0 / self.min_depth
        return 1.0 / (min_disp + (max_disp - min_disp) * disp)


class DepthPredictor:
    """Engine-facing wrapper (the reference `DepthPrediction` class): u8 RGB
    frame in, metric f32 depth out, jitted per input shape."""

    def __init__(
        self,
        params: Any | None = None,
        widths: Sequence[int] = (32, 64, 128, 256),
        min_depth: float = 0.5,
        max_depth: float = 80.0,
        seed: int = 0,
    ):
        self.net = DepthNet(widths=widths, min_depth=min_depth, max_depth=max_depth)
        self._params = params
        self._seed = seed
        self._apply = jax.jit(lambda p, x: self.net.apply({"params": p}, x))

    def init_for(self, height: int, width: int) -> None:
        if self._params is None:
            key = jax.random.PRNGKey(self._seed)
            dummy = jnp.zeros((1, height, width, 3), jnp.float32)
            self._params = self.net.init(key, dummy)["params"]

    @property
    def params(self):
        return self._params

    def predict(self, rgb_u8: jnp.ndarray) -> jnp.ndarray:
        """[H,W,3] u8 -> [H,W] metric depth."""
        H, W, _ = rgb_u8.shape
        self.init_for(H, W)
        x = jnp.asarray(rgb_u8, jnp.float32)[None] / 255.0
        return self._apply(self._params, x)[0]

    @classmethod
    def pretrained_synthetic(cls) -> "DepthPredictor":
        """The packaged weights distilled from the analytic synthetic scene
        (trained by `examples/train_depthnet.py` to <10% held-out mean
        relative depth error) — makes monocular mode (`predict_depth=True`,
        reference `--predict_depth`) functional without an external
        checkpoint."""
        import json
        import os

        base = os.path.join(os.path.dirname(__file__), "weights")
        with open(os.path.join(base, "depthnet_synthetic.json")) as f:
            meta = json.load(f)
        p = cls(
            widths=tuple(meta["widths"]),
            min_depth=meta["min_depth"],
            max_depth=meta["max_depth"],
        )
        # conv params are input-size independent: any init shape works
        p.load(os.path.join(base, "depthnet_synthetic.npz"), 120, 160)
        return p

    @classmethod
    def pretrained_street(cls) -> "DepthPredictor":
        """Packaged weights trained on the street-scale procedural loop
        (`examples/train_depthnet_street.py`) — the monocular KITTI-shaped
        operating point (reference normnet role, `DepthPrediction.cpp:3-169`,
        `--predict_depth`)."""
        import json
        import os

        base = os.path.join(os.path.dirname(__file__), "weights")
        with open(os.path.join(base, "depthnet_street.json")) as f:
            meta = json.load(f)
        p = cls(
            widths=tuple(meta["widths"]),
            min_depth=meta["min_depth"],
            max_depth=meta["max_depth"],
        )
        h, w = meta.get("train_res", [80, 256])
        p.load(os.path.join(base, "depthnet_street.npz"), h, w)
        return p

    # --- weight I/O --------------------------------------------------------
    def save(self, path: str) -> None:
        flat = jax.tree_util.tree_flatten_with_path(self._params)[0]
        np.savez_compressed(
            path,
            **{
                "/".join(str(k.key) for k in ks): np.asarray(v)
                for ks, v in flat
            },
        )

    def load(self, path: str, height: int, width: int) -> None:
        self.init_for(height, width)
        z = np.load(path)
        flat, treedef = jax.tree_util.tree_flatten_with_path(self._params)
        new_leaves = []
        for ks, v in flat:
            name = "/".join(str(k.key) for k in ks)
            new_leaves.append(jnp.asarray(z[name]))
        self._params = jax.tree_util.tree_unflatten(
            jax.tree_util.tree_structure(self._params), new_leaves
        )


def l1_depth_loss(pred: jnp.ndarray, gt: jnp.ndarray) -> jnp.ndarray:
    """Masked L1 + edge-aware smoothness-ish gradient matching."""
    valid = gt > 0
    l1 = jnp.abs(pred - gt) * valid
    gx_p = jnp.abs(pred[:, :, 1:] - pred[:, :, :-1])
    gx_g = jnp.abs(gt[:, :, 1:] - gt[:, :, :-1])
    gy_p = jnp.abs(pred[:, 1:] - pred[:, :-1])
    gy_g = jnp.abs(gt[:, 1:] - gt[:, :-1])
    grad = jnp.mean(jnp.abs(gx_p - gx_g)) + jnp.mean(jnp.abs(gy_p - gy_g))
    return jnp.sum(l1) / jnp.maximum(jnp.sum(valid), 1.0) + 0.5 * grad


def make_train_step(net: DepthNet, optimizer):
    """Supervised training step (for distillation / RGB-D fitting)."""

    @jax.jit
    def step(params, opt_state, rgb, depth_gt):
        def loss_fn(p):
            pred = net.apply({"params": p}, rgb)
            return l1_depth_loss(pred, depth_gt)

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        import optax

        params = optax.apply_updates(params, updates)
        return params, opt_state, loss

    return step
