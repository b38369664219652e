"""Per-stage breakdown of the flagship monocular-hybrid street frame.

Runs the exact bench configuration (`bench.run_mono_street`) twice over the
same frames:

1. **pipelined** — as the bench runs it (async dispatch, no syncs): the
   honest fps;
2. **staged** — every pipeline stage wrapped with `block_until_ready`:
   attributes wall time to depth CNN / sparse detect / sparse match+pose /
   dense step / tracker flush (keyframes, loop retrieval, local BA) / loop
   machinery, plus dispatch counts, host-sync counts and recompile events.

Run on the GPU (plain `python examples/profile_mono.py`) or on the CPU
(`JAX_PLATFORMS=cpu`) to check that it runs.
"""

import collections
import functools
import logging
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import jax
import jax.numpy as jnp
import numpy as np

from densemonoslam_tpu.config import CameraConfig, EngineConfig
from densemonoslam_tpu.engine import Engine
from densemonoslam_tpu.io.street import StreetSequence
from densemonoslam_tpu.models.depthnet import DepthPredictor
from densemonoslam_tpu.tracking import sparse as sparsemod
from densemonoslam_tpu.tracking.sparse import SparseTracker

N_FRAMES = int(os.environ.get("PROFILE_FRAMES", "72"))
WARM = 12

times = collections.defaultdict(float)
calls = collections.defaultdict(int)
active = []  # stage stack: nested stages subtract child time from parents


def staged(name, fn):
    """Wrap fn: block until its outputs are ready, attribute wall time."""

    @functools.wraps(fn)
    def wrap(*a, **k):
        t0 = time.perf_counter()
        active.append(0.0)
        out = fn(*a, **k)
        try:
            jax.block_until_ready(out)
        except Exception:
            pass
        dt = time.perf_counter() - t0
        child = active.pop()
        if active:
            active[-1] += dt
        times[name] += dt - child
        calls[name] += 1
        return out

    return wrap


def build(seq):
    cfg = EngineConfig(
        max_surfels=1 << 22, depth_cutoff=40.0, max_depth=80.0,
        depth_factor=1.0, depth_gate_rel=0.1, nid_keyframing=True,
        open_loop=True, predict_depth=True, orb_tracking=True,
        hybrid_loops=True, time_delta=200, pyramid_levels=4,
        track_row_stride=2,
    )
    eng = Engine(seq.camera, cfg)
    eng.frontend("cam0")
    eng.set_depth_predictor(DepthPredictor.pretrained_street())
    fe = eng.frontends["cam0"]
    fe.pose = seq.gt_pose(0).astype(np.float32)
    fe.sparse_tracker = SparseTracker(
        seq.camera.intrinsics, run_local_ba=True, keyframe_min_disp=1.0,
        loop_min_gap=100,
    )
    fe.sparse_tracker.pose = np.asarray(fe.state.pose)
    return eng, fe


def run(eng, fe, frames, instrument: bool):
    if instrument:
        st = fe.sparse_tracker
        eng._depth_predictor.predict = staged(
            "depth_cnn", eng._depth_predictor.predict
        )
        st.detect = staged("sparse_detect", st.detect)
        st.track = staged("sparse_track_total", st.track)
        st.flush = staged("tracker_flush", st.flush)
        st._process_batch = staged("flush_batch", st._process_batch)
        st._advance_async = staged("flush_async", st._advance_async)
        fe.step_fn = staged("dense_step", fe.step_fn)
        import densemonoslam_tpu.loops as loopsmod

        loopsmod.apply_hybrid_loop = staged(
            "hybrid_loop", loopsmod.apply_hybrid_loop
        )
    for i in range(WARM):
        eng.process_frame("cam0", frames[i], None, float(i), sync=False)
    jax.block_until_ready(fe.state.map_data)
    times.clear()
    calls.clear()
    t0 = time.perf_counter()
    for i in range(WARM, len(frames)):
        t_f0 = time.perf_counter()
        eng.process_frame("cam0", frames[i], None, float(i), sync=False)
        times["_frame_wall"] += time.perf_counter() - t_f0
        calls["_frame_wall"] += 1
    jax.block_until_ready(fe.state.map_data)
    return time.perf_counter() - t0


def main():
    seq = StreetSequence(
        camera=CameraConfig.kitti_default(), num_frames=N_FRAMES,
        exposure_jitter=0.03,
    )
    frames = [seq.frame(i)[0] for i in range(N_FRAMES)]
    n_timed = N_FRAMES - WARM

    # ---- leg 1: pipelined (bench-identical) -------------------------------
    eng, fe = build(seq)
    total = run(eng, fe, frames, instrument=False)
    print(f"pipelined: {n_timed / total:.2f} fps "
          f"({1e3 * total / n_timed:.1f} ms/frame)")

    # ---- leg 2: staged ----------------------------------------------------
    logging.getLogger("jax._src.dispatch").setLevel(logging.WARNING)
    jax.config.update("jax_log_compiles", True)
    compiles = []

    class Counter(logging.Handler):
        def emit(self, record):
            compiles.append(record.getMessage()[:120])

    h = Counter()
    logging.getLogger("jax._src.interpreters.pxla").addHandler(h)
    eng, fe = build(seq)
    total = run(eng, fe, frames, instrument=True)
    jax.config.update("jax_log_compiles", False)
    print(f"\nstaged:    {n_timed / total:.2f} fps "
          f"({1e3 * total / n_timed:.1f} ms/frame) — sync overhead included")
    print(f"\n{'stage':24s} {'ms/frame':>9s} {'calls/frame':>12s} {'total s':>8s}")
    other = total
    for k in sorted(times, key=lambda k: -times[k]):
        if k.startswith("_"):
            continue
        print(f"{k:24s} {1e3 * times[k] / n_timed:9.2f} "
              f"{calls[k] / n_timed:12.2f} {times[k]:8.2f}")
        other -= times[k]
    print(f"{'(host gaps / other)':24s} {1e3 * other / n_timed:9.2f}")
    print(f"\nrecompiles in timed region: {len(compiles)}")
    for c in compiles[:20]:
        print("  ", c)


if __name__ == "__main__":
    main()
