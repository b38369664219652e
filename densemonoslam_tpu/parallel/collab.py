"""Collaborative multi-camera SLAM step over a device mesh.

Replaces the reference's collaborative-session machinery — N `Context`s
round-robined through one GPU with LCM transporting frames
(`GUI/src/MainController.cpp:262-400`, `Tools/LcmHandler.h`) — with SPMD:
one camera per device on the mesh `cam` axis (the BASELINE "one camera
stream per host" layout), each device running the FULL fused per-frame step
(`step.make_step`: preprocess, predict, track, NID gate, fuse, clean) on its
own camera and map shard.  Because each shard processes exactly one camera,
the step's `lax.cond` fusion branch stays a real branch (vmapping it would
degrade to a both-sides select).

Cross-camera state rides mesh collectives: per-camera stats are all-gathered
so every host sees session health, and the global surfel total is a psum —
the SPMD analogue of the reference's shared stats/GUI state.  Inter-map loop
closures and merges run collectively (`parallel.intermap`); per-camera
INTRA-map loop closure runs as part of the sharded work at cadence
(`make_collab_local_loop`), so each collaborative camera executes the FULL
reference `processFrame` surface — NID keyframing, time-window gating, local
deformation — not just open-loop odometry+fusion
(`ElasticFusion.cpp:99-637`: every context runs the complete pipeline).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from densemonoslam_tpu import step as stepmod
from densemonoslam_tpu.config import CameraIntrinsics, EngineConfig

# The collaborative state is the per-camera `step.SlamState` pytree with a
# leading `cam` batch axis on every leaf.
CollabState = stepmod.SlamState


def init_state(
    n_cams: int, capacity: int, height: int, width: int, levels: int = 3
) -> CollabState:
    one = stepmod.init_state(capacity, height, width, levels=levels)
    return jax.tree.map(
        lambda v: jnp.broadcast_to(v, (n_cams,) + v.shape), one
    )


def make_collab_step(
    mesh: Mesh,
    intr: CameraIntrinsics,
    height: int,
    width: int,
    config: EngineConfig | None = None,
):
    """Build the jitted SPMD collaborative step (one camera per device)."""
    cfg = config or EngineConfig(
        max_surfels=1 << 14, depth_cutoff=100.0, depth_factor=1.0,
        nid_keyframing=False, open_loop=True,
    )
    step = stepmod.make_step(intr, height, width, cfg)

    def local(state_b: CollabState, rgb, depth):
        # each shard holds exactly one camera: drop the leading axis
        state = jax.tree.map(lambda v: v[0], state_b)
        new_state, stats = step(
            state, rgb[0], depth[0],
            jnp.eye(4, dtype=jnp.float32), jnp.asarray(False),
            jnp.asarray(1.0, jnp.float32), jnp.float32(0.0),
        )
        # session-wide views over the mesh
        global_stats = jax.lax.all_gather(stats, "cam")
        total = jax.lax.psum(new_state.map_count, "cam")
        out = jax.tree.map(lambda v: v[None], new_state)
        return out, global_stats, total

    sharded = shard_map(
        local,
        mesh=mesh,
        in_specs=(P("cam"), P("cam"), P("cam")),
        out_specs=(P("cam"), P(), P()),
        check_vma=False,
    )

    @jax.jit
    def collab_step(
        state: CollabState, rgb_batch: jnp.ndarray, depth_batch: jnp.ndarray
    ):
        return sharded(state, rgb_batch, depth_batch)

    return collab_step


def init_rel_banks(n_cams: int, capacity: int = 64):
    """Per-camera relative-constraint banks (leading `cam` axis)."""
    from densemonoslam_tpu import loops as loopsmod

    one = loopsmod.make_rel_bank(capacity)
    return jax.tree.map(
        lambda v: jnp.broadcast_to(v, (n_cams,) + v.shape), one
    )


def make_collab_local_loop(
    mesh: Mesh,
    intr: CameraIntrinsics,
    height: int,
    width: int,
    config: EngineConfig,
):
    """Per-camera INTRA-map loop closure inside the sharded program.

    Each device runs the complete jitted local-loop program on its own
    camera's map — INACTIVE render, model-to-model ICP, acceptance gates,
    deformation-graph GN-CG, whole-map apply (`loops._make_local_loop`,
    reference `ElasticFusion.cpp:399-495`) — with only the tiny outcome
    vectors riding one `all_gather`, so every host sees which cameras
    closed.  Call at the engine's loop cadence between `collab_step`s.

    Returns a jitted `(state_b, banks_b) -> (state_b, banks_b, infos)` with
    `infos` [n_cams, 5] replicated: columns are (closed, inactive_frac,
    inlier_frac, icp_error, cons_error) per camera (`loops.LoopInfo`).
    """
    from densemonoslam_tpu import loops as loopsmod

    run = loopsmod._make_local_loop(intr, width, height, config)

    def local(state_b, bank_b):
        state = jax.tree.map(lambda v: v[0], state_b)
        bank = jax.tree.map(lambda v: v[0], bank_b)
        new_state, info_vec, _graph, new_bank = run(state, bank)
        infos = jax.lax.all_gather(info_vec, "cam")
        return (
            jax.tree.map(lambda v: v[None], new_state),
            jax.tree.map(lambda v: v[None], new_bank),
            infos,
        )

    sharded = shard_map(
        local,
        mesh=mesh,
        in_specs=(P("cam"), P("cam")),
        out_specs=(P("cam"), P("cam"), P()),
        check_vma=False,
    )

    @jax.jit
    def loop_round(state_b, bank_b):
        return sharded(state_b, bank_b)

    return loop_round
