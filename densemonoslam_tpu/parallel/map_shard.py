"""Map-axis sharding: surfel-tensor passes distributed over the `map` mesh
axis.

SURVEY §5.7's blueprint maps the reference's time-windowed map to "the surfel
tensor sharded by time-block across chips": the active window stays resident
on the tracking chip while full-map passes (deformation application, INACTIVE
renders, exports) run sharded.  This module provides the first such pass —
`apply_to_map` (the reference `copy_unstable.vert:150-320` GPU deformation of
every surfel) over row blocks — proving the map can exceed one device's
memory: the deformation graph is tiny and replicated, rows are embarrassingly
parallel, so the only communication is the initial shard layout.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from densemonoslam_tpu.mapping import deformation as dg


def make_sharded_apply_to_map(mesh: Mesh):
    """Build `run(data [N+1,16], count, graph) -> data` with the N surfel
    rows block-sharded over the mesh's `map` axis (graph replicated).
    Runs the same per-row function as `deformation.apply_to_map`
    (`deformation.deform_rows`); N must divide by the `map` axis size."""

    def local(rows, count, gpos, gtime, gvalid, gA, gt):
        graph = dg.DeformGraph(pos=gpos, time=gtime, valid=gvalid, A=gA, t=gt)
        base = jax.lax.axis_index("map") * rows.shape[0]
        return dg.deform_rows(graph, rows, base, count)

    sharded = shard_map(
        local,
        mesh=mesh,
        in_specs=(P("map"), P(), P(), P(), P(), P(), P()),
        out_specs=P("map"),
        check_vma=False,
    )

    @jax.jit
    def run(data: jnp.ndarray, count: jnp.ndarray, graph: dg.DeformGraph):
        rows = sharded(
            data[:-1], count, graph.pos, graph.time, graph.valid, graph.A,
            graph.t,
        )
        return data.at[:-1].set(rows)

    return run
