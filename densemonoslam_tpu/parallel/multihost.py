"""Multi-host collaborative session formation (SURVEY §5.8, BASELINE
configs 4-5: "collaborative 4-camera session, one stream per host").

The reference forms distributed sessions over LCM UDP multicast: every host
publishes `eflcm::Frame`s tagged with its senderName and one GPU machine
consumes them all (`Tools/networking/LcmReceiver.cpp`, `LcmHandler.h`,
`Options.h:389-406`).  This design inverts that: compute is the
distributed thing, not the frames.  `jax.distributed` joins the hosts into
one process group; the collaborative SPMD step (`parallel.collab`) is jitted
over a GLOBAL mesh spanning every host's devices, with the `cam` axis laid
out so each host's cameras land on its OWN local devices — per-camera
pipelines never leave the host; only the session-wide collectives
(stats all-gather, surfel psum, future BA/PGO reductions) cross hosts.

Frame ingest stays host-local (each host feeds its own cameras from its own
logs/UDP streams via `io.camera_manager`), entering the global arrays with
`jax.make_array_from_process_local_data` — the moral equivalent of the
reference's per-host LCM publishers, minus the network copy of every frame.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from densemonoslam_tpu.config import CameraIntrinsics, EngineConfig

# NOTE: `parallel.collab` (and transitively the whole step pipeline, which
# holds module-level jnp constants that initialise the XLA backend) is
# imported lazily inside MultiHostSession — `initialize()` must be callable
# before ANY backend-initialising JAX call, per jax.distributed's contract.


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> bool:
    """Join (or form) the multi-host process group.

    Values default from the environment (`DMS_COORDINATOR`, `DMS_NUM_HOSTS`,
    `DMS_HOST_ID` — or the standard JAX cluster-detection variables).  A
    single-process session (no coordinator configured) is a no-op returning
    False, so the same entry point serves laptops and pods.  This replaces
    the reference's "everyone subscribes to the multicast group" session
    formation (`MultiLiveCameraManager` + `Options::lcmUrl`)."""
    coordinator_address = coordinator_address or os.environ.get("DMS_COORDINATOR")
    if num_processes is None and "DMS_NUM_HOSTS" in os.environ:
        num_processes = int(os.environ["DMS_NUM_HOSTS"])
    if process_id is None and "DMS_HOST_ID" in os.environ:
        process_id = int(os.environ["DMS_HOST_ID"])
    if coordinator_address is None and num_processes is None:
        return False  # single-host session
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
    return True


def session_mesh(n_cams: Optional[int] = None) -> Mesh:
    """Global mesh whose `cam` axis is ordered host-major: process p's
    cameras occupy the contiguous slot range [p*cph, (p+1)*cph), so each
    camera's full per-frame pipeline runs on a device of the host that
    ingests that camera's frames (DCN carries only collectives)."""
    devs = sorted(jax.devices(), key=lambda d: (d.process_index, d.id))
    n_cams = n_cams if n_cams is not None else len(devs)
    arr = np.array(devs[:n_cams]).reshape(n_cams, 1)
    return Mesh(arr, axis_names=("cam", "map"))


class MultiHostSession:
    """A running collaborative session: one camera per device, all hosts.

    Usage per host::

        multihost.initialize()                  # join the process group
        sess = multihost.MultiHostSession(intr, H, W, cfg)
        for ...:
            stats, total = sess.step(rgb_local, depth_local)  # this host's cams

    `rgb_local`/`depth_local` carry ONLY this host's cameras
    ([cams_per_host, H, W(, 3)]); `stats` is the session-wide per-camera
    stats block (replicated, so every host sees every camera's health — the
    reference's LCM-shared GUI state), `total` the global surfel count."""

    def __init__(
        self,
        intr: CameraIntrinsics,
        height: int,
        width: int,
        config: Optional[EngineConfig] = None,
        cams_per_host: Optional[int] = None,
    ):
        from densemonoslam_tpu.parallel import collab

        self.process_id = jax.process_index()
        self.n_hosts = jax.process_count()
        local = len(jax.local_devices())
        self.cams_per_host = min(cams_per_host or local, local)
        self.n_cams = self.cams_per_host * self.n_hosts
        self.height, self.width = height, width
        self.cfg = config or EngineConfig(
            max_surfels=1 << 15, depth_cutoff=100.0, depth_factor=1.0,
            nid_keyframing=False, open_loop=True,
        )
        self.mesh = session_mesh(self.n_cams)
        self.cam_sharding = NamedSharding(self.mesh, P("cam"))
        self.intr = intr
        self.step_fn = collab.make_collab_step(
            self.mesh, intr, height, width, self.cfg
        )
        self._im_round = None
        self._im_state = None
        # init the global state ON the mesh (a host-local init array would
        # not be addressable across processes)
        n, cap, H, W = self.n_cams, self.cfg.max_surfels, height, width
        self.state = jax.jit(
            lambda: collab.init_state(n, cap, H, W),
            out_shardings=self.cam_sharding,
        )()
        self.ticks = 0

    def _globalise(self, local_batch: np.ndarray) -> jax.Array:
        """This host's [cams_per_host, ...] frames -> global [n_cams, ...]."""
        return jax.make_array_from_process_local_data(
            self.cam_sharding, np.ascontiguousarray(local_batch)
        )

    def step(
        self, rgb_local: np.ndarray, depth_local: np.ndarray
    ) -> Tuple[np.ndarray, int]:
        rgb = self._globalise(np.asarray(rgb_local))
        depth = self._globalise(np.asarray(depth_local, np.float32))
        self.state, stats, total = self.step_fn(self.state, rgb, depth)
        self.ticks += 1
        return np.asarray(stats), int(total)

    def enable_intermap(self, **kw) -> None:
        """Arm collective inter-map closure rounds (BASELINE config 5's
        'inter-map loop closures' in the distributed session; reference
        `ReferenceFrame::resolveRelativeTransformationFern` +
        `consumeReferenceFrame`).  Every camera starts in its OWN map;
        `intermap_round` merges maps when cameras recognise each other's
        places — all decisions ride replicated collectives, so every host
        applies the same merge without any cross-host control messages."""
        from densemonoslam_tpu.parallel import intermap

        self._im_round = intermap.make_intermap_round(
            self.mesh, self.intr, self.height, self.width, self.cfg, **kw
        )
        ist_host = intermap.init_state(self.n_cams, self.cfg.num_ferns)
        self._im_state = jax.tree.map(
            lambda v: jax.make_array_from_process_local_data(
                self.cam_sharding,
                np.ascontiguousarray(
                    np.asarray(v)[list(self.my_cam_slots)]
                ),
            ),
            ist_host,
        )

    def intermap_round(self, rgb_local: np.ndarray, depth_local: np.ndarray):
        """Run one collective inter-map round with this host's frames.
        Returns the replicated `intermap.MergeInfo` (host numpy views)."""
        assert self._im_round is not None, "call enable_intermap() first"
        rgb = self._globalise(np.asarray(rgb_local))
        depth = self._globalise(np.asarray(depth_local, np.float32))
        self.state, self._im_state, info = self._im_round(
            self.state, self._im_state, rgb, depth
        )
        return jax.tree.map(np.asarray, info)

    @property
    def my_cam_slots(self) -> range:
        """Global camera indices this host feeds."""
        return range(
            self.process_id * self.cams_per_host,
            (self.process_id + 1) * self.cams_per_host,
        )
