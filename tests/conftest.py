"""Test configuration: run everything on a virtual 8-device CPU mesh.

Mirrors the reference's "multi-node without a cluster" strategy (LCM file://
loopback, SURVEY §4.4): sharding/collective code paths are exercised on one
host by forcing XLA to expose 8 host devices.  Must run before jax imports.
"""

import os

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ.setdefault("JAX_ENABLE_X64", "0")

import jax  # noqa: E402

# Set the platform in config too, in case jax was imported before the env
# var above.
jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(scope="session")
def synthetic_seq():
    from densemonoslam_tpu.io.synthetic import SyntheticSequence

    return SyntheticSequence(num_frames=12)


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(42)
