"""The accelerator a measuring entry point runs on.

Entry points that report device numbers (`bench.py`, `chip_smoke.py`,
``cli --platform gpu``) fail when JAX finds no GPU instead of falling back to
the CPU, and label what they print with the card's name and power limit: a
card set below its maximum power runs slower under load.
"""

from __future__ import annotations

import subprocess

import jax


def require_gpu() -> jax.Device:
    """JAX's default device; raises unless it is a GPU."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise RuntimeError(
            f"no GPU: JAX's default device is {dev.platform!r} ({dev.device_kind})"
        )
    return dev


def card_lines() -> list[str]:
    """One ``name, power.limit`` line per card, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout
    return [line.strip() for line in out.splitlines() if line.strip()]
