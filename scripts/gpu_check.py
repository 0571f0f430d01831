"""Shared guard of the measuring scripts: name the device, refuse anything
but a GPU (a time taken on JAX's CPU fallback is no device number)."""

from __future__ import annotations

import subprocess
import sys


def require_gpu(script: str) -> str:
    """One line naming JAX's devices and the card (nvidia-smi name and
    power limit); exits with status 1 unless JAX runs on a GPU."""
    import jax

    d = jax.devices()
    if d[0].platform != "gpu":
        sys.exit(f"{script}: needs a GPU, JAX runs on {d[0].platform}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30,
    ).stdout.strip().replace("\n", " | ")
    return f"{d[0].platform} x{len(d)} {d[0].device_kind}; card: {card}"
