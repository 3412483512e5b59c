"""The device a measurement runs on.

A measurement names the card it ran on and refuses to run anywhere else:
``require_gpu`` fails when JAX's default device is not an NVIDIA GPU, and
``card_info`` reads the card's name and power limit from ``nvidia-smi`` in
a child process that does not import JAX.
"""

from __future__ import annotations

import subprocess


def with_cpu_backend() -> None:
    """Keep JAX's CPU backend available beside the GPU (the parity oracle
    runs there). Call before JAX initialises its backends: a platform list
    (``JAX_PLATFORMS``) that names only the GPU gets ``cpu`` appended,
    which leaves the GPU the default device."""
    import jax

    plats = jax.config.jax_platforms
    if plats and "cpu" not in plats.split(","):
        jax.config.update("jax_platforms", plats + ",cpu")


def require_gpu(allow_cpu: bool = False):
    """JAX's default device, or ``SystemExit`` when it is not a GPU.

    ``allow_cpu`` admits the CPU too; it exists only to rehearse a chip
    script on a machine without a card."""
    import jax

    dev = jax.devices()[0]
    if dev.platform == "gpu" or (allow_cpu and dev.platform == "cpu"):
        return dev
    raise SystemExit(f"needs an NVIDIA GPU; JAX's default device is "
                     f"{dev.platform} ({dev.device_kind})")


def card_info() -> str | None:
    """``name, power.limit`` of each card as ``nvidia-smi`` prints them
    (one line per card), or None when ``nvidia-smi`` is not installed."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            check=True, capture_output=True, text=True, timeout=60)
    except FileNotFoundError:
        return None
    return out.stdout.strip()


def describe(dev) -> dict:
    """The device fields every result line carries."""
    import jax

    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices())}
