"""Acceleration-structure checkpointing.

The reference has no checkpoint/resume; SURVEY.md §5 specifies it as a
pure addition: persist the computed gradient /
occupancy / distance maps to disk keyed on (volume identity, TF parameters,
block size, skipping type), so a session can resume without re-running the
load-time gradient pass or the TF-edit rebuild.
"""

from __future__ import annotations

import hashlib
import os

import jax.numpy as jnp
import numpy as np


def _key(volume, skipping_type) -> str:
    o = volume.options
    d, h, w = volume.density.shape
    # Volume identity: name + shape + a cheap content probe (corners + strided
    # checksum) — hashing 342 MB per lookup would defeat the purpose.
    probe = np.asarray(volume.density[::64, ::64, ::64]).tobytes()
    raw = (
        f"{volume.name}|{d}x{h}x{w}|bs{volume.block_size}|st{int(skipping_type)}|"
        f"tf{o.intensity_min:.6g},{o.intensity_max:.6g},{o.gradient_min:.6g},"
        f"{o.gradient_max:.6g}|g{int(o.use_precomputed_gradient)}"
    ).encode() + hashlib.sha1(probe).digest()
    return hashlib.sha1(raw).hexdigest()


def save(cache_dir: str, volume, skipping_type) -> str:
    """Persist the volume's computed maps; returns the checkpoint path."""
    os.makedirs(cache_dir, exist_ok=True)
    path = os.path.join(cache_dir, _key(volume, skipping_type) + ".npz")
    arrays = {}
    if volume.gradient is not None:
        arrays["gradient"] = np.asarray(volume.gradient)
    if volume.dist_maps is not None:
        arrays["dist_maps"] = np.asarray(volume.dist_maps)
    np.savez_compressed(path, **arrays)
    return path


def load(cache_dir: str, volume, skipping_type) -> bool:
    """Restore maps for this (volume, TF, skipping) if checkpointed."""
    path = os.path.join(cache_dir, _key(volume, skipping_type) + ".npz")
    if not os.path.exists(path):
        return False
    with np.load(path) as z:
        if "gradient" in z:
            volume.gradient = jnp.asarray(z["gradient"])
        if "dist_maps" in z:
            volume.dist_maps = jnp.asarray(z["dist_maps"])
    return True
