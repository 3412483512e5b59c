"""Gradient-magnitude map — 4-tap tetrahedron stencil as one jitted XLA pass.

Device-side twin of ``shaders/gradient_map.comp`` +
``shaders/get_gradient_compute.glsl:5-23``: per voxel

    k = (1, -1)
    dir = 0.25 * ( k.xyy * v[p + k.xyy] + k.yyx * v[p + k.yyx]
                 + k.yxy * v[p + k.yxy] + k.xxx * v[p + k.xxx] )
    g   = clamp(|dir| * grad_magnitude_modifier, 0, 1)    # stored R8 unorm

with taps clamped to the volume bounds (``imageLoad`` with clamped coords).
In XLA this is a fused elementwise stencil: integer tap sums in int16, one
rsqrt-free float norm, quantised back to u8. The host-side dispatch
ceremony (``src/compute_gradient_map.cpp:57-81``) collapses into ``jit``.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

# Tetrahedron tap offsets in (x, y, z), reference get_gradient_compute.glsl:13-18.
_TAPS = (
    (1, -1, -1),   # k.xyy
    (-1, -1, 1),   # k.yyx
    (-1, 1, -1),   # k.yxy
    (1, 1, 1),     # k.xxx
)


def _shift_clamped(padded: jax.Array, off_xyz, shape_zyx):
    """Slice of the edge-padded volume shifted by (ox, oy, oz)."""
    ox, oy, oz = off_xyz
    d, h, w = shape_zyx
    return jax.lax.dynamic_slice(padded, (oz + 1, oy + 1, ox + 1), (d, h, w))


@functools.partial(jax.jit, static_argnames=("use_gradient",))
def gradient_map(
    volume_u8: jax.Array,
    grad_magnitude_modifier: jax.Array | float = 1.0,
    *,
    use_gradient: bool = True,
) -> jax.Array:
    """Compute the R8-unorm gradient map for a (D, H, W) uint8 volume.

    When ``use_gradient`` is False the reference kernel writes 1.0 everywhere
    (get_gradient_compute.glsl:6-7); we reproduce that (a stale all-ones map
    is observable if gradient modulation is enabled later without recompute).
    """
    if not use_gradient:
        return jnp.full(volume_u8.shape, 255, dtype=jnp.uint8)

    padded = jnp.pad(volume_u8, 1, mode="edge")
    shape = volume_u8.shape

    # Accumulate signed tap sums in int16 (|sum| <= 4*255 = 1020).
    dx = jnp.zeros(shape, jnp.int16)
    dy = jnp.zeros(shape, jnp.int16)
    dz = jnp.zeros(shape, jnp.int16)
    for ox, oy, oz in _TAPS:
        v = _shift_clamped(padded, (ox, oy, oz), shape).astype(jnp.int16)
        dx = dx + jnp.int16(ox) * v
        dy = dy + jnp.int16(oy) * v
        dz = dz + jnp.int16(oz) * v

    # 0.25 * length(dir) with dir components in unorm units (v/255).
    scale = jnp.float32(0.25 / 255.0)
    dxf = dx.astype(jnp.float32)
    dyf = dy.astype(jnp.float32)
    dzf = dz.astype(jnp.float32)
    mag = jnp.sqrt(dxf * dxf + dyf * dyf + dzf * dzf) * scale
    g = jnp.clip(mag * jnp.float32(grad_magnitude_modifier), 0.0, 1.0)
    # R8 unorm store rounds to nearest.
    return jnp.round(g * 255.0).astype(jnp.uint8)


def gradient_at_points(volume_u8, pos_xyz, grad_magnitude_modifier=1.0):
    """On-the-fly gradient at continuous texture coords — the fragment-shader
    variant with *linear* taps (shaders/volume_render.frag:91-97). Used by the
    marcher when the precomputed map is disabled (``--gradient_test``).

    Implemented in render/sampling.py; re-exported here for API symmetry."""
    from ..render import sampling

    return sampling.gradient_on_the_fly(volume_u8, pos_xyz, grad_magnitude_modifier)
