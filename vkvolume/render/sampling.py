"""Texture sampling in XLA: trilinear volume reads, distance-map texel
fetches, on-the-fly gradients.

Replaces the Vulkan sampler hardware the reference leans on
(``texture(volume, pos)`` with a linear CLAMP_TO_EDGE sampler,
``texelFetch(distance_map, u_i, 0)`` — shaders/volume_render.frag:272, 230-232)
with explicit gathers from HBM-resident arrays:

* texel centres at ``(i + 0.5) / dim`` — sample position ``p = u*dim - 0.5``,
* CLAMP_TO_EDGE: corner indices clamped to ``[0, dim-1]``,
* R8 unorm: value = u8 / 255.

Convention: arrays are ``(D, H, W)`` (z-major); position vectors are
``(x, y, z)`` like GLSL, so axis i of ``pos`` indexes array axis ``2 - i``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def _flat(volume: jax.Array):
    d, h, w = volume.shape
    return volume.reshape(-1), (d, h, w)


def trilinear(volume_u8: jax.Array, pos_xyz: jax.Array,
              global_depth: int | None = None,
              origin_z=None) -> jax.Array:
    """``texture(volume, pos).x`` — trilinear unorm sample, float in [0, 1].

    pos_xyz: (..., 3) texture coordinates.

    Volume-sharded (TP) mode: ``volume_u8`` is a z-slab of a
    ``global_depth``-deep volume whose first local plane is global plane
    ``origin_z`` (traced scalar). Coordinates and CLAMP_TO_EDGE clamping use
    the GLOBAL depth; tap indices are then rebased into the slab. Positions
    whose taps fall outside the slab (callers clamp rays to the slab's
    z-interval, so only masked lanes do) clamp to the slab edge — in-bounds
    garbage, never a fault.
    """
    flat, (d, h, w) = _flat(volume_u8)
    D = d if global_depth is None else global_depth
    dims = jnp.asarray([w, h, D], jnp.float32)
    p = pos_xyz * dims - 0.5
    i0f = jnp.floor(p)
    frac = p - i0f
    i0 = i0f.astype(jnp.int32)
    i1 = i0 + 1
    i0 = jnp.clip(i0, 0, jnp.asarray([w - 1, h - 1, D - 1], jnp.int32))
    i1 = jnp.clip(i1, 0, jnp.asarray([w - 1, h - 1, D - 1], jnp.int32))

    x0, y0, z0 = i0[..., 0], i0[..., 1], i0[..., 2]
    x1, y1, z1 = i1[..., 0], i1[..., 1], i1[..., 2]
    fx, fy, fz = frac[..., 0], frac[..., 1], frac[..., 2]
    if origin_z is not None:
        z0 = jnp.clip(z0 - origin_z, 0, d - 1)
        z1 = jnp.clip(z1 - origin_z, 0, d - 1)

    def tap(z, y, x):
        idx = (z * h + y) * w + x
        return jnp.take(flat, idx).astype(jnp.float32)

    c000 = tap(z0, y0, x0)
    c001 = tap(z0, y0, x1)
    c010 = tap(z0, y1, x0)
    c011 = tap(z0, y1, x1)
    c100 = tap(z1, y0, x0)
    c101 = tap(z1, y0, x1)
    c110 = tap(z1, y1, x0)
    c111 = tap(z1, y1, x1)

    c00 = c000 + (c001 - c000) * fx
    c01 = c010 + (c011 - c010) * fx
    c10 = c100 + (c101 - c100) * fx
    c11 = c110 + (c111 - c110) * fx
    c0 = c00 + (c01 - c00) * fy
    c1 = c10 + (c11 - c10) * fy
    c = c0 + (c1 - c0) * fz
    return c * jnp.float32(1.0 / 255.0)


def texel_fetch(map_u8: jax.Array, u_i_xyz: jax.Array) -> jax.Array:
    """``texelFetch(map, u_i, 0).x`` — integer texel read (indices pre-clamped)."""
    flat, (d, h, w) = _flat(map_u8)
    idx = (u_i_xyz[..., 2] * h + u_i_xyz[..., 1]) * w + u_i_xyz[..., 0]
    return jnp.take(flat, idx)


def gradient_on_the_fly(
    volume_u8: jax.Array, pos_xyz: jax.Array, grad_magnitude_modifier,
    global_depth: int | None = None, origin_z=None
) -> jax.Array:
    """Fragment-shader on-the-fly gradient via 4 *linear* taps at
    ``pos + dim_inv * k`` (shaders/volume_render.frag:91-97)."""
    d, h, w = volume_u8.shape
    D = d if global_depth is None else global_depth
    dim_inv = jnp.asarray([1.0 / w, 1.0 / h, 1.0 / D], jnp.float32)
    taps = jnp.asarray(
        [[1, -1, -1], [-1, -1, 1], [-1, 1, -1], [1, 1, 1]], jnp.float32
    )
    acc = jnp.zeros(pos_xyz.shape[:-1] + (3,), jnp.float32)
    for k in range(4):
        v = trilinear(volume_u8, pos_xyz + dim_inv * taps[k],
                      global_depth=global_depth, origin_z=origin_z)
        acc = acc + taps[k] * v[..., None]
    g = jnp.linalg.norm(acc * 0.25, axis=-1) * grad_magnitude_modifier
    return jnp.clip(g, 0.0, 1.0)
