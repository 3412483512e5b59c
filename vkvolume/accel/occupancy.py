"""Occupancy map + occupied-voxel count as jitted XLA block reductions.

Twin of ``shaders/occupancy_map.comp:45-73`` (per map cell: any voxel in its
block with TF alpha > 0 → OCCUPIED=0 else EMPTY=255) and of the
``occupied_voxel_count`` subgroup-reduction pair
(``shaders/occupied_voxel_count.comp`` / ``..._reduce.comp`` +
``src/compute_occupied_voxel_count.cpp:28-156``), which in XLA is a single
fused reduction — the int64/subgroup machinery has no equivalent work.

Shape of the computation: per-voxel alpha>0 as a fused elementwise op, padded
to a block multiple with False, reshaped to (mz, bz, my, by, mx, bx) and
``jnp.any`` over block axes — XLA lowers this to one fused reduction.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..tf.transfer_function import TFParams

OCCUPIED = 0
EMPTY = 255


def map_extent(extent_xyz, block_size: int):
    """Occupancy/distance map extent = ceil(extent / block_size) per axis
    (reference: src/volume_component.cpp:91-92)."""
    return tuple(-(-e // block_size) for e in extent_xyz)


def effective_block_size(extent_xyz, map_extent_xyz):
    """Per-axis block size recomputed from the map extent,
    ``rndUp(volume_extent, map_extent)`` (reference:
    src/compute_distance_map.cpp:107-113 and src/volume_render_subpass.cpp:245-249).
    May differ from the nominal block size (e.g. extent 9, bs 4 → map 3, eff 3).
    """
    return tuple(-(-e // m) for e, m in zip(extent_xyz, map_extent_xyz))


def voxel_alpha_positive(
    volume_u8: jax.Array,
    gradient_u8: jax.Array | None,
    tf: TFParams,
) -> jax.Array:
    """Per-voxel ``get_color(intensity, gradient).a > 0`` boolean field.

    Matches occupancy_map.comp:61-64 with the closed-form TF
    (transfer_function.glsl:40-43): alpha>0 iff alpha_i>0 and alpha_g>0.
    ``gradient_u8=None`` means on-the-fly gradients (the compute-shader
    integer-tap variant, get_gradient_compute.glsl:12-20).
    """
    intensity = volume_u8.astype(jnp.float32) * jnp.float32(1.0 / 255.0)
    alpha_i = jnp.clip(
        (intensity - tf.intensity_min) * tf.intensity_range_inv, 0.0, 1.0
    )
    if not tf.use_gradient:
        return alpha_i > 0.0
    if gradient_u8 is None:
        from .gradient import gradient_map

        gradient_u8 = gradient_map(
            volume_u8, tf.grad_magnitude_modifier, use_gradient=True
        )
    gradient = gradient_u8.astype(jnp.float32) * jnp.float32(1.0 / 255.0)
    alpha_g = jnp.clip(
        (gradient - tf.gradient_min) * tf.gradient_range_inv, 0.0, 1.0
    )
    return (alpha_i > 0.0) & (alpha_g > 0.0)


def alpha_positive_threshold(lo: float, inv: float) -> int | None:
    """Smallest uint8 value v whose closed-form TF term is positive:
    ``clip((f32(v) * (1/255) - lo) * inv, 0, 1) > 0``  — evaluated per u8
    value with the IDENTICAL float32 arithmetic the device kernel uses, so
    thresholded integer comparisons are bit-exact. Returns 256 when no value
    is positive and None when the positive set is not of the form
    ``{v : v >= T}`` (e.g. inverted ranges) — callers then use the general
    float path."""
    v = np.arange(256, dtype=np.float32)
    a = np.clip((v * np.float32(1.0 / 255.0) - np.float32(lo))
                * np.float32(inv), np.float32(0.0), np.float32(1.0))
    pos = a > 0.0
    if not pos.any():
        return 256
    first = int(np.argmax(pos))
    return first if bool(pos[first:].all()) else None


def _tf_thresholds(tf: TFParams, tf_host=None):
    """(ti, tg) uint8 thresholds for the fast integer path, or None when
    unavailable (traced TF params without host values, or non-monotone).

    ``tf_host`` = (imin, imax, gmin, gmax) as python floats lets callers
    (the engine, which owns the slider values) derive the thresholds with
    ZERO device round-trips — reading the committed TF scalars back
    waits behind the whole device queue."""
    if tf_host is not None:
        imin, imax, gmin, gmax = tf_host
        # Replicate tf_params' f32 derivation bit-exactly
        # (tf/transfer_function.py:54-67).
        ti = alpha_positive_threshold(
            float(np.float32(imin)), float(np.float32(1.0 / (imax - imin))))
        if ti is None:
            return None
        tg = 0
        if gmax != gmin:
            tg = alpha_positive_threshold(
                float(np.float32(gmin)),
                float(np.float32(1.0 / (gmax - gmin))))
            if tg is None:
                return None
        return ti, tg
    for leaf in (tf.intensity_min, tf.intensity_range_inv,
                 tf.gradient_min, tf.gradient_range_inv):
        if isinstance(leaf, jax.core.Tracer):
            return None
    ti = alpha_positive_threshold(float(tf.intensity_min),
                                  float(tf.intensity_range_inv))
    if ti is None:
        return None
    tg = 0
    if tf.use_gradient:
        tg = alpha_positive_threshold(float(tf.gradient_min),
                                      float(tf.gradient_range_inv))
        if tg is None:
            return None
    return ti, tg


def _block_max_u8(a: jax.Array, map_shape_zyx) -> jax.Array:
    """Separable per-block uint8 max (zero-padded; 0 is neutral for max)."""
    mz, my, mx = map_shape_zyx
    d, h, w = a.shape
    bz, by, bx = (-(-d // mz), -(-h // my), -(-w // mx))
    a = jnp.pad(a, ((0, mz * bz - d), (0, my * by - h), (0, mx * bx - w)))
    a = a.reshape(mz, bz, my * by, mx * bx).max(axis=1)
    a = a.reshape(mz, my, by, mx * bx).max(axis=2)
    return a.reshape(mz, my, mx, bx).max(axis=3)


@functools.partial(jax.jit, static_argnames=("map_shape_zyx",))
def _occupancy_u8(volume_u8, gradient_u8, map_shape_zyx, ti, tg):
    """Integer-domain occupancy: any(alpha>0) per block == thresholded
    per-block max (max is monotone; the AND of two per-voxel window tests
    needs the mask-then-max form). ``ti``/``tg`` are TRACED int32 scalars
    (0..256) — TF slider edits do not retrigger compilation; 256 ("no u8
    value positive") folds in via the ``valid`` masks."""
    ti = jnp.asarray(ti, jnp.int32)
    tg = jnp.asarray(tg, jnp.int32)
    ti_u8 = jnp.minimum(ti, 255).astype(jnp.uint8)
    tg_u8 = jnp.minimum(tg, 255).astype(jnp.uint8)
    valid = (ti <= 255) & (tg <= 255)
    if gradient_u8 is None:
        occ = _block_max_u8(volume_u8, map_shape_zyx) >= ti_u8
    else:
        mask = ((volume_u8 >= ti_u8)
                & (gradient_u8 >= tg_u8)).astype(jnp.uint8)
        occ = _block_max_u8(mask, map_shape_zyx) >= jnp.uint8(1)
    return jnp.where(occ & valid, jnp.uint8(OCCUPIED), jnp.uint8(EMPTY))


@functools.partial(jax.jit, static_argnames=("map_shape_zyx", "on_the_fly_gradient"))
def _occupancy_general(
    volume_u8: jax.Array,
    gradient_u8: jax.Array | None,
    tf: TFParams,
    map_shape_zyx: tuple[int, int, int],
    on_the_fly_gradient: bool = False,
) -> jax.Array:
    """General float path (traced TF params / non-monotone ranges)."""
    if on_the_fly_gradient:
        gradient_u8 = None
    occ_bool = voxel_alpha_positive(volume_u8, gradient_u8, tf)
    any_occ = _block_max_u8(occ_bool.astype(jnp.uint8),
                            map_shape_zyx) >= jnp.uint8(1)
    return jnp.where(any_occ, jnp.uint8(OCCUPIED), jnp.uint8(EMPTY))


def occupancy_map(
    volume_u8: jax.Array,
    gradient_u8: jax.Array | None,
    tf: TFParams,
    map_shape_zyx: tuple[int, int, int],
    on_the_fly_gradient: bool = False,
    tf_host=None,
) -> jax.Array:
    """uint8 occupancy map of shape ``map_shape_zyx``: OCCUPIED=0 / EMPTY=255.

    Fast path: the closed-form ``alpha > 0`` test is monotone in the u8
    intensity (and gradient), so the per-block ``any`` collapses to a
    per-block u8 max + one integer comparison — a pure-integer streaming
    reduction (no f32 blowup of the 10^8-voxel volume). The thresholds are
    derived on the host with the same f32 arithmetic (bit-exact); traced TF
    params fall back to the general float path."""
    if on_the_fly_gradient:
        gradient_u8 = None
    thr = _tf_thresholds(tf, tf_host)
    if thr is not None:
        ti, tg = thr
        if tf.use_gradient and gradient_u8 is None:
            from .gradient import gradient_map

            gradient_u8 = gradient_map(
                volume_u8, tf.grad_magnitude_modifier, use_gradient=True
            )
        return _occupancy_u8(volume_u8,
                             gradient_u8 if tf.use_gradient else None,
                             map_shape_zyx, ti, tg)
    return _occupancy_general(volume_u8, gradient_u8, tf, map_shape_zyx,
                              on_the_fly_gradient=on_the_fly_gradient)


@jax.jit
def _count_u8(volume_u8, gradient_u8, ti, tg):
    ti = jnp.asarray(ti, jnp.int32)
    tg = jnp.asarray(tg, jnp.int32)
    valid = (ti <= 255) & (tg <= 255)
    occ = (volume_u8 >= jnp.minimum(ti, 255).astype(jnp.uint8)) & valid
    if gradient_u8 is not None:
        occ &= gradient_u8 >= jnp.minimum(tg, 255).astype(jnp.uint8)
    # Per-slice int32 partials (a slice is < 2^31 voxels); the host sums
    # them in arbitrary precision — the int64 totals the reference's
    # subgroup reduction guarantees (occupied_voxel_count.comp, shaderInt64)
    # without requiring jax x64 mode.
    return jnp.sum(occ, axis=(1, 2), dtype=jnp.int32)


@functools.partial(jax.jit, static_argnames=("on_the_fly_gradient",))
def _count_general(
    volume_u8: jax.Array,
    gradient_u8: jax.Array | None,
    tf: TFParams,
    on_the_fly_gradient: bool = False,
) -> jax.Array:
    if on_the_fly_gradient:
        gradient_u8 = None
    occ = voxel_alpha_positive(volume_u8, gradient_u8, tf)
    # Sum in int32 per z-slice then widen: max volume ~1024^3 > int32? A
    # single slice is < 2^31; the final sum may exceed int32 for >2G voxels —
    # accumulate slices in float64-free int64 via jnp.sum dtype promotion.
    return jnp.sum(occ, dtype=jnp.int64 if jax.config.jax_enable_x64 else jnp.int32)


def occupied_voxel_count(
    volume_u8: jax.Array,
    gradient_u8: jax.Array | None,
    tf: TFParams,
    on_the_fly_gradient: bool = False,
    tf_host=None,
) -> jax.Array:
    """Total number of voxels with TF alpha > 0. Diagnostic printed as
    `Occupied voxels: X%` (reference: src/volume_render.cpp:399-418).
    Integer fast path under the same exactness argument as occupancy_map."""
    if on_the_fly_gradient:
        gradient_u8 = None
    thr = _tf_thresholds(tf, tf_host)
    if thr is not None:
        ti, tg = thr
        if tf.use_gradient and gradient_u8 is None:
            from .gradient import gradient_map

            gradient_u8 = gradient_map(
                volume_u8, tf.grad_magnitude_modifier, use_gradient=True
            )
        slices = _count_u8(volume_u8,
                           gradient_u8 if tf.use_gradient else None, ti, tg)
        return int(np.asarray(slices, dtype=np.int64).sum())
    return _count_general(volume_u8, gradient_u8, tf,
                          on_the_fly_gradient=on_the_fly_gradient)
