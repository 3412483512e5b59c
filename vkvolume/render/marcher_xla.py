"""Reference-exact ray marcher as a lock-step masked XLA ``while_loop``.

This is the semantic twin of THE hot loop, ``shaders/volume_render.frag:117-336``:
per pixel, a state machine over step index ``i`` with

* empty-space skipping: when the previous sample was transparent and the ray
  has moved to a new distance-map cell, fetch the Chebyshev distance and leap
  ``i`` forward by the exact GLSL formula (:242-244) — or by one block in
  BLOCK mode (:239); on entering an occupied cell, step *backwards* by
  ``ceil(sampling_factor)`` floored at ``i_min`` (:253-261),
* trilinear sampling + transfer function + opacity correction
  ``1-(1-a)^(1/sf)`` + front-to-back premultiplied compositing (:272-287),
* early ray termination at accumulated alpha > 0.99 (:293-299),
* first-hit depth output (:315-321) and the RayEntry / RayExit /
  NumTextureSamples diagnostics (:168-173, 323-335).

XLA mapping: every ray advances one *event* per while-loop iteration, all
pixels in lock-step with per-pixel masks; the loop ends when every ray is
done. ESS shortens the iteration count for every ray. The shader ``#define``
variants (src/volume_render_subpass.cpp:56-93) are jit static arguments.

This marcher is the correctness oracle (bit-level state machine parity,
sample-count parity) and runs on every backend; the plane sweep
(sweep.py) is tested against it.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp

from ..options import SkippingType, Test
from ..tf.transfer_function import TFParams, sample_texture
from . import sampling
from .ray_setup import RaySetup

_BIG = jnp.float32(1e30)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class RenderOutput:
    color: jax.Array          # (H, W, 4) premultiplied rgba, float32
    depth: jax.Array          # (H, W) reverse-Z gl_FragDepth equivalent
    num_volume_samples: jax.Array    # (H, W) int32 (zeros unless counting)
    num_distance_samples: jax.Array  # (H, W) int32
    num_empty_samples: jax.Array     # (H, W) int32
    iterations: jax.Array     # () int32 — lock-step loop trip count (profiling)


@functools.partial(
    jax.jit,
    static_argnames=(
        "skipping_type",
        "early_ray_termination",
        "precomputed_gradient",
        "test",
        "count_samples",
        "max_iterations",
        "global_depth",
    ),
)
def march(
    volume_u8: jax.Array,              # (D, H, W) uint8
    gradient_u8: jax.Array | None,     # (D, H, W) uint8 or None
    dist_maps_u8: jax.Array | None,    # (N, mz, my, mx) uint8; N=1 iso/block, 8 aniso
    tf: TFParams,
    rays: RaySetup,
    block_size_xyz: jax.Array,         # (3,) float32 — effective block size
    proj_view_model: jax.Array,        # (4,4) proj@view@model for depth output
    tf_texture: jax.Array | None = None,   # (256,256,4) uint8 — texture TF path
    vol_origin_z=None,                 # traced scalar: slab's first global plane
    *,
    skipping_type: SkippingType = SkippingType.DISTANCE,
    early_ray_termination: bool = True,
    precomputed_gradient: bool = True,
    test: Test = Test.NONE,
    count_samples: bool = False,
    max_iterations: int = 0,           # 0 = unbounded (until all rays done)
    global_depth: int | None = None,   # volume-sharded (TP) mode: full depth
) -> RenderOutput:
    f = jnp.float32
    H, W = rays.valid.shape
    d, h, w = volume_u8.shape
    if global_depth is not None:
        # Volume-sharded mode (parallel/mesh.py:march_volume_sharded): the
        # arrays are z-slabs; every coordinate computation uses the GLOBAL
        # extent and the trilinear taps rebase into the slab.
        d = global_depth
    dims = jnp.asarray([w, h, d], f)
    dim_max = max(w, h, d)
    skip = skipping_type != SkippingType.NONE
    count = count_samples or test == Test.NUM_TEXTURE_SAMPLES

    entry = rays.entry
    ray_dir = rays.ray_dir

    # --- Tests that bypass the march (volume_render.frag:168-173) ---
    if test == Test.RAY_ENTRY or test == Test.RAY_EXIT:
        pt = entry if test == Test.RAY_ENTRY else rays.exit
        color = jnp.concatenate([pt, jnp.ones((H, W, 1), f)], -1)
        color = jnp.where(rays.valid[..., None], color, 0.0)
        zeros_i = jnp.zeros((H, W), jnp.int32)
        return RenderOutput(
            color=color,
            depth=rays.depth_init,
            num_volume_samples=zeros_i,
            num_distance_samples=zeros_i,
            num_empty_samples=zeros_i,
            iterations=jnp.int32(0),
        )

    # --- Per-ray constants (volume_render.frag:176-210) ---
    n_steps = jnp.ceil(f(dim_max) * rays.ray_distance * tf.sampling_factor).astype(
        jnp.int32
    )
    step_volume = (
        ray_dir * rays.ray_distance[..., None] / (n_steps[..., None].astype(f) - 1.0)
    )
    sampling_factor_inv = 1.0 / tf.sampling_factor

    # Performance-regression guard for edge-on views (frag:182-187).
    eet = entry + step_volume
    early_out = jnp.any(eet <= 0.0, -1) | jnp.any(eet >= 1.0, -1)

    active0 = rays.valid & ~early_out & (n_steps > 0)

    if skip:
        n_maps, mz, my, mx = dist_maps_u8.shape
        maps_flat = dist_maps_u8.reshape(-1)
        map_dims_1 = jnp.asarray([mx - 1, my - 1, mz - 1], jnp.int32)
        vol_to_map = dims / block_size_xyz
        step_dist_texel = step_volume * dims / block_size_xyz
        step_dist_texel_inv = 1.0 / step_dist_texel
        if skipping_type == SkippingType.ANISOTROPIC_DISTANCE:
            # Octant select (volume_render.frag:209).
            map_idx = (
                (ray_dir[..., 2] < 0).astype(jnp.int32)
                + 2 * (ray_dir[..., 1] < 0).astype(jnp.int32)
                + 4 * (ray_dir[..., 0] < 0).astype(jnp.int32)
            )
        else:
            map_idx = jnp.zeros((H, W), jnp.int32)
        back_step = jnp.ceil(tf.sampling_factor).astype(jnp.int32)

    use_tf_texture = tf_texture is not None

    def sample_color(pos):
        intensity = sampling.trilinear(volume_u8, pos, global_depth=global_depth,
                                       origin_z=vol_origin_z)
        if tf.use_gradient:
            if precomputed_gradient:
                gradient = sampling.trilinear(
                    gradient_u8, pos, global_depth=global_depth,
                    origin_z=vol_origin_z)
            else:
                gradient = sampling.gradient_on_the_fly(
                    volume_u8, pos, tf.grad_magnitude_modifier,
                    global_depth=global_depth, origin_z=vol_origin_z
                )
        else:
            gradient = jnp.ones_like(intensity)
        if use_tf_texture:
            rgba = sample_texture(tf_texture, intensity, gradient)
            return rgba[..., :3], rgba[..., 3]
        alpha_i = jnp.clip(
            (intensity - tf.intensity_min) * tf.intensity_range_inv, 0.0, 1.0
        )
        if tf.use_gradient:
            alpha_g = jnp.clip(
                (gradient - tf.gradient_min) * tf.gradient_range_inv, 0.0, 1.0
            )
            a = alpha_i * alpha_g
        else:
            a = alpha_i
        return jnp.stack([a, a, a], -1), a

    zeros_i = jnp.zeros((H, W), jnp.int32)
    state0 = dict(
        i=zeros_i,
        i_min=zeros_i,
        i_first_hit=n_steps,
        u_last=jnp.zeros((H, W, 3), jnp.int32),
        occupied=jnp.ones((H, W), bool),
        color=jnp.zeros((H, W, 4), f),
        done=~active0,
        n_vol=zeros_i,
        n_dist=zeros_i,
        n_empty=zeros_i,
        it=jnp.int32(0),
    )

    def cond(s):
        not_done = jnp.any(~s["done"])
        if max_iterations:
            return not_done & (s["it"] < max_iterations)
        return not_done

    def body(s):
        active = ~s["done"]
        i_f = s["i"].astype(f)
        pos = entry + i_f[..., None] * step_volume

        if skip:
            u = vol_to_map * pos
            u_i = jnp.clip(u.astype(jnp.int32), 0, map_dims_1)
            changed = jnp.any(u_i != s["u_last"], -1)
            do_skip = active & ~s["occupied"] & changed
        else:
            do_skip = jnp.zeros((H, W), bool)
            u_i = s["u_last"]

        # ---- Skip branch (volume_render.frag:224-263) ----
        if skip:
            flat_idx = (
                (map_idx * (mz) + u_i[..., 2]) * my + u_i[..., 1]
            ) * mx + u_i[..., 0]
            dist = jnp.take(maps_flat, flat_idx).astype(f)
            r = jnp.clip(u_i.astype(f) - u, -1.0, 0.0)
            inv = step_dist_texel_inv
            if skipping_type == SkippingType.BLOCK:
                delta_xyz = (jnp.where(inv >= 0.0, 1.0, 0.0) + r) * inv
            else:
                delta_xyz = (
                    jnp.where(-inv >= 0.0, 1.0, 0.0)
                    + jnp.sign(inv) * dist[..., None]
                    + r
                ) * inv
            # GLSL min() ignores NaN operands in practice; 0 * inf -> NaN here.
            delta_xyz = jnp.where(jnp.isnan(delta_xyz), _BIG, delta_xyz)
            i_delta = jnp.maximum(
                1.0, jnp.ceil(jnp.min(delta_xyz, axis=-1))
            )
            i_delta = jnp.minimum(i_delta, f(2**30)).astype(jnp.int32)
            empty = dist > 0.0

            i_skip = s["i"] + i_delta
            i_back = jnp.maximum(s["i"] - back_step, s["i_min"])
            new_i_sk = jnp.where(empty, i_skip, i_back)
            occ_sk = jnp.where(empty, s["occupied"], True)
            u_last_sk = jnp.where(
                (do_skip & ~empty)[..., None], u_i, s["u_last"]
            )
        else:
            new_i_sk = s["i"]
            occ_sk = s["occupied"]
            u_last_sk = s["u_last"]

        # ---- Sample branch (volume_render.frag:266-310) ----
        do_sample = active & ~do_skip
        rgb, a = sample_color(pos)
        occ_now = a > 0.0
        a_corr = jnp.clip(
            tf.voxel_alpha_factor * (1.0 - jnp.power(1.0 - a, sampling_factor_inv)),
            0.0,
            1.0,
        )
        src = jnp.concatenate([rgb * a_corr[..., None], a_corr[..., None]], -1)
        blend_mask = do_sample & occ_now
        new_color = jnp.where(
            blend_mask[..., None],
            s["color"] + (1.0 - s["color"][..., 3:4]) * src,
            s["color"],
        )
        i_first_hit = jnp.where(
            blend_mask & (a_corr > 0.0), s["i"], s["i_first_hit"]
        )
        full = new_color[..., 3] > 0.99
        if early_ray_termination:
            ert_now = blend_mask & full
            new_color = jnp.where(
                ert_now[..., None],
                jnp.concatenate([new_color[..., :3], jnp.ones((H, W, 1), f)], -1),
                new_color,
            )
        else:
            ert_now = jnp.zeros((H, W), bool)

        u_last_sm = jnp.where(blend_mask[..., None], u_i, u_last_sk)
        occupied = jnp.where(do_sample, occ_now, occ_sk)
        i_next = jnp.where(do_sample, s["i"] + 1, new_i_sk)
        i_min = jnp.where(do_sample, s["i"] + 1, s["i_min"])

        done = s["done"] | ert_now | (i_next >= n_steps)

        out = dict(
            i=jnp.where(active, i_next, s["i"]),
            i_min=jnp.where(active, i_min, s["i_min"]),
            i_first_hit=i_first_hit,
            u_last=jnp.where(active[..., None], u_last_sm, s["u_last"]),
            occupied=jnp.where(active, occupied, s["occupied"]),
            color=new_color,
            done=done,
            n_vol=s["n_vol"] + (do_sample & count),
            n_dist=s["n_dist"] + (do_skip & count),
            n_empty=s["n_empty"] + (do_sample & count & ~occ_now),
            it=s["it"] + 1,
        )
        return out

    state = jax.lax.while_loop(cond, body, state0)

    color = state["color"]

    # ---- Depth write (volume_render.frag:315-321) ----
    hit = (color[..., 3] > 0.0) & (state["i_first_hit"] < n_steps)
    pen_tex = entry + step_volume * state["i_first_hit"][..., None].astype(f)
    pen_model = pen_tex - 0.5
    pen_h = jnp.concatenate([pen_model, jnp.ones((H, W, 1), f)], -1)
    pen_clip = pen_h @ proj_view_model.T
    pen_depth = pen_clip[..., 2] / pen_clip[..., 3]
    depth = jnp.where(hit, pen_depth, rays.depth_init)

    if test == Test.NUM_TEXTURE_SAMPLES:
        # n_steps_max (volume_render.frag:324): uint truncation after the
        # ceil × sampling_factor product.
        n_steps_max = jnp.floor(
            jnp.ceil(f(dim_max) * jnp.sqrt(f(3.0))) * tf.sampling_factor
        )
        val = (state["n_vol"] + state["n_dist"]).astype(f) / n_steps_max
        color = jnp.concatenate(
            [jnp.stack([val, val, val], -1), jnp.ones((H, W, 1), f)], -1
        )
        color = jnp.where((rays.valid & ~early_out)[..., None], color, 0.0)

    return RenderOutput(
        color=color,
        depth=depth,
        num_volume_samples=state["n_vol"],
        num_distance_samples=state["n_dist"],
        num_empty_samples=state["n_empty"],
        iterations=state["it"],
    )
