"""Plane-sweep renderer — the XLA plane sweep.

The reference's per-pixel ray march (volume_render.frag:212-312) is a
gather-per-sample loop with a per-ray trip count. This renderer restructures
it: rays are advanced through **slabs perpendicular to the dominant axis of
the view**, one slab per step, all pixels at once:

* Per slab, the two source voxel planes are sliced contiguously; sampling
  every ray against them is a bilinear gather from that two-plane table
  plus one lerp along the principal axis. Same 8-tap trilinear
  reconstruction, same CLAMP_TO_EDGE unorm sampler semantics as the
  reference.
* Opacity correction becomes per-ray-exact via the segment-length exponent:
  the reference corrects ``1-(1-a)^(1/sf)`` for step ``1/(dim_max*sf)``
  (volume_render.frag:283); a sweep step crosses ``Δs/|d_p|`` of ray length,
  so the exponent is ``κ(r) = dim_max * Δs / |d_p(r)|`` — the identical
  correction law, applied to the slab geometry.
* **Empty-space skipping** maps to slab skipping driven by the same
  occupancy map: a slab whose two source planes contain no voxel with
  alpha > 0 contributes exactly zero to every ray, so skipping it is
  *exact for intensity-only TFs* (interpolation from all-zero-alpha
  corners is zero-alpha when alpha is a monotone map of one interpolated
  field) — the sweep's analogue of distance-map leaping
  (distance_map.comp), with the same TF-edit → occupancy rebuild
  dependency. For gradient-modulated 2D TFs the guarantee weakens to
  sampling tolerance: corners may each fail a *different* gate
  (intensity vs gradient) while the interpolated sample passes both;
  tests bound the skip-vs-noskip error for that case.
* **Early ray termination** (volume_render.frag:293-299) becomes a chunked
  while-loop: march 16-slab chunks until every covered ray saturates.

Differences vs the exact marcher (marcher_xla.py): sample positions lie on
slab planes rather than uniformly along each ray, so images agree to normal
sampling tolerance (≈1-2 u8 LSB), not bit-exactly; the per-ray sample-count
diagnostics count slab samples. The marcher remains the parity oracle.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..options import Test
from ..tf.transfer_function import TFParams, sample_texture
from .marcher_xla import RenderOutput
from .ray_setup import FrameUniforms, RaySetup

# Axis permutations: for principal axis p (0=x, 1=y, 2=z), the slab planes
# are indexed by p and the in-plane (row, col) axes are (v, u) in xyz terms.
#   p=z: rows=y, cols=x ; p=y: rows=z, cols=x ; p=x: rows=z, cols=y
_SLICE_AXES = {2: (1, 0), 1: (2, 0), 0: (2, 1)}  # p -> (v_axis, u_axis)


def principal_axis(rays: RaySetup) -> int:
    """Dominant |component| of the mean ray direction (host-side, per frame)."""
    import numpy as np

    d = np.asarray(rays.ray_dir)
    valid = np.asarray(rays.valid)
    if valid.any():
        mean = d[valid].mean(axis=0)
    else:
        mean = np.array([0.0, 0.0, 1.0])
    return int(np.argmax(np.abs(mean)))  # 0=x, 1=y, 2=z


def mixed_principal_signs(rays: RaySetup, p: int) -> bool:
    """True when valid rays disagree on the sign of d[p] (host-side).

    The sweep iterates slabs in one global order; rays whose principal-axis
    direction component has the opposite sign would be composited
    back-to-front, which is wrong for over-blending and ERT. Such frames
    (camera inside the volume with a wide FOV straddling the axis) must
    fall back to the per-ray marcher.
    """
    import numpy as np

    d = np.asarray(rays.ray_dir)[..., p]
    valid = np.asarray(rays.valid) & (np.abs(d) > 1e-6)
    if not valid.any():
        return False
    dv = d[valid]
    return bool((dv > 0).any() and (dv < 0).any())


def transpose_for_axis(volume_zyx: jax.Array, p: int) -> jax.Array:
    """(D,H,W) u8 → (Np, Sv, Su) with the principal axis leading."""
    if p == 2:
        return volume_zyx                      # (D, H, W): rows=y cols=x
    if p == 1:
        return volume_zyx.transpose(1, 0, 2)   # (H, D, W): rows=z cols=x
    return volume_zyx.transpose(2, 0, 1)       # (W, D, H): rows=z cols=y


@functools.partial(
    jax.jit,
    static_argnames=(
        "p_axis",
        "skipping",
        "early_ray_termination",
        "test",
        "chunk",
        "oversample",
    ),
)
def sweep(
    vol_t: jax.Array,                # (Np, Sv, Su) uint8, principal-axis-major
    grad_t: jax.Array | None,        # same layout or None
    occupancy_t: jax.Array | None,   # (mp, mv, mu) uint8 occupancy, same perm
    tf: TFParams,
    rays: RaySetup,
    uniforms: FrameUniforms,
    proj_view_model: jax.Array,
    tf_texture: jax.Array | None = None,
    *,
    p_axis: int = 2,
    skipping: bool = True,
    early_ray_termination: bool = True,
    test: Test = Test.NONE,
    chunk: int = 16,
    oversample: float = 1.0,
) -> RenderOutput:
    f = jnp.float32
    H, W = rays.valid.shape
    Np, Sv, Su = vol_t.shape
    v_ax, u_ax = _SLICE_AXES[p_axis]
    dim_max = max(Np, Sv, Su)

    if test in (Test.RAY_ENTRY, Test.RAY_EXIT):
        pt = rays.entry if test == Test.RAY_ENTRY else rays.exit
        color = jnp.concatenate([pt, jnp.ones((H, W, 1), f)], -1)
        color = jnp.where(rays.valid[..., None], color, 0.0)
        zi = jnp.zeros((H, W), jnp.int32)
        return RenderOutput(color, rays.depth_init, zi, zi, zi, jnp.int32(0))

    d = rays.ray_dir
    d_p = d[..., p_axis]
    d_u = d[..., u_ax]
    d_v = d[..., v_ax]
    o = uniforms.cam_pos_tex
    o_p, o_u, o_v = o[p_axis], o[u_ax], o[v_ax]

    # Ray parameterised by principal coordinate s: pos = o + (d/d_p)·(s-o_p).
    sgn = jnp.sign(jnp.sum(jnp.where(rays.valid, d_p, 0.0)))
    sgn = jnp.where(sgn == 0.0, 1.0, sgn)
    safe_dp = jnp.where(jnp.abs(d_p) < 1e-6, jnp.where(d_p < 0, -1e-6, 1e-6), d_p)
    w_u = d_u / safe_dp
    w_v = d_v / safe_dp

    # Per-ray active s interval from the exact entry/exit points.
    s_a = rays.entry[..., p_axis]
    s_b = rays.exit[..., p_axis]
    s_lo = jnp.minimum(s_a, s_b)
    s_hi = jnp.maximum(s_a, s_b)
    # Rays whose d_p sign opposes the global slab order would composite
    # back-to-front — exclude them (the engine detects mixed-sign frames
    # host-side via mixed_principal_signs and falls back to the marcher).
    covered = rays.valid & (jnp.abs(d_p) > 1e-6) & (jnp.sign(d_p) == sgn)

    # Sampling grid along s and the opacity-correction exponent.
    n_slabs = int(max(2, round(Np * oversample)))
    ds = 1.0 / n_slabs
    kappa = f(dim_max) * ds / jnp.abs(safe_dp)

    # Front-to-back slab order depends on the sign of d_p.
    ks = jnp.arange(n_slabs, dtype=jnp.int32)
    order = jnp.where(sgn > 0, ks, n_slabs - 1 - ks)

    # Slab-level ESS: a slab whose source planes hold no alpha>0 voxel
    # contributes zero everywhere (exact; see module docstring).
    if skipping and occupancy_t is not None:
        mp = occupancy_t.shape[0]
        plane_occ = jnp.any(occupancy_t == 0, axis=(1, 2))  # (mp,) per map slab
        bp = -(-Np // mp)  # effective block size along p

        def slab_occupied(k0):
            m0 = jnp.clip(k0 // bp, 0, mp - 1)
            m1 = jnp.clip((k0 + 1) // bp, 0, mp - 1)
            return plane_occ[m0] | plane_occ[m1]
    else:
        def slab_occupied(k0):
            return jnp.bool_(True)

    use_tf_texture = tf_texture is not None

    def tf_color(intensity, gradient):
        if use_tf_texture:
            rgba = sample_texture(tf_texture, intensity, gradient)
            return rgba[..., :3], rgba[..., 3]
        a_i = jnp.clip((intensity - tf.intensity_min) * tf.intensity_range_inv,
                       0.0, 1.0)
        if tf.use_gradient:
            a_g = jnp.clip((gradient - tf.gradient_min) * tf.gradient_range_inv,
                           0.0, 1.0)
            a = a_i * a_g
        else:
            a = a_i
        return jnp.stack([a, a, a], -1), a

    grad_stack = grad_t if (tf.use_gradient and grad_t is not None) else None

    def sample_slab(k_idx):
        """Trilinear sample of every ray against slab k (2-plane table)."""
        s_k = (k_idx.astype(f) + 0.5) * ds
        zp = s_k * Np - 0.5
        k0 = jnp.clip(jnp.floor(zp).astype(jnp.int32), 0, Np - 2)
        fp = jnp.clip(zp - k0.astype(f), 0.0, 1.0)

        planes = jax.lax.dynamic_slice(vol_t, (k0, 0, 0), (2, Sv, Su))
        flat = planes.reshape(-1)

        t = s_k - o_p
        qu = (o_u + w_u * t) * Su - 0.5
        qv = (o_v + w_v * t) * Sv - 0.5
        iu0 = jnp.clip(jnp.floor(qu).astype(jnp.int32), 0, Su - 1)
        iv0 = jnp.clip(jnp.floor(qv).astype(jnp.int32), 0, Sv - 1)
        iu1 = jnp.minimum(iu0 + 1, Su - 1)
        iv1 = jnp.minimum(iv0 + 1, Sv - 1)
        fu = jnp.clip(qu - jnp.floor(qu), 0.0, 1.0)
        fv = jnp.clip(qv - jnp.floor(qv), 0.0, 1.0)

        def bilerp(base):
            i00 = base + iv0 * Su + iu0
            i01 = base + iv0 * Su + iu1
            i10 = base + iv1 * Su + iu0
            i11 = base + iv1 * Su + iu1
            c00 = jnp.take(flat, i00).astype(f)
            c01 = jnp.take(flat, i01).astype(f)
            c10 = jnp.take(flat, i10).astype(f)
            c11 = jnp.take(flat, i11).astype(f)
            c0 = c00 + (c01 - c00) * fu
            c1 = c10 + (c11 - c10) * fu
            return c0 + (c1 - c0) * fv

        plane_sz = Sv * Su
        val = bilerp(0) + (bilerp(plane_sz) - bilerp(0)) * fp
        intensity = val * f(1.0 / 255.0)

        if grad_stack is not None:
            gplanes = jax.lax.dynamic_slice(grad_stack, (k0, 0, 0), (2, Sv, Su))
            gflat = gplanes.reshape(-1)

            def gbilerp(base):
                i00 = base + iv0 * Su + iu0
                i01 = base + iv0 * Su + iu1
                i10 = base + iv1 * Su + iu0
                i11 = base + iv1 * Su + iu1
                c00 = jnp.take(gflat, i00).astype(f)
                c01 = jnp.take(gflat, i01).astype(f)
                c10 = jnp.take(gflat, i10).astype(f)
                c11 = jnp.take(gflat, i11).astype(f)
                c0 = c00 + (c01 - c00) * fu
                c1 = c10 + (c11 - c10) * fu
                return c0 + (c1 - c0) * fv

            gval = gbilerp(0) + (gbilerp(plane_sz) - gbilerp(0)) * fp
            gradient = gval * f(1.0 / 255.0)
        else:
            gradient = jnp.ones((H, W), f)
        return s_k, intensity, gradient

    def composite(state, k_idx):
        color, first_s, n_samp, done = state

        def do(_):
            s_k, intensity, gradient = sample_slab(k_idx)
            rgb, a = tf_color(intensity, gradient)
            in_range = covered & (s_k >= s_lo) & (s_k <= s_hi) & ~done
            # Opacity correction with the per-ray segment exponent
            # (reference law, volume_render.frag:283).
            a_corr = jnp.clip(
                tf.voxel_alpha_factor
                * (1.0 - jnp.power(1.0 - a, kappa)),
                0.0, 1.0,
            )
            contrib = in_range & (a > 0.0)
            src = jnp.concatenate(
                [rgb * a_corr[..., None], a_corr[..., None]], -1
            )
            new_color = jnp.where(
                contrib[..., None],
                color + (1.0 - color[..., 3:4]) * src,
                color,
            )
            hit = contrib & (a_corr > 0.0) & (first_s > 1.5)
            new_first = jnp.where(hit, s_k, first_s)
            full = new_color[..., 3] > 0.99
            if early_ray_termination:
                new_done = done | (contrib & full)
                new_color = jnp.where(
                    (contrib & full)[..., None],
                    jnp.concatenate(
                        [new_color[..., :3], jnp.ones((H, W, 1), f)], -1
                    ),
                    new_color,
                )
            else:
                new_done = done
            return new_color, new_first, n_samp + in_range, new_done

        k0 = jnp.clip(
            jnp.floor((k_idx.astype(f) + 0.5) * ds * Np - 0.5).astype(jnp.int32),
            0, Np - 2,
        )
        return jax.lax.cond(
            slab_occupied(k0), do, lambda _: state, operand=None
        ), None

    init = (
        jnp.zeros((H, W, 4), f),
        jnp.full((H, W), 2.0, f),          # sentinel > 1.5 = no hit yet
        jnp.zeros((H, W), jnp.int32),
        jnp.zeros((H, W), bool),
    )

    n_chunks = -(-n_slabs // chunk)
    pad = n_chunks * chunk - n_slabs
    order_p = jnp.concatenate([order, jnp.full((pad,), -1, jnp.int32)])

    def chunk_body(loop_state):
        ci, state = loop_state
        ks_chunk = jax.lax.dynamic_slice_in_dim(order_p, ci * chunk, chunk)

        def scan_step(st, k_idx):
            return jax.lax.cond(
                k_idx >= 0,
                lambda _: composite(st, k_idx)[0],
                lambda _: st,
                operand=None,
            ), None

        state, _ = jax.lax.scan(scan_step, state, ks_chunk)
        return ci + 1, state

    def chunk_cond(loop_state):
        ci, state = loop_state
        more = ci < n_chunks
        if early_ray_termination:
            _, _, _, done = state
            live = jnp.any(covered & ~done)
            return more & live
        return more

    _, (color, first_s, n_samp, _) = jax.lax.while_loop(
        chunk_cond, chunk_body, (jnp.int32(0), init)
    )

    # Depth from the first contributing slab (reverse-Z, like the marcher).
    hit = (color[..., 3] > 0.0) & (first_s < 1.5)
    t_hit = first_s - o_p
    pen_xyz = [None, None, None]
    pen_xyz[p_axis] = first_s
    pen_xyz[u_ax] = o_u + w_u * t_hit
    pen_xyz[v_ax] = o_v + w_v * t_hit
    pen = jnp.stack(pen_xyz, -1) - 0.5
    pen_h = jnp.concatenate([pen, jnp.ones((H, W, 1), f)], -1)
    pen_clip = pen_h @ proj_view_model.T
    pen_depth = pen_clip[..., 2] / jnp.where(pen_clip[..., 3] == 0, 1.0,
                                             pen_clip[..., 3])
    depth = jnp.where(hit, pen_depth, rays.depth_init)

    if test == Test.NUM_TEXTURE_SAMPLES:
        n_steps_max = jnp.floor(
            jnp.ceil(f(dim_max) * jnp.sqrt(f(3.0))) * tf.sampling_factor
        )
        val = n_samp.astype(f) / n_steps_max
        color = jnp.concatenate(
            [jnp.stack([val, val, val], -1), jnp.ones((H, W, 1), f)], -1
        )
        color = jnp.where(covered[..., None], color, 0.0)

    zi = jnp.zeros((H, W), jnp.int32)
    return RenderOutput(
        color=color,
        depth=depth,
        num_volume_samples=n_samp,
        num_distance_samples=zi,
        num_empty_samples=zi,
        iterations=jnp.int32(n_slabs),
    )
