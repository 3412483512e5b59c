"""Engine — the application orchestrator.

Functional replacement for ``VolumeRender`` (src/volume_render.cpp:99-445):
owns the volumes, their acceleration structures and the render options;
tracks which structures are stale after option edits (the reference's
TF-slider → ``update_transfer_function`` → occupancy + distance rebuild path,
src/volume_render.cpp:392-445 and draw_gui :447-547); and drives per-frame
rendering. Vulkan instance/device/swapchain/fence management collapses into
jit dispatch + ``block_until_ready``.
"""

from __future__ import annotations

import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np

from ..accel.distance import anisotropic_distance, isotropic_distance
from ..accel.gradient import gradient_map
from ..accel.occupancy import occupied_voxel_count
from ..render.marcher_xla import RenderOutput, march
from ..render.ray_setup import make_rays, make_uniforms
from ..tf.transfer_function import bake_texture, tf_params
from ..options import RenderOptions, SkippingType, Test
from .volume import Volume


import functools


@jax.jit
def _octant_composite(maps, kz, ky, kx):
    """Per-cell octant-selected skip map for a pinhole camera.

    The reference selects the distance map per RAY by the ray's direction
    octant (volume_render.frag:209, binding of 8 maps at
    volume_render_subpass.cpp:273-284). For a pinhole camera the direction
    of the ray through any point c is c - cam, so the selected octant is a
    pure function of WHICH SIDE of the camera's three axis planes the
    sample lies on: idx = (z<kz) + 2*(y<ky) + 4*(x<kx) (the map convention
    idx = (dz<0) + 2*(dy<0) + 4*(dx<0), accel/distance.py:178). Stitching
    the 8 maps along those planes therefore reproduces the reference's
    per-ray selection EXACTLY — for every ray at once, with no kernel
    change — as 7 where-combines instead of a per-element gather.

    ``maps`` is the (8, mz, my, mx) u8 stack; ``kz/ky/kx`` the camera
    position in MAP-CELL coordinates per axis (voxel / block_size). A map
    cell whose voxel extent straddles a camera plane carries rays of both
    direction signs; that one-cell layer takes the elementwise min of the
    two sides (conservative, identical occupied set)."""
    def combine(a, b, n, k, axis):
        # a = map for coord < plane (d<0 bit set), b = for coord >= plane.
        shape = [1, 1, 1]
        shape[axis] = n
        c = jnp.arange(n).reshape(shape)
        kc = jnp.floor(k).astype(jnp.int32)
        out = jnp.where(c < kc, a, b)
        return jnp.where(c == kc, jnp.minimum(a, b), out)

    mz, my, mx = maps.shape[1:]
    # idx = 4*bx + 2*by + bz; combine z pairs, then y, then x.
    z = [combine(maps[i + 1], maps[i], mz, kz, 0) for i in (0, 2, 4, 6)]
    y = [combine(z[2 * j + 1], z[2 * j], my, ky, 1) for j in (0, 1)]
    return combine(y[1], y[0], mx, kx, 2)


@functools.partial(jax.jit, static_argnames=("map_shape_zyx", "st",
                                             "on_the_fly", "fast"))
def _build_maps_fused(density, gradient, tf, ti, tg, *, map_shape_zyx, st,
                      on_the_fly, fast):
    """Occupancy + distance transform as ONE device program.

    The TF-edit update path dispatches this once per build: the reference's
    5-run benchmark protocol (volume_render.cpp:421-430) then costs one
    dispatch per run instead of one per kernel launch.

    ``fast`` selects the integer-threshold occupancy with TRACED (ti, tg)
    — the thresholds are host-derived (accel/occupancy._tf_thresholds with
    tf_host) because inside jit the TF leaves are tracers, and a TF slider
    edit must retrigger neither a threshold read-back nor a recompile.

    BLOCK uses the occupancy map directly; NONE keeps it for diagnostics
    (the reference also computes it, then skips the distance passes —
    src/compute_distance_map.cpp:96-99)."""
    from ..accel.occupancy import _occupancy_general, _occupancy_u8

    if fast:
        g = None if on_the_fly else gradient
        if tf.use_gradient and g is None:
            g = gradient_map(density, tf.grad_magnitude_modifier,
                             use_gradient=True)
        occ = _occupancy_u8(density, g if tf.use_gradient else None,
                            map_shape_zyx, ti, tg)
    else:
        occ = _occupancy_general(density, gradient, tf, map_shape_zyx,
                                 on_the_fly_gradient=on_the_fly)
    if st not in (SkippingType.DISTANCE, SkippingType.ANISOTROPIC_DISTANCE):
        return occ[None]
    return (isotropic_distance(occ)[None] if st == SkippingType.DISTANCE
            else anisotropic_distance(occ))


@dataclasses.dataclass
class UpdateStats:
    """Metrics contract of the reference log lines that benchmark.py scrapes
    (src/volume_render.cpp:418, 430).

    ``map_update_ms`` semantics depend on the engine mode: in benchmark
    mode it is the synced per-build device time (comparable to the
    reference's timed 5-build average); in interactive mode the builds
    stay QUEUED (the reference records dispatches with no CPU readback
    between a TF edit and the next draw, volume_render.cpp:392-445), so
    it reports async dispatch cost only — the per-edit latency shows up
    in the next frame's time, not here. Don't compare the interactive
    value against the reference's synced update times."""

    occupied_voxel_percent: float | None = None
    count_ms: float | None = None
    map_update_ms: float | None = None
    gradient_ms: float | None = None


# Max suspect lanes per repair-march device program (True = gradient TF,
# which marches ~4x slower): the lock-step loop runs until the slowest lane
# of its chunk finishes, so shorter chunks bound the divergence waste.
# Module-level so tests can shrink it.
_REPAIR_CHUNK = {True: 8192, False: 32768}

# Frame renderers: "sweep" = the XLA plane sweep (render/sweep.py),
# "marcher" = the reference-exact lock-step ray march (render/marcher_xla.py,
# the parity oracle). The marcher is the default: on an H100 it renders the
# 1920×1080 beetle frame (skip mode 3) in about a third of the sweep's time
# (PERF.md), and it is exact by construction.
RENDERERS = ("sweep", "marcher")
DEFAULT_RENDERER = "marcher"


class Engine:
    def __init__(self, options: RenderOptions | None = None,
                 benchmark_mode: bool = False,
                 renderer: str = DEFAULT_RENDERER,
                 accel_cache_dir: str | None = None):
        """``renderer``: one of ``RENDERERS``. "sweep" renders with the XLA
        plane sweep and falls back to the marcher for frames whose rays
        disagree on the principal-axis sign; "marcher" always runs the
        reference-exact ray march."""
        if renderer not in RENDERERS:
            raise ValueError(f"unknown renderer {renderer!r}; "
                             f"expected one of {RENDERERS}")
        self.options = options or RenderOptions()
        self.benchmark_mode = benchmark_mode
        self.renderer = renderer
        if benchmark_mode:
            # Benchmark mode forces (src/volume_render.cpp:177-183).
            self.options.clip_distance = 1.0
            self.options.early_ray_termination = False
            self.options.test = Test.NUM_TEXTURE_SAMPLES
        self.volumes: list[Volume] = []
        self.accel_cache_dir = accel_cache_dir
        # Per-renderer frame counts: how often the sweep runs vs the
        # marcher fallback (mixed-sign views).
        self.renderer_counts = {r: 0 for r in RENDERERS}
        self.last_renderer = None          # set by every rendered frame

    # ---- setup ----------------------------------------------------------

    def add_volume(self, volume: Volume) -> UpdateStats:
        """Load path of prepare(): gradient at load + first TF update
        (src/volume_render.cpp:186-242). With ``accel_cache_dir`` set,
        checkpointed maps are restored instead of recomputed (SURVEY.md §5
        checkpoint/resume)."""
        self.volumes.append(volume)
        stats = UpdateStats()
        if self.accel_cache_dir is not None:
            from . import accel_cache

            if accel_cache.load(self.accel_cache_dir, volume,
                                self.options.skipping_type):
                return stats
        if volume.options.use_precomputed_gradient:
            t0 = time.perf_counter()
            volume.gradient = gradient_map(
                volume.density, 1.0, use_gradient=volume.options.use_gradient
            )
            volume.gradient.block_until_ready()
            stats.gradient_ms = (time.perf_counter() - t0) * 1e3
        tf_stats = self.update_transfer_function(volume)
        stats.occupied_voxel_percent = tf_stats.occupied_voxel_percent
        stats.count_ms = tf_stats.count_ms
        stats.map_update_ms = tf_stats.map_update_ms
        if self.accel_cache_dir is not None:
            from . import accel_cache

            accel_cache.save(self.accel_cache_dir, volume,
                             self.options.skipping_type)
        return stats

    def _tf(self, volume: Volume):
        o = volume.options
        key = (o.intensity_min, o.intensity_max, o.gradient_min,
               o.gradient_max, o.sampling_factor, o.voxel_alpha_factor)
        cached = getattr(volume, "_tf_cache", None)
        if cached is not None and cached[0] == key:
            return cached[1]
        # Building TFParams costs ~7 scalar host-to-device copies — cache
        # per volume, invalidated by value.
        tf = tf_params(
            intensity_min=o.intensity_min,
            intensity_max=o.intensity_max,
            gradient_min=o.gradient_min,
            gradient_max=o.gradient_max,
            sampling_factor=o.sampling_factor,
            voxel_alpha_factor=o.voxel_alpha_factor,
        )
        volume._tf_cache = (key, tf)
        return tf

    def _slab_oversample(self, volume: Volume, vol_t_shape, tf) -> float:
        """Slab count per principal-axis voxel plane (RenderOptions.
        slab_density). "ref" matches the reference's per-ray step density
        1/(dim_max·sf) (volume_render.frag:176-179): n_slabs ≈ dim_max·sf
        instead of Np·sf. "auto" pays that only for gradient TFs — the one
        content class where plane-aligned slabs measurably diverge (28 % of
        covered pixels >8/255 vs 0 %; intensity-only TFs measure ≤0.04 %
        either way, so they keep the plane-aligned fast path)."""
        sf = float(volume.options.sampling_factor)
        mode = self.options.slab_density
        mult = 1.0
        if mode == "auto":
            if tf.use_gradient:
                # Sharp-shell content needs ~2× the reference density for
                # the fixed-phase slab quadrature to converge (see
                # RenderOptions.grad_density_mult).
                mode = "ref"
                mult = float(self.options.grad_density_mult)
            else:
                mode = "axis"
        if mode == "ref":
            return sf * max(vol_t_shape) / vol_t_shape[0] * mult
        return sf

    def update_transfer_function(self, volume: Volume, timed_runs: int = 5) -> UpdateStats:
        """TF-edit recompute path (src/volume_render.cpp:392-445): bake the TF
        texture, optionally count occupied voxels (benchmark mode), rebuild the
        occupancy map and the distance map(s) for the active skipping type."""
        o = volume.options
        tf = self._tf(volume)
        stats = UpdateStats()

        volume.tf_texture = bake_texture(
            intensity_min=o.intensity_min,
            intensity_max=o.intensity_max,
            gradient_min=o.gradient_min,
            gradient_max=o.gradient_max,
        )

        gradient = volume.gradient if o.use_precomputed_gradient else None
        on_the_fly = not o.use_precomputed_gradient

        tf_host = (o.intensity_min, o.intensity_max,
                   o.gradient_min, o.gradient_max)

        if self.benchmark_mode:
            t0 = time.perf_counter()
            n_occ = int(
                occupied_voxel_count(
                    volume.density, gradient, tf,
                    on_the_fly_gradient=on_the_fly, tf_host=tf_host,
                )
            )
            stats.count_ms = (time.perf_counter() - t0) * 1e3
            n_vox = int(np.prod(volume.density.shape))
            stats.occupied_voxel_percent = 100.0 * n_occ / n_vox

        from ..accel.occupancy import _tf_thresholds

        thr = _tf_thresholds(tf, tf_host)
        ti, tg = thr if thr is not None else (0, 0)

        def build_maps():
            return _build_maps_fused(
                volume.density, gradient, tf, ti, tg,
                map_shape_zyx=volume.map_shape_zyx,
                st=self.options.skipping_type, on_the_fly=on_the_fly,
                fast=thr is not None)

        runs = timed_runs if self.benchmark_mode else 1
        if self.benchmark_mode:
            # Warm the jit cache before timing (the reference's 5-run
            # average also amortises pipeline warmup,
            # volume_render.cpp:421-430). Interactive edits skip it — the
            # traced-threshold build recompiles for no TF edit, so the
            # cache is warm after the first edit.
            build_maps().block_until_ready()
        t0 = time.perf_counter()
        for _ in range(runs):
            maps = build_maps()
        if self.benchmark_mode:
            # The queued builds execute serially on the device, so
            # wall/runs is the per-build device time.
            maps.block_until_ready()
        # Interactive edits stay QUEUED: the reference's update path records
        # compute dispatches with no CPU readback between the TF edit and
        # the next draw (volume_render.cpp:392-445) — the next presented
        # frame consumes the new maps device-side and pays one sync for
        # rebuild + render together. map_update_ms then reports dispatch
        # cost only; the per-edit latency lives in the frame time.
        stats.map_update_ms = (time.perf_counter() - t0) * 1e3 / runs
        volume.dist_maps = maps
        volume._maps_version = getattr(volume, "_maps_version", 0) + 1
        return stats

    def set_skipping_type(self, st: SkippingType) -> None:
        """ESS mode change rebuilds the maps for every volume
        (src/volume_render.cpp:512-518)."""
        if st != self.options.skipping_type:
            self.options.skipping_type = st
            for v in self.volumes:
                self.update_transfer_function(v, timed_runs=1)

    # ---- per-frame ------------------------------------------------------

    def render_with_scene(self, camera, width: int, height: int, mesh,
                          light_dir=(-0.4, -0.8, -0.45)) -> RenderOutput:
        """Forward scene pass + volume pass, composited like the
        reference's render pipeline with ``render_sponza_scene`` on
        (src/volume_render.cpp:329-356): the mesh renders first
        (render/forward.py), its reverse-Z depth clips the volume rays
        (DEPTH_ATTACHMENT variant, volume_render.frag:122-165), and the
        volume's premultiplied front-to-back output composites OVER the
        scene color (src/volume_render_subpass.cpp:177-186)."""
        from ..render.forward import rasterize

        scene_rgb, scene_depth = rasterize(mesh, camera, height, width,
                                           light_dir=light_dir)
        prev = self.options.depth_attachment
        self.options.depth_attachment = True
        try:
            out = self.render(camera, width, height,
                              depth_image=scene_depth)
        finally:
            self.options.depth_attachment = prev
        vol_a = out.color[..., 3:4]
        rgb = out.color[..., :3] + (1.0 - vol_a) * scene_rgb
        covered = (scene_depth > 0.0)[..., None].astype(jnp.float32)
        alpha = vol_a + (1.0 - vol_a) * covered
        return dataclasses.replace(
            out,
            color=jnp.concatenate([rgb, alpha], -1),
            depth=jnp.maximum(out.depth, scene_depth),
        )

    def render(self, camera, width: int, height: int,
               depth_image=None) -> RenderOutput:
        """One frame: per volume, ray setup + march, blended front-to-back
        into the target in draw order (VolumeRenderSubpass::draw,
        src/volume_render_subpass.cpp:159-293)."""
        out = None
        for volume in self.volumes:
            result = self.render_volume(
                volume, camera, width, height, depth_image=depth_image
            )
            if out is None:
                out = result
            else:
                # Target blend state (src/volume_render_subpass.cpp:177-186):
                # src factor ONE, dst factor ONE_MINUS_SRC_ALPHA — each later
                # draw composites OVER the accumulated target:
                # new = src + (1 - src.a) * dst.
                c = result.color + (1.0 - result.color[..., 3:4]) * out.color
                # Reverse-Z depth (GREATER = nearer): keep the nearer hit.
                d = jnp.maximum(result.depth, out.depth)
                out = dataclasses.replace(
                    result, color=c, depth=d,
                    num_volume_samples=(result.num_volume_samples
                                        + out.num_volume_samples),
                    num_distance_samples=(result.num_distance_samples
                                          + out.num_distance_samples),
                    num_empty_samples=(result.num_empty_samples
                                       + out.num_empty_samples),
                )
        return out

    def render_volume(self, volume: Volume, camera, width: int, height: int,
                      depth_image=None) -> RenderOutput:
        if self.renderer == "sweep":
            out = self._render_sweep(volume, camera, width, height,
                                     depth_image=depth_image)
            if out is not None:
                if (self.options.edge_repair
                        and self.options.test == Test.NONE):
                    out = self._edge_repair(out, volume, camera,
                                            width, height, depth_image)
                return out
            # Mixed principal-axis signs (camera inside the volume, wide
            # FOV): one global slab order cannot composite every ray
            # front-to-back — use the per-ray marcher for this frame.
            pass
        # Reached both by an explicit renderer="marcher" engine and by the
        # mixed-sign fallback above — count it here so last_renderer /
        # renderer_counts exist for EVERY rendered frame, not only the
        # sweep paths.
        self.last_renderer = "marcher"
        self.renderer_counts["marcher"] += 1
        uniforms = make_uniforms(
            camera,
            volume.node_transform,
            volume.image_transform,
            self.options.clip_distance,
            np.asarray(volume.effective_block_size_xyz, np.float32),
        )
        rays = make_rays(
            uniforms,
            height,
            width,
            depth_image=depth_image,
            use_depth=self.options.depth_attachment and depth_image is not None,
        )
        tf = self._tf(volume)
        pvm = jnp.asarray(
            (camera.proj.astype(np.float64)
             @ camera.view.astype(np.float64)
             @ volume.model_matrix).astype(np.float32)
        )

        def march_rows(band):
            return march(
                volume.density,
                volume.gradient,
                volume.dist_maps
                if self.options.skipping_type != SkippingType.NONE else None,
                tf,
                band,
                uniforms.block_size,
                pvm,
                skipping_type=self.options.skipping_type,
                early_ray_termination=self.options.early_ray_termination,
                precomputed_gradient=volume.options.use_precomputed_gradient,
                test=self.options.test,
                tf_texture=self._tf_texture(volume),
            )

        # Band large marches into row strips: every pixel is independent, so
        # the output is identical, but the lock-step loop's trip count per
        # strip is the strip's own worst ray, not the frame's (less
        # divergence waste). Gradient-modulated TFs march ~2x slower
        # (second trilinear per sample) and band finer.
        n_px = height * width
        if n_px >= 512 * 512:
            if self._tf(volume).use_gradient:
                n_bands = min(32, max(2, n_px // (128 * 1024)))
            else:
                n_bands = min(8, max(2, n_px // (256 * 1024)))
            rows = [height * b // n_bands for b in range(n_bands + 1)]
            parts = [
                march_rows(jax.tree.map(lambda x: x[rows[b]:rows[b + 1]],
                                        rays))
                for b in range(n_bands)
            ]
            return RenderOutput(
                color=jnp.concatenate([p.color for p in parts], axis=0),
                depth=jnp.concatenate([p.depth for p in parts], axis=0),
                num_volume_samples=jnp.concatenate(
                    [p.num_volume_samples for p in parts], axis=0),
                num_distance_samples=jnp.concatenate(
                    [p.num_distance_samples for p in parts], axis=0),
                num_empty_samples=jnp.concatenate(
                    [p.num_empty_samples for p in parts], axis=0),
                iterations=parts[0].iterations,
            )
        return march_rows(rays)

    def _edge_repair(self, out: RenderOutput, volume: Volume, camera,
                     width: int, height: int, depth_image) -> RenderOutput:
        """Exact-marcher repair of resampling-suspect pixels (quality mode).

        The plane sweep samples each ray on slab planes rather than
        uniformly along the ray, so at silhouette/depth discontinuities and
        sharp intensity edges a small class of pixels departs from the
        reference march by more than a few LSB. This pass finds pixels whose 3×3 alpha/depth
        neighbourhood is discontinuous (dilated once), re-marches ONLY
        those rays with the reference-exact per-ray marcher
        (render/marcher_xla.py — the parity oracle), and splices them in.
        Pixel budget is static (~3 % of the frame, 1024-aligned for stable
        jit shapes); overflow beyond the budget keeps the sweep pixels.
        """
        f = jnp.float32
        a = out.color[..., 3]
        dep = out.depth

        def rng3(x):
            mx = jax.lax.reduce_window(
                x, -jnp.inf, jax.lax.max, (3, 3), (1, 1), "SAME")
            mn = jax.lax.reduce_window(
                x, jnp.inf, jax.lax.min, (3, 3), (1, 1), "SAME")
            return mx - mn

        # Alpha/depth discontinuities (silhouettes) PLUS color edges at
        # flat alpha: interior intensity edges shift the TF color with no
        # alpha signature at all, so the alpha/depth detector alone misses
        # them; a 0.08 color-range term catches them at the cost of more
        # suspects (raise repair_budget accordingly).
        c3 = out.color[..., :3]
        cmx = jax.lax.reduce_window(
            c3, -jnp.inf, jax.lax.max, (3, 3, 1), (1, 1, 1), "SAME")
        cmn = jax.lax.reduce_window(
            c3, jnp.inf, jax.lax.min, (3, 3, 1), (1, 1, 1), "SAME")
        mask = ((rng3(a) > 0.04) | (rng3(dep) > 0.01)
                | ((cmx - cmn).max(-1) > 0.08))
        mask = jax.lax.reduce_window(
            mask.astype(f), -jnp.inf, jax.lax.max, (3, 3), (1, 1),
            "SAME") > 0.5
        n_px = height * width
        n_found = mask.sum()
        if self.options.repair_budget <= 0:
            # Probe mode: count suspects only (callers bucket the march
            # budget by the count — the oracle march costs ∝ the STATIC
            # budget K whether or not the lanes are live).
            self.last_repair_px = (n_found, 0)
            return out
        K = int(min(n_px, -(-max(
            2048, int(n_px * self.options.repair_budget)) // 1024) * 1024))
        idx = jnp.nonzero(mask.ravel(), size=K, fill_value=0)[0]
        live = jnp.arange(K) < n_found
        # Device value, NOT synced here (a host int() would stall the
        # frame pipeline); callers that need the count int() it.
        self.last_repair_px = (n_found, K)

        uniforms = make_uniforms(
            camera, volume.node_transform, volume.image_transform,
            self.options.clip_distance,
            np.asarray(volume.effective_block_size_xyz, np.float32))
        use_depth = (self.options.depth_attachment
                     and depth_image is not None)
        rays = make_rays(uniforms, height, width, depth_image=depth_image,
                         use_depth=use_depth)
        sub = jax.tree.map(
            lambda x: (x.reshape((n_px,) + x.shape[2:])[idx][None]
                       if getattr(x, "ndim", 0) >= 2
                       and x.shape[:2] == (height, width) else x),
            rays)
        tf = self._tf(volume)
        pvm = jnp.asarray(
            (camera.proj.astype(np.float64)
             @ camera.view.astype(np.float64)
             @ volume.model_matrix).astype(np.float32))
        # The oracle march skips with whatever map exists: even skipmode
        # NONE builds the occupancy map (reference parity,
        # src/compute_distance_map.cpp:96-99), and BLOCK-mode skipping
        # over it (step to the next block boundary while the cell is
        # EMPTY) is exact — without it the static suspect budget
        # brute-forces every ray (measured 12.3 s/frame at a 1/8 budget
        # on present skipmode 0). Skipped cells are strictly unoccupied
        # under the same TF thresholds, so repaired pixels stay
        # oracle-exact.
        st_rep = self.options.skipping_type
        if st_rep == SkippingType.NONE and volume.dist_maps is not None:
            st_rep = SkippingType.BLOCK

        def march_lanes(lanes):
            return march(
                volume.density, volume.gradient,
                volume.dist_maps if st_rep != SkippingType.NONE else None,
                tf, lanes, uniforms.block_size, pvm,
                skipping_type=st_rep,
                early_ray_termination=self.options.early_ray_termination,
                precomputed_gradient=volume.options.use_precomputed_gradient,
                test=self.options.test,
                tf_texture=self._tf_texture(volume),
            )

        # Band the suspect march into chunks: suspects are all edge rays
        # (deep marches, little skipping), and each chunk's lock-step loop
        # stops at its own slowest lane. Same banding rationale as
        # render_volume's full-frame oracle strips.
        chunk = _REPAIR_CHUNK[bool(tf.use_gradient)]
        if K > chunk:
            parts = [
                march_lanes(jax.tree.map(
                    lambda x: (x[:, c:c + chunk]
                               if getattr(x, "ndim", 0) >= 2
                               and x.shape[:2] == (1, K) else x), sub))
                for c in range(0, K, chunk)
            ]
            rep = RenderOutput(
                color=jnp.concatenate([p.color for p in parts], axis=1),
                depth=jnp.concatenate([p.depth for p in parts], axis=1),
                num_volume_samples=jnp.concatenate(
                    [p.num_volume_samples for p in parts], axis=1),
                num_distance_samples=jnp.concatenate(
                    [p.num_distance_samples for p in parts], axis=1),
                num_empty_samples=jnp.concatenate(
                    [p.num_empty_samples for p in parts], axis=1),
                iterations=parts[0].iterations,
            )
        else:
            rep = march_lanes(sub)

        # Dead (padding) lanes scatter to an out-of-bounds index and are
        # dropped — a live suspect at pixel 0 must not race with padding
        # writes (nonzero pads with fill_value=0).
        idx_w = jnp.where(live, idx, n_px)

        def splice(old, new):
            flat = old.reshape((n_px,) + old.shape[2:])
            return flat.at[idx_w].set(new[0], mode="drop").reshape(old.shape)

        return dataclasses.replace(
            out, color=splice(out.color, rep.color),
            depth=splice(out.depth, rep.depth))

    def _tf_texture(self, volume: Volume):
        """Baked TF texture when the TRANSFER_FUNCTION_TEXTURE variant is
        active (RenderOptions.texture_tf), else None (closed-form TF)."""
        if not self.options.texture_tf:
            return None
        return jnp.asarray(volume.tf_texture)

    def _render_sweep(self, volume: Volume, camera, width: int, height: int,
                      depth_image=None) -> RenderOutput | None:
        """Sweep frame, or None when the frame needs the marcher (mixed
        principal-axis direction signs, or no ray hits the volume).

        The per-frame decisions (principal axis, mixed-sign detection) are
        host-side analytic functions of the camera (render/plan.py), so the
        steady-state frame loop issues no synced device-to-host transfers."""
        from ..render import plan as plan_mod
        from ..render import sweep as sweep_mod

        cache = getattr(volume, "_sweep_cache", None)
        if cache is None:
            cache = volume._sweep_cache = {}

        # Per-camera-pose cache: a static camera renders with zero per-frame
        # host analysis and zero ray-setup dispatches; an orbiting camera
        # pays only host-side analytic math (render/plan.py).
        use_depth = self.options.depth_attachment and depth_image is not None
        cam_key = (camera.view.tobytes(), camera.proj.tobytes(),
                   float(self.options.clip_distance), height, width,
                   # The cached uniforms/pvm also depend on the volume
                   # transform (spin mode / translation edits).
                   np.asarray(volume.model_matrix).tobytes())
        # Depth-clipped frames are never pose-cached: the depth buffer's
        # contents change per frame (and id() can be recycled), so cached
        # rays would clip against stale depths.
        pose = None if use_depth else cache.get(("pose", cam_key))
        if pose is None:
            uniforms = make_uniforms(
                camera,
                volume.node_transform,
                volume.image_transform,
                self.options.clip_distance,
                np.asarray(volume.effective_block_size_xyz, np.float32),
            )
            view = plan_mod.analyze_view(uniforms, height, width)
            rays = None
            if view is not None and not view["mixed"]:
                rays = make_rays(uniforms, height, width,
                                 depth_image=depth_image, use_depth=use_depth)
            pose = dict(uniforms=uniforms, view=view, rays=rays)
            if not use_depth:
                # Bound the pose cache (an orbiting camera would grow it
                # indefinitely; dropping it only costs host-side re-analysis).
                keys = [k for k in cache if isinstance(k, tuple)
                        and k[0] == "pose"]
                if len(keys) > 64:
                    for k in keys:
                        del cache[k]
                cache[("pose", cam_key)] = pose
        uniforms, view, rays = pose["uniforms"], pose["view"], pose["rays"]
        if self.options.test in (Test.RAY_ENTRY, Test.RAY_EXIT):
            # No march: the entry/exit POSITION images
            # (volume_render.frag:168-173) come straight from the ray
            # setup — one elementwise device program, no maps, no banding
            # (render/sweep.py:134-139 and marcher_xla.py:103-112 agree
            # on the semantics).
            if rays is None:
                rays = pose["rays"] = make_rays(
                    uniforms, height, width,
                    depth_image=depth_image, use_depth=use_depth)
            pt = (rays.entry if self.options.test == Test.RAY_ENTRY
                  else rays.exit)
            color = jnp.concatenate(
                [pt, jnp.ones((height, width, 1), jnp.float32)], -1)
            color = jnp.where(rays.valid[..., None], color, 0.0)
            zi = jnp.zeros((height, width), jnp.int32)
            self.last_renderer = "sweep"
            self.renderer_counts["sweep"] += 1
            return RenderOutput(color, rays.depth_init, zi, zi, zi,
                                jnp.int32(0))
        if view is None or view["mixed"]:
            return None  # caller falls back to the per-ray marcher
        p = view["p_axis"]
        if p not in cache:
            vol_t = sweep_mod.transpose_for_axis(volume.density, p)
            grad_t = (
                sweep_mod.transpose_for_axis(volume.gradient, p)
                if volume.gradient is not None else None
            )
            cache[p] = (vol_t, grad_t)
        vol_t, grad_t = cache[p]
        # Any map with 0 ⇔ occupied works for slab skipping (distance maps
        # are 0 exactly at occupied cells, occupancy is OCCUPIED=0). The 8
        # anisotropic octant maps are stitched
        # per CELL by _octant_composite: for a pinhole camera every ray
        # through a cell shares the octant sign pattern sign(cell_center -
        # cam), so selecting that octant's value per cell reproduces the
        # reference's per-ray map selection exactly (volume_render.frag:209)
        # — not a conservative min.
        occ_t = None
        if volume.dist_maps is not None:
            maps = volume.dist_maps
            # Keyed on a monotonic rebuild counter, not id() (array ids can
            # be recycled after GC, silently serving stale maps).
            ver = getattr(volume, "_maps_version", 0)
            if maps.shape[0] == 8:
                # Anisotropic: per-cell octant stitch (_octant_composite) —
                # the exact twin of the reference's per-ray map selection.
                # The stitch depends on the camera position only through
                # which map cell holds it, so the cache key quantises to
                # that cell (static poses and slow pans hit the cache).
                bs = np.asarray(volume.effective_block_size_xyz, np.float64)
                dz, hy, wx = volume.density.shape
                cam = np.asarray(uniforms.cam_pos_tex, np.float64)
                ks = (cam[2] * dz / bs[2], cam[1] * hy / bs[1],
                      cam[0] * wx / bs[0])
                sel = tuple(int(np.floor(k)) for k in ks)
            else:
                ks = None
                sel = tuple(range(maps.shape[0]))
            occ_key = ("occ", p, ver, sel)
            occ_t = cache.get(occ_key)
            if occ_t is None:
                # Evict combines of superseded map builds: each is a full
                # transposed u8 volume on device, and a long interactive
                # session (one rebuild per TF edit) would otherwise leak
                # device memory per edit. Octant stitches additionally
                # rotate per camera cell — bound them like the pose cache.
                stale = [k for k in cache
                         if isinstance(k, tuple) and k[0] == "occ"
                         and k[2] != ver]
                live = [k for k in cache
                        if isinstance(k, tuple) and k[0] == "occ"
                        and k[2] == ver]
                for k in stale + (live if len(live) > 16 else []):
                    del cache[k]
                if ks is not None:
                    src = _octant_composite(
                        maps, *(jnp.float32(k) for k in ks))
                else:
                    src = maps[sel[0]]
                    for i in sel[1:]:
                        src = jnp.minimum(src, maps[i])
                occ_t = sweep_mod.transpose_for_axis(src, p)
                cache[occ_key] = occ_t
        tf = self._tf(volume)
        self.last_renderer = "sweep"
        self.renderer_counts["sweep"] += 1

        pvm = pose.get("pvm")
        if pvm is None:
            # Host proj·view·model (float64 product, f32 result) once per pose.
            pvm = pose["pvm"] = jnp.asarray(
                (camera.proj.astype(np.float64)
                 @ camera.view.astype(np.float64)
                 @ volume.model_matrix).astype(np.float32))

        def sweep_rows(band):
            return sweep_mod.sweep(
                vol_t, grad_t, occ_t, tf, band, uniforms, pvm,
                p_axis=p,
                skipping=self.options.skipping_type != SkippingType.NONE,
                early_ray_termination=self.options.early_ray_termination,
                test=self.options.test,
                oversample=self._slab_oversample(volume, vol_t.shape, tf),
                tf_texture=self._tf_texture(volume),
            )

        # Band large sweeps into row strips (pixel-independent — identical
        # output): each strip's ERT loop stops when the strip's own rays
        # saturate, not the frame's.
        n_px = height * width
        if n_px >= 512 * 512:
            n_bands = min(8, max(2, n_px // (256 * 1024)))
            rows_ix = [height * b // n_bands for b in range(n_bands + 1)]
            parts = [
                sweep_rows(jax.tree.map(
                    lambda x: x[rows_ix[b]:rows_ix[b + 1]], rays))
                for b in range(n_bands)
            ]
            return RenderOutput(
                color=jnp.concatenate([q.color for q in parts], axis=0),
                depth=jnp.concatenate([q.depth for q in parts], axis=0),
                num_volume_samples=jnp.concatenate(
                    [q.num_volume_samples for q in parts], axis=0),
                num_distance_samples=jnp.concatenate(
                    [q.num_distance_samples for q in parts], axis=0),
                num_empty_samples=jnp.concatenate(
                    [q.num_empty_samples for q in parts], axis=0),
                iterations=parts[0].iterations,
            )
        return sweep_rows(rays)

    def render_image(self, camera, width: int, height: int,
                     background=(0.0, 0.0, 0.0),
                     scene_mesh=None) -> np.ndarray:
        """Render and composite over a background, returning uint8 HxWx3.
        ``scene_mesh`` routes through the forward scene pass
        (render_with_scene — the reference's render_sponza_scene path)."""
        if scene_mesh is not None:
            out = self.render_with_scene(camera, width, height, scene_mesh)
        else:
            out = self.render(camera, width, height)
        rgba = np.asarray(out.color)
        bg = np.asarray(background, np.float32)
        rgb = rgba[..., :3] + (1.0 - rgba[..., 3:4]) * bg
        return np.clip(np.round(rgb * 255.0), 0, 255).astype(np.uint8)
