"""Command-line interface.

Twin of the reference's plugin flag system + benchmark mode
(src/volume_render.h:35-63, src/volume_render.cpp:65-84): same flags, same
defaults, and the same machine-readable log lines that
``scripts/benchmark.py:55-61`` scrapes::

    ran <N> frames, averaged <X> fps
    Updated occupancy/distance map in <X>ms
    Occupied voxels: <X>% in <X>ms

Usage:
    vkvolume [options] [<dataset>]
    vkvolume --synth beetle [options]          # procedural stand-in dataset
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from .engine.engine import DEFAULT_RENDERER, RENDERERS


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="vkvolume",
        description="Accelerated volume renderer in JAX "
                    "(Chebyshev distance-map empty-space skipping)",
    )
    # Reference flags and defaults (src/volume_render.cpp:67-82).
    p.add_argument("dataset", nargs="*", default=None,
                   help="raw volume path(s) (each with a <path>.header "
                        "sidecar); multiple volumes composite in draw "
                        "order like the reference's "
                        "<binary_volume_image>... argument "
                        "(src/volume_render.cpp:95,186)")
    p.add_argument("--imin", type=float, default=0.1)
    p.add_argument("--imax", type=float, default=1.0)
    p.add_argument("--gmin", type=float, default=0.0)
    p.add_argument("--gmax", type=float, default=0.2)
    p.add_argument("--skipmode", type=int, default=2, choices=[0, 1, 2, 3],
                   help="0=None 1=Block 2=Distance 3=AnisotropicDistance")
    p.add_argument("--blocksize", type=int, default=4)
    p.add_argument("--gradient_test", action="store_true",
                   help="on-the-fly gradients instead of the precomputed map")
    p.add_argument("--width", type=int, default=1280)
    p.add_argument("--height", type=int, default=720)
    p.add_argument("--benchmark", type=int, default=0, metavar="FRAMES",
                   help="benchmark mode: time FRAMES frames and report fps")
    # Extensions beyond the reference CLI.
    p.add_argument("--synth", choices=["present", "beetle", "snake"],
                   help="use a synthetic stand-in dataset")
    p.add_argument("--synth-scale", type=float, default=1.0)
    p.add_argument("--sampling", type=float, default=1.0,
                   help="sampling factor (GUI slider equivalent)")
    p.add_argument("--alpha", type=float, default=1.0,
                   help="voxel alpha factor")
    p.add_argument("--clip-distance", type=float, default=50.0)
    p.add_argument("--no-ert", action="store_true",
                   help="disable early ray termination")
    p.add_argument("--test", type=int, default=0, choices=[0, 1, 2, 3],
                   help="0=None 1=RayEntry 2=RayExit 3=NumTextureSamples")
    p.add_argument("--texture-tf", action="store_true",
                   help="sample the baked 256x256 TF texture instead of the "
                        "closed form (the TRANSFER_FUNCTION_TEXTURE build "
                        "variant, transfer_function.glsl:36-38)")
    p.add_argument("--edge-repair", action="store_true",
                   help="quality mode: re-march resampling-suspect pixels "
                        "(silhouette/depth edges) with the exact per-ray "
                        "marcher and splice them into the sweep frame")
    p.add_argument("--scene", action="store_true",
                   help="render the demo hall mesh around the volume "
                        "(the reference's render_sponza_scene toggle, "
                        "src/volume_render.cpp:88: forward scene pass + "
                        "depth-clipped volume composite)")
    p.add_argument("--azimuth", type=float, default=30.0)
    p.add_argument("--elevation", type=float, default=20.0)
    p.add_argument("--spin", type=float, default=0.0, metavar="DEG",
                   help="rotate the volume DEG degrees per benchmark frame "
                        "(the reference's spin_volumes animation, "
                        "src/volume_render.cpp:89)")
    p.add_argument("--orbit", type=float, default=0.0,
                   help="degrees of azimuth per frame (spin equivalent)")
    p.add_argument("--output", default=None, help="write a PNG snapshot")
    p.add_argument("--renderer", default=DEFAULT_RENDERER,
                   choices=RENDERERS,
                   help="marcher = reference-exact ray march (the "
                        "default, and the parity oracle); sweep = XLA plane "
                        "sweep (the marcher renders views whose rays need "
                        "two slab orders)")
    p.add_argument("--debug-nans", action="store_true",
                   help="enable jax debug_nans (the sanitizer role of the "
                        "reference's optional Vulkan validation layers, "
                        "SURVEY §5; fails fast on the first NaN any jitted "
                        "pipeline produces)")
    p.add_argument("--sweep", action="store_true",
                   help="run the full benchmark sweep "
                        "(scripts/benchmark.py equivalent) and write CSVs")
    p.add_argument("--frames", type=int, default=20,
                   help="timed frames per sweep config")
    return p


def setup_engine(args):
    """Engine + volume list from parsed CLI args (shared with the viewer).

    Does NOT add the volumes to the engine (callers time that step — it is
    the reference's load → gradient → map-update pipeline). Each volume
    gets its OWN options instance (the reference's per-volume options,
    src/volume_render.cpp:190-195 — GUI edits must not alias)."""
    import dataclasses

    from .engine import Engine, RenderOptions, from_array, from_file
    from .options import SkippingType, Test, VolumeOptions

    # Persistent compile cache: the reference recompiles shader variants in
    # ms (src/volume_render.cpp:541-544); XLA compiles of the frame and
    # map-build programs take seconds cold, so every user entry point starts
    # the cache before the first jit — a warm second session renders
    # structural option edits (sampling, spin, skipmode) from cached
    # executables.
    from .utils import enable_compile_cache

    enable_compile_cache()

    if getattr(args, "debug_nans", False):
        import jax

        jax.config.update("jax_debug_nans", True)

    opts = VolumeOptions(
        sampling_factor=args.sampling,
        voxel_alpha_factor=args.alpha,
        use_precomputed_gradient=not args.gradient_test,
        intensity_min=args.imin, intensity_max=args.imax,
        gradient_min=args.gmin, gradient_max=args.gmax,
    )
    render_opts = RenderOptions(
        skipping_type=SkippingType(args.skipmode),
        clip_distance=args.clip_distance,
        early_ray_termination=not args.no_ert,
        test=Test(args.test),
        texture_tf=args.texture_tf,
        edge_repair=args.edge_repair,
    )
    engine = Engine(render_opts, benchmark_mode=args.benchmark > 0,
                    renderer=args.renderer)

    if args.synth:
        from .bench.datasets import DATASETS, synthesize

        ds = DATASETS[args.synth]
        data = synthesize(ds, scale=args.synth_scale)
        volumes = [from_array(data, opts, block_size=args.blocksize,
                              name=ds.filename)]
    else:
        paths = args.dataset or ["stag_beetle_832x832x494.uint16"]
        volumes = [from_file(ds, dataclasses.replace(opts),
                             block_size=args.blocksize)
                   for ds in paths]
    for volume in volumes:
        # Fit to the viewport: node scale = 100 / (per-world-axis image
        # scale), the reference's benchmark-mode decompose
        # (src/volume_render.cpp:224-233: |rotation · scale| of the image
        # transform). The reference's non-benchmark mode uses a plain 100
        # with a FREE camera; our CLI camera is a fixed fit-orbit for a
        # ~100-unit volume, so the fit scaling applies always — without
        # it, real headers (voxel_size in metres) give sub-unit volumes
        # that render as a handful of pixels.
        lin = np.asarray(volume.image_transform, np.float64)[:3, :3]
        s = np.linalg.norm(lin, axis=0)               # image scale (glm)
        rot = lin / np.where(s == 0.0, 1.0, s)[None, :]
        world = np.abs(rot @ s)                       # abs(rotation*scale)
        volume.set_scale(tuple(100.0 / np.where(world == 0.0, 1.0, world)))
    return engine, volumes


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from .bench.harness import benchmark_camera, run_sweep
    from .camera import orbit_camera, fit_distance

    if args.sweep:
        from .utils import enable_compile_cache

        enable_compile_cache()
        run_sweep(width=args.width, height=args.height, frames=args.frames,
                  scale=args.synth_scale)
        return 0

    engine, volumes = setup_engine(args)

    t0 = time.perf_counter()
    for volume in volumes:
        # Per-volume load pipeline + log lines (the reference logs each
        # volume as it loads, src/volume_render.cpp:186-242).
        stats = engine.add_volume(volume)
        if stats.gradient_ms is not None:
            print(f"Updated gradient map in {stats.gradient_ms}ms")
        if stats.occupied_voxel_percent is not None:
            print(f"Occupied voxels: {stats.occupied_voxel_percent}% "
                  f"in {stats.count_ms}ms")
        print(f"Updated occupancy/distance map in {stats.map_update_ms}ms")
    print(f"Prepared in {time.perf_counter() - t0:.2f}s")

    aspect = args.width / args.height
    if args.benchmark:
        cam = benchmark_camera(aspect, args.azimuth, args.elevation)
        out = engine.render(cam, args.width, args.height)
        out.color.block_until_ready()
        n = args.benchmark
        t0 = time.perf_counter()
        for i in range(n):
            az = args.azimuth + args.orbit * i
            cam = benchmark_camera(aspect, az, args.elevation)
            if args.spin:
                for volume in volumes:
                    volume.set_spin(np.deg2rad(args.spin * i))
            out = engine.render(cam, args.width, args.height)
        out.color.block_until_ready()
        dt = time.perf_counter() - t0
        print(f"ran {n} frames, averaged {n / dt} fps")
    else:
        radius = fit_distance(50.0, np.deg2rad(60.0), aspect) * 1.3
        cam = orbit_camera(radius=radius, azimuth_deg=args.azimuth,
                           elevation_deg=args.elevation, aspect=aspect)
        if args.scene:
            from .render.forward import sponza_lite

            out = engine.render_with_scene(cam, args.width, args.height,
                                           sponza_lite())
        else:
            out = engine.render(cam, args.width, args.height)
        out.color.block_until_ready()

    if args.output:
        from .utils.image import write_png

        write_png(args.output, np.asarray(out.color))
        print(f"wrote {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
