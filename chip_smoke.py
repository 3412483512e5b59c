#!/usr/bin/env python3
"""Smoke run of the renderer's main path on one NVIDIA GPU.

One process, through the user entry points (``Engine`` with
``from_array`` and the synthetic beetle stand-in, 832×832×494 u8):

1. device  — JAX's default device must be a GPU; the card's name and
   power limit as ``nvidia-smi`` reports them.
2. load    — synthesis from ``--seed``, ``add_volume`` (gradient + the
   anisotropic-distance map build), the warm map-update time and the
   occupied-voxel share.
3. frame   — 1920×1080, shaded, ERT on: compile time of the first frame,
   then ``--frames`` frames each closed by ``block_until_ready``, for the
   default renderer and the other one; peak device memory.
4. edits   — one TF edit, one ESS-mode switch (3 → 2 and back), an orbit
   of 8 fresh poses at 2° per pose.
5. parity  — vkvolume/bench/parity.py: marcher GPU vs CPU, sweep vs
   marcher, distance transforms GPU vs CPU, each against its bar.

Each phase prints one JSON line; the last line is
``{"ok": true, "device": {...}}``. A failed phase or bar ends the run with
a non-zero exit code and no final line.

    python chip_smoke.py                 # full size, on the card
    python chip_smoke.py --tiny --allow-cpu   # rehearsal on the CPU
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from vkvolume.bench.device import with_cpu_backend  # noqa: E402

with_cpu_backend()

import jax  # noqa: E402
import numpy as np  # noqa: E402


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def time_frames(engine, cams, width, height) -> list[float]:
    """Wall ms of each frame, each closed by block_until_ready."""
    out = []
    for cam in cams:
        t0 = time.perf_counter()
        engine.render(cam, width, height).color.block_until_ready()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def stats_ms(ms: list[float]) -> dict:
    med = float(np.median(ms))
    return {"median_ms": med, "min_ms": float(min(ms)),
            "max_ms": float(max(ms)),
            "spread": (max(ms) - min(ms)) / med, "n": len(ms)}


def peak_bytes(dev):
    stats = dev.memory_stats()
    return None if stats is None else stats.get("peak_bytes_in_use")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--frames", type=int, default=20)
    ap.add_argument("--tiny", action="store_true",
                    help="shrink every size (volume, image, parity "
                         "reference) for a quick rehearsal")
    ap.add_argument("--allow-cpu", action="store_true",
                    help="rehearsal only: accept the CPU as the device")
    args = ap.parse_args(argv)

    from vkvolume.bench.device import card_info, describe, require_gpu

    # ---- 1. device
    dev = require_gpu(allow_cpu=args.allow_cpu)
    card = card_info()
    if card is None and dev.platform == "gpu":
        raise SystemExit("nvidia-smi is not available")
    device = describe(dev)
    emit("device", **device, cpu_reference=str(jax.devices("cpu")[0]))
    print(card if card is not None else "nvidia-smi: not available",
          flush=True)

    from vkvolume.accel import occupied_voxel_count
    from vkvolume.bench.datasets import DATASETS, synthesize
    from vkvolume.bench.harness import benchmark_camera, make_engine
    from vkvolume.bench.parity import device_parity
    from vkvolume.engine.engine import DEFAULT_RENDERER, RENDERERS
    from vkvolume.options import SkippingType, Test
    from vkvolume.utils import enable_compile_cache

    cache_dir = enable_compile_cache()
    if args.tiny:
        scale, width, height = 0.06, 64, 36
        ref = dict(ref_scale=0.06, ref_width=48, ref_height=27)
    else:
        scale, width, height = 1.0, 1920, 1080
        ref = dict(ref_scale=0.25, ref_width=480, ref_height=272)

    # ---- 2. load
    t0 = time.perf_counter()
    vol_u8 = synthesize(DATASETS["beetle"], seed=args.seed, scale=scale)
    synth_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    eng, _, _, _ = make_engine(
        "beetle", 3, 4, scale=scale, seed=args.seed, volume_u8=vol_u8,
        renderer=DEFAULT_RENDERER, benchmark_mode=False, test=Test.NONE,
        ert=True)
    vol = eng.volumes[0]
    vol.dist_maps.block_until_ready()
    add_volume_s = time.perf_counter() - t0
    update_ms = []
    for _ in range(5):
        t0 = time.perf_counter()
        eng.update_transfer_function(vol)
        vol.dist_maps.block_until_ready()
        update_ms.append((time.perf_counter() - t0) * 1e3)
    o = vol.options
    n_occ = int(occupied_voxel_count(
        vol.density, vol.gradient, eng._tf(vol),
        tf_host=(o.intensity_min, o.intensity_max, o.gradient_min,
                 o.gradient_max)))
    emit("load", shape_zyx=list(vol_u8.shape), seed=args.seed,
         synth_s=synth_s, add_volume_s=add_volume_s,
         map_update_ms=float(np.median(update_ms)),
         map_update_runs_ms=update_ms,
         occupancy_pct=100.0 * n_occ / vol_u8.size,
         compile_cache=cache_dir)

    # ---- 3. frame
    cam = benchmark_camera(aspect=width / height)
    order = [DEFAULT_RENDERER] + [r for r in RENDERERS
                                  if r != DEFAULT_RENDERER]
    for renderer in order:
        eng.renderer = renderer
        t0 = time.perf_counter()
        eng.render(cam, width, height).color.block_until_ready()
        first_s = time.perf_counter() - t0
        ms = time_frames(eng, [cam] * args.frames, width, height)
        emit("frame", renderer=renderer, default=renderer == DEFAULT_RENDERER,
             image=f"{width}x{height}", first_frame_s=first_s,
             **stats_ms(ms), frame_ms=ms, last_renderer=eng.last_renderer,
             peak_bytes_in_use=peak_bytes(dev))
        if eng.last_renderer != renderer:
            raise SystemExit(f"{renderer} frame was rendered by "
                             f"{eng.last_renderer}")
    eng.renderer = DEFAULT_RENDERER

    # ---- 4. edits (each timed to the end of its map rebuild, then the
    # next frame separately)
    def timed(fn):
        t0 = time.perf_counter()
        fn()
        vol.dist_maps.block_until_ready()
        edit_ms = (time.perf_counter() - t0) * 1e3
        return edit_ms, time_frames(eng, [cam], width, height)[0]

    imin = o.intensity_min

    def tf_edit(value):
        def run():
            o.intensity_min = value
            eng.update_transfer_function(vol)
        return run

    tf_ms, tf_frame_ms = timed(tf_edit(imin + 0.02))
    tf_back_ms, _ = timed(tf_edit(imin))
    ess_ms, ess_frame_ms = timed(
        lambda: eng.set_skipping_type(SkippingType.DISTANCE))
    ess_back_ms, ess_back_frame_ms = timed(
        lambda: eng.set_skipping_type(SkippingType.ANISOTROPIC_DISTANCE))
    orbit = [benchmark_camera(aspect=width / height, azimuth=32.0 + 2.0 * i)
             for i in range(8)]
    orbit_ms = time_frames(eng, orbit, width, height)
    emit("edits", renderer=eng.renderer, tf_edit_ms=tf_ms,
         tf_edit_next_frame_ms=tf_frame_ms, tf_edit_back_ms=tf_back_ms,
         ess_3_to_2_ms=ess_ms, ess_3_to_2_next_frame_ms=ess_frame_ms,
         ess_2_to_3_ms=ess_back_ms, ess_2_to_3_next_frame_ms=ess_back_frame_ms,
         orbit_deg_per_pose=2.0, orbit=stats_ms(orbit_ms), orbit_ms=orbit_ms,
         last_renderer=eng.last_renderer)

    # ---- 5. parity
    result = device_parity(eng, cam, width, height, gpu=dev,
                           cpu=jax.devices("cpu")[0], seed=args.seed, **ref)
    emit("parity", image=f"{width}x{height}", **result,
         peak_bytes_in_use=peak_bytes(dev))
    if not result["ok"]:
        raise SystemExit("parity bar missed")

    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
