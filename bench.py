#!/usr/bin/env python3
"""Headline benchmark: ms/frame at 1920×1080, beetle-class volume,
anisotropic distance-map ESS, shaded, ERT on.

Prints ONE JSON line:
    {"metric": ..., "value": N, "unit": "ms/frame", "vs_baseline": N,
     "device": {...}, "card": "...", ...}

Baseline derivation (BASELINE.md): the reference's stag-beetle TF-a result
in the same skip mode (benchmark_results_<skipmode>.csv:14, 1200×1200) on
unrecorded GPU hardware, pixel-scaled to the measured image size.
``vs_baseline`` = baseline_ms / our_ms (>1 = faster than the reference).
The reference stretches every volume to a cube (its benchmark fit); this
bench keeps the aspect ratio unless ``VKV_BENCH_FIT=stretch``, and the
``fit`` field says which one was measured.

The CT datasets are not redistributable; the volume is a deterministic
synthetic stand-in with the same extents and calibrated to the same
occupancy (3.97 %) — the quantity that drives ESS work (see
vkvolume/bench/datasets.py).

One process on one GPU. It needs an NVIDIA GPU as JAX's default device
and exits non-zero, printing no result, when it has none or when any
step fails.

Environment overrides: BENCH_FRAMES, BENCH_REPS, BENCH_SCALE (volume
scale factor), BENCH_WIDTH/BENCH_HEIGHT, BENCH_DATASET, BENCH_SKIPMODE,
BENCH_RENDERER, VKV_BENCH_FIT.
"""

import json
import os
import sys
import time

import numpy as np


def main() -> int:
    frames = int(os.environ.get("BENCH_FRAMES", "20"))
    reps = int(os.environ.get("BENCH_REPS", "5"))
    scale = float(os.environ.get("BENCH_SCALE", "1.0"))
    width = int(os.environ.get("BENCH_WIDTH", "1920"))
    height = int(os.environ.get("BENCH_HEIGHT", "1080"))
    dataset = os.environ.get("BENCH_DATASET", "beetle")
    # AnisotropicDistance (skipmode 3) is the reference's own best mode
    # (benchmark_results_3.csv:14, 672.3 fps vs 623.8 for Distance).
    skipmode = int(os.environ.get("BENCH_SKIPMODE", "3"))

    from vkvolume.bench.device import card_info, describe, require_gpu
    from vkvolume.engine.engine import DEFAULT_RENDERER
    from vkvolume.utils import enable_compile_cache

    renderer = os.environ.get("BENCH_RENDERER", DEFAULT_RENDERER)
    dev = require_gpu()
    card = card_info()
    enable_compile_cache()

    from vkvolume.bench.datasets import DATASETS, synthesize
    from vkvolume.bench.harness import benchmark_camera, make_engine
    from vkvolume.options import Test

    t_start = time.time()
    vol_u8 = synthesize(DATASETS[dataset], seed=0, scale=scale)
    synth_s = time.time() - t_start
    eng, stats, _, _ = make_engine(
        dataset, skipmode, 4, scale=scale, volume_u8=vol_u8,
        renderer=renderer, test=Test.NONE, ert=True)

    cam = benchmark_camera(aspect=width / height)
    fit = os.environ.get("VKV_BENCH_FIT", "aspect")
    # Mode-matched reference fps (stag beetle TF-a, 1200x1200, BASELINE.md):
    # benchmark_results_{0..3}.csv:14 (None/Block/Distance/AnisoDist).
    ref_fps_1200 = {0: 75.3, 1: 340.3, 2: 623.8, 3: 672.3}[skipmode]
    baseline_ms = 1000.0 / (ref_fps_1200 / ((width * height) / 1200.0 ** 2))

    t0 = time.perf_counter()
    eng.render(cam, width, height).color.block_until_ready()
    first_frame_s = time.perf_counter() - t0

    rep_ms = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(frames):
            out = eng.render(cam, width, height)
        out.color.block_until_ready()
        rep_ms.append((time.perf_counter() - t0) / frames * 1e3)
    frame_ms = float(np.median(rep_ms))

    print(json.dumps({
        "metric": (f"ms/frame {width}x{height} {dataset} "
                   f"skipmode={skipmode} renderer={renderer} fit={fit} "
                   "(synthetic, occupancy+structure-matched)"),
        "value": round(frame_ms, 3),
        "unit": "ms/frame",
        "vs_baseline": round(baseline_ms / frame_ms, 4),
        "fit": fit,
        "fps": round(1000.0 / frame_ms, 2),
        "device": describe(dev),
        "card": card,
        "synth_s": round(synth_s, 1),
        "first_frame_s": round(first_frame_s, 2),
        "map_update_ms": round(stats.map_update_ms or 0.0, 3),
        "occupancy_pct": round(stats.occupied_voxel_percent or 0.0, 3),
        "frames": frames,
        "scale": scale,
        "rep_ms": [round(r, 3) for r in rep_ms],
        "rep_spread": round((max(rep_ms) - min(rep_ms)) / frame_ms, 3),
        "renderer_used": eng.last_renderer,
        "renderer_counts": dict(eng.renderer_counts),
        "protocol": f"{reps}x{frames}",
        "wall_s": round(time.time() - t_start, 1),
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
