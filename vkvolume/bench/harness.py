"""Benchmark harness — twin of the reference's ``scripts/benchmark.py``.

Reproduces the reference measurement protocol (BASELINE.md): per
(dataset, skipmode, blocksize) configuration render N frames of a static
fit-to-viewport view and report

    image, skipmode, blocksize, occupancy, framerate, update, imin, imax,
    gmin, gmax

in the same CSV schema as scripts/benchmark_results_<skipmode>.csv. Benchmark
mode forces clip_distance = 1, ERT off, NumTextureSamples output
(src/volume_render.cpp:177-183); map-update time is a 5-run average
(:421-430); occupancy % comes from the voxel-count reduction (:399-418).
"""

from __future__ import annotations

import dataclasses
import os
import time

import numpy as np

from ..camera import fit_distance, orbit_camera
from ..engine import Engine, RenderOptions, from_array
from ..engine.engine import DEFAULT_RENDERER
from ..options import SkippingType, Test, VolumeOptions
from .datasets import DATASETS, synthesize

CSV_COLUMNS = ["image", "skipmode", "blocksize", "occupancy", "framerate",
               "update", "imin", "imax", "gmin", "gmax"]


def benchmark_camera(aspect: float, azimuth=30.0, elevation=20.0):
    """Deterministic stand-in for the reference's free-camera benchmark pose:
    the volume is a 100-unit cube at the origin (src/volume_render.cpp:233)
    and the camera is placed so it fills the viewport."""
    radius = fit_distance(50.0, np.deg2rad(60.0), aspect) * 1.05
    return orbit_camera(radius=radius, azimuth_deg=azimuth,
                        elevation_deg=elevation, aspect=aspect)


@dataclasses.dataclass
class BenchResult:
    image: str
    skipmode: int
    blocksize: int
    occupancy: float
    framerate: float
    update: float
    imin: float
    imax: float
    gmin: float
    gmax: float
    frame_ms: float = 0.0
    load_s: float = 0.0
    rep_ms: tuple = ()        # per-repetition ms/frame (spread diagnostics)
    renderer_used: str = ""
    renderer_counts: dict | None = None   # frames per renderer (fallback rate)

    def row(self):
        return [self.image, self.skipmode, self.blocksize,
                round(self.occupancy, 6), round(self.framerate, 2),
                round(self.update, 4), self.imin, self.imax, self.gmin,
                self.gmax]


def make_engine(
    dataset_key: str,
    skipmode: int,
    blocksize: int = 4,
    *,
    scale: float = 1.0,
    seed: int = 0,
    volume_u8=None,
    renderer: str = DEFAULT_RENDERER,
    benchmark_mode: bool = True,
    test: Test | None = None,
    ert: bool | None = None,
):
    """Engine + loaded synthetic volume for one benchmark config (the setup
    shared by run_config, bench.py and chip_smoke.py).
    Returns (engine, add_volume stats, volume array, synthesis seconds)."""
    ds = DATASETS[dataset_key]
    t_load = time.perf_counter()
    if volume_u8 is None:
        volume_u8 = synthesize(ds, seed=seed, scale=scale)
    load_s = time.perf_counter() - t_load

    opts = VolumeOptions(
        intensity_min=ds.imin, intensity_max=ds.imax,
        gradient_min=ds.gmin, gradient_max=ds.gmax,
    )
    eng = Engine(RenderOptions(skipping_type=SkippingType(skipmode)),
                 benchmark_mode=benchmark_mode, renderer=renderer)
    if test is not None:
        eng.options.test = test
    if ert is not None:
        eng.options.early_ray_termination = ert
    vol = from_array(volume_u8, opts, block_size=blocksize, name=ds.filename)
    d, h, w = volume_u8.shape
    if os.environ.get("VKV_BENCH_FIT", "aspect") == "stretch":
        # The reference benchmark's EXACT fit: stretch every axis to 100
        # (volume_render.cpp:224-233). Measured (CPU plan, beetle az30):
        # The default stays aspect-preserving; flip the env for a
        # protocol-matched A/B.
        vol.set_scale((100.0 / w, 100.0 / h, 100.0 / d))
    else:
        vol.set_scale((100.0 / max(d, h, w),) * 3)
    stats = eng.add_volume(vol)
    return eng, stats, volume_u8, load_s


def run_config(
    dataset_key: str,
    skipmode: int,
    blocksize: int,
    *,
    width: int = 1200,
    height: int = 1200,
    frames: int = 20,
    scale: float = 1.0,
    seed: int = 0,
    volume_u8=None,
    test: Test | None = None,
    ert: bool | None = None,
    renderer: str = DEFAULT_RENDERER,
    orbit_deg: float = 0.0,
) -> BenchResult:
    ds = DATASETS[dataset_key]
    eng, stats, volume_u8, load_s = make_engine(
        dataset_key, skipmode, blocksize, scale=scale, seed=seed,
        volume_u8=volume_u8, renderer=renderer, test=test, ert=ert,
    )

    aspect = width / height

    def cam_for(i):
        return benchmark_camera(aspect, azimuth=30.0 + orbit_deg * i)

    # Warm the jit cache, then time the steady state (the reference's
    # 1000-frame average is likewise steady-state, scripts/benchmark.py:55),
    # as the MEDIAN of several repetitions (the spread is kept in rep_ms).
    #
    # ``orbit_deg`` spins the camera (the reference protocol uses a free
    # camera): every timed pose is FRESH, so each pays its host-side view
    # analysis and ray setup.
    out = eng.render(cam_for(0), width, height)
    out.color.block_until_ready()
    reps = []
    idx = 0
    for _rep in range(5):
        t0 = time.perf_counter()
        for _ in range(frames):
            out = eng.render(cam_for(idx), width, height)
            idx += 1
        out.color.block_until_ready()
        reps.append((time.perf_counter() - t0) / frames * 1e3)
    frame_ms = float(np.median(reps))

    return BenchResult(
        image=dataset_key.split("-")[0],
        skipmode=skipmode,
        blocksize=blocksize,
        occupancy=stats.occupied_voxel_percent or 0.0,
        framerate=1000.0 / frame_ms,
        update=stats.map_update_ms or 0.0,
        imin=ds.imin, imax=ds.imax, gmin=ds.gmin, gmax=ds.gmax,
        frame_ms=frame_ms, load_s=load_s,
        rep_ms=tuple(round(r, 3) for r in reps),
        renderer_used=getattr(eng, "last_renderer", ""),
        renderer_counts=dict(getattr(eng, "renderer_counts", {}) or {}),
    )


def run_sweep(
    *,
    dataset_keys=("present", "present-grad", "beetle", "beetle-grad",
                  "snake", "snake-grad"),
    skipmodes=(0, 1, 2, 3),
    blocksizes=(2, 3, 4, 5, 6),
    width=1200, height=1200, frames=20, scale=1.0,
    out_prefix="benchmark_results",
    log=print,
):
    """Full sweep, one CSV per skipmode (scripts/benchmark.py:66-93).
    skipmode 0 only runs the first block size, like the reference (:71).

    Rows are appended to the CSV as they complete and already-present
    (image, blocksize, TF) rows are skipped on restart, so an interrupted
    sweep resumes where it stopped instead of starting over."""
    import csv
    import os

    for skipmode in skipmodes:
        path = f"{out_prefix}_{skipmode}.csv"
        done = set()
        if os.path.exists(path):
            with open(path, newline="") as fh:
                for row in csv.DictReader(fh):
                    done.add((row["image"], int(row["blocksize"]),
                              float(row["gmin"]), float(row["gmax"])))
        else:
            with open(path, "w", newline="") as fh:
                csv.writer(fh).writerow(CSV_COLUMNS)
        for key in dataset_keys:
            cached_vol = None
            for b in blocksizes:
                # Skipmode 0 runs exactly one block size — the SMALLEST,
                # matching the reference's first-of-list b=2
                # (scripts/benchmark.py:71) regardless of caller priority
                # order.
                if skipmode == 0 and b != min(blocksizes):
                    continue
                ds = DATASETS[key]
                sig = (key.split("-")[0], b, ds.gmin, ds.gmax)
                if sig in done:
                    log(f"{key} skipmode={skipmode} b={b}: already done")
                    continue
                if cached_vol is None:
                    cached_vol = synthesize(ds, scale=scale)
                r = run_config(key, skipmode, b, width=width, height=height,
                               frames=frames, scale=scale,
                               volume_u8=cached_vol)
                log(f"{key} skipmode={skipmode} b={b}: "
                    f"{r.framerate:.1f} fps, update {r.update:.2f} ms, "
                    f"occ {r.occupancy:.2f}%")
                with open(path, "a", newline="") as fh:
                    csv.writer(fh).writerow(r.row())
        log(f"wrote {path}")
