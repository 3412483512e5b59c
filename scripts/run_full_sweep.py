#!/usr/bin/env python3
"""The FULL reference benchmark protocol at full scale.

All 6 dataset/TF configs × skipmodes {0,1,2,3} × block sizes {2..6}
(skipmode 0 runs one block size, like scripts/benchmark.py:71), 1200×1200,
ERT off, NumTextureSamples output, fit-to-viewport — writes
$OUT_DIR/benchmark_results_{0..3}.csv (default docs/benchmarks) in the
reference CSV schema (scripts/benchmark.py:66-93). Rows already in the
CSVs are skipped, so an interrupted sweep resumes.

Environment: OUT_DIR, SWEEP_SKIPMODES, SWEEP_BLOCKSIZES, SWEEP_W, SWEEP_H,
SWEEP_FRAMES, SWEEP_SCALE.
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from vkvolume.bench.harness import run_sweep
from vkvolume.utils import enable_compile_cache


def main():
    enable_compile_cache()
    out_dir = os.environ.get("OUT_DIR", "docs/benchmarks")
    os.makedirs(out_dir, exist_ok=True)
    t0 = time.time()

    def log(msg):
        print(f"[{time.time() - t0:8.1f}s] {msg}", flush=True)

    # Distance/AnisoDist at the reference's headline block size 4 first;
    # None/Block fill in afterwards.
    run_sweep(
        skipmodes=tuple(int(s) for s in os.environ.get(
            "SWEEP_SKIPMODES", "2,3,0,1").split(",")),
        blocksizes=tuple(int(b) for b in os.environ.get(
            "SWEEP_BLOCKSIZES", "4,2,3,5,6").split(",")),
        width=int(os.environ.get("SWEEP_W", "1200")),
        height=int(os.environ.get("SWEEP_H", "1200")),
        frames=int(os.environ.get("SWEEP_FRAMES", "10")),
        scale=float(os.environ.get("SWEEP_SCALE", "1.0")),
        out_prefix=os.path.join(out_dir, "benchmark_results"),
        log=log,
    )
    log("done")


if __name__ == "__main__":
    main()
