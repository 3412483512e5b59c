#!/usr/bin/env python3
"""Regenerate <dir>/COMPARISON.md from the measured CSVs and
the reference's checked-in CSVs (ratios between modes are the transferable
signal — the reference GPU is unrecorded desktop hardware, BASELINE.md).

Usage: python scripts/make_comparison.py [docs/benchmarks]
Reference CSVs are read from the repo snapshot in docs/ (copied from
/root/reference/scripts at survey time) or REF_DIR.
"""

import csv
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load(path):
    """Rows keyed by (config, blocksize); the gradient-TF configs share
    the base image name and differ only in gmin/gmax (scripts/
    benchmark.py:27-34), so derive the -grad suffix from the TF."""
    rows = {}
    if not os.path.exists(path):
        return rows
    with open(path, newline="") as fh:
        for r in csv.DictReader(fh):
            cfg = r["image"]
            if float(r["gmax"]) > 0.0:
                cfg += "-grad"
            rows[(cfg, int(r["blocksize"]))] = r
    return rows


def main():
    out_dir = sys.argv[1] if len(sys.argv) > 1 else "docs/benchmarks"
    out_dir = os.path.join(REPO, out_dir)
    ref_dir = os.environ.get("REF_DIR", "/root/reference/scripts")

    ours = {sm: load(os.path.join(out_dir, f"benchmark_results_{sm}.csv"))
            for sm in range(4)}
    ref = {sm: load(os.path.join(ref_dir, f"benchmark_results_{sm}.csv"))
           for sm in range(4)}

    configs = ["beetle", "beetle-grad", "present", "present-grad",
               "snake", "snake-grad"]
    B = 4                                        # headline block size

    lines = [
        "# Benchmark vs reference (ratios are the signal)",
        "",
        "Generated by `scripts/make_comparison.py` from the CSVs in this",
        "directory and the reference's checked-in results (1200x1200,",
        "NumTextureSamples, ERT off — scripts/benchmark.py protocol).",
        "",
        "| config | occ% (ours/ref) | none fps | block | dist | aniso |"
        " dist/none (ours) | dist/none (ref) |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for cfg in configs:
        def fps(sm, who):
            # Skipmode 0 is blocksize-invariant; our CSV keeps one row
            # (b=2) where the reference duplicates it per blocksize.
            # Other skipmodes must NOT silently substitute b=2 numbers.
            r = who[sm].get((cfg, B))
            if r is None and sm == 0:
                r = who[sm].get((cfg, 2))
            return float(r["framerate"]) if r else None

        o = [fps(sm, ours) for sm in range(4)]
        r0 = fps(0, ref)
        r2 = fps(2, ref)
        occ_o = ours[2].get((cfg, B))
        occ_r = ref[2].get((cfg, B))
        if None in o or not occ_o or not occ_r or not r0 or not r2:
            lines.append(f"| {cfg} | (incomplete) | | | | | | |")
            continue
        lines.append(
            f"| {cfg} | {float(occ_o['occupancy']):.2f}/"
            f"{float(occ_r['occupancy']):.2f} | {o[0]:.1f} | {o[1]:.1f} | "
            f"{o[2]:.1f} | {o[3]:.1f} | {o[2] / o[0]:.1f}x | "
            f"{r2 / r0:.1f}x |")

    lines += [
        "",
        "| config | update ms b=2..6 (dist, ours) | (dist, ref) |",
        "|---|---|---|",
    ]
    for cfg in configs:
        def upd(who):
            vals = []
            for b in range(2, 7):
                r = who[2].get((cfg, b))
                vals.append(f"{float(r['update']):.0f}" if r else "?")
            return " / ".join(vals)

        lines.append(f"| {cfg} | {upd(ours)} | {upd(ref)} |")

    lines += [
        "",
        "Aniso-vs-iso fps at b=4 (skipmode 3 vs 2; reference gains ~8%):",
        "",
        "| config | ours sm3/sm2 | ref sm3/sm2 |",
        "|---|---|---|",
    ]
    for cfg in configs:
        def ratio(who):
            a = who[3].get((cfg, B))
            d = who[2].get((cfg, B))
            if not a or not d:
                return "?"
            return f"{float(a['framerate']) / float(d['framerate']):.2f}"

        lines.append(f"| {cfg} | {ratio(ours)} | {ratio(ref)} |")

    out = os.path.join(out_dir, "COMPARISON.md")
    with open(out, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
