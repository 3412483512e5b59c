#!/usr/bin/env python3
"""Merge the measured CSVs ($OURS_DIR, default docs/benchmarks) with the
reference CSVs and report the
transferable signals: per-config ESS speedup ratios (skipmode X vs 0),
blocksize trends, and update-time comparisons. Markdown to stdout."""
import csv
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OURS = os.environ.get(
    "OURS_DIR", os.path.join(REPO, "docs", "benchmarks"))
REF = "/root/reference/scripts"


def load(prefix, path):
    rows = {}
    for sm in (0, 1, 2, 3):
        fn = os.path.join(path, f"{prefix}_{sm}.csv")
        if not os.path.exists(fn):
            continue
        with open(fn, newline="") as fh:
            for r in csv.DictReader(fh):
                key = (r["image"], float(r["gmin"]), float(r["gmax"]), sm,
                       int(r["blocksize"]))
                rows[key] = dict(fps=float(r["framerate"]),
                                 update=float(r["update"]),
                                 occ=float(r["occupancy"]))
    return rows


def main():
    ours = load("benchmark_results", OURS)
    ref = load("benchmark_results", REF)
    configs = sorted({(k[0], k[1], k[2]) for k in ours})
    print("| config | occ% (ours/ref) | none fps | block | dist | aniso |"
          " dist/none (ours) | dist/none (ref) |")
    print("|---|---|---|---|---|---|---|---|")
    for img, gmin, gmax in configs:
        def get(rows, sm, b=4):
            if sm == 0:
                cands = [v for k, v in rows.items()
                         if k[:3] == (img, gmin, gmax) and k[3] == 0]
                return cands[0] if cands else None
            return rows.get((img, gmin, gmax, sm, b))

        o0, o1, o2, o3 = (get(ours, s) for s in (0, 1, 2, 3))
        r0, r2 = get(ref, 0), get(ref, 2)
        if not (o0 and o2):
            continue
        tag = img + ("-grad" if gmax else "")
        occ = f"{o2['occ']:.2f}/{r2['occ']:.2f}" if r2 else f"{o2['occ']:.2f}"
        ratio_o = o2["fps"] / o0["fps"]
        ratio_r = (r2["fps"] / r0["fps"]) if (r0 and r2) else float("nan")
        print(f"| {tag} | {occ} | {o0['fps']:.1f} |"
              f" {o1['fps'] if o1 else 0:.1f} | {o2['fps']:.1f} |"
              f" {o3['fps'] if o3 else 0:.1f} | {ratio_o:.1f}x |"
              f" {ratio_r:.1f}x |")

    print()
    print("| config | update ms b=2..6 (dist, ours) | (dist, ref) |")
    print("|---|---|---|")
    for img, gmin, gmax in configs:
        tag = img + ("-grad" if gmax else "")
        ou = [ours.get((img, gmin, gmax, 2, b)) for b in range(2, 7)]
        ru = [ref.get((img, gmin, gmax, 2, b)) for b in range(2, 7)]
        fmt = lambda xs: " / ".join(f"{x['update']:.0f}" if x else "-" for x in xs)
        print(f"| {tag} | {fmt(ou)} | {fmt(ru)} |")


if __name__ == "__main__":
    main()
