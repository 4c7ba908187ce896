#!/usr/bin/env python3
"""Serial-vs-accelerated comparison (reference benchmark_serial_parallel.py).

The reference compares its serial binary against 64-thread OpenMP per
dataset, parsing 'Image Stitching:' and 'Total Execution Time (OpenMP):'
lines, appending CSV, and drawing a grouped bar chart with auto log scale
(benchmark_serial_parallel.py:26-105). Here the comparison is the JAX CPU
oracle vs the GPU path, same output artifacts. Without --datasets the
datasets are seeded 4-view pano.scenes chains (seeds 0, 1, 2).
"""

import argparse
import csv
import os
import re
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))

STITCH_RE = re.compile(
    r"^Total Stitching Process(?: \((?:GPU|Sharded|OpenMP)\))?: ([\d.]+) ms$",
    re.M,
)


def run_impl(impl, image_args):
    proc = subprocess.run(
        [sys.executable, "-m", "pano.cli", impl, "--warmup"] + image_args,
        capture_output=True,
        text=True,
        cwd=HERE,
    )
    matches = STITCH_RE.findall(proc.stdout)
    if not matches:
        print(proc.stdout[-1500:], proc.stderr[-1500:], file=sys.stderr)
        raise RuntimeError(f"no timing line from {impl}")
    return float(matches[-1]) / 1000.0  # seconds, like the reference CSV


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--datasets", default=None,
                    help="comma list of image directories")
    ap.add_argument("--csv", default="serial_vs_gpu.csv")
    ap.add_argument("--plot", default="serial_vs_gpu.png")
    ap.add_argument("--repeats", type=int, default=2)
    args = ap.parse_args()

    tmp = tempfile.mkdtemp(prefix="bench_sp_")
    if args.datasets is None:
        from pano import scenes

        dirs = []
        for seed in (0, 1, 2):
            d = os.path.join(tmp, f"scene{seed}")
            scenes.write_views(scenes.make_scene(4, 3117, 4156, seed), d)
            dirs.append(d)
    else:
        dirs = args.datasets.split(",")

    rows = []
    for ds in dirs:
        name = os.path.basename(ds.rstrip("/"))
        out = os.path.join(tmp, f"{name}.png")
        image_args = ["--dir", ds, "--out", out]
        serial_s = min(run_impl("serial", image_args)
                       for _ in range(args.repeats))
        gpu_s = min(run_impl("gpu", image_args) for _ in range(args.repeats))
        rows.append(
            {"dataset": name, "serial_s": serial_s, "gpu_s": gpu_s,
             "speedup": serial_s / gpu_s}
        )
        print(f"{name}: serial={serial_s:.2f}s gpu={gpu_s:.2f}s "
              f"speedup={serial_s / gpu_s:.1f}x", flush=True)

    exists = os.path.exists(args.csv)
    with open(args.csv, "a", newline="") as f:
        w = csv.DictWriter(
            f, fieldnames=["dataset", "serial_s", "gpu_s", "speedup"]
        )
        if not exists:
            w.writeheader()
        w.writerows(rows)
    print(f"Appended {args.csv}")

    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        import numpy as np

        names = [r["dataset"] for r in rows]
        x = np.arange(len(names))
        plt.figure(figsize=(8, 5))
        plt.bar(x - 0.2, [r["serial_s"] for r in rows], 0.4, label="serial (CPU)")
        plt.bar(x + 0.2, [r["gpu_s"] for r in rows], 0.4, label="GPU")
        spread = max(r["serial_s"] for r in rows) / max(
            1e-9, min(r["gpu_s"] for r in rows)
        )
        if spread > 10:  # reference auto-log rule (:96-100)
            plt.yscale("log")
        plt.xticks(x, names)
        plt.ylabel("total stitching time (s)")
        plt.legend()
        plt.grid(True, axis="y", alpha=0.3)
        plt.savefig(args.plot, dpi=120, bbox_inches="tight")
        print(f"Wrote {args.plot}")
    except Exception as e:  # pragma: no cover
        print(f"plotting skipped: {e}", file=sys.stderr)


if __name__ == "__main__":
    main()
