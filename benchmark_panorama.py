#!/usr/bin/env python3
"""Strong/weak scaling benchmark (reference benchmark_panorama.py:1-142).

The reference sweeps OMP_NUM_THREADS in {1..64} over the OpenMP binary and
parses its 'Total Execution Time (OpenMP):' stdout line; the scaling axes
here are image resolution (weak scaling: downsample so per-unit work
tracks the reference's sqrt(t/max) rule, benchmark_panorama.py:52-63) and —
when more than one device is visible — the mesh size for the sharded path.

Outputs CSV + log-log matplotlib plots with ideal-scaling lines, like the
reference (benchmark_panorama.py:101-137). Without --dataset the images
are the seeded 4156x3117 pano.scenes pair of seed 0. Needs opencv-python
(downsampling).
"""

import argparse
import csv
import os
import re
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))

TIME_RE = {
    "serial": re.compile(r"^Total Execution Time: ([\d.]+) ms$", re.M),
    "gpu": re.compile(r"^Total Execution Time(?: \(GPU\))?: ([\d.]+) ms$", re.M),
    "sharded": re.compile(
        r"^Total Execution Time \((?:Sharded|OpenMP)\): ([\d.]+) ms$", re.M
    ),
}
STITCH_RE = re.compile(
    r"^Total Stitching Process(?: \((?:GPU|Sharded|OpenMP)\))?: ([\d.]+) ms$",
    re.M,
)


def downsample_images(src_dir, dst_dir, scale):
    """Reference downsample rule (benchmark_panorama.py:11-21)."""
    import cv2

    os.makedirs(dst_dir, exist_ok=True)
    for name in sorted(os.listdir(src_dir)):
        path = os.path.join(src_dir, name)
        img = cv2.imread(path)
        if img is None:
            continue
        if scale < 1.0:
            img = cv2.resize(
                img,
                (max(2, int(img.shape[1] * scale)),
                 max(2, int(img.shape[0] * scale))),
            )
        cv2.imwrite(os.path.join(dst_dir, name), img)


def run_once(impl, image_dir, out_file, env=None):
    full_env = dict(os.environ)
    if env:
        full_env.update(env)
    proc = subprocess.run(
        [sys.executable, "-m", "pano.cli", impl, "--warmup", "--dir",
         image_dir, "--out", out_file],
        capture_output=True,
        text=True,
        env=full_env,
        cwd=HERE,
    )
    matches = STITCH_RE.findall(proc.stdout)
    if not matches:
        print(proc.stdout[-2000:], proc.stderr[-2000:], file=sys.stderr)
        raise RuntimeError(f"no timing line from {impl}")
    return float(matches[-1])


def _device_worker(args):
    """Child process for one device count: times the sharded batch paths.

    Separate process because the virtual device count (XLA_FLAGS) must be
    set before JAX initializes. On a host with real multi-chip hardware the
    forcing is skipped and the real mesh is used.
    """
    n = args._worker
    import time

    import numpy as np

    if not args.real_mesh:
        os.environ["JAX_PLATFORMS"] = "cpu"
        flags = os.environ.get("XLA_FLAGS", "")
        os.environ["XLA_FLAGS"] = (
            flags + f" --xla_force_host_platform_device_count={n}"
        ).strip()
    import jax

    if not args.real_mesh:
        jax.config.update("jax_platforms", "cpu")
    import cv2
    import jax.numpy as jnp

    from pano.config import HarrisOptions, PanoConfig, RansacOptions
    from pano.parallel import shard

    assert len(jax.devices()) >= n, (len(jax.devices()), n)

    # Strong scaling: fixed total work (B pairs) over n devices. Weak
    # scaling (--weak): work ∝ parallelism — batch = B*n so per-device
    # load is constant, the device-axis analog of the reference's
    # area-∝-threads rule (reference benchmark_panorama.py:52-63).
    names = sorted(
        f for f in os.listdir(args.dataset)
        if f.lower().endswith((".jpg", ".png"))
    )[:2]
    imgs = []
    for f in names:
        im = cv2.imread(os.path.join(args.dataset, f))
        im = cv2.resize(
            im,
            (int(im.shape[1] * args.device_scale),
             int(im.shape[0] * args.device_scale)),
            interpolation=cv2.INTER_AREA,
        )
        imgs.append(im)
    h = min(i.shape[0] for i in imgs)
    w = min(i.shape[1] for i in imgs)
    imgs = [i[:h, :w] for i in imgs]
    if args.weak:
        b = args.batch * n          # constant per-device load
    else:
        # Pad the batch up to a multiple of the mesh's data axis (the
        # sharded batch paths require divisibility).
        b = ((args.batch + n - 1) // n) * n
    lefts = jnp.asarray(np.stack([imgs[0]] * b), jnp.uint8)
    rights = jnp.asarray(np.stack([imgs[1]] * b), jnp.uint8)

    cfg = PanoConfig(
        harris=HarrisOptions(max_keypoints=args.kpts),
        ransac=RansacOptions(num_iterations=1024),
    )
    mesh = shard.make_mesh(n_data=n, n_hyp=1)

    from pano import pipeline

    # Count host fetches (device->host syncs) so the sweep asserts the
    # SCALING STRUCTURE — one fetch per batch regardless of batch or device
    # count — even where wall-clock over virtual devices is meaningless
    # (the host's cores time-slice them).
    fetch_calls = []
    real_fetch = pipeline._host_fetch
    pipeline._host_fetch = lambda x: (fetch_calls.append(1), real_fetch(x))[1]

    def run_est():
        packed, _ = shard.fused_estimate_batched(lefts, rights, cfg, mesh)
        pipeline._host_fetch(packed)  # one host sync for the whole batch

    def run_full():
        shard.stitch_pairs_batched(lefts, rights, cfg, mesh)

    out = {}
    for label, fn in (("est", run_est), ("full", run_full)):
        fn()  # warmup: pays compiles
        times = []
        for _ in range(args.repeats):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        out[label] = min(times)
        fetch_calls.clear()
        fn()
        out[label + "_fetches"] = len(fetch_calls)
    print(
        f"DEVICE_SWEEP devices={n} batch={b} est_ms={out['est']:.1f} "
        f"full_ms={out['full']:.1f} est_fetches={out['est_fetches']} "
        f"full_fetches={out['full_fetches']}",
        flush=True,
    )


def _device_sweep(args):
    """Parent: sweep device counts, collect, write CSV + log-log plot.

    The multi-device analog of the reference's OMP_NUM_THREADS 1..64 sweep
    (reference benchmark_panorama.py:26,38-63,85,101-137): the
    parallelism axis is the mesh size over which the batch of pairs is
    sharded, instead of a thread count. Default is strong scaling (fixed
    batch); --weak couples work to parallelism (batch = --batch x devices,
    constant per-device load), the device-axis analog of the reference's
    area-proportional-to-threads rule. Each row also records the host-fetch
    count per batch — the sync-structure invariant (1 fetch per batch) that
    holds regardless of wall-clock noise on time-sliced virtual devices.
    """
    counts = [int(c) for c in args.devices.split(",")]
    line_re = re.compile(
        r"DEVICE_SWEEP devices=(\d+) batch=(\d+) est_ms=([\d.]+) "
        r"full_ms=([\d.]+) est_fetches=(\d+) full_fetches=(\d+)"
    )
    rows = []
    for n in counts:
        cmd = [
            sys.executable, os.path.abspath(__file__),
            "--_worker", str(n),
            "--dataset", args.dataset,
            "--batch", str(args.batch),
            "--kpts", str(args.kpts),
            "--device-scale", str(args.device_scale),
            "--repeats", str(args.repeats),
        ] + (["--real-mesh"] if args.real_mesh else []) \
          + (["--weak"] if args.weak else [])
        proc = subprocess.run(
            cmd, capture_output=True, text=True, cwd=HERE
        )
        m = line_re.search(proc.stdout)
        if not m:
            print(proc.stdout[-2000:], proc.stderr[-2000:], file=sys.stderr)
            raise RuntimeError(f"device sweep worker failed for n={n}")
        rows.append(
            {
                "devices": n,
                "batch": int(m.group(2)),
                "est_ms": float(m.group(3)),
                "full_ms": float(m.group(4)),
                "pairs_per_s": 1e3 * int(m.group(2)) / float(m.group(4)),
                "est_fetches": int(m.group(5)),
                "full_fetches": int(m.group(6)),
            }
        )
        print(
            f"devices={n} batch={rows[-1]['batch']} "
            f"est={rows[-1]['est_ms']:.1f} ms "
            f"full={rows[-1]['full_ms']:.1f} ms "
            f"({rows[-1]['pairs_per_s']:.2f} pairs/s, "
            f"{rows[-1]['est_fetches']}/{rows[-1]['full_fetches']} fetches)",
            flush=True,
        )

    with open(args.csv, "w", newline="") as f:
        w = csv.DictWriter(
            f,
            fieldnames=["devices", "batch", "est_ms", "full_ms",
                        "pairs_per_s", "est_fetches", "full_fetches"],
        )
        w.writeheader()
        w.writerows(rows)
    print(f"Wrote {args.csv}")

    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        ns = [r["devices"] for r in rows]
        plt.figure(figsize=(7, 5))
        for key, label in (("est_ms", "estimation (fused batch)"),
                           ("full_ms", "full stitch (est + composite)")):
            ys = [r[key] for r in rows]
            plt.loglog(ns, ys, "o-", label=f"{label} measured")
            if args.weak:
                # Weak scaling: per-device load constant => ideal is flat.
                ideal = [ys[0]] * len(ns)
                ideal_lbl = f"{label} ideal (flat)"
            else:
                ideal = [ys[0] * ns[0] / n for n in ns]
                ideal_lbl = f"{label} ideal 1/n"
            plt.loglog(ns, ideal, "--", alpha=0.6, label=ideal_lbl)
        plt.xlabel("devices (mesh 'data' axis)")
        if args.weak:
            plt.ylabel(
                f"batch of {args.batch}x devices pairs: time (ms)"
            )
            regime = "weak"
        else:
            plt.ylabel(f"batch of {rows[0]['batch']} pairs: time (ms)")
            regime = "strong"
        plt.title(
            f"Device-count {regime} scaling — "
            f"{os.path.basename(args.dataset)}"
        )
        plt.xticks(ns, [str(n) for n in ns])
        plt.legend(fontsize=8)
        plt.grid(True, which="both", alpha=0.3)
        plt.savefig(args.plot, dpi=120, bbox_inches="tight")
        print(f"Wrote {args.plot}")
    except Exception as e:  # pragma: no cover
        print(f"plotting skipped: {e}", file=sys.stderr)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default=None,
                    help="image directory (default: the seeded scene pair)")
    ap.add_argument("--impl", default="gpu",
                    choices=["serial", "gpu", "sharded"])
    ap.add_argument(
        "--scales", default="0.125,0.177,0.25,0.354,0.5,0.707,1.0",
        help="resolution scales to sweep (weak-scaling axis)",
    )
    ap.add_argument(
        "--devices", default=None,
        help="comma list of device counts: run the parallelism-axis strong-"
        "scaling sweep instead (virtual CPU mesh unless --real-mesh)",
    )
    ap.add_argument("--real-mesh", action="store_true",
                    help="use the real device mesh (multi-chip hardware)")
    ap.add_argument("--weak", action="store_true",
                    help="weak scaling for the device sweep: batch = "
                    "--batch x devices so per-device load is constant "
                    "(the device-axis analog of the reference's "
                    "area-proportional-to-threads rule)")
    ap.add_argument("--batch", type=int, default=8,
                    help="pairs per batch for the device sweep")
    ap.add_argument("--kpts", type=int, default=1024,
                    help="keypoint capacity for the device sweep")
    ap.add_argument("--device-scale", type=float, default=0.125,
                    dest="device_scale",
                    help="image downscale for the device sweep")
    ap.add_argument("--_worker", type=int, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--repeats", type=int, default=2)
    ap.add_argument("--csv", default="benchmark_results.csv")
    ap.add_argument("--plot", default="benchmark_scaling.png")
    args = ap.parse_args()
    if args.dataset is None:
        from pano import scenes

        args.dataset = os.path.join(tempfile.mkdtemp(), "scene")
        scenes.write_views(scenes.make_scene(2, 3117, 4156, 0), args.dataset)

    if args._worker is not None:
        _device_worker(args)
        return
    if args.devices:
        _device_sweep(args)
        return

    scales = [float(s) for s in args.scales.split(",")]
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        for scale in scales:
            d = os.path.join(tmp, f"s{scale}")
            downsample_images(args.dataset, d, scale)
            times = [
                run_once(args.impl, d, os.path.join(tmp, "out.jpg"))
                for _ in range(args.repeats)
            ]
            best = min(times)
            area = scale * scale
            rows.append({"scale": scale, "area": area, "ms": best})
            print(f"scale={scale:.3f} area={area:.3f} best={best:.1f} ms",
                  flush=True)

    with open(args.csv, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=["scale", "area", "ms"])
        w.writeheader()
        w.writerows(rows)
    print(f"Wrote {args.csv}")

    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        areas = [r["area"] for r in rows]
        ms = [r["ms"] for r in rows]
        plt.figure(figsize=(7, 5))
        plt.loglog(areas, ms, "o-", label=f"{args.impl} measured")
        ideal = [ms[-1] * a / areas[-1] for a in areas]
        plt.loglog(areas, ideal, "--", label="ideal (linear in pixels)")
        plt.xlabel("image area (fraction of full)")
        plt.ylabel("total stitching time (ms)")
        plt.title(f"Resolution scaling — {os.path.basename(args.dataset)}")
        plt.legend()
        plt.grid(True, which="both", alpha=0.3)
        plt.savefig(args.plot, dpi=120, bbox_inches="tight")
        print(f"Wrote {args.plot}")
    except Exception as e:  # pragma: no cover
        print(f"plotting skipped: {e}", file=sys.stderr)


if __name__ == "__main__":
    main()
