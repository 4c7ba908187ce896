#!/usr/bin/env python3
"""Pipelined serving-throughput benchmark: pairs/s at a bounded in-flight
window, the deployment analog of bench.py's single-pair latency number.

The reference has no serving story — each of its binaries processes one
image list per process (src/serial/main.cpp:430-451). For a
service the relevant number is throughput with dispatch/fetch overlap: the
host keeps DEPTH pairs' fused stitch graphs in flight and fetches the
oldest pair's packed result while the device works on the newer
dispatches, so the host's fetch and crop overlap device work instead of
leaving the device idle between pairs.

The loop runs the SAME device graphs as PairStitcher.stitch_pair_fast's
common path (fused estimate + tier-0 fused compose, one packed fetch + the
crop); pairs that would need the tier/staged fallback ladder are counted
and excluded from the claimed rate. Without image paths it stitches the
seeded 4156x3117 pano.scenes pair of seed 0.

Usage: python benchmark_throughput.py [--pairs N] [--depth D] [left right]
Prints one JSON line: {"metric": "pair_13mp_throughput_pairs_per_s", ...}
"""

import argparse
import json
import os
import sys
import time
from collections import deque

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))



def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--pairs", type=int, default=30)
    ap.add_argument("--depth", type=int, default=3)
    ap.add_argument("images", nargs="*")
    args = ap.parse_args()
    if len(args.images) not in (0, 2):
        ap.error(f"expected 0 or 2 image paths, got {len(args.images)}")

    import jax

    from pano import device, scenes
    from pano.config import DEFAULT_CONFIG
    from pano.io import imread_bgr
    from pano.pipeline import PairStitcher, _host_fetch, fast_path_crop

    if args.images:
        views = [imread_bgr(p) for p in args.images]
    else:
        views = scenes.make_scene(2, 3117, 4156, 0).views
    gpu = device.accelerator()
    left = jax.device_put(views[0], gpu)
    right = jax.device_put(views[1], gpu)
    stitcher = PairStitcher(DEFAULT_CONFIG, print_timing=False)

    def dispatch():
        """Queue one pair's full fused stitch; returns device handles."""
        est_packed, _pts = stitcher._fused_estimate(left, right)
        packed_out, canvas = stitcher._fused_compose(0)(
            left, right, est_packed
        )
        # Start the D2H copy of the packed vector now, so retire()'s fetch
        # DEPTH dispatches later finds it on the host.
        packed_out.copy_to_host_async()
        return packed_out, canvas

    def retire(handles):
        """Fetch the packed vector (the pipeline's one sync) and crop."""
        packed_out, canvas = handles
        status, cropped = fast_path_crop(_host_fetch(packed_out), canvas)
        return cropped if status == "ok" else None

    # Warmup (compiles); validate the fast path applies.
    pano = retire(dispatch())
    if pano is None:
        print("the pair needs the fallback ladder", file=sys.stderr)
        return 1
    jax.block_until_ready(pano)

    fallbacks = 0
    inflight = deque()
    t0 = time.perf_counter()
    for _ in range(args.pairs):
        inflight.append(dispatch())
        if len(inflight) >= args.depth:
            if retire(inflight.popleft()) is None:
                fallbacks += 1
    while inflight:
        if retire(inflight.popleft()) is None:
            fallbacks += 1
    total_s = time.perf_counter() - t0

    rate = (args.pairs - fallbacks) / total_s
    print(json.dumps({
        "metric": "pair_13mp_throughput_pairs_per_s",
        "value": round(rate, 2),
        "unit": "pairs/s",
        "ms_per_pair": round(total_s / args.pairs * 1e3, 2),
        "depth": args.depth,
        "fallback_pairs": fallbacks,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
