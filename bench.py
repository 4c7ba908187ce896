#!/usr/bin/env python3
"""Pair-stitch benchmark on the GPU: a seeded 4156x3117 pair.

Prints ONE JSON line:
  {"metric": "pair_13mp_stitch_ms", "value": <ms>, "unit": "ms",
   "device_compute_ms": <ms>, "device": <kind>, "card": <name, power limit>}

`value` is the steady-state per-pair wall-clock (mean over one timed block
of PANO_BENCH_REPEATS iterations) of the full stitchTwoImages-equivalent
(Harris x2 -> match -> RANSAC -> fused warp+blend, device-resident,
including the host crop) on the pano.scenes pair of seed 0, after one
warmup iteration that pays XLA compilation. `device_compute_ms` is the
GPU's busy time per pair from a profiler trace of a separate block.

Exits non-zero, printing no result, when JAX finds no GPU.
"""

import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

SIZE = (3117, 4156)
SEED = 0


def main():
    import jax

    from pano import device, scenes
    from pano.config import DEFAULT_CONFIG
    from pano.pipeline import PairStitcher

    sys.path.insert(0, os.path.join(HERE, "tools"))
    import xprof_summary

    gpu = device.accelerator()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.splitlines()[gpu.id].strip()
    repeats = int(os.environ.get("PANO_BENCH_REPEATS", "5"))

    scene = scenes.make_scene(2, SIZE[0], SIZE[1], SEED)
    left = jax.device_put(scene.views[0], gpu)
    right = jax.device_put(scene.views[1], gpu)
    stitcher = PairStitcher(DEFAULT_CONFIG, print_timing=False)

    # Warmup: pays compilation for every stage + the canvas bucket.
    pano = stitcher.stitch_pair_fast(left, right)
    if pano is None:
        print("stitch failed", file=sys.stderr)
        return 1
    jax.block_until_ready(pano)

    # Timed as one block: the device executes dispatches in order, so the
    # final block_until_ready covers every iteration's trailing crop.
    t0 = time.perf_counter()
    for _ in range(repeats):
        pano = stitcher.stitch_pair_fast(left, right)
    jax.block_until_ready(pano)
    value = (time.perf_counter() - t0) * 1e3 / repeats

    # Device busy time per pair from a SEPARATE traced block, so profiler
    # overhead never touches the wall-clock number.
    trace_reps = 3
    with tempfile.TemporaryDirectory() as td:
        with jax.profiler.trace(td):
            for _ in range(trace_reps):
                pano = stitcher.stitch_pair_fast(left, right)
            jax.block_until_ready(pano)
        pd = xprof_summary.load(xprof_summary.find_pb(td))
        device_ms = xprof_summary.device_busy_ms(pd) / trace_reps
    if device_ms <= 0.0:
        print("the trace holds no device time", file=sys.stderr)
        return 1

    print(json.dumps({
        "metric": "pair_13mp_stitch_ms",
        "value": round(value, 3),
        "unit": "ms",
        "device_compute_ms": round(device_ms, 3),
        "device": gpu.device_kind,
        "card": card,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
