"""pano as a library — embed the stitcher in your own Python process.

The CLI (`pano.sh run ...`) is a thin wrapper over the same calls shown
here; embedding skips per-process startup entirely (the jitted graphs and
the persistent compilation cache live as long as your process, which is the
serving model — see `pano.sh serve`).

Reference analog: linking against the reference's stitcher objects instead
of exec'ing its mains (src/serial/main.cpp:395-414 stitchAllImages).

Run:  python examples/library_quickstart.py IMG1 IMG2 [IMG3 ...] --out pano.jpg
      python examples/library_quickstart.py            # synthetic smoke demo
"""

import os
import sys

import numpy as np

# Allow running straight from a checkout: python examples/library_quickstart.py
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

if os.environ.get("PANO_CPU"):  # force the CPU backend (e.g. laptop dev);
    import jax                  # must happen before first JAX use
    jax.config.update("jax_platforms", "cpu")

from pano import DEFAULT_CONFIG, PairStitcher, stitch_all_images
from pano.io import imread_bgr, imwrite_bgr


def stitch_files(paths, out_path):
    """Production path: multiband chain stitch, single-sync fused dispatches."""
    images = [imread_bgr(p) for p in paths]
    for p, img in zip(paths, images):
        if img is None:
            raise SystemExit(f"could not read {p}")

    # dataclasses.replace works on every config level; every CLI flag maps
    # to one of these fields (see pano/config.py).
    import dataclasses

    config = dataclasses.replace(
        DEFAULT_CONFIG,
        stitch=dataclasses.replace(DEFAULT_CONFIG.stitch, blend="multiband"),
    )

    pano = stitch_all_images(
        images,
        config=config,
        print_timing=True,
        mode="chain",      # detect once per source image, composite globally
        timing="total",    # fused single-sync product path (the benchmarked one)
    )
    if pano is None:
        raise SystemExit("stitching failed")
    imwrite_bgr(out_path, pano)
    print(f"wrote {out_path}  ({pano.shape[1]}x{pano.shape[0]})")


def synthetic_demo():
    """No-dataset smoke: stitch two overlapping crops of a random scene.

    Uses the staged PairStitcher API directly — the per-stage entry points
    (detect / match / estimate) are public too, for callers that want the
    intermediates rather than the panorama.
    """
    rng = np.random.default_rng(0)
    scene = rng.integers(0, 255, (480, 960, 3), np.uint8)
    # Blur a little so Harris finds stable corners on structure, not noise.
    scene = (
        scene.astype(np.float32) * 0.25
        + np.roll(scene, 1, 1).astype(np.float32) * 0.75
    ).astype(np.uint8)
    left, right = scene[:, :640], scene[:, 320:]

    stitcher = PairStitcher(DEFAULT_CONFIG, print_timing=False)
    pano = stitcher.stitch_pair_fast(left, right)
    if pano is None:
        raise SystemExit("synthetic stitch failed")
    pano = np.asarray(pano)
    print(f"synthetic demo ok: {left.shape} + {right.shape} -> {pano.shape}")


if __name__ == "__main__":
    import argparse

    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter
    )
    parser.add_argument(
        "images", nargs="*", help="two or more image files (none: synthetic demo)"
    )
    parser.add_argument("--out", default="panorama.jpg", help="output file")
    ns = parser.parse_args()
    if len(ns.images) >= 2:
        stitch_files(ns.images, ns.out)
    elif len(ns.images) == 1:
        # One path is almost always a typo'd second path — fail loudly
        # instead of silently running the synthetic demo.
        parser.error("need at least two images (or none for the synthetic demo)")
    else:
        synthetic_demo()
