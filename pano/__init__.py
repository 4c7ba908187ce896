"""pano — panoramic image stitching on an accelerator with JAX/XLA.

A ground-up JAX/XLA re-design of the pipeline in
Albus-Tan/UCB-CS267-Parallel-Panoramic-Image-Stitching (Harris corners ->
SSD patch matching -> RANSAC homography -> perspective warp -> blending):
fixed-shape masked tensors, one matrix product for matching, vmapped
hypothesis batches for RANSAC, fused warp+blend, and shard_map scaling over
device meshes instead of OpenMP threads / CUDA blocks. Its accelerator is
an NVIDIA GPU; the `serial` CLI implementation runs the same code on the
CPU as the reference-semantics oracle.
"""

import os

import jax

# Persistent XLA compilation cache. JAX itself honours
# JAX_COMPILATION_CACHE_DIR; without it the cache lives at a fixed path in
# the checkout (the path is part of the cache key, so it must not move).
if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    jax.config.update(
        "jax_compilation_cache_dir",
        os.path.join(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            ".jax_cache",
        ),
    )
jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)

# Geometry math (3x3 homography chains, 8x8 DLT solves, 9x9 normal matrices)
# needs true float32: a GPU runs DEFAULT-precision f32 matrix products in
# TF32 (10 mantissa bits), which is fatal for homography estimation. The one
# hot large product that is exact at the fast rate opts back in locally
# (ops/match.py: u8-valued descriptors).
jax.config.update("jax_default_matmul_precision", "highest")

from pano.config import (
    DEFAULT_CONFIG,
    HarrisOptions,
    PanoConfig,
    RansacOptions,
    StitchOptions,
)
from pano.pipeline import PairStitcher, stitch_all_images

__version__ = "0.1.0"

__all__ = [
    "DEFAULT_CONFIG",
    "HarrisOptions",
    "PanoConfig",
    "RansacOptions",
    "StitchOptions",
    "PairStitcher",
    "stitch_all_images",
]
