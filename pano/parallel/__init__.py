"""Multi-device scaling via jax.sharding + shard_map over device meshes.

The reference's parallelism is OpenMP threads (src/openmp/main.cpp) and CUDA
blocks (src/gpu/*.cu) inside one node; its scaling knob is OMP_NUM_THREADS
(benchmark_panorama.py:26). The scaling axes here are:

  * batch-of-pairs data parallelism (throughput mode) — pairs sharded over
    the 'data' mesh axis;
  * RANSAC hypothesis sharding — the 1000-hypothesis batch split over the
    'hyp' mesh axis, combined with an all-gather + argmax (the counterpart
    of the OpenMP per-thread best-H + serial argmax reduction,
    src/openmp/main.cpp:379-442);
  * match-row sharding — query keypoints split over a mesh axis, each
    device computing its rows' argmin against replicated train descriptors.
"""

from pano.parallel import shard

__all__ = ["shard"]
