"""Device ops: the JAX equivalents of the reference's C++/CUDA algorithm
stages (src/serial/main.cpp, src/openmp/main.cpp, src/gpu/*.cu)."""

from pano.ops import conv, harris, match, ransac, warp

__all__ = ["conv", "harris", "match", "ransac", "warp"]
