"""2-D convolution primitives (Sobel / Gaussian) as fused shift-and-add.

Reference equivalents:
  * kernel constructors: src/serial/main.cpp:61-91 (getSobelXKernel,
    getSobelYKernel, getGaussianKernel);
  * dense valid-interior convolution with a zero border of width k:
    src/serial/main.cpp:96-116 (convolveSequential), parallelized at
    src/openmp/main.cpp:105-126 and as a CUDA thread-per-pixel kernel at
    src/gpu/convolution.cu:6-54.

Design: small constant kernels are unrolled as statically weighted shifted
slices of one buffer rather than handed to XLA's convolution op (a
single-channel image with a 3x3 or 5x5 kernel leaves a convolution library
nothing to parallelize over channels). XLA fuses the whole tap sum into one
pass over the image, and neighboring elementwise work (gradient products,
Harris response) fuses into the same pass.

Kernel weights are embedded as compile-time scalar constants (numpy, f64)
so the tap sum constant-folds the weight math exactly like the reference's
double-precision kernels.

Convolution orientation: the reference computes a *correlation*
(sum input[y+i, x+j] * kernel[k+i][k+j], src/serial/main.cpp:107-110); the
tap unrolling below indexes identically.
"""

from __future__ import annotations

import numpy as np

import jax.numpy as jnp
from jax import lax


def sobel_x_kernel() -> np.ndarray:
    """3x3 Sobel X (src/serial/main.cpp:61-65)."""
    return np.array([[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]], dtype=np.float64)


def sobel_y_kernel() -> np.ndarray:
    """3x3 Sobel Y (src/serial/main.cpp:67-71)."""
    return np.array([[-1, -2, -1], [0, 0, 0], [1, 2, 1]], dtype=np.float64)


def gaussian_kernel(size: int, sigma: float) -> np.ndarray:
    """Normalized size x size Gaussian (src/serial/main.cpp:73-91), f64."""
    half = size // 2
    xs = np.arange(size) - half
    g = np.exp(-(xs[:, None] ** 2 + xs[None, :] ** 2) / (2.0 * sigma * sigma))
    g /= g.sum()
    return g


def _tap_sum(img: jnp.ndarray, kernel: np.ndarray) -> jnp.ndarray:
    """Valid-region correlation as an unrolled, constant-weighted tap sum.

    `img` has shape (..., H, W); returns (..., H-2k, W-2k). Zero-weight taps
    (e.g. the Sobel middle column) are skipped outright.
    """
    kernel = np.asarray(kernel, np.float64)
    ksize = kernel.shape[0]
    assert ksize % 2 == 1, "Kernel size has to be odd"
    h, w = img.shape[-2], img.shape[-1]
    vh, vw = h - (ksize - 1), w - (ksize - 1)

    acc = None
    for i in range(ksize):
        for j in range(ksize):
            wgt = float(kernel[i, j])
            if wgt == 0.0:
                continue
            tap = img[..., i : i + vh, j : j + vw]
            term = tap * jnp.asarray(wgt, img.dtype)
            acc = term if acc is None else acc + term
    assert acc is not None
    return acc


def conv2d_valid_zero_border(img: jnp.ndarray, kernel: np.ndarray) -> jnp.ndarray:
    """Correlate `img` (..., H, W) with constant `kernel` (k, k); the border
    of width k//2 is zero.

    Matches convolveSequential (src/serial/main.cpp:96-116): output has the
    input shape; only the valid interior is written, the border stays zero.
    """
    kernel = np.asarray(kernel, np.float64)
    k = kernel.shape[0] // 2
    out = _tap_sum(img, kernel)
    pad = [(0, 0)] * (img.ndim - 2) + [(k, k), (k, k)]
    return jnp.pad(out, pad)


def conv2d_separable_valid_zero_border(
    img: jnp.ndarray, k1d: np.ndarray
) -> jnp.ndarray:
    """Correlate with outer(k1d, k1d) as two 1-D tap-sum passes.

    Exactly equals conv2d_valid_zero_border(img, outer(k1d, k1d)) up to f32
    rounding (a normalized 2-D Gaussian factors into normalized 1-D ones),
    at 2k taps/pixel instead of k^2 — the 5x5 Gaussian smoothing drops from
    25 to 10 multiply-adds per pixel.
    """
    k1d = np.asarray(k1d, np.float64)
    ksize = k1d.shape[0]
    assert ksize % 2 == 1
    k = ksize // 2
    h, w = img.shape[-2], img.shape[-1]

    # Vertical pass (valid rows, full columns).
    acc = None
    for i in range(ksize):
        term = img[..., i : i + h - 2 * k, :] * jnp.asarray(
            float(k1d[i]), img.dtype
        )
        acc = term if acc is None else acc + term
    acc = lax.optimization_barrier(acc)  # stop tap-recompute fusion

    # Horizontal pass (valid columns).
    out = None
    for j in range(ksize):
        term = acc[..., :, j : j + w - 2 * k] * jnp.asarray(
            float(k1d[j]), img.dtype
        )
        out = term if out is None else out + term
    pad = [(0, 0)] * (img.ndim - 2) + [(k, k), (k, k)]
    return jnp.pad(out, pad)


def gaussian_kernel_1d(size: int, sigma: float) -> np.ndarray:
    """Normalized 1-D Gaussian whose outer product equals gaussian_kernel."""
    half = size // 2
    xs = np.arange(size) - half
    g = np.exp(-(xs**2) / (2.0 * sigma * sigma))
    return g / g.sum()


def conv2d_same(img: jnp.ndarray, kernel: np.ndarray) -> jnp.ndarray:
    """SAME-padded correlation; used by blending/eval (no reference analog)."""
    kernel = np.asarray(kernel, np.float64)
    k = kernel.shape[0] // 2
    pad = [(0, 0)] * (img.ndim - 2) + [(k, k), (k, k)]
    return _tap_sum(jnp.pad(img, pad), kernel)
