"""Harris corner detection as a fused, fixed-shape XLA graph.

Reference equivalents:
  * serial: seqHarrisCornerDetectorDetect (src/serial/main.cpp:119-185);
  * OpenMP: ompHarrisCornerDetectorDetect (src/openmp/main.cpp:129-232) —
    thread-local keypoint vectors merged in a critical section;
  * CUDA: gpuHarrisCornerDetectorDetect (src/gpu/harris_detector.cu:91-227) —
    thread-per-pixel response kernel + atomicAdd compaction NMS, capped at
    10000 keypoints (src/gpu/harris_detector.cu:196).

Design decisions:
  * Everything stays device-resident; the five convolutions (2 Sobel + 3
    Gaussian) are constant-weight tap sums that XLA fuses into a few passes
    over the image (ops/conv.py; the Gaussian smooth of Ixx/Iyy/Ixy is one
    pass over a stacked 3-plane array), vs the CUDA path's five
    malloc/copy/launch/sync/free round trips (src/gpu/convolution.cu:25-54).
  * The variable-length keypoint vector becomes a **static top-K** selection
    with a validity mask, in place of atomicAdd compaction. K defaults to
    8192 (HarrisOptions.max_keypoints); the reference itself caps at 10000.
  * NMS "strictly greater than every neighbor" (src/serial/main.cpp:164-179,
    including the tie-rejection implied by `resp > max_resp`) is computed
    exactly via a max over the k*k-1 shifted neighbor planes.
  * Gray conversion uses float BT.601 weights (0.299/0.587/0.114) with
    round-half-to-even (bgr_to_gray_f32 below), matching cv::cvtColor's
    fixed-point BGR2GRAY to within +-1 on rounding-boundary pixels, so
    responses track the reference's `cvtColor -> convertTo(CV_64F)` path
    (src/serial/main.cpp:123-129) up to f32-vs-f64 rounding in the conv
    chain.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from pano.config import HarrisOptions
from pano.ops import conv as conv_ops


class KeyPoints(NamedTuple):
    """Fixed-capacity keypoint set (replaces std::vector<cv::KeyPoint>).

    xy:       (K, 2) int32, columns are (x, y) pixel coordinates.
    response: (K,) float32 Harris response (cv::KeyPoint has size=1, no
              response recorded in the reference; we keep it for top-K).
    valid:    (K,) bool — True for real keypoints, False for padding.
    """

    xy: jnp.ndarray
    response: jnp.ndarray
    valid: jnp.ndarray

    @property
    def capacity(self) -> int:
        return self.xy.shape[0]

    def count(self) -> jnp.ndarray:
        return jnp.sum(self.valid.astype(jnp.int32))


def bgr_to_gray_f32(img_u8: jnp.ndarray) -> jnp.ndarray:
    """cv::cvtColor(BGR2GRAY) emulation -> float32.

    The reference converts to 8-bit gray first, THEN to CV_64F
    (src/serial/main.cpp:123-129), so gray values are integers. We use the
    BT.601 weights with round-half-to-even, matching modern OpenCV's rounding
    to within +-1 on the ~0.1% of pixels that land exactly on a rounding
    boundary (f32 weighted sums of uint8 inputs are exact to ~1e-4, far
    below the 1e-3 quantization of the weight grid).
    """
    b = img_u8[..., 0].astype(jnp.float32)
    g = img_u8[..., 1].astype(jnp.float32)
    r = img_u8[..., 2].astype(jnp.float32)
    gray = 0.114 * b + 0.587 * g + 0.299 * r
    return jnp.round(gray)  # round half to even, like cv::saturate_cast


def harris_response(gray: jnp.ndarray, k: float) -> jnp.ndarray:
    """Harris response map R = det(M) - k*trace(M)^2.

    Mirrors src/serial/main.cpp:131-155: Sobel gradients (zero border),
    gradient products, 5x5 sigma=1 Gaussian smoothing (zero border), then the
    pointwise response.
    """
    gx = conv_ops.conv2d_valid_zero_border(gray, conv_ops.sobel_x_kernel())
    gy = conv_ops.conv2d_valid_zero_border(gray, conv_ops.sobel_y_kernel())

    # Materialization barrier: without it XLA may fuse the gradient tap
    # sums into every Gaussian tap downstream, recomputing the Sobel chain
    # per tap.
    gx, gy = lax.optimization_barrier((gx, gy))

    prods = jnp.stack([gx * gx, gy * gy, gx * gy])  # (3, H, W)
    prods = lax.optimization_barrier(prods)

    # One separable tap-sum smooths all three product planes (vs three
    # separate 25-tap passes in the reference, src/serial/main.cpp:141-143)
    # — the leading axis rides along through the shifted slices.
    gk1 = conv_ops.gaussian_kernel_1d(5, 1.0)
    sm = conv_ops.conv2d_separable_valid_zero_border(prods, gk1)
    sxx, syy, sxy = sm[0], sm[1], sm[2]

    det = sxx * syy - sxy * sxy
    trace = sxx + syy
    return det - jnp.asarray(k, gray.dtype) * trace * trace


def _neighbor_max(resp: jnp.ndarray, neighborhood: int) -> jnp.ndarray:
    """Max over the neighborhood window *excluding* the center pixel.

    Exactly the reference's NMS comparison set (src/serial/main.cpp:164-173).
    Implemented as a max over the k*k-1 shifted planes; for the default 3x3
    window this is 8 cheap fused shifts.
    """
    half = neighborhood // 2
    padded = jnp.pad(
        resp, ((half, half), (half, half)), constant_values=-jnp.inf
    )
    h, w = resp.shape
    nmax = jnp.full_like(resp, -jnp.inf)
    for dy in range(-half, half + 1):
        for dx in range(-half, half + 1):
            if dy == 0 and dx == 0:
                continue
            shifted = lax.dynamic_slice(padded, (half + dy, half + dx), (h, w))
            nmax = jnp.maximum(nmax, shifted)
    return nmax


@jax.named_scope("harris")
def harris_detect(img_u8: jnp.ndarray, opts: HarrisOptions) -> KeyPoints:
    """Full Harris detection: gray -> response -> NMS -> masked top-K.

    Returns a fixed-capacity KeyPoints (K = opts.max_keypoints). Keypoints are
    ordered by descending response (the reference's scan order is row-major,
    src/serial/main.cpp:159-180 — order only affects tie-breaking downstream,
    which the acceptance gate treats statistically).
    """
    h, w = img_u8.shape[:2]
    gray = bgr_to_gray_f32(img_u8)
    resp = harris_response(gray, opts.k)

    half = opts.nms_neighborhood // 2
    nmax = _neighbor_max(resp, opts.nms_neighborhood)

    ys = lax.broadcasted_iota(jnp.int32, (h, w), 0)
    xs = lax.broadcasted_iota(jnp.int32, (h, w), 1)
    border_ok = (
        (ys >= half) & (ys < h - half) & (xs >= half) & (xs < w - half)
    )
    is_peak = (
        (resp > jnp.asarray(opts.nms_thresh, resp.dtype))
        & (resp > nmax)
        & border_ok
    )

    # Pack the in-2x2-block offset into the two mantissa LSBs of each peak:
    # the 2x2 block-max below then carries its own sub-block position and
    # the decode needs no gathers back into the full-resolution plane.
    off_bits = ((ys & 1) << 1) | (xs & 1)
    rbits = lax.bitcast_convert_type(resp, jnp.int32)
    packed_resp = lax.bitcast_convert_type(
        (rbits & ~3) | off_bits, jnp.float32
    )
    scores = jnp.where(is_peak, packed_resp, -jnp.inf)
    if h % 2 or w % 2:
        scores = jnp.pad(
            scores, ((0, h % 2), (0, w % 2)), constant_values=-jnp.inf
        )

    # Exact 2x2 block reduction before top-K: NMS peaks are pairwise
    # non-adjacent (two adjacent pixels cannot both be strictly greater than
    # each other), so every 2x2 block holds at most one peak and reducing to
    # block maxima is lossless. This quarters the selection problem.
    h2, w2 = scores.shape[0] // 2, scores.shape[1] // 2
    bmax = lax.reduce_window(
        scores, -jnp.inf, lax.max, (2, 2), (2, 2), "VALID"
    )                                                   # (h2, w2)

    k_cap = min(opts.max_keypoints, h2 * w2)
    if opts.topk_method == "approx":
        top_scores, top_bidx = lax.approx_max_k(
            bmax.reshape(-1), k_cap, recall_target=opts.topk_recall
        )
    else:
        top_scores, top_bidx = lax.top_k(bmax.reshape(-1), k_cap)
    valid = jnp.isfinite(top_scores)

    # Recover the in-block position from the two mantissa LSBs packed above:
    # the block max IS the block's only peak, so its low bits are its
    # sub-block offset.
    by = top_bidx // w2
    bx = top_bidx % w2
    off = lax.bitcast_convert_type(top_scores, jnp.int32) & 3
    top_y = by.astype(jnp.int32) * 2 + (off >> 1)
    top_x = bx.astype(jnp.int32) * 2 + (off & 1)

    xy = jnp.stack([top_x, top_y], axis=-1)
    # Zero out padding coords so downstream gathers stay in range; clear
    # the packed offset bits from the reported responses (the <= 3 ulp
    # floor is invisible downstream but keeps the field clean).
    xy = jnp.where(valid[:, None], xy, 0)
    response = jnp.where(
        valid,
        lax.bitcast_convert_type(
            lax.bitcast_convert_type(top_scores, jnp.int32) & ~3,
            jnp.float32,
        ),
        0.0,
    )

    if k_cap < opts.max_keypoints:  # tiny images: pad to static capacity
        pad = opts.max_keypoints - k_cap
        xy = jnp.pad(xy, ((0, pad), (0, 0)))
        response = jnp.pad(response, (0, pad))
        valid = jnp.pad(valid, (0, pad))

    return KeyPoints(xy=xy, response=response, valid=valid)


harris_detect_jit = jax.jit(harris_detect, static_argnames=("opts",))
