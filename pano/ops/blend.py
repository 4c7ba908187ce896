"""Blending algorithms: Laplacian-pyramid (multi-band) blending.

No reference analog — the reference composites with a hard overlay
(src/serial/main.cpp:380-386), which is why its seams are visible; its
"quality ceiling" path delegates multiband blending to cv::Stitcher
(src/opencv/main.cpp:59-70). Here Gaussian/Laplacian
pyramids are built from the same fused shift-and-add tap sums as the Harris
stage (ops/conv.py), all device-resident, fully fusible by XLA.

Algorithm (Burt & Adelson 1983): blend Laplacian bands of the two aligned
images under a Gaussian-smoothed seam mask, collapse. Low frequencies mix
over wide regions (no visible seam), high frequencies switch sharply (no
ghosting).
"""

from __future__ import annotations

from typing import List

import jax.numpy as jnp
import numpy as np

from pano.ops import conv as conv_ops

# 5-tap binomial (Burt-Adelson a=0.375) kernel, outer-product separable.
_K1D = np.array([1.0, 4.0, 6.0, 4.0, 1.0]) / 16.0
_K2D = np.outer(_K1D, _K1D)


def _blur(x: jnp.ndarray) -> jnp.ndarray:
    """5x5 binomial blur with edge-replicate padding (zero padding would
    decay both the images and the seam mask at canvas borders, bleeding
    darkness and cross-mixing into edge pixels)."""
    pad = [(0, 0)] * (x.ndim - 2) + [(2, 2), (2, 2)]
    return conv_ops._tap_sum(jnp.pad(x, pad, mode="edge"), _K2D)


def _decimate2(x: jnp.ndarray) -> jnp.ndarray:
    """x[..., ::2, ::2] as an explicit strided lax.slice (native XLA op)."""
    from jax import lax

    starts = (0,) * x.ndim
    limits = x.shape
    strides = (1,) * (x.ndim - 2) + (2, 2)
    return lax.slice(x, starts, limits, strides)


def _row_interleave(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """(..., h, w) x2 -> (..., 2h, w) with a on even rows.

    Stacks on the second-to-last axis then merges with a free reshape —
    no strided scatter (`.at[::2, ::2].set`) and no interior-dilated
    lax.pad.
    """
    s = jnp.stack([a, b], axis=-2)               # (..., h, 2, w)
    return s.reshape(a.shape[:-2] + (2 * a.shape[-2], a.shape[-1]))


def _interleave2(x: jnp.ndarray) -> jnp.ndarray:
    """Zero-stuff: out[..., 2i, 2j] = x[..., i, j] (see _row_interleave)."""
    z = jnp.zeros_like(x)
    rows = _row_interleave(x, z)                 # (..., 2h, w)
    rt = jnp.swapaxes(rows, -1, -2)              # (..., w, 2h)
    cols = _row_interleave(rt, jnp.zeros_like(rt))
    return jnp.swapaxes(cols, -1, -2)            # (..., 2h, 2w)


def _down(x: jnp.ndarray) -> jnp.ndarray:
    """Blur + decimate by 2 (even rows/cols)."""
    return _decimate2(_blur(x))


def _up(x: jnp.ndarray, out_h: int, out_w: int) -> jnp.ndarray:
    """Zero-stuff + normalized blur — the transpose of _down.

    Normalizing by the blurred zero-stuffed ones-field makes the
    interpolation exact at borders (a plain x4 gain undershoots where the
    5-tap support is clipped)."""
    h, w = x.shape[-2], x.shape[-1]
    up = _interleave2(x)
    ones = _interleave2(jnp.ones((h, w), x.dtype))
    num = conv_ops.conv2d_same(up, _K2D)
    den = conv_ops.conv2d_same(ones, _K2D)
    up = num / jnp.maximum(den, 1e-8)
    return up[..., :out_h, :out_w]


def gaussian_pyramid(x: jnp.ndarray, levels: int) -> List[jnp.ndarray]:
    pyr = [x]
    for _ in range(levels - 1):
        pyr.append(_down(pyr[-1]))
    return pyr


def laplacian_pyramid(x: jnp.ndarray, levels: int) -> List[jnp.ndarray]:
    gp = gaussian_pyramid(x, levels)
    lp = []
    for i in range(levels - 1):
        h, w = gp[i].shape[-2], gp[i].shape[-1]
        lp.append(gp[i] - _up(gp[i + 1], h, w))
    lp.append(gp[-1])
    return lp


def laplacian_blend(
    a: jnp.ndarray,        # (H, W, 3) float32 — left/base image (pre-filled)
    b: jnp.ndarray,        # (H, W, 3) float32 — right/warped image
    mask: jnp.ndarray,     # (H, W) float32 in [0,1]: 1 -> take b
    levels: int = 5,
) -> jnp.ndarray:
    """Multi-band blend of two aligned images under a seam mask.

    H and W must be divisible by 2**(levels-1) (the pipeline's canvas
    bucketing guarantees multiples of 128, so levels <= 8). Channels ride
    along as a leading axis for the separable tap sums.
    """
    h, w = a.shape[:2]
    assert h % (1 << (levels - 1)) == 0 and w % (1 << (levels - 1)) == 0

    ac = jnp.moveaxis(a, -1, 0)           # (3, H, W)
    bc = jnp.moveaxis(b, -1, 0)

    la = laplacian_pyramid(ac, levels)
    lb = laplacian_pyramid(bc, levels)
    gm = gaussian_pyramid(mask[None], levels)

    out = None
    for i in reversed(range(levels)):
        m = jnp.clip(gm[i], 0.0, 1.0)
        band = la[i] * (1.0 - m) + lb[i] * m
        if out is None:
            out = band
        else:
            hh, ww = band.shape[-2], band.shape[-1]
            out = _up(out, hh, ww) + band
    return jnp.moveaxis(out, 0, -1)
