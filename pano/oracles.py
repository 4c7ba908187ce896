"""Plain numpy references for the device ops, in float64.

Each function restates one op's semantics directly (the reference's loops,
vectorized over pixels or keypoints) and shares no code with the JAX
implementation it checks. The tests compare the device ops with these at
small sizes; chip_smoke.py compares them at the real sizes on the GPU.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from pano.scenes import bilinear_sample

SOBEL_X = np.array([[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]], np.float64)
SOBEL_Y = np.array([[-1, -2, -1], [0, 0, 0], [1, 2, 1]], np.float64)


def gaussian_kernel(size: int = 5, sigma: float = 1.0) -> np.ndarray:
    """Normalized size x size Gaussian (src/serial/main.cpp:73-91)."""
    xs = np.arange(size) - size // 2
    g = np.exp(-(xs[:, None] ** 2 + xs[None, :] ** 2) / (2.0 * sigma**2))
    return g / g.sum()


def conv_valid_zero_border(img: np.ndarray, kernel: np.ndarray) -> np.ndarray:
    """convolveSequential (src/serial/main.cpp:96-116): correlation over the
    valid interior, a zero border of width k//2, output in float64."""
    img = np.asarray(img, np.float64)
    ks = kernel.shape[0]
    k = ks // 2
    h, w = img.shape
    out = np.zeros((h, w), np.float64)
    acc = out[k:h - k, k:w - k]
    for i in range(ks):
        for j in range(ks):
            acc += img[i:i + h - 2 * k, j:j + w - 2 * k] * kernel[i, j]
    return out


def harris_response(gray: np.ndarray, k: float = 0.04) -> np.ndarray:
    """R = det(M) - k trace(M)^2 with Sobel gradients and a 5x5 sigma-1
    Gaussian window (src/serial/main.cpp:131-155)."""
    gx = conv_valid_zero_border(gray, SOBEL_X)
    gy = conv_valid_zero_border(gray, SOBEL_Y)
    g = gaussian_kernel()
    sxx = conv_valid_zero_border(gx * gx, g)
    syy = conv_valid_zero_border(gy * gy, g)
    sxy = conv_valid_zero_border(gx * gy, g)
    return sxx * syy - sxy * sxy - k * (sxx + syy) ** 2


def harris_peaks(
    resp: np.ndarray, nms_thresh: float, neighborhood: int = 3
) -> Tuple[np.ndarray, np.ndarray]:
    """NMS of src/serial/main.cpp:157-180: pixels above the threshold and
    strictly greater than every neighbor. Returns (xy (N, 2) int, response
    (N,)) sorted by descending response."""
    half = neighborhood // 2
    h, w = resp.shape
    pad = np.pad(resp, half, constant_values=-np.inf)
    nmax = np.full_like(resp, -np.inf)
    for dy in range(neighborhood):
        for dx in range(neighborhood):
            if dy == half and dx == half:
                continue
            nmax = np.maximum(nmax, pad[dy:dy + h, dx:dx + w])
    peak = (resp > nms_thresh) & (resp > nmax)
    peak[:half] = peak[h - half:] = False
    peak[:, :half] = peak[:, w - half:] = False
    ys, xs = np.nonzero(peak)
    order = np.argsort(-resp[ys, xs], kind="stable")
    return np.stack([xs[order], ys[order]], axis=1), resp[ys, xs][order]


def patch_descriptors(
    img: np.ndarray, xy: np.ndarray, valid: np.ndarray, patch: int = 5
) -> Tuple[np.ndarray, np.ndarray]:
    """P x P x 3 patches (row-major, channel-minor) around each keypoint;
    rows of keypoints whose patch leaves the image are zero
    (src/serial/main.cpp:203-216). Returns (desc (K, P*P*3) float64,
    border_valid (K,) bool)."""
    h, w = img.shape[:2]
    b = patch // 2
    x, y = xy[:, 0].astype(np.int64), xy[:, 1].astype(np.int64)
    ok = valid & (x >= b) & (y >= b) & (x + b < w) & (y + b < h)
    offs = np.arange(-b, b + 1)
    ys = np.clip(y[:, None] + offs, 0, h - 1)
    xs = np.clip(x[:, None] + offs, 0, w - 1)
    desc = img[ys[:, :, None], xs[:, None, :]].reshape(len(xy), -1)
    return np.where(ok[:, None], desc.astype(np.float64), 0.0), ok


def match_ssd(
    desc_q: np.ndarray, valid_q: np.ndarray,
    desc_t: np.ndarray, valid_t: np.ndarray,
    max_ssd: float, ratio: float = 0.0, cross_check: bool = False,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Brute-force argmin-SSD matching (src/serial/main.cpp:188-244) plus
    the Lowe ratio test and mutual-nearest cross check. Exact in float64
    for u8-valued descriptors; ties go to the lowest index. Returns
    (train_idx, ssd, valid) with zeros where invalid."""
    q = np.asarray(desc_q, np.float64)
    t = np.asarray(desc_t, np.float64)
    ssd = (q * q).sum(1)[:, None] + (t * t).sum(1)[None, :] - 2.0 * q @ t.T
    ssd[:, ~valid_t] = np.inf
    best = np.argmin(ssd, axis=1)
    rows = np.arange(len(q))
    best_ssd = ssd[rows, best]
    ok = valid_q & np.isfinite(best_ssd) & (best_ssd < max_ssd)
    if ratio > 0.0:
        ssd[rows, best] = np.inf
        second = ssd.min(axis=1)
        ssd[rows, best] = best_ssd
        ok &= ~np.isfinite(second) | (best_ssd < ratio * ratio * second)
    if cross_check:
        ssd[~valid_q] = np.inf
        ok &= np.argmin(ssd, axis=0)[best] == rows
    return (
        np.where(ok, best, 0), np.where(ok, best_ssd, 0.0), ok
    )


def _sample_through(
    img: np.ndarray, m_inv: np.ndarray, out_h: int, out_w: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Bilinear samples of img at m_inv (x, y, 1) for every output pixel:
    (values (out_h, out_w, C) float64, in-bounds weight (out_h, out_w))."""
    m_inv = np.asarray(m_inv, np.float64)
    gx, gy = np.meshgrid(np.arange(out_w, dtype=np.float64),
                         np.arange(out_h, dtype=np.float64))
    den = m_inv[2, 0] * gx + m_inv[2, 1] * gy + m_inv[2, 2]
    sx = (m_inv[0, 0] * gx + m_inv[0, 1] * gy + m_inv[0, 2]) / den
    sy = (m_inv[1, 0] * gx + m_inv[1, 1] * gy + m_inv[1, 2]) / den
    return bilinear_sample(img, sx, sy)


def warp_u8(
    img: np.ndarray, m_inv: np.ndarray, out_h: int, out_w: int
) -> np.ndarray:
    """cv::warpPerspective(INTER_LINEAR, BORDER_CONSTANT=0) given the
    inverse map: output pixel (x, y) samples img at m_inv (x, y, 1)."""
    vals, _ = _sample_through(img, m_inv, out_h, out_w)
    return np.clip(np.round(vals), 0, 255).astype(np.uint8)


def edge_ramp(h: int, w: int) -> np.ndarray:
    """Feather weight of an (h, w) image: distance to its nearest edge
    (1 on the outermost pixels) over half the shorter side."""
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    d = np.minimum(np.minimum(xs + 1, w - xs), np.minimum(ys + 1, h - ys))
    return d / (min(h, w) / 2.0)


def compose(
    left: np.ndarray, right: np.ndarray, m_inv: np.ndarray,
    tx: int, ty: int, out_h: int, out_w: int, blend: str = "overlay",
) -> np.ndarray:
    """A pair composite: left copied at (ty, tx) on a black canvas, right
    warped through m_inv and blended in.

    overlay (src/serial/main.cpp:371-386): every non-black warped pixel
    lands on top. feather: a mean weighted by each image's edge ramp — the
    right ramp resampled as an 8-bit map times the in-bounds bilinear
    weight, the left ramp masked by non-black coverage; where only one
    image covers a pixel, that image's value."""
    canvas = np.zeros((out_h, out_w, 3), np.uint8)
    hl, wl = left.shape[:2]
    canvas[ty:ty + hl, tx:tx + wl] = left[: out_h - ty, : out_w - tx]
    vals, inb = _sample_through(right, m_inv, out_h, out_w)
    if blend == "overlay":
        warped = np.clip(np.round(vals), 0, 255).astype(np.uint8)
        nonblack = warped.any(axis=-1)
        canvas[nonblack] = warped[nonblack]
        return canvas
    if blend != "feather":
        raise ValueError(f"no oracle for blend mode {blend!r}")
    hr, wr = right.shape[:2]
    ramp_u8 = (edge_ramp(hr, wr)[..., None] * 255.0).astype(np.uint8)
    ramp_r, _ = _sample_through(ramp_u8, m_inv, out_h, out_w)
    w_right = ramp_r[..., 0] / 255.0 * inb
    w_left = np.zeros((out_h, out_w))
    w_left[ty:ty + hl, tx:tx + wl] = edge_ramp(hl, wl)[: out_h - ty,
                                                       : out_w - tx]
    w_left = np.where(canvas.any(axis=-1), w_left, 0.0)
    base = canvas.astype(np.float64)
    total = np.maximum(w_left + w_right, 1e-6)
    out = (base * w_left[..., None] + vals * w_right[..., None]) / total[
        ..., None]
    out = np.where((w_right <= 0.0)[..., None], base, out)
    out = np.where(((w_left <= 0.0) & (inb > 0.0))[..., None], vals, out)
    return np.clip(np.round(out), 0, 255).astype(np.uint8)
