"""Projective inverse warp + fused compositing on device.

Reference equivalents (the stage the reference never accelerated — its GPU
path does warping and blending on the host with OpenCV + serial loops,
src/gpu/main.cpp:369-421):
  * canvas geometry: warped corners -> bounds -> translation
    (src/serial/main.cpp:334-369);
  * cv::warpPerspective(right, T*H, canvasSize) with INTER_LINEAR and
    BORDER_CONSTANT=0 (src/serial/main.cpp:371-372);
  * left image copied into the canvas ROI (src/serial/main.cpp:375-377);
  * overlay blend: any non-(0,0,0) warped pixel overwrites the canvas
    (src/serial/main.cpp:380-386, parallelized at src/openmp/main.cpp:526-533).

Design notes:
  * Bilinear taps are 1-D `jnp.take` gathers on the flattened (H*W, 3) uint8
    image with linearized indices.
  * Sampling is restricted to the (bucketed) bounding box of the warped
    right image — the rest of the canvas is just the translated left image,
    composed with a dynamic_update_slice. This typically halves the gather
    volume for side-by-side panoramas.
  * Canvas dimensions and the warp window are bucketed
    (StitchOptions.canvas_bucket) so XLA compiles once per size bucket; the
    exact canvas is cropped afterwards.

Blend modes:
  * 'overlay'  — reference parity.
  * 'feather'  — distance-ramp weighted average over the overlap (no
    reference analog; the reference's hard overlay is why its seams are
    visible).
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax


# Canvas framing rounds with a 1e-3 px tolerance, so the f64 host geometry
# here and the f32 in-graph geometry (pipeline._fused_compose_impl) frame a
# near-integer placement identically.
FRAME_EPS = 1e-3


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def compute_canvas_geometry(
    h_right_to_left: np.ndarray,
    left_shape: Tuple[int, int],
    right_shape: Tuple[int, int],
) -> Tuple[Tuple[int, int], np.ndarray, Tuple[float, float]]:
    """Host-side canvas math (tiny; only the 3x3 H crosses device->host).

    Mirrors src/serial/main.cpp:334-369: warp the right image's corners by H,
    take the union with the left rect, build the translation that shifts
    negative coordinates into view.

    Returns ((canvas_h, canvas_w), T (3,3) float64, (min_x, min_y)).
    """
    hl, wl = left_shape
    hr, wr = right_shape
    warped = warp_corners(h_right_to_left, hr, wr)

    min_x = min(0.0, warped[:, 0].min())
    min_y = min(0.0, warped[:, 1].min())
    max_x = max(float(wl), warped[:, 0].max())
    max_y = max(float(hl), warped[:, 1].max())

    t = np.array(
        [[1.0, 0.0, -min_x], [0.0, 1.0, -min_y], [0.0, 0.0, 1.0]],
        dtype=np.float64,
    )
    canvas_w = int(np.ceil(max_x - min_x - FRAME_EPS))
    canvas_h = int(np.ceil(max_y - min_y - FRAME_EPS))
    return (canvas_h, canvas_w), t, (min_x, min_y)


def left_offset(min_v: float) -> int:
    """Integer placement of the left image on the canvas: the reference
    truncates -min (cv::Rect, src/serial/main.cpp:376); here with the
    framing tolerance."""
    return int(np.floor(-min_v + FRAME_EPS))


def warp_corners(h: np.ndarray, img_h: int, img_w: int) -> np.ndarray:
    """Corner positions of an (img_h, img_w) image under H -> (4, 2) f64
    (cv::perspectiveTransform on the 4 corners, src/serial/main.cpp:334-342).
    """
    corners = np.array(
        [
            [0.0, 0.0, 1.0],
            [img_w, 0.0, 1.0],
            [img_w, img_h, 1.0],
            [0.0, img_h, 1.0],
        ],
        dtype=np.float64,
    )
    warped = (np.asarray(h, np.float64) @ corners.T).T
    return warped[:, :2] / warped[:, 2:3]


def warp_window_geometry(
    m: np.ndarray,
    img_h: int,
    img_w: int,
    pad_h: int,
    pad_w: int,
    bucket: int,
) -> Tuple[int, int, int, int]:
    """Host-side warp-window placement shared by every composite path:
    the bucketed bbox of the warped image corners under `m`, +2 px bilinear
    margin, clipped to the (pad_h, pad_w) canvas.

    Returns (wx0, wy0, win_w, win_h)."""
    corners = warp_corners(m, img_h, img_w)
    wx0 = max(0, int(np.floor(corners[:, 0].min())) - 2)
    wy0 = max(0, int(np.floor(corners[:, 1].min())) - 2)
    wx1 = min(pad_w, int(np.ceil(corners[:, 0].max())) + 2)
    wy1 = min(pad_h, int(np.ceil(corners[:, 1].max())) + 2)
    win_w = min(_round_up(max(wx1 - wx0, 1), bucket), pad_w)
    win_h = min(_round_up(max(wy1 - wy0, 1), bucket), pad_h)
    wx0 = min(wx0, pad_w - win_w)
    wy0 = min(wy0, pad_h - win_h)
    return wx0, wy0, win_w, win_h


def _inverse_map(
    h_inv: jnp.ndarray, out_h: int, out_w: int,
    off_x: jnp.ndarray, off_y: jnp.ndarray,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Map canvas pixels (off_x + j, off_y + i) through h_inv -> source xy."""
    ys = lax.broadcasted_iota(jnp.float32, (out_h, out_w), 0) + off_y
    xs = lax.broadcasted_iota(jnp.float32, (out_h, out_w), 1) + off_x
    denom = h_inv[2, 0] * xs + h_inv[2, 1] * ys + h_inv[2, 2]
    sx = (h_inv[0, 0] * xs + h_inv[0, 1] * ys + h_inv[0, 2]) / denom
    sy = (h_inv[1, 0] * xs + h_inv[1, 1] * ys + h_inv[1, 2]) / denom
    return sx, sy


def _bilinear_sample_u8(
    img: jnp.ndarray,          # (H, W, C) uint8
    sx: jnp.ndarray,           # (Ho, Wo) f32 source x
    sy: jnp.ndarray,           # (Ho, Wo) f32 source y
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """INTER_LINEAR sample with BORDER_CONSTANT=0; returns (f32 rgb, weight).

    Out-of-bounds taps contribute zero, matching cv::warpPerspective's
    constant border. `weight` is the summed in-bounds bilinear weight (1.0
    strictly inside, <1 at the border fringe, 0 outside) — reused by feather
    blending as the warped validity/alpha. Taps are flat 1-D takes.
    """
    h, w = img.shape[:2]
    oh, ow = sx.shape
    flat = img.reshape(-1, img.shape[-1])
    x0 = jnp.floor(sx)
    y0 = jnp.floor(sy)
    fx = sx - x0
    fy = sy - y0
    x0i = x0.astype(jnp.int32)
    y0i = y0.astype(jnp.int32)

    out = None
    wsum = None
    for dy, dx, wgt in (
        (0, 0, (1 - fx) * (1 - fy)),
        (0, 1, fx * (1 - fy)),
        (1, 0, (1 - fx) * fy),
        (1, 1, fx * fy),
    ):
        xi = x0i + dx
        yi = y0i + dy
        ok = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        idx = jnp.clip(yi, 0, h - 1) * w + jnp.clip(xi, 0, w - 1)
        tap = jnp.take(flat, idx.reshape(-1), axis=0).astype(jnp.float32)
        tap = tap.reshape(oh, ow, flat.shape[-1])
        wm = jnp.where(ok, wgt, 0.0)
        contrib = tap * wm[..., None]
        out = contrib if out is None else out + contrib
        wsum = wm if wsum is None else wsum + wm
    return out, wsum


def warp_perspective_u8(
    img: jnp.ndarray, h_inv: jnp.ndarray, out_h: int, out_w: int
) -> jnp.ndarray:
    """cv::warpPerspective(img, M, size) equivalent, given M^-1.

    Standalone warp (uint8 out); the pipeline normally uses the fused
    warp_and_blend below instead.
    """
    zero = jnp.asarray(0.0, jnp.float32)
    sx, sy = _inverse_map(h_inv, out_h, out_w, zero, zero)
    rgb, _ = _bilinear_sample_u8(img, sx, sy)
    return jnp.clip(jnp.round(rgb), 0, 255).astype(jnp.uint8)


def _multiband_compose(
    left_f: jnp.ndarray,    # (H, W, 3) f32
    right_f: jnp.ndarray,   # (H, W, 3) f32
    w_left: jnp.ndarray,    # (H, W) f32 >= 0
    w_right: jnp.ndarray,   # (H, W) f32 >= 0
) -> jnp.ndarray:
    """Laplacian-pyramid composite of the overlap window -> uint8.

    Invalid regions of each image are pre-filled with the other so pyramid
    blurs don't bleed black across the seam; the seam mask prefers whichever
    image is 'deeper' (larger feather weight) at each pixel.
    """
    from pano.ops import blend as blend_ops

    has_l = w_left > 0.0
    has_r = w_right > 0.0
    a = jnp.where(has_l[..., None], left_f, right_f)
    b = jnp.where(has_r[..., None], right_f, left_f)
    mask = jnp.where(
        has_r & (~has_l | (w_right > w_left)), 1.0, 0.0
    ).astype(jnp.float32)
    out = blend_ops.laplacian_blend(a, b, mask, levels=5)
    out = jnp.where((has_l | has_r)[..., None], out, 0.0)
    return jnp.clip(jnp.round(out), 0, 255).astype(jnp.uint8)


def _edge_ramp(h: int, w: int) -> jnp.ndarray:
    """Feather weight map: distance to nearest image edge, normalized."""
    ys = lax.broadcasted_iota(jnp.float32, (h, w), 0)
    xs = lax.broadcasted_iota(jnp.float32, (h, w), 1)
    d = jnp.minimum(
        jnp.minimum(xs + 1.0, w - xs), jnp.minimum(ys + 1.0, h - ys)
    )
    return d / jnp.asarray(min(h, w) / 2.0, jnp.float32)


def _estimate_gain(
    left_win_f: jnp.ndarray,    # (h, w, 3) f32 canvas pixels
    right_f: jnp.ndarray,       # (h, w, 3) f32 warped incoming pixels
    overlap: jnp.ndarray,       # (h, w) bool — both sides covered
) -> jnp.ndarray:
    """Scalar exposure gain mapping the incoming image onto the canvas's
    brightness over their overlap — the single-pair analog of
    cv::detail::GainCompensator (inside the reference's cv::Stitcher
    baseline, src/opencv/main.cpp:59-70; the reference's own pipeline has no
    compensation). Returns 1.0 when the overlap is too small to trust."""
    m = overlap.astype(jnp.float32)
    num = jnp.sum(jnp.sum(left_win_f, axis=-1) * m)
    den = jnp.sum(jnp.sum(right_f, axis=-1) * m)
    cnt = jnp.sum(m)
    ok = (cnt > 256.0) & (den > 1e3)
    g = jnp.where(ok, num / jnp.maximum(den, 1e-6), 1.0)
    return jnp.clip(g, 0.6, 1.6)


@functools.partial(
    jax.jit,
    static_argnames=("out_h", "out_w", "win_h", "win_w", "blend", "gain"),
)
def blend_window_outputs(
    left: jnp.ndarray,          # (Hl, Wl, 3) uint8
    rgb_win: jnp.ndarray,       # (win_h, win_w) int32 packed warped right
    w_win: jnp.ndarray,         # (win_h, win_w) f32 warped weight/alpha
    tx: jnp.ndarray,
    ty: jnp.ndarray,
    win_x: jnp.ndarray,
    win_y: jnp.ndarray,
    out_h: int,
    out_w: int,
    win_h: int,
    win_w: int,
    blend: str = "overlay",
    w_left_win: Optional[jnp.ndarray] = None,
    gain: bool = False,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Composite a pre-warped window (packed b|g<<8|r<<16 RGB plus its
    warped weight) with the translated left image — the blend half of the
    batched sharded composite, whose warps run as one vmapped dispatch.

    `w_left_win` is the left side's coverage weight over the window. Chain
    mode maintains an exact accumulated weight canvas and passes its window
    slice; when absent (pair mode) the weight is derived from the left
    image's edge ramp masked by nonblack coverage.

    Returns (canvas, new_w_left_win) where new_w_left_win is the merged
    coverage weight of the window after compositing (chain mode writes it
    back into its weight canvas).
    """
    hl, wl = left.shape[:2]
    warped_right = jnp.stack(
        [
            (rgb_win & 0xFF).astype(jnp.uint8),
            ((rgb_win >> 8) & 0xFF).astype(jnp.uint8),
            ((rgb_win >> 16) & 0xFF).astype(jnp.uint8),
        ],
        axis=-1,
    )
    if left.shape[:2] == (out_h, out_w):
        # Chain mode: `left` is already the full canvas — no placement copy.
        canvas_left = left
    else:
        canvas_left = jnp.zeros((out_h, out_w, 3), jnp.uint8)
        canvas_left = lax.dynamic_update_slice(
            canvas_left, left, (ty, tx, jnp.asarray(0, ty.dtype))
        )
    left_win = lax.dynamic_slice(
        canvas_left,
        (win_y, win_x, jnp.asarray(0, win_y.dtype)),
        (win_h, win_w, 3),
    )

    if w_left_win is None:
        # Derive the left coverage weight: geometric edge ramp masked by
        # actual pixel coverage (a composed left canvas has black holes the
        # ramp alone cannot see).
        ramp_l = _edge_ramp(hl, wl)
        canvas_wl = jnp.zeros((out_h, out_w), jnp.float32)
        canvas_wl = lax.dynamic_update_slice(canvas_wl, ramp_l, (ty, tx))
        w_left_win = lax.dynamic_slice(
            canvas_wl, (win_y, win_x), (win_h, win_w)
        )
        left_nonblack = jnp.any(left_win != 0, axis=-1)
        w_left_win = jnp.where(left_nonblack, w_left_win, 0.0)

    if gain:
        # In-graph exposure compensation: no extra host syncs, the scalar
        # gain flows straight into the blend below.
        overlap = (w_left_win > 0.05) & (w_win > 0.05)
        g = _estimate_gain(
            left_win.astype(jnp.float32),
            warped_right.astype(jnp.float32),
            overlap,
        )
        warped_right = jnp.clip(
            jnp.round(warped_right.astype(jnp.float32) * g), 0, 255
        ).astype(jnp.uint8)

    if blend == "overlay":
        right_nonblack = rgb_win != 0
        win_out = jnp.where(right_nonblack[..., None], warped_right, left_win)
    elif blend == "feather":
        w_left = w_left_win
        w_right = w_win
        total = jnp.maximum(w_left + w_right, 1e-6)
        blended = (
            left_win.astype(jnp.float32) * w_left[..., None]
            + warped_right.astype(jnp.float32) * w_right[..., None]
        ) / total[..., None]
        only_left = w_right <= 0.0
        only_right = (w_left <= 0.0) & (w_right > 0.0)
        win_f = jnp.where(
            only_left[..., None], left_win.astype(jnp.float32), blended
        )
        win_f = jnp.where(
            only_right[..., None], warped_right.astype(jnp.float32), win_f
        )
        win_out = jnp.clip(jnp.round(win_f), 0, 255).astype(jnp.uint8)
    elif blend == "multiband":
        win_out = _multiband_compose(
            left_win.astype(jnp.float32),
            warped_right.astype(jnp.float32),
            w_left_win,
            w_win,
        )
    else:
        raise ValueError(f"unknown blend mode: {blend}")

    new_w = jnp.maximum(w_left_win, w_win)
    canvas = lax.dynamic_update_slice(
        canvas_left, win_out, (win_y, win_x, jnp.asarray(0, win_y.dtype))
    )
    return canvas, new_w


@functools.partial(
    jax.jit,
    static_argnames=("out_h", "out_w", "win_h", "win_w", "blend", "gain"),
)
@jax.named_scope("warp_blend")
def warp_and_blend(
    left: jnp.ndarray,          # (Hl, Wl, 3) uint8
    right: jnp.ndarray,         # (Hr, Wr, 3) uint8
    h_inv: jnp.ndarray,         # (3, 3) f32 — inverse of T @ H
    tx: jnp.ndarray,            # () int32 — left placement offset x
    ty: jnp.ndarray,            # () int32
    out_h: int,
    out_w: int,
    blend: str = "overlay",
    win_x: Optional[jnp.ndarray] = None,   # () int32 warp-window origin
    win_y: Optional[jnp.ndarray] = None,
    win_h: Optional[int] = None,           # static warp-window size
    win_w: Optional[int] = None,
    gain: bool = False,                    # exposure compensation (see
    #                                        _estimate_gain)
) -> jnp.ndarray:
    """Fused inverse warp of `right` + composite with translated `left`.

    Produces the (out_h, out_w, 3) uint8 canvas in one device pass. The
    expensive bilinear gather runs only inside the warp window (the bucketed
    bbox of the warped right image); outside it the canvas is exactly the
    translated left image. `tx, ty, win_x, win_y` are traced so one compiled
    graph serves every pair within a (canvas, window) size bucket.
    """
    hl, wl = left.shape[:2]

    if win_h is None or win_w is None:
        win_h, win_w = out_h, out_w
        win_x = jnp.asarray(0, jnp.int32)
        win_y = jnp.asarray(0, jnp.int32)

    sx, sy = _inverse_map(
        h_inv, win_h, win_w,
        win_x.astype(jnp.float32), win_y.astype(jnp.float32),
    )
    right_f, right_w = _bilinear_sample_u8(right, sx, sy)

    # Translated left image on the canvas (src/serial/main.cpp:375-377).
    canvas_left = jnp.zeros((out_h, out_w, 3), jnp.uint8)
    canvas_left = lax.dynamic_update_slice(
        canvas_left, left, (ty, tx, jnp.asarray(0, ty.dtype))
    )
    # Left-image pixels of the window region, for blending.
    left_win = lax.dynamic_slice(
        canvas_left,
        (win_y, win_x, jnp.asarray(0, win_y.dtype)),
        (win_h, win_w, 3),
    )

    if gain:
        overlap = (
            jnp.any(left_win != 0, axis=-1) & (right_w > 0.05)
        )
        g = _estimate_gain(left_win.astype(jnp.float32), right_f, overlap)
        right_f = right_f * g

    if blend == "overlay":
        # Reference semantics: non-black warped pixels win
        # (src/serial/main.cpp:380-386).
        warped_right = jnp.clip(jnp.round(right_f), 0, 255).astype(jnp.uint8)
        right_nonblack = jnp.any(warped_right != 0, axis=-1)
        win_out = jnp.where(
            right_nonblack[..., None], warped_right, left_win
        )
    elif blend == "feather":
        hr, wr = right.shape[:2]
        ramp_r = _edge_ramp(hr, wr)
        wr_map, _ = _bilinear_sample_u8(
            (ramp_r[..., None] * 255.0).astype(jnp.uint8), sx, sy
        )
        w_right = (wr_map[..., 0] / 255.0) * right_w

        ramp_l = _edge_ramp(hl, wl)
        canvas_wl = jnp.zeros((out_h, out_w), jnp.float32)
        canvas_wl = lax.dynamic_update_slice(canvas_wl, ramp_l, (ty, tx))
        w_left = lax.dynamic_slice(canvas_wl, (win_y, win_x), (win_h, win_w))
        # Mask by actual coverage: a composed left canvas has black holes.
        w_left = jnp.where(jnp.any(left_win != 0, axis=-1), w_left, 0.0)

        total = jnp.maximum(w_left + w_right, 1e-6)
        blended = (
            left_win.astype(jnp.float32) * w_left[..., None]
            + right_f * w_right[..., None]
        ) / total[..., None]
        # Regions covered by only one image fall back to that image exactly.
        only_left = w_right <= 0.0
        only_right = (w_left <= 0.0) & (right_w > 0.0)
        win_f = jnp.where(
            only_left[..., None], left_win.astype(jnp.float32), blended
        )
        win_f = jnp.where(only_right[..., None], right_f, win_f)
        win_out = jnp.clip(jnp.round(win_f), 0, 255).astype(jnp.uint8)
    elif blend == "multiband":
        hr, wr = right.shape[:2]
        ramp_r = _edge_ramp(hr, wr)
        wr_map, _ = _bilinear_sample_u8(
            (ramp_r[..., None] * 255.0).astype(jnp.uint8), sx, sy
        )
        w_right = (wr_map[..., 0] / 255.0) * right_w
        ramp_l = _edge_ramp(hl, wl)
        canvas_wl = jnp.zeros((out_h, out_w), jnp.float32)
        canvas_wl = lax.dynamic_update_slice(canvas_wl, ramp_l, (ty, tx))
        w_left = lax.dynamic_slice(canvas_wl, (win_y, win_x), (win_h, win_w))
        w_left = jnp.where(jnp.any(left_win != 0, axis=-1), w_left, 0.0)
        win_out = _multiband_compose(
            left_win.astype(jnp.float32), right_f, w_left, w_right
        )
    else:
        raise ValueError(f"unknown blend mode: {blend}")

    return lax.dynamic_update_slice(
        canvas_left, win_out, (win_y, win_x, jnp.asarray(0, win_y.dtype))
    )
