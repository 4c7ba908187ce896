"""Seeded synthetic scenes whose true geometry is known.

A procedural, corner-rich world texture is rendered into N overlapping
views through known homographies with numpy bilinear sampling. The
homographies are the ground truth for quality checks: the corner
reprojection error of an estimated homography, and the PSNR of a
panorama against the true render of the world in the anchor view's frame.
Everything is deterministic from the seed.

Write a scene's views as PNG files for the CLI:

    python -m pano.scenes --out DIR --views 4 --height 3117 --width 4156 \
        --seed 0
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
from typing import List, Optional, Sequence, Tuple

import numpy as np

# Views overlap by 1 - _STEP of their width, like a handheld sweep.
_STEP = 0.55
_MARGIN = 0.06


@dataclasses.dataclass
class Scene:
    """world: (Hw, Ww, 3) uint8 BGR texture; homs[i] maps view-i pixel
    coordinates to world coordinates; views[i]: (h, w, 3) uint8 BGR."""

    world: np.ndarray
    homs: List[np.ndarray]
    views: List[np.ndarray]


def _block_noise(shape: Tuple[int, int], cell: int, rng) -> np.ndarray:
    """Random per-cell colors on a randomly offset grid of `cell` px,
    nearest-upsampled: every grid crossing is a corner."""
    h, w = shape
    oy, ox = rng.integers(0, cell, 2)
    grid = rng.random(((h + oy) // cell + 1, (w + ox) // cell + 1, 3))
    ys = (np.arange(h) + oy) // cell
    xs = (np.arange(w) + ox) // cell
    return grid[ys][:, xs].astype(np.float32)


def world_texture(h: int, w: int, rng) -> np.ndarray:
    """Corner-rich texture: three block-noise octaves (coarse regions,
    mid-size patches, fine blocks) on unaligned grids, softened by a 3x3
    box blur so edges survive resampling without aliasing."""
    tex = (
        0.35 * _block_noise((h, w), 97, rng)
        + 0.30 * _block_noise((h, w), 23, rng)
        + 0.35 * _block_noise((h, w), 9, rng)
    )
    pad = np.pad(tex, ((1, 1), (1, 1), (0, 0)), mode="edge")
    blur = sum(
        pad[dy:dy + h, dx:dx + w] for dy in range(3) for dx in range(3)
    ) / 9.0
    return np.clip(np.round(blur * 255.0), 0, 255).astype(np.uint8)


def view_homographies(
    n: int, h: int, w: int, rng
) -> Tuple[List[np.ndarray], Tuple[int, int]]:
    """n view->world homographies for a left-to-right sweep and the world
    size they need: centers _STEP*w apart with a little vertical jitter,
    up to 1 degree of roll and a mild perspective term each."""
    margin = int(np.ceil(_MARGIN * max(h, w)))
    world_w = int(np.ceil((n - 1) * _STEP * w)) + w + 2 * margin
    world_h = h + 2 * margin
    to_center = np.array([[1.0, 0.0, -w / 2], [0.0, 1.0, -h / 2],
                          [0.0, 0.0, 1.0]])
    homs = []
    for i in range(n):
        th = np.deg2rad(rng.uniform(-1.0, 1.0))
        rot = np.array([[np.cos(th), -np.sin(th), 0.0],
                        [np.sin(th), np.cos(th), 0.0],
                        [0.0, 0.0, 1.0]])
        persp = np.eye(3)
        persp[2, 0] = rng.uniform(-0.01, 0.01) / w
        persp[2, 1] = rng.uniform(-0.01, 0.01) / h
        cx = margin + w / 2 + i * _STEP * w
        cy = margin + h / 2 + rng.uniform(-0.03, 0.03) * h
        place = np.array([[1.0, 0.0, cx], [0.0, 1.0, cy], [0.0, 0.0, 1.0]])
        homs.append(place @ rot @ persp @ to_center)
    return homs, (world_h, world_w)


def bilinear_sample(
    img: np.ndarray, sx: np.ndarray, sy: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """Bilinear sample of (H, W, C) `img` at float coords, zero outside
    (cv::warpPerspective INTER_LINEAR + BORDER_CONSTANT). Returns
    (values (..., C) float64, summed in-bounds weight (...))."""
    h, w = img.shape[:2]
    x0 = np.floor(sx)
    y0 = np.floor(sy)
    fx, fy = sx - x0, sy - y0
    x0 = x0.astype(np.int64)
    y0 = y0.astype(np.int64)
    out = np.zeros(sx.shape + (img.shape[2],), np.float64)
    wsum = np.zeros(sx.shape, np.float64)
    for dy, dx, wgt in (
        (0, 0, (1 - fx) * (1 - fy)),
        (0, 1, fx * (1 - fy)),
        (1, 0, (1 - fx) * fy),
        (1, 1, fx * fy),
    ):
        xi, yi = x0 + dx, y0 + dy
        ok = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        wm = np.where(ok, wgt, 0.0)
        tap = img[np.clip(yi, 0, h - 1), np.clip(xi, 0, w - 1)]
        out += tap * wm[..., None]
        wsum += wm
    return out, wsum


def render(
    world: np.ndarray, hom: np.ndarray, h: int, w: int, rows: int = 512
) -> np.ndarray:
    """Render the (h, w) view whose pixels map to the world through `hom`
    (bilinear, in row bands to bound memory). Returns uint8 BGR."""
    out = np.empty((h, w, 3), np.uint8)
    xs = np.arange(w, dtype=np.float64)
    for y0 in range(0, h, rows):
        ys = np.arange(y0, min(h, y0 + rows), dtype=np.float64)
        gx, gy = np.meshgrid(xs, ys)
        den = hom[2, 0] * gx + hom[2, 1] * gy + hom[2, 2]
        sx = (hom[0, 0] * gx + hom[0, 1] * gy + hom[0, 2]) / den
        sy = (hom[1, 0] * gx + hom[1, 1] * gy + hom[1, 2]) / den
        vals, _ = bilinear_sample(world, sx, sy)
        out[y0:y0 + len(ys)] = np.clip(np.round(vals), 0, 255)
    return out


def make_scene(n: int, h: int, w: int, seed: int) -> Scene:
    """The seeded n-view scene at view size (h, w)."""
    rng = np.random.default_rng(seed)
    homs, (world_h, world_w) = view_homographies(n, h, w, rng)
    world = world_texture(world_h, world_w, rng)
    views = [render(world, hm, h, w) for hm in homs]
    return Scene(world=world, homs=homs, views=views)


def pair_homography(scene: Scene, i: int, j: int) -> np.ndarray:
    """True homography mapping view j's pixels into view i's frame (the
    pipeline's right -> left H when view i is left, j right)."""
    hm = np.linalg.inv(scene.homs[i]) @ scene.homs[j]
    return hm / hm[2, 2]


def corner_error(
    h_est: np.ndarray, h_true: np.ndarray, height: int, width: int
) -> float:
    """Largest distance (px) between where the two homographies send the
    four corners of a (height, width) image."""
    c = np.array([[0.0, 0.0, 1.0], [width, 0.0, 1.0],
                  [width, height, 1.0], [0.0, height, 1.0]]).T
    a = np.asarray(h_est, np.float64) @ c
    b = np.asarray(h_true, np.float64) @ c
    d = a[:2] / a[2] - b[:2] / b[2]
    return float(np.sqrt((d * d).sum(axis=0)).max())


def truth_canvas(
    scene: Scene, anchor: int, t_mat: np.ndarray, out_h: int, out_w: int
) -> np.ndarray:
    """The world rendered on a panorama canvas whose pixel p shows anchor
    view point T^-1 p (T = the canvas translation, t_mat)."""
    return render(
        scene.world, scene.homs[anchor] @ np.linalg.inv(t_mat), out_h, out_w
    )


def footprint(
    hom: np.ndarray, src_h: int, src_w: int, out_h: int, out_w: int,
    erode: int = 2,
) -> np.ndarray:
    """Canvas pixels whose inverse image under `hom` (source -> canvas)
    lies inside the (src_h, src_w) source at least `erode` px from its
    border — the interior of a warped view."""
    inv = np.linalg.inv(hom)
    gx, gy = np.meshgrid(np.arange(out_w, dtype=np.float64),
                         np.arange(out_h, dtype=np.float64))
    den = inv[2, 0] * gx + inv[2, 1] * gy + inv[2, 2]
    sx = (inv[0, 0] * gx + inv[0, 1] * gy + inv[0, 2]) / den
    sy = (inv[1, 0] * gx + inv[1, 1] * gy + inv[1, 2]) / den
    return (
        (sx >= erode) & (sx <= src_w - 1 - erode)
        & (sy >= erode) & (sy <= src_h - 1 - erode)
    )


def psnr(a: np.ndarray, b: np.ndarray, mask: Optional[np.ndarray] = None):
    """PSNR (dB) of two uint8 images over `mask` (all pixels if None)."""
    d = a.astype(np.float64) - b.astype(np.float64)
    if mask is not None:
        d = d[mask]
    mse = float(np.mean(d * d))
    return float("inf") if mse == 0.0 else 10.0 * np.log10(255.0**2 / mse)


def write_views(scene: Scene, out_dir: str, ext: str = ".png") -> List[str]:
    """Write the views as view_00<ext>, view_01<ext>, ... (lexicographic
    order = sweep order, as the CLI's --dir reader sorts). Returns the
    image paths."""
    from pano.io import imwrite_bgr

    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for i, v in enumerate(scene.views):
        p = os.path.join(out_dir, f"view_{i:02d}{ext}")
        if not imwrite_bgr(p, v):
            raise OSError(f"could not write {p}")
        paths.append(p)
    return paths


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", required=True, help="output directory")
    ap.add_argument("--views", type=int, default=2)
    ap.add_argument("--height", type=int, default=3117)
    ap.add_argument("--width", type=int, default=4156)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    scene = make_scene(args.views, args.height, args.width, args.seed)
    for p in write_views(scene, args.out):
        print(p)
    return 0


if __name__ == "__main__":
    sys.exit(main())
