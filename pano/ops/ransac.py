"""RANSAC homography estimation — all hypotheses on-device, one shot.

Reference equivalents:
  * serial: SeqRansacHomographyCalculator (src/serial/main.cpp:247-307) —
    1000 iterations, each shuffles the match list, takes 4, calls
    cv::findHomography on the minimal sample, counts inliers by reprojection
    distance < 3.0, keeps the best H; nondeterministic std::random_device.
  * OpenMP: OmpRansacHomographyCalculator (src/openmp/main.cpp:353-453) —
    per-thread RNG + best-H, dynamic schedule (and a data race on shared
    sample buffers at :375-377, which we structurally cannot reproduce).
  * CUDA: ransacKernel (src/gpu/ransac.cu:229-316) — thread-per-hypothesis
    with a device-side 4-point DLT (Hartley normalization :29-66, 8x9
    assembly :69-95, Gaussian elimination :97-138), host argmax, <10-inlier
    fallback (:499-511), least-squares refinement on inliers (:524-544).

Design:
  * Sampling: deterministic `jax.random` (threefry) — 4 indices per
    hypothesis drawn over the compacted valid-match range. Duplicate indices
    (~0.1% of hypotheses) simply yield a degenerate DLT -> NaN H -> zero
    inliers, the same harmless outcome as the CUDA path's failed retries.
  * Solve: vmapped Hartley-normalized 4-point DLT as an unrolled 8x8
    Gauss-Jordan elimination with the h33=1 gauge, vectorized across all
    1000 hypotheses — replacing 1000 sequential cv::findHomography calls.
  * Scoring: one broadcast pass computes the (N_hyp, M) reprojection
    distances and reduces to per-hypothesis inlier counts; `argmax` picks the
    winner. No host round trip until the final 3x3 H is fetched.
  * Refinement: masked normalized DLT over ALL inliers of the winner via a
    9x9 eigendecomposition of A^T A (the economy form of the SVD the
    reference delegates to cv::findHomography(method=0)).

Everything is float32; Hartley normalization keeps the linear systems
well-conditioned at that precision (the reference GPU solver is also f32,
src/gpu/ransac.cu:23-181).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
from jax import lax

from pano.config import RansacOptions


class RansacResult(NamedTuple):
    H: jnp.ndarray             # (3, 3) float32, normalized so H[2,2] = 1
    inlier_count: jnp.ndarray  # () int32
    num_matches: jnp.ndarray   # () int32 — valid matches scored
    inlier_mask: jnp.ndarray   # (M,) bool — inliers of the final H
    ok: jnp.ndarray            # () bool — inlier_count >= min_inliers


def _normalization_transform(
    pts: jnp.ndarray, mask: jnp.ndarray
) -> jnp.ndarray:
    """Hartley similarity transform for masked points: T @ [x,y,1] has zero
    centroid and mean distance sqrt(2) (src/gpu/ransac.cu:29-66 does the same
    for the 4-point sample)."""
    m = mask.astype(pts.dtype)
    cnt = jnp.maximum(jnp.sum(m), 1.0)
    mean = jnp.sum(pts * m[:, None], axis=0) / cnt
    d = jnp.sqrt(jnp.sum((pts - mean) ** 2, axis=-1))
    mean_d = jnp.sum(d * m) / cnt
    s = jnp.sqrt(2.0) / jnp.maximum(mean_d, 1e-8)
    return jnp.array(
        [[s, 0.0, -s * mean[0]], [0.0, s, -s * mean[1]], [0.0, 0.0, 1.0]],
        dtype=pts.dtype,
    )


def inv3x3(m: jnp.ndarray) -> jnp.ndarray:
    """Closed-form 3x3 inverse (adjugate / determinant).

    Pure elementwise math that fuses into its consumers under vmap, in
    place of a batched LAPACK-style inverse. Singular input yields inf/nan
    (same degeneracy semantics as the LAPACK path)."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    co00 = e * i - f * h
    co01 = c * h - b * i
    co02 = b * f - c * e
    co10 = f * g - d * i
    co11 = a * i - c * g
    co12 = c * d - a * f
    co20 = d * h - e * g
    co21 = b * g - a * h
    co22 = a * e - b * d
    det = a * co00 + b * co10 + c * co20
    adj = jnp.stack(
        [
            jnp.stack([co00, co01, co02], axis=-1),
            jnp.stack([co10, co11, co12], axis=-1),
            jnp.stack([co20, co21, co22], axis=-1),
        ],
        axis=-2,
    )
    return adj / det[..., None, None]


def _solve8(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """8x8 linear solve by unrolled Gauss-Jordan with partial pivoting.

    Eight unrolled elimination steps of pure elementwise/select ops
    vectorize across the 1000-hypothesis batch, in place of a batched
    LAPACK-style solve. Same algorithm as the reference's device-side solver
    (src/gpu/ransac.cu:97-138). Singular systems produce inf/nan, which
    score zero inliers downstream — identical degeneracy semantics.
    """
    m = jnp.concatenate([a, b[:, None]], axis=1)           # (8, 9)
    rows = jnp.arange(8)
    for col in range(8):
        # Partial pivot: strongest remaining row for this column.
        mag = jnp.abs(m[:, col])
        mag = jnp.where(rows >= col, mag, -jnp.inf)
        piv = jnp.argmax(mag)
        # Swap rows col <-> piv with masked selects, NOT dynamic
        # slices/updates: under the 1000-hypothesis vmap, `m[piv]` /
        # `m.at[piv].set` lower to batched gathers/scatters, while the
        # select form fuses into the elimination arithmetic. Same values
        # bit-for-bit.
        is_piv = (rows == piv)[:, None]
        row_c = m[col]
        row_p = jnp.sum(jnp.where(is_piv, m, 0.0), axis=0)
        m = jnp.where(
            (rows == col)[:, None],
            row_p[None, :],
            jnp.where(is_piv, row_c[None, :], m),
        )
        # Eliminate the column everywhere except the pivot row.
        factor = m[:, col] / m[col, col]
        factor = jnp.where(rows == col, 0.0, factor)
        m = m - factor[:, None] * m[col][None, :]
    return m[:, 8] / jnp.diagonal(m[:, :8])


def homography_from_4pts(
    src: jnp.ndarray, dst: jnp.ndarray
) -> jnp.ndarray:
    """Exact homography from 4 correspondences (src -> dst), f32.

    Hartley-normalize both sides, solve the 8x8 system with the h33=1 gauge,
    denormalize. Degenerate samples produce non-finite entries, which score
    zero inliers downstream — the moral equivalent of cv::findHomography
    returning empty (src/serial/main.cpp:279-281).
    """
    ones4 = jnp.ones((4,), src.dtype)
    t_src = _normalization_transform(src, ones4 > 0)
    t_dst = _normalization_transform(dst, ones4 > 0)
    sn = src @ t_src[:2, :2].T + t_src[:2, 2]
    dn = dst @ t_dst[:2, :2].T + t_dst[:2, 2]

    x, y = sn[:, 0], sn[:, 1]
    u, v = dn[:, 0], dn[:, 1]
    zeros = jnp.zeros_like(x)
    ones = jnp.ones_like(x)
    # Rows: u = (h1 x + h2 y + h3) / (h7 x + h8 y + 1)
    rows_u = jnp.stack(
        [x, y, ones, zeros, zeros, zeros, -u * x, -u * y], axis=-1
    )
    rows_v = jnp.stack(
        [zeros, zeros, zeros, x, y, ones, -v * x, -v * y], axis=-1
    )
    a = jnp.concatenate([rows_u, rows_v], axis=0)          # (8, 8)
    b = jnp.concatenate([u, v], axis=0)                    # (8,)
    h8 = _solve8(a, b)
    h = jnp.concatenate([h8, jnp.ones((1,), src.dtype)]).reshape(3, 3)

    h_full = inv3x3(t_dst) @ h @ t_src
    return h_full / h_full[2, 2]


def project_points(h: jnp.ndarray, pts: jnp.ndarray) -> jnp.ndarray:
    """Apply homography to (M, 2) points -> (M, 2) (cv::perspectiveTransform
    semantics, src/serial/main.cpp:287-291)."""
    w = h[2, 0] * pts[:, 0] + h[2, 1] * pts[:, 1] + h[2, 2]
    px = (h[0, 0] * pts[:, 0] + h[0, 1] * pts[:, 1] + h[0, 2]) / w
    py = (h[1, 0] * pts[:, 0] + h[1, 1] * pts[:, 1] + h[1, 2]) / w
    return jnp.stack([px, py], axis=-1)


def _score_hypotheses(
    hs: jnp.ndarray,            # (N, 3, 3)
    src: jnp.ndarray,           # (M, 2)
    dst: jnp.ndarray,           # (M, 2)
    valid: jnp.ndarray,         # (M,)
    thresh: float,
) -> jnp.ndarray:
    """Inlier count per hypothesis in one broadcast pass -> (N,) int32."""
    x, y = src[:, 0], src[:, 1]                       # (M,)
    w = hs[:, 2, 0, None] * x + hs[:, 2, 1, None] * y + hs[:, 2, 2, None]
    px = (hs[:, 0, 0, None] * x + hs[:, 0, 1, None] * y + hs[:, 0, 2, None]) / w
    py = (hs[:, 1, 0, None] * x + hs[:, 1, 1, None] * y + hs[:, 1, 2, None]) / w
    d2 = (px - dst[None, :, 0]) ** 2 + (py - dst[None, :, 1]) ** 2
    # NaN / inf distances compare False — degenerate H scores 0.
    is_in = (d2 < thresh * thresh) & valid[None, :]
    return jnp.sum(is_in.astype(jnp.int32), axis=1)


def _inlier_mask(
    h: jnp.ndarray, src: jnp.ndarray, dst: jnp.ndarray, valid: jnp.ndarray,
    thresh: float,
) -> jnp.ndarray:
    proj = project_points(h, src)
    d2 = jnp.sum((proj - dst) ** 2, axis=-1)
    return (d2 < thresh * thresh) & valid


def refine_homography(
    src: jnp.ndarray, dst: jnp.ndarray, mask: jnp.ndarray
) -> jnp.ndarray:
    """Least-squares DLT over all masked correspondences.

    The economy-SVD refinement the reference GPU path delegates to
    cv::findHomography(inliers, method=0) (src/gpu/ransac.cu:524-544): build
    the (2M, 9) DLT system with outlier rows zeroed, take the eigenvector of
    A^T A (9x9) with the smallest eigenvalue.
    """
    dtype = src.dtype
    t_src = _normalization_transform(src, mask)
    t_dst = _normalization_transform(dst, mask)
    sn = src @ t_src[:2, :2].T + t_src[:2, 2]
    dn = dst @ t_dst[:2, :2].T + t_dst[:2, 2]

    x, y = sn[:, 0], sn[:, 1]
    u, v = dn[:, 0], dn[:, 1]
    zeros = jnp.zeros_like(x)
    ones = jnp.ones_like(x)
    m = mask.astype(dtype)
    r1 = jnp.stack(
        [-x, -y, -ones, zeros, zeros, zeros, u * x, u * y, u], axis=-1
    ) * m[:, None]
    r2 = jnp.stack(
        [zeros, zeros, zeros, -x, -y, -ones, v * x, v * y, v], axis=-1
    ) * m[:, None]
    a = jnp.concatenate([r1, r2], axis=0)                  # (2M, 9)
    ata = a.T @ a                                          # (9, 9)
    # Smallest-eigenvalue eigenvector of the normal matrix == right singular
    # vector of A for the smallest singular value.
    _, vecs = jnp.linalg.eigh(ata)
    h = vecs[:, 0].reshape(3, 3)
    h_full = inv3x3(t_dst) @ h @ t_src
    return h_full / h_full[2, 2]


def ransac_best_hypothesis(
    key: jax.Array,
    pts_src: jnp.ndarray,
    pts_dst: jnp.ndarray,
    valid: jnp.ndarray,
    num_iterations: int,
    num_samples: int,
    distance_threshold: float,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Search `num_iterations` hypotheses; return (best_H (3,3), count ()).

    The shared core of the single-chip path and the hypothesis-sharded
    multi-chip path (pano.parallel.shard folds the mesh axis index into
    `key` so each chip searches a disjoint hypothesis stream).
    """
    n_valid = jnp.sum(valid.astype(jnp.int32))
    # (N, num_samples) indices over the compacted valid range. Sampling with
    # replacement: a duplicated index degenerates that hypothesis only.
    idx = jax.random.randint(
        key,
        (num_iterations, num_samples),
        0,
        jnp.maximum(n_valid, 1),
    )

    samples_src = pts_src[idx]                         # (N, 4, 2)
    samples_dst = pts_dst[idx]
    hs = jax.vmap(homography_from_4pts)(samples_src, samples_dst)

    counts = _score_hypotheses(
        hs, pts_src, pts_dst, valid, distance_threshold
    )
    best = jnp.argmax(counts)
    return hs[best], counts[best]


@functools.partial(jax.jit, static_argnames=("opts",))
@jax.named_scope("ransac")
def ransac_homography(
    pts_src: jnp.ndarray,       # (M, 2) f32 — compacted: valid rows first
    pts_dst: jnp.ndarray,       # (M, 2) f32
    valid: jnp.ndarray,         # (M,) bool
    opts: RansacOptions,
) -> RansacResult:
    """Estimate H mapping src -> dst with vmapped RANSAC + optional refine."""
    key = jax.random.PRNGKey(opts.seed)
    best_h, best_count = ransac_best_hypothesis(
        key,
        pts_src,
        pts_dst,
        valid,
        opts.num_iterations,
        opts.num_samples,
        opts.distance_threshold,
    )
    return finalize_ransac(best_h, best_count, pts_src, pts_dst, valid, opts)


def finalize_ransac(
    best_h: jnp.ndarray,
    best_count: jnp.ndarray,
    pts_src: jnp.ndarray,
    pts_dst: jnp.ndarray,
    valid: jnp.ndarray,
    opts: RansacOptions,
) -> RansacResult:
    """Degeneracy guard + inlier mask + optional least-squares refinement."""
    n_valid = jnp.sum(valid.astype(jnp.int32))

    # Guard: no valid hypothesis at all (e.g. < 4 matches) -> identity H.
    enough = n_valid >= opts.num_samples
    best_h = jnp.where(
        jnp.isfinite(best_h).all() & enough, best_h, jnp.eye(3, dtype=pts_src.dtype)
    )

    mask0 = _inlier_mask(
        best_h, pts_src, pts_dst, valid, opts.distance_threshold
    )

    if opts.refine:
        refined = refine_homography(pts_src, pts_dst, mask0)
        mask_r = _inlier_mask(
            refined, pts_src, pts_dst, valid, opts.distance_threshold
        )
        count_r = jnp.sum(mask_r.astype(jnp.int32))
        use_refined = (
            jnp.isfinite(refined).all() & (count_r >= best_count)
        )
        best_h = jnp.where(use_refined, refined, best_h)
        mask0 = jnp.where(use_refined, mask_r, mask0)
        best_count = jnp.where(use_refined, count_r, best_count)

    ok = (best_count >= opts.min_inliers) & enough
    return RansacResult(
        H=best_h,
        inlier_count=best_count,
        num_matches=n_valid,
        inlier_mask=mask0,
        ok=ok,
    )
