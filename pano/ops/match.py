"""SSD patch matching as descriptor gather + distance matrix + argmin.

Reference equivalents:
  * serial: seqHarrisMatchKeyPoints (src/serial/main.cpp:188-244) — for each
    border-valid left keypoint, scan ALL right keypoints, SSD over a 5x5 RGB
    patch, keep the argmin, emit a match iff ssd < maxSSDThresh;
  * OpenMP: ompHarrisMatchKeyPoints (src/openmp/main.cpp:235-349) — dynamic
    scheduling, SIMD row reductions, early-exit pruning;
  * CUDA: computeSSDKernel + findBestMatchesKernel
    (src/gpu/harris_matcher.cu:10-81) — thread-per-pair full K x K SSD matrix.

Design: gather each keypoint's patch once into a (K, P*P*3) descriptor
matrix, then SSD(i,j) = |qi|^2 + |tj|^2 - 2*qi.tj — one (K, D) x (D, K)
matrix product plus rank-1 terms, followed by row/column reductions. All
quantities are integers < 2^24, so float32 is exact. Row-level early-exit
pruning (src/openmp/main.cpp:321-325) is replaced by the dense product: the
whole 8192 x 8192 distance computation is one ~10 GFLOP matrix product.

Invalid (padding / border-clipped) keypoints participate with +inf distance,
reproducing the reference's skip-continue logic with static shapes.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
from jax import lax

from pano.config import HarrisOptions
from pano.ops.harris import KeyPoints


class Matches(NamedTuple):
    """Fixed-capacity match set (replaces std::vector<cv::DMatch>).

    Row i corresponds to query keypoint i (cv::DMatch::queryIdx == i).
    train_idx: (K,) int32 best-match index into the train keypoint set.
    ssd:       (K,) float32 best SSD (cv::DMatch::distance).
    valid:     (K,) bool — query was border-valid, train exists, ssd < thresh.
    """

    train_idx: jnp.ndarray
    ssd: jnp.ndarray
    valid: jnp.ndarray

    def count(self) -> jnp.ndarray:
        return jnp.sum(self.valid.astype(jnp.int32))


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@jax.named_scope("descriptors")
def extract_patch_descriptors(
    img_u8: jnp.ndarray, kps: KeyPoints, patch_size: int
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Gather P x P x 3 patches around keypoints into flat f32 descriptors.

    Returns (desc (K, P*P*3) float32, border_valid (K,) bool). Descriptors
    of invalid keypoints are zeros. Border validity is the reference's clip
    test (src/serial/main.cpp:203-206 / :213-216).
    """
    h, w = img_u8.shape[:2]
    border = patch_size // 2
    x = kps.xy[:, 0]
    y = kps.xy[:, 1]

    border_valid = (
        (x >= border)
        & (y >= border)
        & (x + border < w)
        & (y + border < h)
        & kps.valid
    )

    offs = jnp.arange(-border, border + 1)
    ys = jnp.clip(y[:, None] + offs[None, :], 0, h - 1)       # (K, P)
    xs = jnp.clip(x[:, None] + offs[None, :], 0, w - 1)       # (K, P)
    k_cap = kps.xy.shape[0]
    # Pack BGR into one i32 per pixel, then one flat 1-D gather: one fetched
    # element per patch pixel instead of a 3-byte row.
    p32 = img_u8.astype(jnp.int32)
    pk = p32[..., 0] | (p32[..., 1] << 8) | (p32[..., 2] << 16)
    idx = (ys[:, :, None] * w + xs[:, None, :]).reshape(k_cap, -1)
    g = jnp.take(pk.reshape(-1), idx, axis=0)             # (K, P*P)
    patches = jnp.stack(
        [(g & 0xFF), (g >> 8) & 0xFF, (g >> 16) & 0xFF], axis=-1
    )
    desc = patches.reshape(k_cap, -1).astype(jnp.float32)
    desc = jnp.where(border_valid[:, None], desc, 0.0)
    return desc, border_valid


# Dense plan up to a (Kq, Kt) f32 matrix of 512 MB (K = 11585 per side);
# above it, stream train tiles so the matrix never materializes.
_DENSE_ELEM_LIMIT = 128 * 1024 * 1024
_STREAM_TILE = 1024


def _exact_u8_dot(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """a @ b.T for u8-valued f32 descriptors, exactly, at the fast rate.

    DEFAULT precision runs f32 operands through the GPU's TF32 tensor cores
    (10 explicit mantissa bits). That is still exact here: every operand is
    an integer in [0, 255], each product fits in 16 bits, and the f32
    accumulator holds every partial sum exactly because a full dot product
    is at most 75 * 255^2 < 2^24."""
    return jnp.dot(
        a, b.T,
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.DEFAULT,
    )


@jax.named_scope("ssd_match")
def match_descriptors(
    desc_q: jnp.ndarray,
    valid_q: jnp.ndarray,
    desc_t: jnp.ndarray,
    valid_t: jnp.ndarray,
    max_ssd_thresh: float,
    ratio_thresh: float = 0.0,
    cross_check: bool = False,
    block_size: int = 0,
) -> Matches:
    """Brute-force argmin-SSD matching of query descriptors against train.

    One matrix product for the cross terms; invalid train columns are masked to
    +inf before the row argmin (the reference `continue`s over border-invalid
    train keypoints, src/serial/main.cpp:213-217).

    Robustness additions over the reference's raw argmin (both cheap
    post-passes on the SSD matrix, defaults set in HarrisOptions):
      * Lowe ratio test: reject if best >= ratio^2 * second-best — kills
        ambiguous matches on repetitive texture;
      * cross check: require the match to be a mutual nearest neighbor.

    `block_size` selects the memory plan: 0 = auto (dense single matmul
    below _DENSE_ELEM_LIMIT elements, else stream train tiles of
    _STREAM_TILE); N > 0 forces the blockwise streaming path with tile N.
    Both paths are bit-identical (see _match_descriptors_streaming).

    """
    kq, kt = desc_q.shape[0], desc_t.shape[0]
    if block_size == 0 and kq * kt > _DENSE_ELEM_LIMIT:
        block_size = _STREAM_TILE
    if block_size > 0 and kt > block_size:
        return _match_descriptors_streaming(
            desc_q, valid_q, desc_t, valid_t, max_ssd_thresh,
            ratio_thresh, cross_check, block_size,
        )

    q_sq = jnp.sum(desc_q * desc_q, axis=1)            # (Kq,)
    t_sq = jnp.sum(desc_t * desc_t, axis=1)            # (Kt,)
    dots = _exact_u8_dot(desc_q, desc_t)                # (Kq, Kt)
    ssd = q_sq[:, None] + t_sq[None, :] - 2.0 * dots
    ssd = jnp.where(valid_t[None, :], ssd, jnp.inf)

    best_idx = jnp.argmin(ssd, axis=1).astype(jnp.int32)
    best_ssd = jnp.min(ssd, axis=1)

    valid = (
        valid_q
        & jnp.isfinite(best_ssd)
        & (best_ssd < jnp.asarray(max_ssd_thresh, jnp.float32))
    )

    if ratio_thresh > 0.0:
        cols = jnp.arange(ssd.shape[1], dtype=jnp.int32)
        ssd_wo_best = jnp.where(
            cols[None, :] == best_idx[:, None], jnp.inf, ssd
        )
        second = jnp.min(ssd_wo_best, axis=1)
        r2 = jnp.asarray(ratio_thresh * ratio_thresh, jnp.float32)
        # SSD is a squared distance, so the ratio applies squared. A missing
        # second neighbor (inf) passes.
        valid = valid & (
            ~jnp.isfinite(second) | (best_ssd < r2 * second)
        )

    if cross_check:
        col_best = jnp.argmin(
            jnp.where(valid_q[:, None], ssd, jnp.inf), axis=0
        ).astype(jnp.int32)
        rows = jnp.arange(ssd.shape[0], dtype=jnp.int32)
        mutual = col_best[best_idx] == rows
        valid = valid & mutual

    best_ssd = jnp.where(valid, best_ssd, 0.0)
    best_idx = jnp.where(valid, best_idx, 0)
    return Matches(train_idx=best_idx, ssd=best_ssd, valid=valid)


def _match_descriptors_streaming(
    desc_q: jnp.ndarray,
    valid_q: jnp.ndarray,
    desc_t: jnp.ndarray,
    valid_t: jnp.ndarray,
    max_ssd_thresh: float,
    ratio_thresh: float,
    cross_check: bool,
    block: int,
) -> Matches:
    """Blockwise streaming matcher: the (Kq, Kt) SSD matrix NEVER
    materializes (the flash-attention trick applied to a distance matrix —
    SURVEY §5 long-context analog; contrast the CUDA full-matrix allocation
    at src/gpu/harris_matcher.cu:127).

    A lax.scan streams train tiles of `block` columns; the carry holds, per
    query row, the running (best, best_idx, second-best). Merging tile
    results is exact: the two smallest of a union are among {run_best,
    tile_best, run_second, tile_second}. The cross-check's per-train-column
    best query needs no carry at all — each train column lives in exactly
    one tile, so the tile-local column argmin is final. Tie-breaking matches
    the dense path bit-for-bit: earlier tiles win ties (strict <), and the
    in-tile argmin takes the lowest column index.

    Peak live memory is Kq x block (64 MB at Kq=16384, block=4096, f32) vs
    the dense path's Kq x Kt (1 GB at K=16384).
    """
    kq, kt = desc_q.shape[0], desc_t.shape[0]
    ktp = _round_up(kt, block)
    if ktp != kt:  # padded columns are invalid -> +inf, never win
        desc_t = jnp.pad(desc_t, ((0, ktp - kt), (0, 0)))
        valid_t = jnp.pad(valid_t, (0, ktp - kt))
    n_tiles = ktp // block

    q_sq = jnp.sum(desc_q * desc_q, axis=1)            # (Kq,)
    t_tiles = desc_t.reshape(n_tiles, block, desc_t.shape[1])
    v_tiles = valid_t.reshape(n_tiles, block)
    bases = (jnp.arange(n_tiles, dtype=jnp.int32) * block)
    cols = jnp.arange(block, dtype=jnp.int32)

    def step(carry, xs):
        best, best_idx, second = carry
        dt, vt, base = xs
        t_sq = jnp.sum(dt * dt, axis=1)                # (block,)
        dots = _exact_u8_dot(desc_q, dt)                # (Kq, block)
        ssd = q_sq[:, None] + t_sq[None, :] - 2.0 * dots
        ssd = jnp.where(vt[None, :], ssd, jnp.inf)

        tb_idx = jnp.argmin(ssd, axis=1).astype(jnp.int32)
        tb = jnp.min(ssd, axis=1)
        ssd_wo = jnp.where(cols[None, :] == tb_idx[:, None], jnp.inf, ssd)
        ts = jnp.min(ssd_wo, axis=1)                    # tile second-best

        # Cross-check: this tile's columns' best query rows (final).
        cb = jnp.argmin(
            jnp.where(valid_q[:, None], ssd, jnp.inf), axis=0
        ).astype(jnp.int32)

        new_second = jnp.minimum(
            jnp.maximum(best, tb), jnp.minimum(second, ts)
        )
        take = tb < best
        new_best = jnp.minimum(best, tb)
        new_idx = jnp.where(take, base + tb_idx, best_idx)
        return (new_best, new_idx, new_second), cb

    init = (
        jnp.full((kq,), jnp.inf, jnp.float32),
        jnp.zeros((kq,), jnp.int32),
        jnp.full((kq,), jnp.inf, jnp.float32),
    )
    if n_tiles <= 32:
        # Unrolled: the tile count is small and static, so the tiles need no
        # while-loop; peak memory stays bounded by XLA's buffer reuse.
        carry = init
        cbs = []
        for i in range(n_tiles):
            carry, cb = step(carry, (t_tiles[i], v_tiles[i], bases[i]))
            cbs.append(cb)
        best_ssd, best_idx, second = carry
        col_best = jnp.stack(cbs)
    else:
        (best_ssd, best_idx, second), col_best = lax.scan(
            step, init, (t_tiles, v_tiles, bases)
        )

    valid = (
        valid_q
        & jnp.isfinite(best_ssd)
        & (best_ssd < jnp.asarray(max_ssd_thresh, jnp.float32))
    )
    if ratio_thresh > 0.0:
        r2 = jnp.asarray(ratio_thresh * ratio_thresh, jnp.float32)
        valid = valid & (~jnp.isfinite(second) | (best_ssd < r2 * second))
    if cross_check:
        col_best = col_best.reshape(ktp)                # (ktp,)
        rows = jnp.arange(kq, dtype=jnp.int32)
        valid = valid & (col_best[best_idx] == rows)

    best_ssd = jnp.where(valid, best_ssd, 0.0)
    best_idx = jnp.where(valid, best_idx, 0)
    return Matches(train_idx=best_idx, ssd=best_ssd, valid=valid)


def match_keypoints(
    kps_q: KeyPoints,
    kps_t: KeyPoints,
    img_q: jnp.ndarray,
    img_t: jnp.ndarray,
    opts: HarrisOptions,
) -> Matches:
    """Full matching stage: descriptors for both sides, then argmin-SSD.

    Signature mirrors seqHarrisMatchKeyPoints(keypointsL, keypointsR, image1,
    image2, options) (src/serial/main.cpp:188-192): `q` is the query side
    (the reference's keypointsL/image1), `t` the train side.
    """
    desc_q, bq = extract_patch_descriptors(img_q, kps_q, opts.patch_size)
    desc_t, bt = extract_patch_descriptors(img_t, kps_t, opts.patch_size)
    return match_descriptors(
        desc_q,
        bq,
        desc_t,
        bt,
        opts.max_ssd_thresh,
        ratio_thresh=opts.ratio_thresh,
        cross_check=opts.cross_check,
        block_size=opts.match_block,
    )


def gather_match_points(
    kps_q: KeyPoints, kps_t: KeyPoints, matches: Matches
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Materialize matched coordinate pairs for RANSAC.

    Returns (pts_q (K,2) f32, pts_t (K,2) f32, valid (K,) bool) where row i
    pairs query keypoint i with its best train keypoint — the coordinate
    arrays RANSAC consumes (reference: keypoints1[m.queryIdx].pt /
    keypoints2[m.trainIdx].pt, src/serial/main.cpp:275-276).

    Valid matches are compacted to the front (stable), giving RANSAC a
    contiguous [0, count) index range to sample from.

    The valid mask is derived as arange < count — exactly valid[order] for
    a stable sort on ~valid — instead of a fourth gather.
    """
    order = jnp.argsort(~matches.valid, stable=True)
    pts_q = kps_q.xy[order].astype(jnp.float32)
    pts_t = kps_t.xy[matches.train_idx[order]].astype(jnp.float32)
    count = matches.valid.sum(dtype=jnp.int32)
    valid = jnp.arange(matches.valid.shape[0], dtype=jnp.int32) < count
    return pts_q, pts_t, valid
