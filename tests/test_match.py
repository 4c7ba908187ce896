"""Unit tests: SSD matching vs a numpy oracle of the reference's
seqHarrisMatchKeyPoints (src/serial/main.cpp:188-244)."""

import numpy as np
import jax.numpy as jnp
import pytest

from pano import oracles
from pano.config import HarrisOptions
from pano.ops import match
from pano.ops.harris import KeyPoints


def make_kps(coords, cap):
    n = len(coords)
    xy = np.zeros((cap, 2), np.int32)
    if n:
        xy[:n] = coords
    valid = np.zeros(cap, bool)
    valid[:n] = True
    resp = np.zeros(cap, np.float32)
    return KeyPoints(
        xy=jnp.asarray(xy), response=jnp.asarray(resp), valid=jnp.asarray(valid)
    )


def ssd_oracle(img1, img2, kps1, kps2, opts):
    """The reference matching loop's result from the numpy oracles
    (pano.oracles): {query index: (train index, SSD)} for valid matches."""
    xy1 = np.asarray(kps1.xy)
    xy2 = np.asarray(kps2.xy)
    d1, v1 = oracles.patch_descriptors(
        img1, xy1, np.asarray(kps1.valid), opts.patch_size)
    d2, v2 = oracles.patch_descriptors(
        img2, xy2, np.asarray(kps2.valid), opts.patch_size)
    idx, ssd, ok = oracles.match_ssd(d1, v1, d2, v2, opts.max_ssd_thresh,
                                     opts.ratio_thresh, opts.cross_check)
    return {int(i): (int(idx[i]), float(ssd[i])) for i in np.nonzero(ok)[0]}


def test_match_exact_vs_oracle(rng):
    img1 = rng.integers(0, 256, (40, 48, 3), dtype=np.uint8)
    img2 = rng.integers(0, 256, (40, 48, 3), dtype=np.uint8)
    # Plant identical patches so there are exact matches.
    img2[10:15, 10:15] = img1[20:25, 20:25]
    c1 = [(22, 22), (10, 10), (30, 5), (1, 1)]   # last one is border-invalid
    c2 = [(12, 12), (25, 25), (40, 30)]
    k1 = make_kps(c1, 8)
    k2 = make_kps(c2, 8)
    # Reference-parity mode: raw argmin without the robustness filters.
    opts = HarrisOptions(ratio_thresh=0.0, cross_check=False)

    m = match.match_keypoints(
        k1, k2, jnp.asarray(img1), jnp.asarray(img2), opts
    )
    want = ssd_oracle(img1, img2, k1, k2, opts)

    got = {
        i: (int(t), float(s))
        for i, (t, s, v) in enumerate(
            zip(np.asarray(m.train_idx), np.asarray(m.ssd), np.asarray(m.valid))
        )
        if v
    }
    assert set(got) == set(want)
    for i in want:
        assert got[i][0] == want[i][0]
        # f32 SSD is integer-exact in this range.
        assert got[i][1] == want[i][1]


def test_planted_identical_patch_matches_with_zero_ssd(rng):
    img1 = rng.integers(0, 256, (32, 32, 3), dtype=np.uint8)
    img2 = np.roll(img1, 7, axis=1)  # right image = left shifted by 7
    k1 = make_kps([(15, 16)], 4)
    k2 = make_kps([(22, 16), (10, 5)], 4)
    m = match.match_keypoints(
        k1, k2, jnp.asarray(img1), jnp.asarray(img2), HarrisOptions()
    )
    assert bool(np.asarray(m.valid)[0])
    assert int(np.asarray(m.train_idx)[0]) == 0
    assert float(np.asarray(m.ssd)[0]) == 0.0


def test_invalid_train_side_yields_no_matches(rng):
    img = rng.integers(0, 256, (32, 32, 3), dtype=np.uint8)
    k1 = make_kps([(15, 15)], 4)
    k2 = make_kps([], 4)
    m = match.match_keypoints(
        k1, k2, jnp.asarray(img), jnp.asarray(img), HarrisOptions()
    )
    assert int(m.count()) == 0


def test_ratio_test_rejects_ambiguous(rng):
    img1 = rng.integers(0, 256, (32, 32, 3), dtype=np.uint8)
    img2 = rng.integers(0, 256, (32, 64, 3), dtype=np.uint8)
    # Two nearly identical train patches, both slightly different from the
    # query (best SSD > 0, second within the ratio) -> ambiguous.
    patch = img1[10:15, 10:15]
    noisy1 = patch.astype(np.int32) + rng.integers(-4, 5, patch.shape)
    noisy2 = patch.astype(np.int32) + rng.integers(-4, 5, patch.shape)
    img2[10:15, 10:15] = noisy1.clip(0, 255).astype(np.uint8)
    img2[10:15, 40:45] = noisy2.clip(0, 255).astype(np.uint8)
    k1 = make_kps([(12, 12)], 4)
    k2 = make_kps([(12, 12), (42, 12)], 4)
    loose = HarrisOptions(ratio_thresh=0.0, cross_check=False)
    strict = HarrisOptions(ratio_thresh=0.85, cross_check=False)
    m_loose = match.match_keypoints(
        k1, k2, jnp.asarray(img1), jnp.asarray(img2), loose
    )
    m_strict = match.match_keypoints(
        k1, k2, jnp.asarray(img1), jnp.asarray(img2), strict
    )
    assert bool(np.asarray(m_loose.valid)[0])      # raw argmin accepts
    assert not bool(np.asarray(m_strict.valid)[0])  # ratio test rejects


def test_cross_check_requires_mutual(rng):
    img1 = rng.integers(0, 256, (32, 32, 3), dtype=np.uint8)
    img2 = rng.integers(0, 256, (32, 32, 3), dtype=np.uint8)
    img2[10:15, 10:15] = img1[10:15, 10:15]  # one true correspondence
    k1 = make_kps([(12, 12), (20, 20)], 4)
    k2 = make_kps([(12, 12)], 4)
    opts = HarrisOptions(ratio_thresh=0.0, cross_check=True)
    m = match.match_keypoints(
        k1, k2, jnp.asarray(img1), jnp.asarray(img2), opts
    )
    v = np.asarray(m.valid)
    assert bool(v[0])       # mutual nearest neighbors
    assert not bool(v[1])   # (20,20) -> (12,12) is not reciprocated


def test_gather_match_points_compacts_valid_first(rng):
    img1 = rng.integers(0, 256, (32, 32, 3), dtype=np.uint8)
    img2 = rng.integers(0, 256, (32, 32, 3), dtype=np.uint8)
    k1 = make_kps([(1, 1), (15, 15), (2, 30)], 6)  # 0 and 2 border-invalid
    k2 = make_kps([(10, 10), (20, 20)], 6)
    m = match.match_keypoints(
        k1, k2, jnp.asarray(img1), jnp.asarray(img2), HarrisOptions()
    )
    pq, pt, valid = match.gather_match_points(k1, k2, m)
    v = np.asarray(valid)
    # All valid entries precede all invalid ones.
    first_invalid = np.argmin(v) if not v.all() else len(v)
    assert not v[first_invalid:].any()
    assert np.asarray(pq).shape == (6, 2)


# --- blockwise streaming matcher parity (ops/match.py streaming path) -----

def _random_descs(rng, kq, kt, d=75):
    """Synthetic uint8-valued descriptor sets with some duplicate rows so
    tie-breaking paths are exercised."""
    dq = rng.integers(0, 256, (kq, d)).astype(np.float32)
    dt = rng.integers(0, 256, (kt, d)).astype(np.float32)
    dt[7] = dq[3, :]              # a perfect match
    dt[19] = dt[5]                # duplicate train rows -> argmin ties
    vq = rng.random(kq) > 0.15
    vt = rng.random(kt) > 0.15
    return (
        jnp.asarray(dq), jnp.asarray(vq), jnp.asarray(dt), jnp.asarray(vt)
    )


@pytest.mark.parametrize("ratio,cross", [(0.0, False), (0.85, True),
                                         (0.85, False), (0.0, True)])
@pytest.mark.parametrize("kt", [96, 128, 200])  # incl. non-multiple of tile
def test_streaming_matcher_bitwise_parity(rng, kt, ratio, cross):
    """Streamed tiles must reproduce the dense matcher bit-for-bit,
    including argmin tie-breaking, ratio-test second-best, and the
    cross-check column argmin."""
    dq, vq, dt, vt = _random_descs(rng, 64, kt)
    dense = match.match_descriptors(
        dq, vq, dt, vt, 1e18, ratio_thresh=ratio, cross_check=cross
    )
    streamed = match.match_descriptors(
        dq, vq, dt, vt, 1e18, ratio_thresh=ratio, cross_check=cross,
        block_size=32,
    )
    np.testing.assert_array_equal(
        np.asarray(dense.valid), np.asarray(streamed.valid)
    )
    np.testing.assert_array_equal(
        np.asarray(dense.train_idx), np.asarray(streamed.train_idx)
    )
    np.testing.assert_array_equal(
        np.asarray(dense.ssd), np.asarray(streamed.ssd)
    )


def test_streaming_matcher_threshold_parity(rng):
    """SSD threshold applies identically on both paths."""
    dq, vq, dt, vt = _random_descs(rng, 48, 96)
    thresh = 2.0e6
    dense = match.match_descriptors(dq, vq, dt, vt, thresh)
    streamed = match.match_descriptors(dq, vq, dt, vt, thresh, block_size=16)
    np.testing.assert_array_equal(
        np.asarray(dense.valid), np.asarray(streamed.valid)
    )


def test_streaming_auto_dispatch_large_k():
    """Above the dense limit the auto path streams (shape-level check: the
    result layout matches and no (Kq, Kt) buffer is required — we run at
    K=16384 which would be a 1 GB dense matrix)."""
    k = 16384
    r = np.random.default_rng(0)
    d = 128
    dq = jnp.asarray(r.integers(0, 256, (k, d)).astype(np.float32))
    dt = jnp.asarray(r.integers(0, 256, (k, d)).astype(np.float32))
    vq = jnp.ones((k,), bool)
    vt = jnp.ones((k,), bool)
    m = match.match_descriptors(dq, vq, dt, vt, 1e18)
    assert m.train_idx.shape == (k,)
    assert bool(np.asarray(m.valid).all())


@pytest.mark.parametrize("ratio,cross", [(0.0, False), (0.85, True),
                                         (0.85, False), (0.0, True)])
@pytest.mark.parametrize("block", [0, 32])
def test_matcher_matches_float64_oracle(rng, block, ratio, cross):
    """Dense (block 0) and streamed matchers against the float64 numpy
    matcher: index, SSD and validity bit-exact, ties to the lowest index
    included (u8-valued descriptors make every SSD an exact integer)."""
    dq, vq, dt, vt = _random_descs(rng, 64, 200)
    m = match.match_descriptors(
        dq, vq, dt, vt, 3.0e6, ratio_thresh=ratio, cross_check=cross,
        block_size=block,
    )
    idx, ssd, ok = oracles.match_ssd(
        np.asarray(dq), np.asarray(vq), np.asarray(dt), np.asarray(vt),
        3.0e6, ratio, cross,
    )
    np.testing.assert_array_equal(np.asarray(m.valid), ok)
    np.testing.assert_array_equal(np.asarray(m.train_idx), idx)
    np.testing.assert_array_equal(np.asarray(m.ssd, np.float64), ssd)


@pytest.mark.parametrize("patch", [3, 5, 7])
def test_patch_descriptors_match_oracle(rng, patch):
    """The packed flat gather against the numpy patch cut, bit for bit,
    with keypoints on every border and padded (invalid) slots."""
    img = rng.integers(0, 256, (30, 41, 3), dtype=np.uint8)
    coords = [(0, 0), (40, 29), (3, 3), (37, 26), (20, 1), (1, 15),
              (10, 10), (25, 20), (patch // 2, patch // 2)]
    kps = make_kps(coords, 12)
    desc, ok = match.extract_patch_descriptors(jnp.asarray(img), kps, patch)
    want, want_ok = oracles.patch_descriptors(
        img, np.asarray(kps.xy), np.asarray(kps.valid), patch)
    np.testing.assert_array_equal(np.asarray(ok), want_ok)
    np.testing.assert_array_equal(np.asarray(desc, np.float64), want)
