"""Unit tests: RANSAC homography estimation (src/serial/main.cpp:247-307,
src/gpu/ransac.cu oracle semantics) on synthetic correspondences."""

import numpy as np
import jax
import jax.numpy as jnp

from pano.config import RansacOptions
from pano.ops import ransac


def apply_h(h, pts):
    p = np.concatenate([pts, np.ones((len(pts), 1))], axis=1) @ h.T
    return p[:, :2] / p[:, 2:3]


def make_problem(n=256, outlier_frac=0.3, noise=0.0, seed=0, cap=512):
    r = np.random.default_rng(seed)
    h_true = np.array(
        [[1.05, 0.02, 30.0], [-0.01, 0.98, -12.0], [1e-5, -2e-5, 1.0]]
    )
    src = r.uniform(50, 950, (n, 2))
    dst = apply_h(h_true, src) + r.normal(0, noise, (n, 2))
    n_out = int(n * outlier_frac)
    dst[:n_out] += r.uniform(50, 400, (n_out, 2))  # gross outliers
    perm = r.permutation(n)
    src, dst = src[perm], dst[perm]

    src_p = np.zeros((cap, 2), np.float32)
    dst_p = np.zeros((cap, 2), np.float32)
    src_p[:n] = src
    dst_p[:n] = dst
    valid = np.zeros(cap, bool)
    valid[:n] = True
    return h_true, jnp.asarray(src_p), jnp.asarray(dst_p), jnp.asarray(valid)


def test_exact_4pt_homography():
    h_true = np.array([[1.2, 0.1, 5.0], [0.05, 0.9, -3.0], [1e-4, 2e-4, 1.0]])
    src = np.array([[0.0, 0.0], [100.0, 10.0], [90.0, 120.0], [5.0, 95.0]])
    dst = apply_h(h_true, src)
    h = np.asarray(
        ransac.homography_from_4pts(
            jnp.asarray(src, jnp.float32), jnp.asarray(dst, jnp.float32)
        )
    )
    np.testing.assert_allclose(h, h_true / h_true[2, 2], rtol=2e-3, atol=2e-3)


def test_degenerate_sample_yields_nonfinite():
    src = np.array([[1.0, 1.0]] * 4, np.float32)  # all identical
    dst = np.array([[2.0, 2.0]] * 4, np.float32)
    h = np.asarray(
        ransac.homography_from_4pts(jnp.asarray(src), jnp.asarray(dst))
    )
    assert not np.isfinite(h).all()


def test_project_points_matches_numpy():
    h = np.array([[1.1, 0.0, 3.0], [0.2, 0.9, -1.0], [1e-4, 0.0, 1.0]])
    pts = np.array([[10.0, 20.0], [5.0, 5.0]], np.float32)
    got = np.asarray(
        ransac.project_points(jnp.asarray(h, jnp.float32), jnp.asarray(pts))
    )
    np.testing.assert_allclose(got, apply_h(h, pts), rtol=1e-5)


def test_ransac_recovers_h_with_outliers():
    h_true, src, dst, valid = make_problem(outlier_frac=0.3)
    res = ransac.ransac_homography(src, dst, valid, RansacOptions())
    assert bool(res.ok)
    # ~70% of 256 matches are clean inliers.
    assert int(res.inlier_count) > 150
    h = np.asarray(res.H, np.float64)
    # Compare action on points, not matrix entries.
    test_pts = np.array([[100.0, 100.0], [800.0, 200.0], [400.0, 900.0]])
    np.testing.assert_allclose(
        apply_h(h, test_pts), apply_h(h_true, test_pts), atol=1.0
    )


def test_ransac_with_noise_and_refinement():
    h_true, src, dst, valid = make_problem(outlier_frac=0.2, noise=0.5, seed=3)
    res_ref = ransac.ransac_homography(
        src, dst, valid, RansacOptions(refine=True)
    )
    res_raw = ransac.ransac_homography(
        src, dst, valid, RansacOptions(refine=False)
    )
    assert bool(res_ref.ok) and bool(res_raw.ok)
    # Refinement should not lose inliers (it keeps the better model).
    assert int(res_ref.inlier_count) >= int(res_raw.inlier_count)


def test_ransac_deterministic_across_runs():
    _, src, dst, valid = make_problem(seed=7)
    r1 = ransac.ransac_homography(src, dst, valid, RansacOptions(seed=42))
    r2 = ransac.ransac_homography(src, dst, valid, RansacOptions(seed=42))
    np.testing.assert_array_equal(np.asarray(r1.H), np.asarray(r2.H))


def test_ransac_too_few_matches_not_ok():
    cap = 64
    src = jnp.zeros((cap, 2), jnp.float32)
    dst = jnp.zeros((cap, 2), jnp.float32)
    valid = jnp.zeros((cap,), bool).at[:3].set(True)  # < num_samples
    res = ransac.ransac_homography(src, dst, valid, RansacOptions())
    assert not bool(res.ok)
    np.testing.assert_array_equal(np.asarray(res.H), np.eye(3, dtype=np.float32))


def test_refine_homography_masked():
    h_true = np.array([[1.0, 0.05, 10.0], [0.0, 1.1, -5.0], [0.0, 1e-4, 1.0]])
    r = np.random.default_rng(0)
    src = r.uniform(0, 500, (128, 2))
    dst = apply_h(h_true, src)
    mask = np.ones(128, bool)
    mask[::4] = False
    dst[~mask] += 300.0  # corrupt masked-out rows; must not affect the fit
    h = np.asarray(
        ransac.refine_homography(
            jnp.asarray(src, jnp.float32),
            jnp.asarray(dst, jnp.float32),
            jnp.asarray(mask),
        ),
        np.float64,
    )
    pts = np.array([[50.0, 50.0], [400.0, 100.0]])
    np.testing.assert_allclose(apply_h(h, pts), apply_h(h_true, pts), atol=0.5)
