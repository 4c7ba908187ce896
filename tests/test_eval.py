"""Tests for the quality-evaluation subsystem (pano.eval)."""

import numpy as np
import pytest

from pano import eval as peval


def test_ssim_identical_images_is_one(rng):
    a = rng.integers(0, 256, (64, 64), dtype=np.uint8).astype(np.float64)
    mask = np.ones((64, 64), bool)
    assert peval.masked_ssim(a, a, mask) == pytest.approx(1.0)


def test_ssim_decreases_with_noise(rng):
    a = rng.integers(0, 256, (64, 64)).astype(np.float64)
    mask = np.ones((64, 64), bool)
    b1 = a + rng.normal(0, 5, a.shape)
    b2 = a + rng.normal(0, 50, a.shape)
    s1 = peval.masked_ssim(a, b1, mask)
    s2 = peval.masked_ssim(a, b2, mask)
    assert 1.0 > s1 > s2 > 0.0


def test_ssim_mask_isolates_region(rng):
    a = rng.integers(0, 256, (64, 64)).astype(np.float64)
    b = a.copy()
    b[:, 32:] = rng.integers(0, 256, (64, 32))  # destroy right half
    left = np.zeros((64, 64), bool)
    left[:, : 32 - 8] = True  # stay clear of the filter support
    assert peval.masked_ssim(a, b, left) == pytest.approx(1.0, abs=1e-6)


def test_grade_thresholds():
    cats, overall = peval.grade(
        {
            "PSNR": 40.0,
            "SSIM": 0.95,
            "Inlier Ratio": 0.9,
            "Reprojection Error": 0.5,
            "Seam Smoothness": 5.0,
        }
    )
    assert overall == "Good"
    assert all(v == "good" for v in cats.values())

    cats, overall = peval.grade(
        {
            "PSNR": 30.0,   # acceptable
            "SSIM": 0.95,
            "Inlier Ratio": 0.9,
            "Reprojection Error": 0.5,
            "Seam Smoothness": 5.0,
        }
    )
    assert overall == "Acceptable"

    cats, overall = peval.grade(
        {
            "PSNR": 10.0,   # poor
            "SSIM": 0.95,
            "Inlier Ratio": 0.9,
            "Reprojection Error": 0.5,
            "Seam Smoothness": 5.0,
        }
    )
    assert overall == "Poor"


def test_compute_metrics_self_comparison(rng):
    """A panorama compared against itself must grade near-perfect."""
    import cv2

    img = np.zeros((200, 300, 3), np.uint8)
    img[:] = 40
    r = np.random.default_rng(0)
    for _ in range(120):
        y, x = r.integers(10, 180), r.integers(10, 280)
        cv2.circle(img, (int(x), int(y)), int(r.integers(3, 9)),
                   tuple(int(c) for c in r.integers(50, 255, 3)), -1)
    m = peval.compute_metrics(img, img)
    assert m["SSIM"] > 0.99
    assert m["PSNR"] > 50 or m["PSNR"] == float("inf")
    assert m["Reprojection Error"] < 1.0
    _, overall = peval.grade(m)
    assert overall == "Good"


def test_compute_metrics_detects_misalignment(rng):
    import cv2

    img = np.zeros((200, 300, 3), np.uint8)
    r = np.random.default_rng(1)
    for _ in range(120):
        y, x = r.integers(10, 180), r.integers(10, 280)
        cv2.circle(img, (int(x), int(y)), int(r.integers(3, 9)),
                   tuple(int(c) for c in r.integers(50, 255, 3)), -1)
    noisy = img.copy()
    noisy = (noisy.astype(np.int32) + r.integers(-60, 60, img.shape)).clip(
        0, 255
    ).astype(np.uint8)
    m = peval.compute_metrics(img, noisy)
    assert m["SSIM"] < 0.9


def test_seam_frame_caveat_pattern(capsys):
    """High inlier ratio + poor seam prints the root-frame hint; weak
    alignment does not (then poor seam is likely a real seam/misalignment)."""
    metrics = {
        "PSNR": 31.0, "SSIM": 0.95, "Inlier Ratio": 0.80,
        "Reprojection Error": 0.9, "Seam Smoothness": 56.0,
    }
    assert peval.seam_frame_caveat(metrics)
    peval.evaluate_quality(metrics)
    assert "different projective root frames" in capsys.readouterr().out

    weak = dict(metrics, **{"Inlier Ratio": 0.4})
    assert not peval.seam_frame_caveat(weak)
    good_seam = dict(metrics, **{"Seam Smoothness": 5.0})
    assert not peval.seam_frame_caveat(good_seam)
    peval.evaluate_quality(good_seam)
    assert "root frames" not in capsys.readouterr().out


def test_seam_caveat_fires_on_rerooted_panorama():
    """Integration: the SAME panorama re-rendered in a different projective
    root frame aligns near-perfectly (high inliers) but its overlap boundary
    ring cuts through content, so the seam metric reads large — exactly the
    grader blind spot the caveat flags.
    """
    import cv2

    from pano import scenes

    # A seeded scene view: ORB matches its block texture cleanly (synthetic
    # circle fields are too self-similar to clear the 0.70 inlier gate this
    # test needs).
    img = scenes.make_scene(1, 240, 320, seed=0).views[0]
    cv2.setRNGSeed(0)
    # A mild projective re-rooting (what a different MST anchor produces).
    h_reroot = np.array(
        [[0.975, 0.03, 6.0], [-0.025, 1.015, 4.5], [1.0e-4, -0.6e-4, 1.0]]
    )
    gen = cv2.warpPerspective(img, h_reroot, (320, 240))
    m = peval.compute_metrics(gen, img)
    assert m["Inlier Ratio"] >= 0.70, m          # alignment recovers fine
    assert m["Seam Smoothness"] > 30.0, m        # ring cuts through content
    assert peval.seam_frame_caveat(m)


# --- SSIM cross-validation against an independent brute-force oracle ------
# The environment has no skimage (the reference's SSIM source,
# evaluate_panorama.py:47), so pano.eval re-implements Wang et al. 2004
# with skimage's defaults. This test validates the optimized cumsum-filter
# implementation against a direct nested-loop computation of the same
# definition (7x7 uniform window, unbiased covariance, K1/K2 defaults).

def _ssim_map_bruteforce(a, b, win=7, data_range=255.0):
    a = a.astype(np.float64)
    b = b.astype(np.float64)
    k1, k2 = 0.01, 0.03
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    n = win * win
    cov_norm = n / (n - 1)
    pad = win // 2
    ap = np.pad(a, pad, mode="reflect")
    bp = np.pad(b, pad, mode="reflect")
    h, w = a.shape
    out = np.zeros((h, w))
    for i in range(h):
        for j in range(w):
            wa = ap[i : i + win, j : j + win]
            wb = bp[i : i + win, j : j + win]
            ux, uy = wa.mean(), wb.mean()
            vx = cov_norm * (np.mean(wa * wa) - ux * ux)
            vy = cov_norm * (np.mean(wb * wb) - uy * uy)
            vxy = cov_norm * (np.mean(wa * wb) - ux * uy)
            out[i, j] = ((2 * ux * uy + c1) * (2 * vxy + c2)) / (
                (ux * ux + uy * uy + c1) * (vx + vy + c2)
            )
    return out


def test_ssim_map_matches_bruteforce_oracle(rng):
    a = rng.integers(0, 256, (40, 48)).astype(np.float64)
    b = np.clip(a + rng.normal(0, 12, a.shape), 0, 255)
    fast = peval.ssim_map(a, b)
    slow = _ssim_map_bruteforce(a, b)
    # Interior (the valid region masked_ssim actually uses).
    np.testing.assert_allclose(fast[3:-3, 3:-3], slow[3:-3, 3:-3],
                               rtol=1e-10, atol=1e-12)


def test_masked_ssim_matches_bruteforce_mean(rng):
    a = rng.integers(0, 256, (32, 32)).astype(np.float64)
    b = np.clip(a + rng.normal(0, 20, a.shape), 0, 255)
    mask = np.zeros((32, 32), bool)
    mask[8:28, 5:30] = True
    got = peval.masked_ssim(a, b, mask)
    smap = _ssim_map_bruteforce(a, b)
    m = mask.copy()
    m[:3] = m[-3:] = False
    m[:, :3] = m[:, -3:] = False
    np.testing.assert_allclose(got, smap[m].mean(), rtol=1e-10)
