"""Seeded scenes (pano.scenes): determinism, the true geometry they carry,
and recovery of that geometry by the pipeline."""

import os

import numpy as np
import pytest

from pano import scenes
from pano.io import imread_bgr


def test_same_seed_same_scene():
    a = scenes.make_scene(2, 48, 64, seed=3)
    b = scenes.make_scene(2, 48, 64, seed=3)
    for va, vb in zip(a.views, b.views):
        np.testing.assert_array_equal(va, vb)
    for ha, hb in zip(a.homs, b.homs):
        np.testing.assert_array_equal(ha, hb)
    np.testing.assert_array_equal(a.world, b.world)


def test_other_seed_other_scene():
    a = scenes.make_scene(2, 48, 64, seed=3)
    b = scenes.make_scene(2, 48, 64, seed=4)
    assert not np.array_equal(a.views[0], b.views[0])
    assert not np.allclose(a.homs[1], b.homs[1])


def test_views_overlap_left_to_right():
    sc = scenes.make_scene(3, 60, 80, seed=0)
    assert [v.shape for v in sc.views] == [(60, 80, 3)] * 3
    for i in range(2):
        h = scenes.pair_homography(sc, i, i + 1)
        # View i+1's left edge lands inside view i, about 0.55 w to the right.
        x = h @ np.array([0.0, 30.0, 1.0])
        assert 0.4 * 80 < x[0] / x[2] < 0.7 * 80
    np.testing.assert_allclose(scenes.pair_homography(sc, 1, 1), np.eye(3),
                               atol=1e-12)


def test_pair_homography_agrees_with_the_renders():
    """A view-j pixel mapped through the true H shows the same world point
    in view i: the rendered colors agree wherever both are interior."""
    sc = scenes.make_scene(2, 96, 128, seed=2)
    h = scenes.pair_homography(sc, 0, 1)
    ys, xs = np.mgrid[10:86:7, 10:118:7]
    pts = np.stack([xs.ravel(), ys.ravel(), np.ones(xs.size)]).astype(float)
    q = h @ pts
    qx, qy = q[0] / q[2], q[1] / q[2]
    inside = (qx > 2) & (qx < 125) & (qy > 2) & (qy < 93)
    assert inside.sum() > 30
    got, _ = scenes.bilinear_sample(sc.views[0], qx[inside], qy[inside])
    want = sc.views[1][ys.ravel()[inside], xs.ravel()[inside]]
    # Two bilinear resamplings of a blurred texture: small differences.
    assert np.abs(got - want).mean() < 6.0


def test_render_identity_crop_is_exact():
    sc = scenes.make_scene(1, 20, 30, seed=5)
    assert sc.world.shape[:2] == (24, 34)   # a 2 px margin around the view
    shift = np.array([[1.0, 0.0, 3.0], [0.0, 1.0, 1.0], [0.0, 0.0, 1.0]])
    np.testing.assert_array_equal(
        scenes.render(sc.world, shift, 20, 30, rows=8),
        sc.world[1:21, 3:33],
    )


def test_corner_error_and_psnr():
    h = np.eye(3)
    assert scenes.corner_error(h, h, 100, 200) == 0.0
    t = np.array([[1.0, 0.0, 3.0], [0.0, 1.0, 4.0], [0.0, 0.0, 1.0]])
    assert scenes.corner_error(t, h, 100, 200) == pytest.approx(5.0)
    a = np.full((4, 4, 3), 100, np.uint8)
    assert scenes.psnr(a, a) == float("inf")
    b = a + 1
    assert scenes.psnr(a, b) == pytest.approx(20 * np.log10(255.0))
    mask = np.zeros((4, 4), bool)
    mask[0, 0] = True
    b[1:] = 0
    assert scenes.psnr(a, b, mask) == pytest.approx(20 * np.log10(255.0))


def test_footprint_erodes_the_border():
    shift = np.array([[1.0, 0.0, 5.0], [0.0, 1.0, 3.0], [0.0, 0.0, 1.0]])
    fp = scenes.footprint(shift, 10, 20, 20, 40, erode=2)
    ys, xs = np.nonzero(fp)
    assert (ys.min(), ys.max(), xs.min(), xs.max()) == (5, 10, 7, 22)
    assert scenes.footprint(shift, 10, 20, 20, 40, erode=0).sum() == 200


def test_write_views_and_main(tmp_path):
    sc = scenes.make_scene(2, 24, 32, seed=0)
    paths = scenes.write_views(sc, str(tmp_path / "v"))
    assert [os.path.basename(p) for p in paths] == ["view_00.png",
                                                    "view_01.png"]
    np.testing.assert_array_equal(imread_bgr(paths[1]), sc.views[1])
    assert scenes.main(["--out", str(tmp_path / "m"), "--views", "3",
                        "--height", "24", "--width", "32"]) == 0
    assert sorted(os.listdir(tmp_path / "m")) == [
        "view_00.png", "view_01.png", "view_02.png"]


@pytest.mark.parametrize("seed", [1, 3])
def test_pipeline_recovers_the_known_homography(seed):
    """The fused estimate on a seeded 512x384 pair lands within the
    evaluator's 1 px corner gate of the true homography."""
    from pano.config import DEFAULT_CONFIG
    from pano.pipeline import get_pair_stitcher

    sc = scenes.make_scene(2, 384, 512, seed)
    stitcher = get_pair_stitcher(DEFAULT_CONFIG, False, "")
    h_est = stitcher.estimate_homography(sc.views[0], sc.views[1])
    assert h_est is not None
    err = scenes.corner_error(h_est, scenes.pair_homography(sc, 0, 1),
                              384, 512)
    assert err <= 1.0, err
