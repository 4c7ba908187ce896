"""Unit tests: projective warp + compositing vs OpenCV's warpPerspective
(the reference's compositing backend, src/serial/main.cpp:371-386)."""

import numpy as np
import jax.numpy as jnp
import cv2
import pytest

from pano.ops import warp


def test_identity_warp_roundtrips(rng):
    img = rng.integers(0, 256, (40, 56, 3), dtype=np.uint8)
    out = np.asarray(
        warp.warp_perspective_u8(
            jnp.asarray(img), jnp.eye(3, dtype=jnp.float32), 40, 56
        )
    )
    np.testing.assert_array_equal(out, img)


def test_translation_warp_matches_cv2(rng):
    img = rng.integers(0, 256, (40, 56, 3), dtype=np.uint8)
    m = np.array([[1.0, 0.0, 10.0], [0.0, 1.0, 6.0], [0.0, 0.0, 1.0]])
    want = cv2.warpPerspective(img, m, (80, 60))
    got = np.asarray(
        warp.warp_perspective_u8(
            jnp.asarray(img),
            jnp.asarray(np.linalg.inv(m), jnp.float32),
            60,
            80,
        )
    )
    np.testing.assert_array_equal(got, want)


def test_projective_warp_close_to_cv2(rng):
    img = rng.integers(0, 256, (64, 64, 3), dtype=np.uint8)
    m = np.array(
        [[1.05, 0.08, 4.0], [-0.03, 0.97, 2.0], [2e-4, -1e-4, 1.0]]
    )
    want = cv2.warpPerspective(img, m, (96, 96)).astype(np.int32)
    got = np.asarray(
        warp.warp_perspective_u8(
            jnp.asarray(img),
            jnp.asarray(np.linalg.inv(m), jnp.float32),
            96,
            96,
        )
    ).astype(np.int32)
    # cv2 uses 5-bit fixed-point bilinear; tolerate small per-pixel deltas on
    # a tiny fraction of pixels (coordinate rounding at texel boundaries).
    diff = np.abs(got - want).max(axis=-1)
    assert (diff > 8).mean() < 0.02, diff.mean()


def test_canvas_geometry_matches_reference_math():
    h = np.array([[1.0, 0.0, -30.0], [0.0, 1.0, 5.0], [0.0, 0.0, 1.0]])
    (ch, cw), t, (mnx, mny) = warp.compute_canvas_geometry(h, (100, 120), (100, 120))
    # Right image shifts left 30 and down 5: canvas extends 30 left, 5 down.
    assert (mnx, mny) == (-30.0, 0.0)
    assert cw == 150 and ch == 105
    np.testing.assert_array_equal(t[:2, 2], [30.0, -0.0])


def test_overlay_blend_semantics(rng):
    left = np.full((20, 20, 3), 100, np.uint8)
    right = np.full((20, 20, 3), 200, np.uint8)
    # H = shift right image by +10 px in x (right occupies x in [10, 30)).
    h = np.array([[1.0, 0.0, 10.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]])
    (ch, cw), t, (mnx, mny) = warp.compute_canvas_geometry(h, (20, 20), (20, 20))
    assert (ch, cw) == (20, 30)
    m_inv = np.linalg.inv(t @ h)
    out = np.asarray(
        warp.warp_and_blend(
            jnp.asarray(left),
            jnp.asarray(right),
            jnp.asarray(m_inv, jnp.float32),
            jnp.asarray(int(-mnx), jnp.int32),
            jnp.asarray(int(-mny), jnp.int32),
            ch,
            cw,
            "overlay",
        )
    )
    # Warped right is non-black and overwrites the overlap region.
    assert np.all(out[:, :10] == 100)     # left only
    assert np.all(out[:, 10:30] == 200)   # right overlays overlap + extension


def test_feather_blend_smooth_overlap(rng):
    left = np.full((20, 20, 3), 100, np.uint8)
    right = np.full((20, 20, 3), 200, np.uint8)
    h = np.array([[1.0, 0.0, 10.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]])
    (ch, cw), t, (mnx, mny) = warp.compute_canvas_geometry(h, (20, 20), (20, 20))
    m_inv = np.linalg.inv(t @ h)
    out = np.asarray(
        warp.warp_and_blend(
            jnp.asarray(left),
            jnp.asarray(right),
            jnp.asarray(m_inv, jnp.float32),
            jnp.asarray(0, jnp.int32),
            jnp.asarray(0, jnp.int32),
            ch,
            cw,
            "feather",
        )
    )
    # Non-overlap regions keep their source values.
    assert np.all(out[5:15, :9] == 100)
    assert np.all(out[5:15, 21:29] == 200)
    # Overlap is a mixture strictly between the two.
    mid = out[10, 12:18, 0].astype(np.int32)
    assert np.all(mid > 100) and np.all(mid < 200)


def test_warp_window_geometry_bucket():
    """The window is the warped bbox (+2 px margin) rounded up to the
    canvas bucket in each axis, and the clamp keeps it inside the padded
    canvas."""
    from pano.ops.warp import warp_window_geometry

    m = np.eye(3)
    m[0, 2], m[1, 2] = 40.0, 20.0
    wx0, wy0, win_w, win_h = warp_window_geometry(
        m, 300, 400, pad_h=640, pad_w=1024, bucket=128
    )
    assert win_w % 128 == 0 and win_h % 128 == 0
    assert 0 <= wx0 <= 1024 - win_w and 0 <= wy0 <= 640 - win_h
    # The window still covers the warped bbox (+2 px margin).
    assert wx0 <= 38 and wx0 + win_w >= 442
    assert wy0 <= 18 and wy0 + win_h >= 322
    # A full-canvas span clamps to pad_w.
    wx0, _, win_w, _ = warp_window_geometry(
        m, 300, 1000, pad_h=640, pad_w=1024, bucket=128
    )
    assert win_w == 1024 and wx0 == 0


def test_global_canvas_geometry_bucket():
    from pano.pipeline import global_canvas_geometry

    imgs = [np.zeros((100, 150, 3), np.uint8)] * 2
    h = np.eye(3)
    h[0, 2] = 120.0
    t, ch, cw, ph, pw = global_canvas_geometry(
        imgs, [np.eye(3), h], anchor=0, bucket=128
    )
    assert cw == 270 and pw == 384 and ch == 100 and ph == 128
    np.testing.assert_array_equal(t, np.eye(3))


# Inverse maps for the oracle comparisons: identity, a fractional shift,
# a rotation with scale, and a strong perspective.
_ORACLE_MAPS = {
    "identity": np.eye(3),
    "fractional": np.array([[1.0, 0.0, -3.25], [0.0, 1.0, 1.75],
                            [0.0, 0.0, 1.0]]),
    "rotation": np.array([[0.9, -0.25, 6.0], [0.25, 0.9, -8.0],
                          [0.0, 0.0, 1.0]]),
    "projective": np.array([[1.1, 0.05, -2.0], [-0.04, 0.95, 3.0],
                            [1.5e-3, -1e-3, 1.0]]),
}


@pytest.mark.parametrize("name", sorted(_ORACLE_MAPS))
def test_warp_matches_float64_oracle(rng, name):
    """warp_perspective_u8 against the float64 bilinear oracle
    (pano.oracles.warp_u8): f32 coordinates move a sample by ~1e-5 px,
    which can flip one rounding, so the bound is 1 per u8 channel."""
    from pano import oracles

    img = rng.integers(0, 256, (48, 64, 3), dtype=np.uint8)
    m_inv = _ORACLE_MAPS[name]
    got = np.asarray(warp.warp_perspective_u8(
        jnp.asarray(img), jnp.asarray(m_inv, jnp.float32), 56, 72))
    want = oracles.warp_u8(img, m_inv, 56, 72)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


@pytest.mark.parametrize("blend", ["overlay", "feather"])
@pytest.mark.parametrize("name", ["fractional", "projective"])
def test_warp_and_blend_window_matches_oracle(rng, name, blend):
    """The fused warp+blend restricted to a warp window equals the
    full-canvas compose oracle (pano.oracles.compose): outside the window
    the canvas is the placed left image."""
    from pano import oracles

    left = rng.integers(1, 256, (40, 48, 3), dtype=np.uint8)
    right = rng.integers(1, 256, (40, 48, 3), dtype=np.uint8)
    shift = np.array([[1.0, 0.0, 30.0], [0.0, 1.0, 4.0], [0.0, 0.0, 1.0]])
    m = shift @ np.linalg.inv(_ORACLE_MAPS[name])
    out_h, out_w, tx, ty = 64, 96, 2, 3
    wx0, wy0, win_w, win_h = warp.warp_window_geometry(
        m, 40, 48, out_h, out_w, 16)
    got = np.asarray(warp.warp_and_blend(
        jnp.asarray(left), jnp.asarray(right),
        jnp.asarray(np.linalg.inv(m), jnp.float32),
        jnp.asarray(tx, jnp.int32), jnp.asarray(ty, jnp.int32),
        out_h, out_w, blend,
        win_x=jnp.asarray(wx0, jnp.int32), win_y=jnp.asarray(wy0, jnp.int32),
        win_h=win_h, win_w=win_w,
    ))
    want = oracles.compose(left, right, np.linalg.inv(m), tx, ty, out_h,
                           out_w, blend)
    d = np.abs(got.astype(int) - want.astype(int)).max(-1)
    assert (d > 1).mean() < 5e-3, (d.max(), (d > 1).mean())
