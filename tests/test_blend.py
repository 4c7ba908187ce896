"""Tests for multi-band (Laplacian pyramid) blending (ops/blend.py)."""

import numpy as np
import jax.numpy as jnp

from pano.ops import blend, warp


def test_pyramid_roundtrip(rng):
    x = rng.random((1, 64, 128)).astype(np.float32) * 255
    lp = blend.laplacian_pyramid(jnp.asarray(x), 4)
    # Collapse must reconstruct the input exactly (linear operations).
    out = lp[-1]
    for i in reversed(range(3)):
        h, w = lp[i].shape[-2], lp[i].shape[-1]
        out = blend._up(out, h, w) + lp[i]
    np.testing.assert_allclose(np.asarray(out), x, atol=1e-2)


def test_blend_identity_regions(rng):
    """Away from the seam, the blend reproduces each source."""
    h, w = 64, 256
    a = np.full((h, w, 3), 50.0, np.float32)
    b = np.full((h, w, 3), 200.0, np.float32)
    mask = np.zeros((h, w), np.float32)
    mask[:, w // 2 :] = 1.0
    out = np.asarray(
        blend.laplacian_blend(jnp.asarray(a), jnp.asarray(b), jnp.asarray(mask))
    )
    assert np.abs(out[:, :40] - 50.0).max() < 1.5
    assert np.abs(out[:, -40:] - 200.0).max() < 1.5
    # Transition is monotone and smooth across the seam.
    mid = out[32, :, 0]
    assert np.all(np.diff(mid) >= -1.0)
    assert mid[w // 2 - 1] > 55 and mid[w // 2] < 195  # actually blended


def test_blend_preserves_texture(rng):
    """High-frequency content away from the seam survives unchanged."""
    h, w = 64, 256
    a = rng.integers(0, 256, (h, w, 3)).astype(np.float32)
    b = rng.integers(0, 256, (h, w, 3)).astype(np.float32)
    mask = np.zeros((h, w), np.float32)
    mask[:, w // 2 :] = 1.0
    out = np.asarray(
        blend.laplacian_blend(jnp.asarray(a), jnp.asarray(b), jnp.asarray(mask))
    )
    np.testing.assert_allclose(out[:, :32], a[:, :32], atol=4.0)
    np.testing.assert_allclose(out[:, -32:], b[:, -32:], atol=4.0)


def test_multiband_compose_seamless(rng):
    """Full composite path: shifted copies of the same scene blend into the
    scene with no visible seam step."""
    h, w = 128, 256
    base = rng.integers(0, 60, (h, w, 3)).astype(np.float32)
    base[:, :, :] += 100.0
    left_f = base.copy()
    right_f = base.copy()
    w_left = np.zeros((h, w), np.float32)
    w_left[:, : w * 3 // 4] = np.linspace(1, 0.1, w * 3 // 4)[None, :]
    w_right = np.zeros((h, w), np.float32)
    w_right[:, w // 4 :] = np.linspace(0.1, 1, w - w // 4)[None, :]
    out = np.asarray(
        warp._multiband_compose(
            jnp.asarray(left_f),
            jnp.asarray(right_f),
            jnp.asarray(w_left),
            jnp.asarray(w_right),
        )
    ).astype(np.float32)
    # Identical sources -> output equals the source everywhere it's covered.
    np.testing.assert_allclose(out, base, atol=2.0)


# --- exposure (gain) compensation -----------------------------------------

def test_gain_compensation_restores_exposure():
    """Right image brightened 1.3x: with --gain the right-only region of the
    panorama is pulled back to the left image's exposure; without it the
    brightness step survives (the reference pipeline's behavior)."""
    import dataclasses

    from pano.config import DEFAULT_CONFIG
    from pano.pipeline import PairStitcher

    r = np.random.default_rng(3)
    base = r.integers(40, 140, (96, 224, 3)).astype(np.uint8)
    left = base[:, :128].copy()
    right = np.clip(base[:, 96:].astype(np.float32) * 1.3, 0, 255).astype(
        np.uint8
    )
    # Known homography: right content starts at left x=96 -> pure translation.
    h = np.array([[1.0, 0.0, 96.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]])

    def run(gain):
        cfg = DEFAULT_CONFIG.replace(
            stitch=dataclasses.replace(
                DEFAULT_CONFIG.stitch, blend="feather",
                gain_compensation=gain,
            )
        )
        st = PairStitcher(cfg, print_timing=False)
        return np.asarray(
            st.composite(jnp.asarray(left), jnp.asarray(right), h)
        )

    pano_off = run(False)
    pano_on = run(True)
    # Right-only region: canvas x in [130, 220).
    target = base[:, 130:220].mean()
    off_err = abs(pano_off[:, 130:220].mean() - target)
    on_err = abs(pano_on[:, 130:220].mean() - target)
    assert off_err > 15.0, off_err     # uncompensated step is visible
    assert on_err < 6.0, on_err        # compensated matches left exposure
    assert on_err < off_err / 3
