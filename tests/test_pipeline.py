"""Integration tests: full pair stitch on synthetic pairs with known
ground-truth homography (stitchTwoImages/stitchAllImages semantics,
src/serial/main.cpp:311-414)."""

import numpy as np
import jax.numpy as jnp
import pytest

from pano.config import DEFAULT_CONFIG, HarrisOptions, PanoConfig, RansacOptions
from pano import pipeline
from pano.pipeline import PairStitcher, stitch_all_images

SMALL = PanoConfig(
    harris=HarrisOptions(max_keypoints=512),
    ransac=RansacOptions(num_iterations=500),
)


def checkerboard_texture(h, w, seed=0):
    """Dense structured texture with strong corners on a noisy background.

    Density matters: re-detected panoramas are bilinear-resampled, and a
    sparse texture on a flat background leaves too few unambiguous patches
    for the second fold step (mirrors why the reference works best on
    feature-rich photographs)."""
    r = np.random.default_rng(seed)
    img = r.integers(0, 60, (h, w, 3)).astype(np.uint8)
    for _ in range(max(60, h * w // 150)):
        y, x = r.integers(2, h - 10), r.integers(2, w - 10)
        img[y : y + 6, x : x + 6] = r.integers(60, 255, 3)
    return img


def translated_pair(h=128, w=160, shift=48, seed=0):
    base = checkerboard_texture(h, w + shift, seed)
    return base[:, shift:].copy(), base[:, :w].copy()  # (left, right)


def test_estimate_homography_translation():
    # right image content appears `shift` px to the right in left frame:
    # H(right->left) should be x -> x + shift... construct carefully:
    # left = base[:, shift:], right = base[:, :w]. Pixel (x, y) in right
    # equals base(x, y); in left it is at x - shift. So H maps x -> x - shift.
    left, right = translated_pair()
    stitcher = PairStitcher(SMALL, print_timing=False)
    h = stitcher.estimate_homography(
        jnp.asarray(left), jnp.asarray(right)
    )
    assert h is not None
    h = h / h[2, 2]
    np.testing.assert_allclose(h[0, 2], -48.0, atol=1.0)
    np.testing.assert_allclose(
        h[:2, :2], np.eye(2), atol=0.02
    )
    np.testing.assert_allclose(h[1, 2], 0.0, atol=1.0)


def test_stitch_pair_produces_panorama():
    left, right = translated_pair()
    stitcher = PairStitcher(SMALL, print_timing=False)
    pano = stitcher.stitch_pair(jnp.asarray(left), jnp.asarray(right))
    assert pano is not None
    pano = np.asarray(pano)
    # Canvas must be wider than either input but no wider than the union
    # (+/- a pixel of estimation slack in the warped corner bounds).
    assert 128 <= pano.shape[0] <= 131
    assert 160 < pano.shape[1] <= 160 + 48 + 3
    # The panorama must reproduce the underlying base texture. The overlay
    # canvas has two differently-aligned regions (the reference-inherited 1px
    # truncation quirk: exact -minX in the warp translation vs int-truncated
    # ROI placement, src/serial/main.cpp:366-376), so check them separately.
    base = checkerboard_texture(128, 160 + 48, seed=0)  # == translated_pair base
    # 1) Warped-right-covered region (canvas x < ~155): aligned with base.
    bad_right = (
        np.abs(
            pano[:128, :150].astype(int) - base[:128, :150].astype(int)
        ).max(axis=-1)
        > 30
    ).mean()
    assert bad_right < 0.05, bad_right
    # 2) Left-only region (canvas x > 160): the left image verbatim at an
    # integer offset near (0, 48).
    best_left = min(
        (
            pano[ty : ty + 128, tx + 120 : tx + 160].astype(int)
            != left[:, 120:160].astype(int)
        ).any(axis=-1).mean()
        for ty in (0, 1)
        for tx in (46, 47, 48, 49)
        if pano.shape[0] >= ty + 128 and pano.shape[1] >= tx + 160
    )
    assert best_left < 0.05, best_left


def test_stitch_all_left_fold_three_images():
    # 50% overlaps: comfortably above the minimal-overlap regime where
    # borderline f32 Harris ties can flip the keypoint set (the acceptance
    # gate for real images is statistical; this is a structural test).
    base = checkerboard_texture(128, 280, seed=2)
    imgs = [
        base[:, 0:140].copy(),
        base[:, 70:210].copy(),
        base[:, 140:280].copy(),
    ]
    pano = stitch_all_images(imgs, SMALL, print_timing=False)
    assert pano is not None
    assert pano.shape[0] >= 128
    assert pano.shape[1] >= 270  # covers nearly the full base width


def test_stitch_all_chain_mode():
    base = checkerboard_texture(128, 280, seed=2)
    imgs = [
        base[:, 0:140].copy(),
        base[:, 70:210].copy(),
        base[:, 140:280].copy(),
    ]
    pano = stitch_all_images(imgs, SMALL, print_timing=False, mode="chain")
    assert pano is not None
    assert pano.shape[0] >= 128
    assert pano.shape[1] >= 270
    # Chain composites against originals: the panorama should closely match.
    hmin = min(pano.shape[0], 128)
    d = np.abs(
        pano[:hmin, :270].astype(int) - base[:hmin, :270].astype(int)
    ).max(-1)
    assert (d > 30).mean() < 0.08, (d > 30).mean()


def test_stitch_all_chain_skips_failed_image():
    base = checkerboard_texture(128, 220, seed=3)
    flat = np.zeros((128, 140, 3), np.uint8)
    imgs = [base[:, 0:140].copy(), flat, base[:, 80:220].copy()]
    pano = stitch_all_images(imgs, SMALL, print_timing=False, mode="chain")
    # Failed middle image is skipped; image 3 re-anchors against image 1.
    assert pano is not None
    assert pano.shape[1] >= 210


def test_stitch_all_auto_mode_unordered():
    """Auto mode must recover the panorama from SHUFFLED input order."""
    base = checkerboard_texture(128, 280, seed=4)
    imgs = [
        base[:, 140:280].copy(),   # rightmost first
        base[:, 0:140].copy(),     # leftmost second
        base[:, 70:210].copy(),    # middle last
    ]
    pano = stitch_all_images(imgs, SMALL, print_timing=False, mode="auto")
    assert pano is not None
    assert pano.shape[1] >= 270
    hmin = min(pano.shape[0], 128)
    d = np.abs(
        pano[:hmin, :270].astype(int) - base[:hmin, :270].astype(int)
    ).max(-1)
    assert (d > 30).mean() < 0.08, (d > 30).mean()


def test_auto_mode_graphs_memoized_across_calls():
    """A second auto job with the same config must re-trace NOTHING: the
    detect/pair graphs are config-memoized at module level, not rebuilt
    inside stitch_all_images_auto on every call."""
    base = checkerboard_texture(128, 280, seed=4)
    imgs = [
        base[:, 140:280].copy(),
        base[:, 0:140].copy(),
        base[:, 70:210].copy(),
    ]
    p1 = stitch_all_images(imgs, SMALL, print_timing=False, mode="auto")
    assert p1 is not None
    detect_fn, pair_fn = pipeline.get_auto_graphs(SMALL)
    sizes = (detect_fn._cache_size(), pair_fn._cache_size())
    assert sizes[0] >= 1 and sizes[1] >= 1  # first job populated the caches
    hits0 = pipeline.get_auto_graphs.cache_info().hits
    p2 = stitch_all_images(imgs, SMALL, print_timing=False, mode="auto")
    assert p2 is not None
    assert pipeline.get_auto_graphs.cache_info().hits > hits0
    assert (detect_fn._cache_size(), pair_fn._cache_size()) == sizes
    np.testing.assert_array_equal(p1, p2)


def test_stitch_all_auto_disconnected_image_excluded():
    base = checkerboard_texture(128, 220, seed=6)
    unrelated = checkerboard_texture(128, 140, seed=99)
    imgs = [base[:, 0:140].copy(), base[:, 80:220].copy(), unrelated]
    pano = stitch_all_images(imgs, SMALL, print_timing=False, mode="auto")
    assert pano is not None
    # The unrelated image must not blow up the canvas.
    assert pano.shape[1] <= 260


def test_stitch_all_skips_failed_pair():
    base = checkerboard_texture(128, 220, seed=3)
    flat = np.zeros((128, 140, 3), np.uint8)  # featureless -> no matches
    imgs = [base[:, 0:140].copy(), flat, base[:, 80:220].copy()]
    pano = stitch_all_images(imgs, SMALL, print_timing=False)
    # Fold must survive the bad middle image (src/serial/main.cpp:404-407).
    assert pano is not None


def _fused(stitcher, left, right, tier=0):
    """Fused estimate + one compose tier -> (packed row, cropped canvas)."""
    est, _ = stitcher._fused_estimate(jnp.asarray(left), jnp.asarray(right))
    packed_out, canvas = stitcher._fused_compose(tier)(
        jnp.asarray(left), jnp.asarray(right), est
    )
    v = np.asarray(packed_out)
    return v, np.asarray(canvas[: int(v[14]), : int(v[15])])


def test_fused_stitch_matches_staged():
    """The single-dispatch fused stitch (device-side canvas math + the XLA
    warp) must reproduce the staged composite for the same estimate."""
    left, right = translated_pair()
    stitcher = PairStitcher(SMALL, print_timing=False)
    v, fused = _fused(stitcher, left, right)
    assert v[11] > 0.5, "RANSAC ok flag"
    assert v[16] > 0.5, "coverage/canvas flag"
    h = v[:9].reshape(3, 3).astype(np.float64)
    staged = np.asarray(
        stitcher.composite(jnp.asarray(left), jnp.asarray(right), h)
    )
    assert fused.shape == staged.shape, (fused.shape, staged.shape)
    d = np.abs(fused.astype(int) - staged.astype(int)).max(-1)
    # f32 in-graph geometry vs f64 host geometry: +-1 rounding only.
    assert (d > 1).mean() < 1e-3, (d.max(), (d > 1).mean())


def test_fused_multiband_keeps_true_black_content():
    """Multiband output can legitimately be exact (0,0,0) inside covered
    area (genuinely dark content); the fused composite must keep it rather
    than show the base (left) canvas through. The staged path is the
    oracle: where it renders black, fused must too."""
    import dataclasses

    left, right = translated_pair()
    right = right.copy()
    # True-black content ONLY in the right image, placed where the right
    # image is the deeper feather side of the overlap (left-frame x =
    # 8..32, near the left image's own edge) so the multiband seam mask
    # prefers it: the blend there is black while the left pixels
    # underneath are bright.
    right[40:80, 56:80] = 0
    cfg_mb = dataclasses.replace(
        SMALL,
        stitch=dataclasses.replace(SMALL.stitch, blend="multiband"),
    )
    stitcher = PairStitcher(cfg_mb, print_timing=False)
    v, fused = _fused(stitcher, left, right)
    assert v[11] > 0.5 and v[16] > 0.5, v[[11, 16]]
    h = v[:9].reshape(3, 3).astype(np.float64)
    staged = np.asarray(
        stitcher.composite(jnp.asarray(left), jnp.asarray(right), h)
    )
    assert fused.shape == staged.shape

    mask = np.zeros(staged.shape[:2], bool)
    mask[42:78, 58:78] = True
    mask &= staged.max(-1) <= 1
    assert mask.sum() > 200, mask.sum()  # the scenario actually happened
    assert fused[mask].max() <= 10, (
        f"pinholes: {(fused[mask].max(-1) > 10).sum()} px show through, "
        f"max {fused[mask].max()}"
    )
    # Multiband pyramids see a different window extent on the two paths.
    d = np.abs(fused.astype(int) - staged.astype(int)).max(-1)
    assert (d > 10).mean() < 0.02, (d.max(), (d > 10).mean())


@pytest.mark.parametrize("tier", [0, 1])
def test_fused_stitch_flags_envelope_violation(tier):
    """A 30-degree rotation of the right view under a known homography:
    the warp has no slope limit, so `safe` depends only on the window and
    canvas fit. When a tier reports safe, its panorama must equal the
    staged composite; either way stitch_pair_fast returns a panorama."""
    import cv2

    left, right = translated_pair()
    rot = np.vstack([cv2.getRotationMatrix2D((80, 64), 30, 1.0),
                     [0.0, 0.0, 1.0]])
    right_rot = cv2.warpAffine(right, rot[:2], (160, 128))
    h = np.eye(3)
    h[0, 2] = -48.0
    h = h @ np.linalg.inv(rot)       # right_rot -> left

    stitcher = PairStitcher(SMALL, print_timing=False)
    v = _run_fused_row(stitcher, left, right_rot, h, tier)
    staged = np.asarray(stitcher.composite(
        jnp.asarray(left), jnp.asarray(right_rot), h))
    if v[16] > 0.5:
        fused = _run_fused_compose(stitcher, left, right_rot, h, tier=tier)
        assert fused.shape == staged.shape
        d = np.abs(fused.astype(int) - staged.astype(int)).max(-1)
        assert (d > 1).mean() < 5e-3, (d.max(), (d > 1).mean())
    else:
        assert tier == 0, "tier 1 must take a 30-degree rotation"
    pano = stitcher.stitch_pair_fast(
        jnp.asarray(left), jnp.asarray(right_rot)
    )
    assert pano is not None


def test_fused_stitch_flags_canvas_overflow():
    """A vertical placement whose true canvas exceeds the panorama-shaped
    static padding (pad_h = hl + hr/2) must clear `safe` so
    stitch_pair_fast falls back to the exact staged path instead of
    silently truncating the panorama."""
    # Vertical pair: right image's content sits mostly BELOW the left image
    # -> canvas_h ~= 352 + 448 = 800 > pad_h = round_up(400 + 224 + 2,
    # 128) = 640.
    base = checkerboard_texture(800, 160, seed=8)
    top = base[:400].copy()
    bottom = base[352:800].copy()  # 48 px overlap

    stitcher = PairStitcher(SMALL, print_timing=False)
    v, _ = _fused(stitcher, top, bottom, tier=1)
    assert v[11] > 0.5, "RANSAC should solve the vertical translation"
    h = v[:9].reshape(3, 3)
    assert h[1, 2] > 250, h  # right maps ~284 px down
    assert v[16] < 0.5, "expected safe=0 for canvas overflow"

    # And the public path must still produce the full (untruncated) result
    # via the staged fallback.
    pano = stitcher.stitch_pair(jnp.asarray(top), jnp.asarray(bottom))
    assert pano is not None
    assert np.asarray(pano).shape[0] >= 790


def test_timing_lines_contract(capsys):
    """The stdout stage lines are a machine-readable API (SURVEY §1)."""
    left, right = translated_pair()
    stitcher = PairStitcher(SMALL, print_timing=True)
    stitcher.stitch_pair(jnp.asarray(left), jnp.asarray(right))
    out = capsys.readouterr().out
    import re

    for label in (
        "Harris Corner Detection",
        "Harris Corner Matching",
        "RANSAC Homography Estimation",
        "Image Stitching",
    ):
        assert re.search(rf"^{label}: \d+\.\d{{3}} ms$", out, re.M), label


def test_auto_mode_single_fetch_for_match_graph(monkeypatch):
    """The local auto mode must pay exactly ONE host fetch for the whole
    n(n-1)/2 pair-estimation graph, mirroring its sharded twin."""
    from pano import pipeline

    base = checkerboard_texture(128, 280, seed=4)
    imgs = [
        np.asarray(base[:, 120:280]),
        np.asarray(base[:, 0:160]),
        np.asarray(base[:, 60:220]),
    ]
    calls = []
    real_fetch = pipeline._host_fetch
    monkeypatch.setattr(
        pipeline, "_host_fetch", lambda x: (calls.append(1), real_fetch(x))[1]
    )
    pano = pipeline.stitch_all_images_auto(imgs, SMALL, print_timing=False)
    assert pano is not None
    assert len(calls) == 1, f"expected 1 packed fetch, saw {len(calls)}"


def test_tier_fallback_reuses_estimate():
    """A tier coverage miss must NOT re-run detection/matching/RANSAC:
    estimation is dispatched once, every tier attempt and the staged
    composite fallback reuse it."""
    # Vertical pair: overflows the panorama-shaped canvas at every tier,
    # so the fused path walks tier 0 -> tier 1 -> staged composite.
    base = checkerboard_texture(800, 160, seed=8)
    top = base[:400].copy()
    bottom = base[352:800].copy()

    stitcher = PairStitcher(SMALL, print_timing=False)
    est_calls, compose_tiers = [], []
    real_est = stitcher._fused_estimate
    stitcher._fused_estimate = (
        lambda *a: (est_calls.append(1), real_est(*a))[1]
    )
    real_compose = stitcher._fused_compose

    def counting_compose(tier):
        compose_tiers.append(tier)
        return real_compose(tier)

    stitcher._fused_compose = counting_compose

    pano = stitcher.stitch_pair_fast(jnp.asarray(top), jnp.asarray(bottom))
    assert pano is not None
    assert np.asarray(pano).shape[0] >= 790  # untruncated staged result
    assert est_calls == [1], f"estimation ran {len(est_calls)} times"
    assert compose_tiers == [0, 1], compose_tiers


def _exact_est_row(h):
    """Fused-protocol estimate row with a KNOWN homography: keeps parity
    tests independent of RANSAC noise."""
    return jnp.asarray(
        list(np.asarray(h, np.float32).ravel())
        + [100.0, 100.0, 1.0, 100.0, 0.0],
        jnp.float32,
    )


def _run_fused_row(stitcher, left, right, h, tier=0):
    """The fused compose's packed row for a known homography."""
    packed_out, _ = stitcher._fused_compose(tier)(
        jnp.asarray(left), jnp.asarray(right), _exact_est_row(h)
    )
    return np.asarray(packed_out)


def _run_fused_compose(stitcher, left, right, h, tier=0):
    packed_out, canvas = stitcher._fused_compose(tier)(
        jnp.asarray(left), jnp.asarray(right), _exact_est_row(h)
    )
    v = np.asarray(packed_out)
    assert v[16] > 0.5, "expected an in-coverage homography"
    return np.asarray(canvas[: int(v[14]), : int(v[15])])


@pytest.mark.parametrize("blend", ["overlay", "feather"])
def test_fused_stitch_blend_matches_staged(blend):
    """Overlay and feather: with an exact integer homography the fused
    compose reproduces the staged composite pixel for pixel."""
    import dataclasses

    cfg = SMALL.replace(
        stitch=dataclasses.replace(SMALL.stitch, blend=blend)
    )
    left, right = translated_pair()
    h = np.eye(3)
    h[0, 2] = -48.0
    stitcher = PairStitcher(cfg, print_timing=False)
    staged = np.asarray(
        stitcher.composite(jnp.asarray(left), jnp.asarray(right), h)
    )
    fused = _run_fused_compose(stitcher, left, right, h)
    np.testing.assert_array_equal(fused, staged)


def test_fused_stitch_multiband_matches_staged():
    """Multiband inside the fused graph, exact integer homography, against
    the staged multiband composite (the pyramids see a different window
    extent on the two paths, hence the loose bound)."""
    import dataclasses

    cfg = SMALL.replace(
        stitch=dataclasses.replace(SMALL.stitch, blend="multiband")
    )
    left, right = translated_pair()
    h = np.eye(3)
    h[0, 2] = -48.0
    stitcher = PairStitcher(cfg, print_timing=False)
    staged = np.asarray(
        stitcher.composite(jnp.asarray(left), jnp.asarray(right), h)
    )
    fused = _run_fused_compose(stitcher, left, right, h)
    assert fused.shape == staged.shape, (fused.shape, staged.shape)
    d = np.abs(fused.astype(int) - staged.astype(int)).max(-1)
    assert (d > 10).mean() < 0.02, (d.max(), (d > 10).mean())


def test_fused_stitch_gain_matches_staged():
    """Gain compensation inside the fused graph must match the staged gain
    path for an exact homography."""
    import dataclasses

    cfg = SMALL.replace(
        stitch=dataclasses.replace(
            SMALL.stitch, blend="feather", gain_compensation=True
        )
    )
    left, right = translated_pair()
    # Real exposure offset so the gain actually engages.
    right = np.clip(right.astype(np.int32) * 1.25, 0, 255).astype(np.uint8)
    h = np.eye(3)
    h[0, 2] = -48.0
    stitcher = PairStitcher(cfg, print_timing=False)
    staged = np.asarray(
        stitcher.composite(jnp.asarray(left), jnp.asarray(right), h)
    )
    fused = _run_fused_compose(stitcher, left, right, h)
    assert fused.shape == staged.shape
    # The blended output must reflect the ~0.8 gain (right-only region
    # darker than the raw brightened input).
    assert fused[:, :40].mean() < right[:, :40].mean() - 5
    d = np.abs(fused.astype(int) - staged.astype(int)).max(-1)
    assert (d > 10).mean() < 0.02, (d.max(), (d > 10).mean())


@pytest.mark.parametrize("blend", ["overlay", "feather"])
@pytest.mark.parametrize("tier", [0, 1])
def test_fused_compose_matches_overlay_oracle(tier, blend):
    """Each tier's fused compose against the numpy compose oracle
    (pano.oracles), fed the same known homography."""
    import dataclasses

    from pano import oracles
    from pano.ops import warp as warp_ops

    left, right = translated_pair()
    h = np.array([[0.99, 0.01, -45.5], [-0.008, 1.0, 2.25],
                  [1e-5, -2e-5, 1.0]])
    cfg = SMALL.replace(
        stitch=dataclasses.replace(SMALL.stitch, blend=blend)
    )
    stitcher = PairStitcher(cfg, print_timing=False)
    fused = _run_fused_compose(stitcher, left, right, h, tier=tier)
    (ch, cw), t_mat, (mx, my) = warp_ops.compute_canvas_geometry(
        h, left.shape[:2], right.shape[:2]
    )
    want = oracles.compose(
        left, right, np.linalg.inv(t_mat @ h),
        warp_ops.left_offset(mx), warp_ops.left_offset(my), ch, cw, blend,
    )
    assert fused.shape == want.shape
    d = np.abs(fused.astype(int) - want.astype(int)).max(-1)
    assert (d > 1).mean() < 5e-3, (d.max(), (d > 1).mean())


def test_chain_mode_single_fetch_for_estimates(monkeypatch):
    """The local chain mode must pay exactly ONE host fetch for all n-1
    adjacent-pair estimates (mirroring the auto mode and the sharded
    twins), not one per pair."""
    from pano import pipeline

    base = checkerboard_texture(128, 280, seed=5)
    imgs = [
        np.asarray(base[:, 0:160]),
        np.asarray(base[:, 60:220]),
        np.asarray(base[:, 120:280]),
    ]
    calls = []
    real_fetch = pipeline._host_fetch
    monkeypatch.setattr(
        pipeline, "_host_fetch", lambda x: (calls.append(1), real_fetch(x))[1]
    )
    pano = pipeline.stitch_all_images_chain(imgs, SMALL, print_timing=False)
    assert pano is not None
    assert len(calls) == 1, f"expected 1 packed fetch, saw {len(calls)}"
    assert pano.shape[1] >= 260  # all three images placed


def test_auto_mode_anchor_first_matches_chain_frame():
    """--anchor first roots the auto MST at the first connected image, so
    on ordered input the auto panorama renders in chain mode's projective
    frame (same canvas) instead of the best-connected image's frame —
    the knob for grading against a reference panorama."""
    from pano import pipeline

    base = checkerboard_texture(128, 300, seed=6)
    imgs = [
        np.asarray(base[:, 0:160]),
        np.asarray(base[:, 70:230]),
        np.asarray(base[:, 140:300]),
    ]
    chain = pipeline.stitch_all_images_chain(imgs, SMALL, print_timing=False)
    auto_first = pipeline.stitch_all_images_auto(
        imgs, SMALL, print_timing=False, anchor="first"
    )
    assert chain is not None and auto_first is not None
    assert auto_first.shape == chain.shape
    # Same frame means near-identical pixels (estimates may differ in ulps).
    diff = np.abs(
        auto_first.astype(np.int32) - chain.astype(np.int32)
    ).mean()
    assert diff < 3.0, diff
    # Default anchor still roots at the best-connected (middle) image.
    auto_def = pipeline.stitch_all_images_auto(
        imgs, SMALL, print_timing=False
    )
    assert auto_def is not None
