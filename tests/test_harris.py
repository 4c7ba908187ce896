"""Unit tests: Harris detection vs a numpy oracle of the reference's
seqHarrisCornerDetectorDetect (src/serial/main.cpp:119-185)."""

import numpy as np
import jax.numpy as jnp
import cv2
import pytest

from pano import oracles
from pano.config import HarrisOptions
from pano.ops import harris


def harris_oracle(img_bgr: np.ndarray, opts: HarrisOptions):
    """Reference-semantics Harris from the float64 numpy oracles
    (pano.oracles): returns (keypoint set, response).

    Uses the library's own gray conversion (validated against cv2
    separately) so this oracle isolates the conv/response/NMS math.
    """
    gray = np.asarray(
        harris.bgr_to_gray_f32(jnp.asarray(img_bgr)), np.float64
    )
    resp = oracles.harris_response(gray, opts.k)
    xy, _ = oracles.harris_peaks(resp, opts.nms_thresh, opts.nms_neighborhood)
    return {(int(x), int(y)) for x, y in xy}, resp


def test_gray_matches_cv2(rng):
    img = rng.integers(0, 256, (32, 40, 3), dtype=np.uint8)
    got = np.asarray(harris.bgr_to_gray_f32(jnp.asarray(img)))
    want = cv2.cvtColor(img, cv2.COLOR_BGR2GRAY).astype(np.float32)
    diff = np.abs(got - want)
    # Exact except for pixels on a rounding boundary (tie-breaking differs
    # between cv2 builds); those may be off by exactly 1.
    assert diff.max() <= 1.0
    assert (diff > 0).mean() < 0.01


@pytest.mark.parametrize("shape", [(24, 28), (37, 53), (64, 17)])
def test_response_matches_oracle(rng, shape):
    img = rng.integers(0, 256, shape + (3,), dtype=np.uint8)
    opts = HarrisOptions()
    gray = harris.bgr_to_gray_f32(jnp.asarray(img))
    got = np.asarray(harris.harris_response(gray, opts.k))
    _, want = harris_oracle(img, opts)
    # f32 vs f64: responses reach ~1e9 on random noise; tolerate relative err.
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e3)


@pytest.mark.parametrize("shape", [(48, 64), (61, 45)])
def test_detect_matches_oracle_keypoint_set(rng, shape):
    img = rng.integers(0, 256, shape + (3,), dtype=np.uint8)
    # exact selection: this test checks NMS semantics, not selection policy
    opts = HarrisOptions(max_keypoints=512, topk_method="exact")
    kps = harris.harris_detect(jnp.asarray(img), opts)
    got = {
        (int(x), int(y))
        for (x, y), v in zip(np.asarray(kps.xy), np.asarray(kps.valid))
        if v
    }
    want, _ = harris_oracle(img, opts)
    # Tie-breaking and f32 rounding may flip borderline peaks; demand high
    # overlap rather than exact equality (the acceptance gate is statistical).
    inter = len(got & want)
    union = len(got | want)
    assert union > 0
    assert inter / union > 0.95, (len(got), len(want), inter)


def test_detect_respects_capacity_and_masks():
    img = np.zeros((40, 40, 3), np.uint8)
    img[10:30:4, 10:30:4] = 255  # sparse bright dots -> strong corners
    opts = HarrisOptions(max_keypoints=8)
    kps = harris.harris_detect(jnp.asarray(img), opts)
    assert kps.xy.shape == (8, 2)
    assert kps.valid.shape == (8,)
    # Responses of valid keypoints sorted descending (top-k order).
    r = np.asarray(kps.response)[np.asarray(kps.valid)]
    assert np.all(np.diff(r) <= 0)


def test_detect_empty_image_no_keypoints():
    img = np.zeros((32, 32, 3), np.uint8)
    kps = harris.harris_detect(jnp.asarray(img), HarrisOptions(max_keypoints=16))
    assert int(kps.count()) == 0
