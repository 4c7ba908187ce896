"""Unit tests: convolution primitives vs a plain-numpy oracle of the
reference's convolveSequential (src/serial/main.cpp:96-116)."""

import numpy as np
import jax.numpy as jnp
import pytest

from pano import oracles
from pano.ops import conv

conv_oracle = oracles.conv_valid_zero_border


def test_sobel_kernels_values():
    assert np.array_equal(
        np.asarray(conv.sobel_x_kernel()),
        [[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]],
    )
    assert np.array_equal(
        np.asarray(conv.sobel_y_kernel()),
        [[-1, -2, -1], [0, 0, 0], [1, 2, 1]],
    )


def test_gaussian_kernel_normalized_and_symmetric():
    g = np.asarray(conv.gaussian_kernel(5, 1.0), dtype=np.float64)
    assert g.shape == (5, 5)
    np.testing.assert_allclose(g.sum(), 1.0, rtol=1e-6)
    np.testing.assert_allclose(g, g.T, rtol=1e-6)
    assert g[2, 2] == g.max()


@pytest.mark.parametrize("size,sigma", [(5, 1.0), (3, 0.8), (7, 1.5)])
def test_conv_valid_zero_border_matches_oracle(rng, size, sigma):
    img = rng.normal(size=(16, 20)).astype(np.float32)
    kernel = np.asarray(conv.gaussian_kernel(size, sigma))
    k = size // 2
    got = np.asarray(conv.conv2d_valid_zero_border(jnp.asarray(img), jnp.asarray(kernel)))
    want = conv_oracle(img.astype(np.float64), kernel.astype(np.float64))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=5e-3)
    # Border of width k must be exactly zero.
    assert np.all(got[:k] == 0) and np.all(got[-k:] == 0)
    assert np.all(got[:, :k] == 0) and np.all(got[:, -k:] == 0)


def test_conv_is_correlation_not_flipped(rng):
    # Asymmetric kernel distinguishes correlation from convolution.
    img = rng.normal(size=(10, 10)).astype(np.float32)
    kernel = np.asarray(conv.sobel_x_kernel())
    got = np.asarray(conv.conv2d_valid_zero_border(jnp.asarray(img), jnp.asarray(kernel)))
    want = conv_oracle(img.astype(np.float64), kernel.astype(np.float64))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=5e-3)
