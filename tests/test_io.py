"""Reader-layer tests: CLI arg semantics (src/reader/reader.cpp:14-82
parity) and native-vs-Python decode equivalence."""

import os

import numpy as np
import pytest

from pano import io as pio


@pytest.fixture
def image_dir(tmp_path, rng):
    import cv2

    paths = []
    for i, name in enumerate(["b.png", "a.png", "c.png"]):
        img = rng.integers(0, 256, (20 + i, 30, 3), dtype=np.uint8)
        p = str(tmp_path / name)
        cv2.imwrite(p, img)
        paths.append(p)
    (tmp_path / "notes.txt").write_text("not an image")
    return str(tmp_path)


def test_dir_mode_sorted_and_skips_unreadable(image_dir, capsys):
    res = pio.read_images_from_args(["--dir", image_dir])
    # 3 images, lexicographic order (a, b, c) — the deliberate determinism
    # fix over the reference's unsorted directory_iterator.
    assert len(res.images) == 3
    assert [os.path.basename(p) for p in res.paths] == [
        "a.png", "b.png", "c.png",
    ]
    assert "Warning: Unable to open image file" in capsys.readouterr().err
    assert res.output_file == "result.jpg"


def test_positional_and_out_flag(image_dir):
    files = sorted(
        os.path.join(image_dir, f)
        for f in os.listdir(image_dir)
        if f.endswith(".png")
    )
    res = pio.read_images_from_args([files[0], "--out", "pano.png", files[1]])
    assert len(res.images) == 2
    assert res.output_file == "pano.png"


def test_dir_takes_precedence_over_positionals(image_dir):
    files = sorted(
        os.path.join(image_dir, f)
        for f in os.listdir(image_dir)
        if f.endswith(".png")
    )
    # reader.cpp:53-79: when --dir is given, positionals are ignored.
    res = pio.read_images_from_args([files[0], "--dir", image_dir])
    assert len(res.images) == 3


def test_missing_dir_exits(tmp_path):
    with pytest.raises(SystemExit):
        pio.read_images_from_args(["--dir", str(tmp_path / "nope")])


def test_imread_parity_native_vs_cv2(image_dir):
    """When the native reader is loaded, it must decode byte-identically to
    cv2 (both are OpenCV imgcodecs underneath)."""
    import cv2

    p = os.path.join(image_dir, "a.png")
    ours = pio.imread_bgr(p)
    ref = cv2.imread(p, cv2.IMREAD_COLOR)
    np.testing.assert_array_equal(ours, ref)


def test_imwrite_roundtrip(tmp_path, rng):
    img = rng.integers(0, 256, (16, 24, 3), dtype=np.uint8)
    p = str(tmp_path / "x.png")
    assert pio.imwrite_bgr(p, img)
    back = pio.imread_bgr(p)
    np.testing.assert_array_equal(back, img)


# --- built-in PNG / PPM codecs (no cv2, no PIL) ---------------------------


@pytest.fixture
def no_codec(monkeypatch):
    """pano.io as on a machine with neither cv2 nor PIL nor the native
    reader: PNG and PPM go through the built-in zlib + numpy codecs."""
    monkeypatch.setattr(pio, "_optional_codec", lambda: None)
    monkeypatch.setattr(pio, "_NATIVE", None)


@pytest.mark.parametrize("shape", [(1, 1), (7, 13), (32, 5)])
def test_png_roundtrip_without_codec(no_codec, tmp_path, rng, shape):
    img = rng.integers(0, 256, shape + (3,), dtype=np.uint8)
    p = str(tmp_path / "x.png")
    assert pio.imwrite_bgr(p, img)
    np.testing.assert_array_equal(pio.imread_bgr(p), img)


@pytest.mark.parametrize("shape", [(1, 1), (9, 4)])
def test_ppm_roundtrip_without_codec(no_codec, tmp_path, rng, shape):
    img = rng.integers(0, 256, shape + (3,), dtype=np.uint8)
    p = str(tmp_path / "x.ppm")
    assert pio.imwrite_bgr(p, img)
    np.testing.assert_array_equal(pio.imread_bgr(p), img)


def test_ppm_header_comment_without_codec(no_codec, tmp_path, rng):
    img = rng.integers(0, 256, (3, 2, 3), dtype=np.uint8)
    p = tmp_path / "c.ppm"
    p.write_bytes(b"P6\n# a comment\n2 3\n255\n"
                  + img[..., ::-1].tobytes())
    np.testing.assert_array_equal(pio.imread_bgr(str(p)), img)


@pytest.mark.parametrize("mode", ["RGB", "L", "RGBA", "P"])
def test_builtin_png_decoder_reads_pil_pngs(tmp_path, rng, mode, monkeypatch):
    """PNGs written by Pillow (adaptive scanline filters, gray, alpha,
    palette) decode with the built-in reader to what Pillow reads."""
    from PIL import Image

    rgb = rng.integers(0, 256, (21, 34, 3), dtype=np.uint8)
    rgb[5:15, 5:20] = rgb[5, 5]   # flat runs make the filters vary
    im = Image.fromarray(rgb).convert(mode)
    p = str(tmp_path / f"{mode}.png")
    im.save(p, optimize=True)
    want = np.asarray(Image.open(p).convert("RGB"))[..., ::-1]
    monkeypatch.setattr(pio, "_optional_codec", lambda: None)
    monkeypatch.setattr(pio, "_NATIVE", None)
    np.testing.assert_array_equal(pio.imread_bgr(p), want)


def _png_filter(px, types):
    """Filter (h, w, bpp) uint8 rows with the given per-row PNG filter
    types, as an encoder does -> the (h, 1 + w * bpp) scanline bytes."""
    x = px.astype(np.int16)
    a = np.zeros_like(x)
    a[:, 1:] = x[:, :-1]                   # left
    b = np.zeros_like(x)
    b[1:] = x[:-1]                         # up
    c = np.zeros_like(x)
    c[1:, 1:] = x[:-1, :-1]                # up-left
    pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    preds = np.stack([np.zeros_like(x), a, b, (a + b) >> 1, paeth])
    pred = preds[types, np.arange(len(types))]
    h, w, bpp = px.shape
    raw = np.empty((h, 1 + w * bpp), np.uint8)
    raw[:, 0] = types
    raw[:, 1:] = ((x - pred) & 0xFF).reshape(h, -1)
    return raw


@pytest.mark.parametrize("bpp", [1, 3, 4])
@pytest.mark.parametrize("types", ["paeth", "average", "mixed", "sub_up"])
def test_png_unfilter_every_filter_type(rng, bpp, types):
    """Each scanline filter, alone and mixed row by row, undoes exactly;
    Average and Paeth rows go through the diagonal wavefront."""
    h, w = 23, 17
    px = rng.integers(0, 256, (h, w, bpp), dtype=np.uint8)
    px[4:12, 3:9] = px[4, 3]               # flat runs and hard edges
    t = {"paeth": np.full(h, 4), "average": np.full(h, 3),
         "mixed": rng.integers(0, 5, h), "sub_up": rng.integers(0, 3, h)}
    raw = _png_filter(px, t[types])
    got = pio._png_unfilter(raw.reshape(-1), h, w * bpp, bpp)
    np.testing.assert_array_equal(got, px.reshape(h, w * bpp))


def test_builtin_png_decoder_reads_cv2_png(tmp_path, rng, no_codec):
    import cv2

    img = rng.integers(0, 256, (17, 23, 3), dtype=np.uint8)
    img[:, 10:] = img[:, 10:11]
    p = str(tmp_path / "cv.png")
    cv2.imwrite(p, img, [cv2.IMWRITE_PNG_COMPRESSION, 9])
    np.testing.assert_array_equal(pio.imread_bgr(p), img)


def test_jpeg_without_codec_names_missing_package(tmp_path, no_codec):
    p = tmp_path / "x.jpg"
    p.write_bytes(b"\xff\xd8\xff\xe0" + b"\0" * 64)
    with pytest.raises(RuntimeError, match="opencv-python.*Pillow"):
        pio.imread_bgr(str(p))
    with pytest.raises(RuntimeError, match="opencv-python.*Pillow"):
        pio.imwrite_bgr(str(tmp_path / "y.jpg"), np.zeros((2, 2, 3), np.uint8))


def test_non_image_without_codec_is_skipped(tmp_path, no_codec):
    p = tmp_path / "notes.txt"
    p.write_text("not an image")
    assert pio.imread_bgr(str(p)) is None
    assert pio.imread_bgr(str(tmp_path / "missing.png")) is None
