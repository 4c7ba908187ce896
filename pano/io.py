"""Image loading/saving + CLI argument parsing (the reference "reader" layer).

Behavioral parity with the reference's only shared library,
src/reader/reader.cpp:14-82 / reader.hpp:8-15:

  * flags: ``--dir <D>`` (load every regular file in D), ``--out <F>``
    (default ``result.jpg``), everything else is a positional image path;
  * ``--dir`` takes precedence over positionals (reader.cpp:53-79);
  * unreadable files print a warning to stderr and are skipped
    (reader.cpp:62-65, 73-76);
  * missing args → usage on stderr + exit(-1) (reader.cpp:22-27).

One deliberate fix over the reference: ``fs::directory_iterator`` yields files
in unspecified OS order (reader.cpp:58), making directory stitches
non-reproducible across filesystems. We sort lexicographically.

Images are returned as HxWx3 uint8 numpy arrays in **BGR** channel order
(cv::imread convention) so downstream gray conversion and SSD semantics match
the reference exactly.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import zlib
from typing import List, Optional, Sequence

import numpy as np

_PNG_SIG = b"\x89PNG\r\n\x1a\n"
# Image formats that only a codec library decodes or encodes here.
_CODEC_EXTS = (".jpg", ".jpeg", ".bmp", ".tif", ".tiff", ".webp")


def _optional_codec():
    """The installed image-codec library (cv2, else PIL), or None. Imported
    on first use, never at module import: neither is required for PNG or
    PPM, which this module reads and writes itself."""
    try:
        import cv2  # type: ignore

        return cv2
    except ImportError:
        pass
    try:
        from PIL import Image  # type: ignore

        return Image
    except ImportError:
        return None


def _need_codec(path: str):
    codec = _optional_codec()
    if codec is None:
        raise RuntimeError(
            f"{path}: reading or writing this format needs opencv-python "
            "(cv2) or Pillow (PIL), and neither is installed; PNG and PPM "
            "work without them"
        )
    return codec


def _png_chunks(data: bytes):
    pos = len(_PNG_SIG)
    while pos + 8 <= len(data):
        n = int.from_bytes(data[pos:pos + 4], "big")
        kind = data[pos + 4:pos + 8]
        yield kind, data[pos + 8:pos + 8 + n]
        pos += 12 + n


def _png_unfilter(raw: np.ndarray, h: int, stride: int, bpp: int):
    """Undo PNG scanline filters (types 0-4) -> (h, stride) uint8."""
    rows = raw.reshape(h, stride + 1)
    ftypes, rows = rows[:, 0], rows[:, 1:]
    if ftypes.max(initial=0) > 4:
        raise ValueError(f"bad PNG filter type {int(ftypes.max())}")
    if (ftypes >= 3).any():
        return _png_unfilter_wavefront(
            ftypes, rows.reshape(h, stride // bpp, bpp)
        ).reshape(h, stride)
    out = np.empty((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        f, r = ftypes[y], rows[y]
        if f == 0:
            out[y] = r
        elif f == 2:                       # Up
            out[y] = r + prev
        else:                              # Sub: running sum per channel
            out[y] = np.cumsum(r.reshape(-1, bpp), axis=0,
                               dtype=np.uint8).reshape(-1)
        prev = out[y]
    return out


def _png_unfilter_wavefront(ftypes: np.ndarray, rows: np.ndarray):
    """Undo filters of any type on (h, w, bpp) rows. Average and Paeth
    predict a byte from its left (a), upper (b) and upper-left (c)
    neighbours, so a row cannot be undone as one vector. Every pixel on an
    anti-diagonal y + x = d depends only on diagonals d-1 and d-2, so the
    image is sheared to put diagonals in rows (s[d + 2, y + 1] holds pixel
    (y, d - y); unwritten cells are the zero border) and undone one
    diagonal at a time: h + w - 1 numpy steps instead of h * w * bpp
    Python ones."""
    h, w, bpp = rows.shape
    filt = np.zeros((h + w + 1, h + 1, bpp), np.int16)
    for y in range(h):
        filt[y + 2:y + 2 + w, y + 1] = rows[y]
    kind = np.zeros((h + 1, 1), np.int16)
    kind[1:, 0] = ftypes
    s = np.zeros_like(filt)
    for d in range(h + w - 1):
        lo, hi = max(0, d - w + 1), min(h, d + 1)
        a = s[d + 1, lo + 1:hi + 1]
        b = s[d + 1, lo:hi]
        c = s[d, lo:hi]
        t = kind[lo + 1:hi + 1]
        pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        pred = np.select(
            [t == 1, t == 2, t == 3, t == 4],
            [a, b, (a + b) >> 1, paeth],
        )
        s[d + 2, lo + 1:hi + 1] = (filt[d + 2, lo + 1:hi + 1] + pred) & 0xFF
    out = np.empty((h, w, bpp), np.uint8)
    for y in range(h):
        out[y] = s[y + 2:y + 2 + w, y + 1]
    return out


def _read_png(path: str) -> Optional[np.ndarray]:
    """8-bit, non-interlaced PNG -> HxWx3 uint8 BGR, with zlib + numpy
    only; None for a PNG outside that subset."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(_PNG_SIG):
        return None
    hdr, idat, palette = None, [], None
    for kind, body in _png_chunks(data):
        if kind == b"IHDR":
            hdr = body
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
    w, h = int.from_bytes(hdr[0:4], "big"), int.from_bytes(hdr[4:8], "big")
    depth, ctype, interlace = hdr[8], hdr[9], hdr[12]
    channels = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}.get(ctype)
    if depth != 8 or interlace != 0 or channels is None:
        return None
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    px = _png_unfilter(raw, h, w * channels, channels).reshape(
        h, w, channels
    )
    if ctype == 3:
        rgb = palette[px[..., 0]]
    elif channels <= 2:                     # gray (+ alpha)
        rgb = np.repeat(px[..., :1], 3, axis=-1)
    else:                                   # RGB (+ alpha)
        rgb = px[..., :3]
    return np.ascontiguousarray(rgb[..., ::-1])


def _write_png(path: str, img: np.ndarray) -> bool:
    """HxWx3 uint8 BGR -> 8-bit RGB PNG (filter type 0, zlib level 1)."""
    h, w = img.shape[:2]
    rows = np.zeros((h, 1 + 3 * w), np.uint8)
    rows[:, 1:] = img[..., ::-1].reshape(h, 3 * w)

    def chunk(kind: bytes, body: bytes) -> bytes:
        crc = zlib.crc32(kind + body) & 0xFFFFFFFF
        return (
            len(body).to_bytes(4, "big") + kind + body + crc.to_bytes(4, "big")
        )

    ihdr = w.to_bytes(4, "big") + h.to_bytes(4, "big") + bytes([8, 2, 0, 0, 0])
    with open(path, "wb") as f:
        f.write(_PNG_SIG)
        f.write(chunk(b"IHDR", ihdr))
        f.write(chunk(b"IDAT", zlib.compress(rows.tobytes(), 1)))
        f.write(chunk(b"IEND", b""))
    return True


def _read_ppm(path: str) -> Optional[np.ndarray]:
    """Binary PPM (P6, maxval 255) -> HxWx3 uint8 BGR; None otherwise."""
    with open(path, "rb") as f:
        data = f.read()
    fields, pos = [], 0
    while len(fields) < 4:
        while pos < len(data) and data[pos:pos + 1].isspace():
            pos += 1
        if data[pos:pos + 1] == b"#":       # comment to end of line
            pos = data.index(b"\n", pos) + 1
            continue
        end = pos
        while end < len(data) and not data[end:end + 1].isspace():
            end += 1
        fields.append(data[pos:end])
        pos = end
    if fields[0] != b"P6" or int(fields[3]) != 255:
        return None
    w, h = int(fields[1]), int(fields[2])
    px = np.frombuffer(data, np.uint8, count=h * w * 3, offset=pos + 1)
    return np.ascontiguousarray(px.reshape(h, w, 3)[..., ::-1])


def _write_ppm(path: str, img: np.ndarray) -> bool:
    h, w = img.shape[:2]
    with open(path, "wb") as f:
        f.write(b"P6\n%d %d\n255\n" % (w, h))
        f.write(np.ascontiguousarray(img[..., ::-1]).tobytes())
    return True


def _ext(path: str) -> str:
    return os.path.splitext(path)[1].lower()


def _load_native():
    """Native host runtime (native/pano_host.cpp): the C++ equivalent of the
    reference's reader static library (src/reader/reader.cpp), loaded via
    ctypes. Optional: it needs OpenCV's C++ libraries and is built by
    `pano.sh build`; when it has not been built (or PANO_NATIVE=0), the
    Python readers below are used."""
    if os.environ.get("PANO_NATIVE", "1") == "0":
        return None
    import ctypes

    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for cand in (
        os.environ.get("PANO_HOST_LIB", ""),  # pano.sh --build-dir=
        os.path.join(here, "native", "build", "libpano_host.so"),
        os.path.join(here, "libpano_host.so"),
    ):
        if not cand:
            continue
        if os.path.exists(cand):
            try:
                lib = ctypes.CDLL(cand)
                lib.ph_version.restype = ctypes.c_int
                if lib.ph_version() != 2:
                    continue  # stale ABI: try the next candidate
                lib.ph_imread_dims.argtypes = [
                    ctypes.c_char_p,
                    ctypes.POINTER(ctypes.c_int),
                    ctypes.POINTER(ctypes.c_int),
                ]
                lib.ph_imread_fill.argtypes = [
                    ctypes.c_char_p,
                    ctypes.POINTER(ctypes.c_ubyte),
                    ctypes.c_int,
                    ctypes.c_int,
                ]
                lib.ph_imwrite.argtypes = [
                    ctypes.c_char_p,
                    ctypes.POINTER(ctypes.c_ubyte),
                    ctypes.c_int,
                    ctypes.c_int,
                ]
                return lib
            except (OSError, AttributeError):
                # Unloadable .so, or a foreign library without the ph_*
                # exports (AttributeError from the ctypes symbol lookup):
                # keep scanning the remaining candidates rather than
                # aborting, and never let import pano.io crash.
                continue
    return None


_NATIVE = _load_native()


@dataclasses.dataclass
class ImageReaderResult:
    """Mirror of reference ImageReaderResult (src/reader/reader.hpp:8-11)."""

    images: List[np.ndarray]
    output_file: str = "result.jpg"
    # Retained for diagnostics; not in the reference struct.
    paths: List[str] = dataclasses.field(default_factory=list)


def imread_bgr(path: str) -> Optional[np.ndarray]:
    """Load an image as HxWx3 uint8 BGR; None if unreadable (cv::imread).

    Order: the native reader when built, else cv2 or PIL when installed,
    else the built-in PNG/PPM decoder. Any other format with no codec
    library installed raises, naming the missing packages."""
    if _NATIVE is not None:
        import ctypes

        h = ctypes.c_int()
        w = ctypes.c_int()
        if _NATIVE.ph_imread_dims(path.encode(), ctypes.byref(h), ctypes.byref(w)) != 0:
            return None
        buf = np.empty((h.value, w.value, 3), np.uint8)
        if (
            _NATIVE.ph_imread_fill(
                path.encode(),
                buf.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
                h.value,
                w.value,
            )
            != 0
        ):
            return None
        return buf
    codec = _optional_codec()
    if codec is None:
        if not os.path.isfile(path):
            return None
        if _ext(path) == ".png":
            return _read_png(path)
        if _ext(path) in (".ppm", ".pnm"):
            return _read_ppm(path)
        with open(path, "rb") as f:
            magic = f.read(8)
        if magic.startswith(_PNG_SIG):
            return _read_png(path)
        if magic.startswith(b"P6"):
            return _read_ppm(path)
        if magic.startswith(b"\xff\xd8\xff") or _ext(path) in _CODEC_EXTS:
            _need_codec(path)
        return None  # not an image: the reader's skip-unreadable rule
    if codec.__name__ == "cv2":
        return codec.imread(path, codec.IMREAD_COLOR)
    try:
        with codec.open(path) as im:
            rgb = np.asarray(im.convert("RGB"), dtype=np.uint8)
    except (OSError, ValueError):  # unreadable / not an image
        return None
    return rgb[..., ::-1].copy()


def imwrite_bgr(path: str, img: np.ndarray) -> bool:
    """Save an HxWx3 uint8 BGR image (cv::imwrite equivalent). PNG and PPM
    need no codec library; other formats use cv2 or PIL."""
    img = np.ascontiguousarray(img, dtype=np.uint8)
    if _NATIVE is not None:
        import ctypes

        return (
            _NATIVE.ph_imwrite(
                path.encode(),
                img.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
                img.shape[0],
                img.shape[1],
            )
            == 0
        )
    codec = _optional_codec()
    if codec is None:
        if _ext(path) == ".png":
            return _write_png(path, img)
        if _ext(path) in (".ppm", ".pnm"):
            return _write_ppm(path, img)
        _need_codec(path)
    if codec.__name__ == "cv2":
        return bool(codec.imwrite(path, img))
    try:
        codec.fromarray(img[..., ::-1]).save(path)
    except (OSError, ValueError):
        return False
    return True


def read_images_from_args(
    argv: Sequence[str],
    preloaded: Optional[dict] = None,
) -> ImageReaderResult:
    """Parse argv (excluding program name) exactly like readImagesFromArgs.

    `preloaded` maps path -> decoded BGR array (or None for unreadable):
    the serve loop's decode-ahead worker fills it so a job's JPEG decode
    overlaps the previous job's device work; paths not in the dict decode
    here as usual. Semantics (warnings, skip-on-unreadable, ordering) are
    identical either way."""
    result = ImageReaderResult(images=[], output_file="result.jpg")

    def _read(path):
        if preloaded is not None and path in preloaded:
            return preloaded[path]
        return imread_bgr(path)

    file_names: List[str] = []
    dir_name = ""

    if len(argv) < 1:
        print(
            "Usage: pano [--dir directory_name] [--out output_file_name] "
            "[image1 image2 ...]",
            file=sys.stderr,
        )
        sys.exit(-1)

    i = 0
    while i < len(argv):
        arg = argv[i]
        if arg == "--dir":
            if i + 1 < len(argv):
                i += 1
                dir_name = argv[i]
            else:
                print("Error: --dir requires a directory name", file=sys.stderr)
                sys.exit(-1)
        elif arg == "--out":
            if i + 1 < len(argv):
                i += 1
                result.output_file = argv[i]
            else:
                print("Error: --out requires an output file name", file=sys.stderr)
                sys.exit(-1)
        else:
            file_names.append(arg)
        i += 1

    if dir_name:
        if not os.path.isdir(dir_name):
            print(f"Error: {dir_name} is not a valid directory.", file=sys.stderr)
            sys.exit(-1)
        entries = sorted(
            os.path.join(dir_name, e)
            for e in os.listdir(dir_name)
            if os.path.isfile(os.path.join(dir_name, e))
        )
        for file_path in entries:
            img = _read(file_path)
            if img is None:
                print(
                    f"Warning: Unable to open image file: {file_path}",
                    file=sys.stderr,
                )
                continue
            result.images.append(img)
            result.paths.append(file_path)
    else:
        for file_name in file_names:
            img = _read(file_name)
            if img is None:
                print(
                    f"Warning: Unable to open image file: {file_name}",
                    file=sys.stderr,
                )
                continue
            result.images.append(img)
            result.paths.append(file_name)

    return result
