"""The port's BMP reader (``ayolov2_torch/data/codecs.decode_bmp``, the
run-length loops in ``csrc/raster_codec.cpp``) against the installed OpenCV
5.0, whose own BMP reader is the reference: 1-, 4- and 8-bit palettes (gray
and colour, short palettes), 16-bit 555 and BI_BITFIELDS 565/555 (other
masks give None), 24 bits, 32 bits plain and BI_BITFIELDS, top-down rows,
core (12-byte), 40-byte, V4 and V5 headers, RLE8 and RLE4 streams of every
escape (and damaged ones, where cv2 gives None and the port raises), the
files OpenCV and Pillow write, and the modes cv2 refuses (JPEG or PNG in a
BMP, sizes beyond its limits), which raise naming them.
"""

from __future__ import annotations

import itertools
import struct
import sys
from pathlib import Path

import cv2  # the reference; the port never imports it
import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent))

from _torch_codec_fixtures import rle  # noqa: E402
from chip_smoke import bmp_file, bmp_rows, codec_source  # noqa: E402

SIZES = [(1, 1), (7, 13), (33, 31)]


def _same_as_cv2(path: Path):
    """``imread`` equals ``cv2.imread``, or raises ``OSError`` where cv2
    gives None or refuses the file (cv2.error)."""
    from ayolov2_torch.data.image_io import imread

    try:
        want = cv2.imread(str(path))
    except cv2.error:
        want = None
    if want is None:
        with pytest.raises(OSError):
            imread(str(path))
    else:
        np.testing.assert_array_equal(imread(str(path)), want)


def _stored(rows: bytes, h: int, top_down: bool) -> bytes:
    n = len(rows) // h
    return rows if top_down else b"".join(rows[i * n: (i + 1) * n] for i in range(h - 1, -1, -1))


@pytest.mark.parametrize("bpp", [1, 4, 8])
@pytest.mark.parametrize("header", [12, 40, 124])
def test_palettes_equal_cv2(tmp_path, bpp, header):
    """Colour and gray palettes, full and short (``biClrUsed``), each size,
    bottom-up and top-down (a core header stores bottom-up only)."""
    rng = np.random.default_rng(bpp * header)
    for (h, w), top, colors in itertools.product(SIZES, (False, True), (0, 2, (1 << bpp) - 1)):
        if header == 12 and (top or colors):
            continue
        idx = rng.integers(0, 1 << bpp, (h, w))
        n = colors or 1 << bpp
        for gray in (False, True):
            pal = (np.repeat(rng.integers(0, 256, (n, 1)), 3, 1) if gray
                   else rng.integers(0, 256, (n, 3)))
            path = tmp_path / f"{h}x{w}_{top}_{colors}_{gray}.bmp"
            path.write_bytes(bmp_file(_stored(bmp_rows(idx, bpp), h, top), w, h, bpp, palette=pal,
                                      header=header, top_down=top, colors_used=colors))
            _same_as_cv2(path)


@pytest.mark.parametrize("bpp, compression, masks", [
    (24, 0, None), (32, 0, None), (32, 3, (0xFF0000, 0xFF00, 0xFF, 0xFF000000)),
    (16, 0, None), (16, 3, (0xF800, 0x7E0, 0x1F)), (16, 3, (0x7C00, 0x3E0, 0x1F)),
    (16, 3, (0xF00, 0xF0, 0xF))], ids=["24", "32", "32bf", "16", "565", "555bf", "444bf"])
def test_direct_colour_equals_cv2(tmp_path, bpp, compression, masks):
    """16, 24 and 32 bits under 40-byte, V4 and V5 headers (whose masks
    cv2 looks for past the header), bottom-up and top-down."""
    rng = np.random.default_rng(bpp + compression)
    for (h, w), header, top in itertools.product(SIZES, (40, 108, 124), (False, True)):
        if bpp == 16:
            rows = bmp_rows(rng.integers(0, 1 << 16, (h, w)), 16)
        else:
            px = codec_source(h + w, h, w)
            if bpp == 32:
                px = np.concatenate([px, rng.integers(0, 256, (h, w, 1), dtype=np.uint8)], 2)
            rows = bmp_rows(px.reshape(h, -1), 8)
        path = tmp_path / f"{h}x{w}_{header}_{top}.bmp"
        path.write_bytes(bmp_file(_stored(rows, h, top), w, h, bpp, compression, masks=masks,
                                  header=header, top_down=top))
        _same_as_cv2(path)
    path = tmp_path / "core24.bmp"
    px = codec_source(5, 9, 11)
    path.write_bytes(bmp_file(_stored(bmp_rows(px.reshape(9, -1), 8), 9, False), 11, 9, 24,
                              header=12))
    _same_as_cv2(path)


def _rle_stream(rng, w: int, h: int, bits: int, mode: str) -> bytes:
    """Random RLE ops. ``clean`` stays inside each line and ends with end of
    bitmap; ``messy`` may overrun a line or stop early; ``noeob`` has no end
    of bitmap; ``cut`` loses its last bytes."""
    out, x, y = bytearray(), 0, 0
    while y < h:
        r, room = rng.random(), w - x
        if mode != "clean" and rng.random() < 0.03:
            room += int(rng.integers(1, 4))
        if r < 0.4 and room > 0:
            n = int(rng.integers(1, min(room, 255) + 1))
            c = int(rng.integers(0, 256))
            out += bytes([n, c])
            x += n
        elif r < 0.7 and room >= 3:
            n = int(rng.integers(3, min(room, 255) + 1))
            nb = n if bits == 8 else (n + 1) // 2
            body = rng.integers(0, 256, nb).astype(np.uint8).tobytes()
            out += bytes([0, n]) + body + bytes(nb % 2)
            x += n
        elif r < 0.8:
            out += bytes([0, 0])
            x, y = 0, y + 1
        elif r < 0.88:
            dx = int(rng.integers(0, max(1, min(w - x, 10)) + (0 if mode == "clean" else 3)))
            dy = int(rng.integers(0, 3))
            out += bytes([0, 2, dx, dy])
            x, y = x + dx, y + dy
        elif r < 0.9 and mode != "clean":
            break
        elif x >= w:
            out += bytes([0, 0])
            x, y = 0, y + 1
    if mode == "noeob":
        return bytes(out)
    if mode == "cut":
        return bytes(out[: max(0, len(out) - int(rng.integers(1, 6)))])
    return bytes(out) + bytes([0, 1])


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("mode", ["clean", "messy", "noeob", "cut"])
def test_rle_streams_equal_cv2(tmp_path, bits, mode):
    """Encoded and absolute runs, end of line, delta and end of bitmap in
    random order, bottom-up and top-down: what a skip passes over takes
    palette entry 0; RLE4's escapes fill only to their horizontal target,
    as OpenCV's reader does; a run past its line or data that ends first
    give None and raise."""
    rng = np.random.default_rng(bits * 10 + len(mode))
    for k in range(120):
        w, h = int(rng.integers(1, 40)), int(rng.integers(1, 12))
        pal = rng.integers(0, 256, (1 << bits, 3))
        data = bmp_file(_rle_stream(rng, w, h, bits, mode), w, h, bits, 1 if bits == 8 else 2,
                        palette=pal, top_down=k % 7 == 0)
        path = tmp_path / f"{k}.bmp"
        path.write_bytes(data)
        _same_as_cv2(path)


@pytest.mark.parametrize("bits", [8, 4])
def test_rle_of_images_equals_cv2(tmp_path, bits):
    """The fixtures' run-length writer (runs, absolute runs, a delta, end of
    line and of bitmap) on images of several sizes."""
    rng = np.random.default_rng(bits)
    for h, w in SIZES + [(45, 71), (20, 300)]:
        idx = (codec_source(h * w, h, w, gray=True) >> (8 - bits)).astype(np.int64)
        pal = rng.integers(0, 256, (1 << bits, 3))
        path = tmp_path / f"{h}x{w}.bmp"
        path.write_bytes(bmp_file(rle(idx[::-1], bits, delta_row=h // 2 if h > 2 else -1), w, h,
                                  bits, 1 if bits == 8 else 2, palette=pal))
        _same_as_cv2(path)


@pytest.mark.parametrize("writer", ["cv2_gray", "cv2_colour", "pil_1", "pil_L", "pil_P",
                                    "pil_RGBA"])
def test_files_that_cv2_and_pillow_write_equal_cv2(tmp_path, writer):
    from PIL import Image

    path = tmp_path / "a.bmp"
    for h, w in SIZES + [(45, 71)]:
        im = codec_source(h + 2 * w, h, w)
        if writer.startswith("cv2"):
            cv2.imwrite(str(path), im[..., 1] if writer == "cv2_gray" else im)
        elif writer == "pil_1":
            Image.fromarray(im[..., 1] > 127).save(path)
        elif writer == "pil_L":
            Image.fromarray(im[..., 1]).save(path)
        elif writer == "pil_P":
            Image.fromarray(im).quantize(colors=50).save(path)
        else:
            Image.fromarray(np.concatenate([im, im[..., :1]], 2), "RGBA").save(path)
        _same_as_cv2(path)


@pytest.mark.parametrize("kind, feature", [(4, "JPEG"), (5, "PNG"), (6, "compression 6")])
def test_left_out_modes_raise_naming_the_feature(tmp_path, kind, feature):
    """A BMP holding JPEG or PNG data, or another compression: cv2 gives
    None; the port raises naming it."""
    from ayolov2_torch.data.image_io import imread

    payload = cv2.imencode(".jpg" if kind == 4 else ".png", codec_source(1, 8, 8))[1].tobytes()
    path = tmp_path / "a.bmp"
    path.write_bytes(bmp_file(payload, 8, 8, 24 if kind == 4 else 0, kind))
    assert cv2.imread(str(path)) is None
    with pytest.raises(OSError, match=feature) as err:
        imread(str(path))
    assert str(path) in str(err.value)


@pytest.mark.parametrize("kind", ["cut_pixels", "cut_palette", "header16", "width0", "huge",
                                  "colors300", "offset_past_end"])
def test_damaged_files_give_what_cv2_gives(tmp_path, kind):
    px = codec_source(3, 9, 10)
    good = bmp_file(_stored(bmp_rows(px.reshape(9, -1), 8), 9, False), 10, 9, 24)
    pal = bmp_file(bytes(12 * 9), 10, 9, 8, palette=np.zeros((256, 3)))
    data = {"cut_pixels": good[:-5], "cut_palette": pal[:54 + 500],
            "header16": good[:14] + struct.pack("<I", 16) + good[18:],
            "width0": good[:18] + struct.pack("<i", 0) + good[22:],
            "huge": good[:18] + struct.pack("<ii", 40000, 40000) + good[26:],
            "colors300": pal[:46] + struct.pack("<i", 300) + pal[50:],
            "offset_past_end": good[:10] + struct.pack("<i", 10 ** 6) + good[14:]}[kind]
    path = tmp_path / "a.bmp"
    path.write_bytes(data)
    _same_as_cv2(path)


def test_image_size_reads_the_header(tmp_path):
    """(w, h) of core, 40-byte and V5 headers, bottom-up and top-down, as
    PIL sizes them (the JAX package's ``exif_size``)."""
    from PIL import Image

    from ayolov2_tpu.data.datasets import exif_size
    from ayolov2_torch.data.image_io import image_size

    px = codec_source(4, 9, 10)
    for header, top in ((12, False), (40, False), (40, True), (124, True)):
        path = tmp_path / f"{header}_{top}.bmp"
        path.write_bytes(bmp_file(_stored(bmp_rows(px.reshape(9, -1), 8), 9, top), 10, 9, 24,
                                  header=header, top_down=top))
        with Image.open(path) as pil:
            assert image_size(str(path)) == exif_size(pil) == (10, 9)
