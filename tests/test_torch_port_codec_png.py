"""The port's PNG reader (``ayolov2_torch/data/codecs.decode_png``, the pixel
stage in ``csrc/image_codec.cpp``) against the sandbox's OpenCV 5.0 (libpng
1.6.58), the reference: every colour type (0, 2, 3, 4, 6) at every bit depth
it allows, Adam7 and not, each row behind a random filter, ``tRNS``, palette
indices past the palette, an ``eXIf`` orientation; and damaged files (CRC
errors in critical and ancillary chunks, cut files, too little and too much
image data, a bad filter type, a size beyond cv2's limits) give what
``cv2.imread`` gives. The files are
written by the tests' own PNG writer (``_torch_codec_fixtures.png_file``),
since cv2 cannot write most of them.
"""

from __future__ import annotations

import itertools
import struct
import sys
import zlib
from pathlib import Path

import cv2  # the reference; the port never imports it
import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent))

from _torch_codec_fixtures import PNG_DEPTHS, chunk, png_file  # noqa: E402

SIZES = [(1, 1), (3, 5), (13, 17), (40, 33)]


def _same_as_cv2(path: Path):
    """``imread`` equals ``cv2.imread``, or raises ``OSError`` where cv2
    gives None or refuses the size (cv2.error)."""
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


@pytest.mark.parametrize("ctype", list(PNG_DEPTHS))
@pytest.mark.parametrize("interlace", [0, 1], ids=["plain", "adam7"])
def test_decode_equals_cv2(tmp_path, ctype, interlace):
    """Each depth and size of one colour type, with and without tRNS."""
    for depth, (h, w), trns in itertools.product(PNG_DEPTHS[ctype], SIZES, (False, True)):
        if trns and ctype in (4, 6):
            continue  # tRNS is not allowed beside an alpha channel
        path = tmp_path / f"{depth}_{h}x{w}_{trns}.png"
        path.write_bytes(png_file(h * w + depth, w, h, depth, ctype, interlace, trns=trns))
        _same_as_cv2(path)


def test_exif_orientation_is_applied_as_cv2(tmp_path):
    for o in range(1, 9):
        path = tmp_path / f"e{o}.png"
        path.write_bytes(png_file(o, 7, 4, 8, 2, exif=o))
        _same_as_cv2(path)


def _damaged(kind: str) -> bytes:
    good = png_file(3, 13, 9, 8, 2, trns=True)
    data = bytearray(good)
    if kind.startswith("crc_"):
        name = {"crc_ihdr": b"IHDR", "crc_idat": b"IDAT", "crc_trns": b"tRNS"}[kind]
        at = data.index(name)
        (n,) = struct.unpack(">I", data[at - 4: at])
        data[at + 4 + n] ^= 1
        return bytes(data)
    if kind == "no_iend":
        return good[:-12]
    if kind.startswith("cut_"):
        return good[: int(len(good) * float(kind[4:]))]
    if kind == "short_data":
        return png_file(3, 13, 9, 8, 2)[:33] + chunk(b"IDAT", zlib.compress(bytes(20))) \
            + chunk(b"IEND", b"")
    if kind == "extra_data":
        return png_file(3, 13, 9, 8, 2, extra_rows=2)
    if kind == "bad_filter":
        raw = bytearray(zlib.decompress(png_file(3, 13, 9, 8, 0)[41:-16]))
        raw[0] = 7
        return png_file(3, 13, 9, 8, 0)[:33] + chunk(b"IDAT", zlib.compress(bytes(raw))) \
            + chunk(b"IEND", b"")
    if kind == "not_first":
        return good[:8] + chunk(b"tEXt", b"a\0b") + good[8:]
    if kind == "huge":  # beyond cv2's CV_IO_MAX_IMAGE_PIXELS
        return (good[:8] + chunk(b"IHDR", struct.pack(">IIBBBBB", 40000, 40000, 8, 2, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(bytes(100))) + chunk(b"IEND", b""))
    raise ValueError(kind)


@pytest.mark.parametrize("kind", ["crc_ihdr", "crc_idat", "crc_trns", "no_iend", "cut_0.3",
                                  "cut_0.7", "cut_0.95", "short_data", "extra_data",
                                  "bad_filter", "not_first", "huge"])
def test_damaged_files_give_what_cv2_gives(tmp_path, kind):
    path = tmp_path / "a.png"
    path.write_bytes(_damaged(kind))
    _same_as_cv2(path)


def test_read_png_takes_every_png(tmp_path):
    """``utils/png.read_png``: BGR for colour files, one channel for gray
    ones, as the plots' round trip reads them."""
    from ayolov2_torch.utils.png import read_png

    for ctype, depth in [(0, 1), (0, 16), (2, 16), (3, 4), (4, 8), (6, 8)]:
        path = tmp_path / f"{ctype}_{depth}.png"
        path.write_bytes(png_file(ctype + depth, 11, 6, depth, ctype, interlace=1))
        want = cv2.imread(str(path))
        got = read_png(path)
        np.testing.assert_array_equal(got, want[..., 0] if ctype in (0, 4) else want)
