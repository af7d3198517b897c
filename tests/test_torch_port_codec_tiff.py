"""The port's TIFF reader (``ayolov2_torch/data/codecs.decode_tiff``, LZW
and PackBits in ``csrc/raster_codec.cpp``) against the installed OpenCV 5.0
(libtiff 4.7.1 through its RGBA interface), the reference: both byte
orders, strips and tiles, planar configurations 1 and 2, no compression,
LZW (current and old bit order), PackBits and Deflate (8 and 32946),
predictor 2 at 8 and 16 bits (ignored without LZW or Deflate, as libtiff
ignores it), MinIsBlack and MinIsWhite at 1, 8 and 16 bits, RGB at 8 and 16
bits with and without alpha (unassociated alpha premultiplied), palettes
with 8- and 16-bit colour maps, CMYK, Orientation 1-8 (5-8 turn a square
image and give None for any other), the
files OpenCV writes, and the depths cv2 refuses. The modes the port leaves
out (JPEG and CCITT compression, YCbCr and Lab, float samples) raise naming
the feature, cv2 or not. The files are written by ``chip_smoke.tiff_file``.
"""

from __future__ import annotations

import itertools
import struct
import sys
from pathlib import Path

import cv2  # the reference; the port never imports it
import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402
from chip_smoke import codec_source, tiff_file  # noqa: E402

# (photometric, bits, samples, ExtraSamples)
KINDS = {"gray8": (1, 8, 1, None), "white8": (0, 8, 1, None), "gray16": (1, 16, 1, None),
         "white16": (0, 16, 1, None), "bilevel": (1, 1, 1, None), "white1": (0, 1, 1, None),
         "gray_alpha": (1, 8, 2, (2,)), "gray16_alpha": (1, 16, 2, (1,)), "gray3": (1, 8, 3, None),
         "rgb8": (2, 8, 3, None), "rgb16": (2, 16, 3, None), "rgba_unassoc": (2, 8, 4, (2,)),
         "rgba_assoc": (2, 8, 4, (1,)), "rgba_none": (2, 8, 4, None),
         "rgba16_unassoc": (2, 16, 4, (2,)), "pal8": (3, 8, 1, None), "pal4": (3, 4, 1, None),
         "pal1": (3, 1, 1, None), "pal2": (3, 2, 1, None), "cmyk": (5, 8, 4, None),
         "gray4": (1, 4, 1, None), "rgb4": (2, 4, 3, None), "cmyk16": (5, 16, 4, None)}


def _same_as_cv2(path: Path):
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


@pytest.mark.parametrize("kind", list(KINDS))
def test_samples_and_layouts_equal_cv2(tmp_path, kind):
    """One photometric and depth under each compression, predictor, planar
    configuration, strip or tile layout and byte order (a random half of
    the combinations, each at a random size)."""
    photo, bits, spp, extra = KINDS[kind]
    rng = np.random.default_rng(sum(map(ord, kind)))
    cases = list(itertools.product((1, 5, 32773, 8, 32946), (1, 2), (1, 2),
                                   ("strip", "strips", "tiles"), (True, False)))
    for k in rng.permutation(len(cases))[: len(cases) // 4]:
        comp, pred, planar, layout, little = cases[k]
        h, w = int(rng.integers(1, 50)), int(rng.integers(1, 50))
        img = rng.integers(0, 1 << bits, (h, w, spp)).astype(np.uint16 if bits == 16 else np.uint8)
        cmap = None
        if photo == 3:
            cmap = rng.integers(0, 1 << 16 if k % 3 else 256, (3, 1 << bits))
        kw = dict(little=little, compression=comp, predictor=pred if bits >= 8 else 1,
                  planar=planar, photometric=photo, bits=bits, colormap=cmap, extra_samples=extra)
        if layout == "strips":
            kw["rows_per_strip"] = int(rng.integers(1, h + 1))
        if layout == "tiles":
            kw["tile"] = (16 * int(rng.integers(1, 3)), 16 * int(rng.integers(1, 3)))
        path = tmp_path / f"{k}.tif"
        path.write_bytes(tiff_file(img, **kw))
        _same_as_cv2(path)


@pytest.mark.parametrize("layout", ["strip", "strips", "tiles"])
def test_orientations_equal_cv2(tmp_path, layout):
    """Orientation 1-4 as libtiff applies them (each tile mirrored within
    itself); 5-8 of a square image as cv2 5.0 turns it, of any other None
    (cv2 5.0), where the port raises naming the tag."""
    from ayolov2_torch.data.image_io import imread

    rng = np.random.default_rng(7)
    for o, square in itertools.product(range(1, 9), (False, True)):
        h, w = int(rng.integers(2, 50)), int(rng.integers(2, 50))
        w = h if square else w + (w == h)
        kw = dict(orientation=o)
        if layout == "strips":
            kw["rows_per_strip"] = 5
        if layout == "tiles":
            kw["tile"] = (16, 32)
        for i, img in enumerate((codec_source(o, h, w)[..., ::-1],
                                 rng.integers(0, 1 << 16, (h, w, 1)).astype(np.uint16))):
            path = tmp_path / f"{o}_{square}_{i}.tif"
            path.write_bytes(tiff_file(img, bits=16 if i else 8, photometric=1 if i else 2, **kw))
            _same_as_cv2(path)
            if o >= 5 and not square:
                with pytest.raises(OSError, match="Orientation"):
                    imread(str(path))


@pytest.mark.parametrize("compression", [1, 5, 32773, 8])
def test_files_that_cv2_writes_equal_cv2(tmp_path, compression):
    for (h, w), gray in itertools.product([(1, 1), (45, 71), (300, 200)], (False, True)):
        im = codec_source(h + w, h, w, gray=gray)
        path = tmp_path / f"{h}x{w}_{gray}.tif"
        assert cv2.imwrite(str(path), im, [cv2.IMWRITE_TIFF_COMPRESSION, compression])
        _same_as_cv2(path)
        v16 = (codec_source(h * w, h, w).astype(np.uint16) * 251)
        assert cv2.imwrite(str(path), v16, [cv2.IMWRITE_TIFF_COMPRESSION, compression])
        _same_as_cv2(path)


@pytest.mark.parametrize("compat", [False, True], ids=["msb", "old_lsb"])
def test_lzw_bit_orders_equal_cv2(tmp_path, compat, monkeypatch):
    """LZW of smooth and noisy data long enough to fill the table (Clear
    codes), in the current order and in the old LSB-first order, which
    libtiff recognises by its first bytes."""
    real = chip_smoke.lzw
    monkeypatch.setattr(chip_smoke, "lzw", lambda data, compat_=compat: real(data, compat=compat_))
    rng = np.random.default_rng(int(compat))
    for h, w in ((40, 33), (120, 150)):
        for img in (codec_source(h, h, w), rng.integers(0, 256, (h, w, 3), dtype=np.uint8)):
            path = tmp_path / "a.tif"
            path.write_bytes(chip_smoke.tiff_file(img, compression=5, rows_per_strip=h // 3 + 1))
            _same_as_cv2(path)


@pytest.mark.parametrize("kind, feature", [
    ("jpeg", "JPEG"), ("old_jpeg", "old-style JPEG"), ("ccitt3", "CCITT"), ("ccitt4", "CCITT"),
    ("ycbcr", "YCbCr"), ("lab", "CIELab"), ("float", "float samples"), ("lzma", "LZMA")])
def test_left_out_modes_raise_naming_the_feature(tmp_path, kind, feature):
    """With cv2 installed or not, the port raises ``OSError`` naming the
    mode, never hands the file to cv2."""
    from ayolov2_torch.data.image_io import imread

    img = codec_source(1, 16, 16)
    kw = {"jpeg": dict(compression=7), "old_jpeg": dict(compression=6),
          "ccitt3": dict(compression=3), "ccitt4": dict(compression=4),
          "ycbcr": dict(photometric=6), "lab": dict(photometric=8),
          "float": dict(sample_format=3), "lzma": dict(compression=34925)}[kind]
    path = tmp_path / "a.tif"
    path.write_bytes(tiff_file(img, **kw))
    with pytest.raises(OSError, match=feature) as err:
        imread(str(path))
    assert str(path) in str(err.value)


def test_only_the_first_image_is_read(tmp_path):
    """Only IFD0 is read: a second image after it is ignored, as cv2.imread
    reads the first page."""
    from ayolov2_torch.data.image_io import image_size, imread

    a, b = codec_source(1, 20, 30), codec_source(2, 25, 35)
    first = tiff_file(a[..., ::-1])
    second = tiff_file(b[..., ::-1])
    (ifd,) = struct.unpack_from("<I", first, 4)
    n = struct.unpack_from("<H", first, ifd)[0]
    end = ifd + 2 + 12 * n
    assert first[end: end + 4] == bytes(4)  # no next IFD yet
    path = tmp_path / "two.tif"
    path.write_bytes(first + second[8:])  # the second file's data and IFD after the first
    _same_as_cv2(path)
    assert image_size(str(path)) == (30, 20)
    np.testing.assert_array_equal(imread(str(path)), a)


def test_image_size_equals_exif_size(tmp_path):
    """(w, h) from IFD0 as PIL sizes it (turned for Orientation 5-8), which
    the JAX package's ``exif_size`` returns."""
    from PIL import Image

    from ayolov2_tpu.data.datasets import exif_size
    from ayolov2_torch.data.image_io import image_size

    for o in range(1, 9):
        for little in (True, False):
            path = tmp_path / f"{o}_{little}.tif"
            path.write_bytes(tiff_file(codec_source(o, 20, 30), orientation=o, little=little))
            with Image.open(path) as pil:
                assert image_size(str(path)) == exif_size(pil), (o, little)


@pytest.mark.parametrize("little", [True, False], ids=["II", "MM"])
def test_bigtiff_equals_cv2(tmp_path, little):
    """The BigTIFF header (43, 8-byte offsets) over strips and tiles."""
    rng = np.random.default_rng(int(little))
    for kw in (dict(), dict(compression=5, predictor=2, rows_per_strip=7),
               dict(compression=8, tile=(16, 32)), dict(bits=16, photometric=1)):
        h, w = int(rng.integers(1, 50)), int(rng.integers(1, 50))
        img = (rng.integers(0, 1 << 16, (h, w, 1)).astype(np.uint16) if kw.get("bits") == 16
               else codec_source(h * w, h, w)[..., ::-1])
        path = tmp_path / f"{len(kw)}.tif"
        path.write_bytes(tiff_file(img, little=little, big=True, **kw))
        _same_as_cv2(path)


@pytest.mark.parametrize("photometric, bits, samples", [(2, 8, 3), (32803, 16, 1),
                                                        (34892, 16, 3)],
                         ids=["preview", "cfa", "linear_raw"])
def test_dng_ifd0_gives_what_cv2_gives(tmp_path, photometric, bits, samples):
    """A ``.dng`` is a TIFF whose IFD0 cv2 reads through libtiff: a baseline
    preview reads as any TIFF; a CFA or LinearRaw IFD0 gives None there, and
    the port raises naming the photometric."""
    from ayolov2_torch.data.image_io import imread

    rng = np.random.default_rng(photometric)
    img = rng.integers(0, 1 << bits, (20, 30, samples)).astype(np.uint16 if bits == 16
                                                                else np.uint8)
    path = tmp_path / "a.dng"
    path.write_bytes(tiff_file(img, photometric=photometric, bits=bits))
    _same_as_cv2(path)
    if photometric != 2:
        with pytest.raises(OSError, match="CFA|LinearRaw"):
            imread(str(path))
