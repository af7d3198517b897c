"""The port's TIFF reader (``ayolov2_torch/data/codecs.decode_tiff``, LZW
and PackBits in ``csrc/raster_codec.cpp``, CCITT in ``csrc/fax_codec.cpp``,
JPEG strips through ``csrc/image_codec.cpp``) against the installed OpenCV
5.0 (libtiff 4.7.1 through its RGBA interface), the reference: both byte
orders, strips and tiles, planar configurations 1 and 2, no compression,
LZW (current and old bit order), PackBits and Deflate (8 and 32946),
predictor 2 at 8 and 16 bits (ignored without LZW or Deflate, as libtiff
ignores it), FillOrder 2, MinIsBlack and MinIsWhite at 1, 8 and 16 bits,
RGB at 8 and 16 bits with and without alpha (unassociated alpha
premultiplied), palettes with 8- and 16-bit colour maps, CMYK, YCbCr at
each subsampling libtiff puts (its coefficients and reference black and
white), JPEG strips and tiles (with and without JPEGTables, grey, RGB and
YCbCr, written by the port's encoder and by Pillow), CCITT RLE, RLEW,
Group 3 1D and 2D and Group 4 in both fill orders, cut and damaged, CIELab
at 8 and 16 bits, Orientation 1-8 (5-8 turn a square image and give None
for any other), the files OpenCV writes, and what cv2 refuses (depths,
subsamplings, ICCLab and ITULab, planar Lab, old-style JPEG and the
compressions its libtiff lacks, float samples), where the port raises
naming the feature. The files are written by ``chip_smoke.tiff_file``, by
Pillow and by ``_torch_codec_fixtures``.
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

sys.path.insert(0, str(Path(__file__).resolve().parent))
from _torch_codec_fixtures import mh_rows, mh_strip  # noqa: E402

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


def _pil_tiff(im, **kw) -> bytes:
    import io

    b = io.BytesIO()
    im.save(b, "TIFF", **kw)
    return b.getvalue()


def _bilevel(seed, h, w):
    from PIL import Image

    return Image.fromarray(codec_source(seed, h, w, gray=True) > 127)


@pytest.mark.parametrize("kind, feature", [
    ("jpeg", "JPEG"), ("old_jpeg", "old-style JPEG"), ("ccitt3", "CCITT"), ("ccitt4", "CCITT"),
    ("ycbcr", "YCbCr"), ("lab", "CIELab"), ("float", "float samples"), ("lzma", "LZMA")])
def test_left_out_modes_raise_naming_the_feature(tmp_path, kind, feature):
    """The modes cv2 reads (JPEG, CCITT Group 3 and 4, YCbCr, CIELab) equal
    ``cv2.imread``; those it refuses (old-style JPEG and LZMA, which its
    libtiff is built without, and float samples) give None there, and the
    port raises ``OSError`` naming the mode, cv2 installed or not, never
    handing the file to cv2."""
    from ayolov2_torch.data.image_io import imread

    img = codec_source(1, 16, 16)
    path = tmp_path / "a.tif"
    if kind in ("ccitt3", "ccitt4"):
        path.write_bytes(_pil_tiff(_bilevel(1, 16, 16), compression="group" + kind[-1]))
    else:
        kw = {"jpeg": dict(compression=7), "old_jpeg": dict(compression=6),
              "ycbcr": dict(photometric=6), "lab": dict(photometric=8),
              "float": dict(sample_format=3), "lzma": dict(compression=34925)}[kind]
        path.write_bytes(tiff_file(img, **kw))
    want = cv2.imread(str(path))
    if kind in ("jpeg", "ccitt3", "ccitt4", "ycbcr", "lab"):
        assert want is not None
        np.testing.assert_array_equal(imread(str(path)), want)
        return
    assert want is None
    with pytest.raises(OSError, match=feature) as err:
        imread(str(path))
    assert str(path) in str(err.value)


@pytest.mark.parametrize("compression", [1, 5, 32773, 8], ids=["none", "lzw", "packbits", "deflate"])
def test_fill_order_2_equals_cv2(tmp_path, compression):
    """FillOrder 2: libtiff reverses the bits of each stored strip or tile
    before unpacking it (TIFFReverseBits), for bilevel, grey, 16-bit and RGB
    samples, strips and tiles, with the predictor where it applies; an
    uncompressed tile whose size is not a multiple of 1024 bytes libtiff
    refuses (cv2 gives None, the port raises)."""
    rng = np.random.default_rng(compression)
    for k, (bits, spp, layout) in enumerate(itertools.product(
            (1, 8, 16), (1, 3), ("strip", "strips", "tiles"))):
        if bits == 1 and spp == 3:
            continue
        h, w = int(rng.integers(1, 50)), int(rng.integers(1, 50))
        img = rng.integers(0, 1 << bits, (h, w, spp)).astype(np.uint16 if bits == 16 else np.uint8)
        kw = dict(compression=compression, bits=bits, photometric=2 if spp == 3 else 0,
                  fill_order=2, predictor=2 if bits >= 8 and compression in (5, 8) else 1)
        if layout == "strips":
            kw["rows_per_strip"] = int(rng.integers(1, h + 1))
        if layout == "tiles":
            kw["tile"] = (16, 32) if k % 2 else (64, 16)
        path = tmp_path / f"{k}.tif"
        path.write_bytes(tiff_file(img, **kw))
        tw, th = kw.get("tile", (0, 0))
        tile_bytes = tw * th * spp * bits // 8
        assert (cv2.imread(str(path)) is None) == (
            compression == 1 and layout == "tiles" and tile_bytes % 1024 > 0)
        _same_as_cv2(path)
    from PIL import Image

    rgb = codec_source(2, 30, 41)[..., ::-1]
    for mode in ("1", "L", "RGB"):
        path = tmp_path / f"pil_{mode}.tif"
        comp = {1: "raw", 5: "tiff_lzw", 32773: "packbits", 8: "tiff_adobe_deflate"}[compression]
        path.write_bytes(_pil_tiff(Image.fromarray(np.ascontiguousarray(rgb)).convert(mode),
                                   compression=comp, tiffinfo={266: 2}))
        _same_as_cv2(path)


@pytest.mark.parametrize("sub", ["44", "42", "41", "22", "21", "12", "11"])
def test_ycbcr_subsamplings_equal_cv2(tmp_path, sub):
    """8-bit YCbCr packed in libtiff's sampling blocks: each compression,
    strips of any height and tiles (a clipped tile's rows as each put
    function steps them: putcontig8bitYCbCr44tile's skip of 10 bytes a
    block), partial blocks at the right and bottom edges, predictor 2 over
    the packed bytes (where libtiff's rows do not divide, the differences
    stay as decoded), YCbCrCoefficients and ReferenceBlackWhite given or
    defaulted, Orientation, and at 1x1 separate planes."""
    sh, sv = int(sub[0]), int(sub[1])
    rng = np.random.default_rng(int(sub))
    cases = list(itertools.product((1, 5, 32773, 8), ("strip", "strips", "tiles"), (1, 2)))
    for k, (comp, layout, pred) in enumerate(cases):
        if pred == 2 and comp not in (5, 8):
            continue
        h, w = int(rng.integers(1, 60)), int(rng.integers(1, 60))
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        kw = dict(photometric=6, subsampling=(sh, sv), compression=comp, predictor=pred)
        if layout == "strips":
            kw["rows_per_strip"] = int(rng.integers(1, h + 1))
        if layout == "tiles":
            kw["tile"] = (16, 16 * int(rng.integers(1, 3)))
        if k % 3 == 1:
            kw["tags"] = {532: (5, [(16, 1), (235, 1), (128, 1), (240, 1), (128, 1), (240, 1)]),
                          529: (5, [(2126, 10000), (7152, 10000), (722, 10000)])}
        if k % 5 == 2:
            kw["orientation"] = int(rng.integers(2, 5))
        if sub == "11" and k % 2:  # separate planes: putseparate8bitYCbCr11tile
            kw["planar"] = 2
        path = tmp_path / f"{k}.tif"
        path.write_bytes(tiff_file(img, **kw))
        assert cv2.imread(str(path)) is not None
        _same_as_cv2(path)


@pytest.mark.parametrize("case", ["planar_22", "planar_default", "sub_24", "sub_33"])
def test_ycbcr_modes_cv2_refuses_raise(tmp_path, case):
    """Subsamplings libtiff has no put function for (separate planes other
    than 1x1, 2x4) or rejects (3x3): cv2 gives None, the port raises."""
    from ayolov2_torch.data.image_io import imread

    img = np.random.default_rng(0).integers(0, 256, (20, 30, 3), dtype=np.uint8)
    kw = {"planar_22": dict(planar=2, subsampling=(2, 2)), "planar_default": dict(planar=2),
          "sub_24": dict(subsampling=(2, 4)), "sub_33": dict(subsampling=(3, 3))}[case]
    path = tmp_path / "a.tif"
    path.write_bytes(tiff_file(img, photometric=6, **kw))
    assert cv2.imread(str(path)) is None
    with pytest.raises(OSError, match="YCbCr subsampling"):
        imread(str(path))


@pytest.mark.parametrize("layout", ["strip", "strips", "tiles", "tables", "gray", "last_full",
                                    "frame_sizes", "pil"])
def test_jpeg_tiff_equals_cv2(tmp_path, layout):
    """Compression 7: each strip or tile its own JPEG, read after the
    JPEGTables stream where there is one, YCbCr through libjpeg's YCbCr ->
    RGB (libtiff's JPEGCOLORMODE_RGB), RGB and grey as stored; a last strip
    coded at the full RowsPerStrip is cut to its rows; a strip cut short
    reads on as libjpeg does. ``frame_sizes``: a frame narrower or shorter
    than its strip or tile fills it in part (libtiff only warns), one wider
    or taller is refused (cv2 gives None). ``pil``: Pillow's (libtiff's)
    RGB, YCbCr (1x1) and grey files at two qualities, and its YCbCr file
    without YCbCrSubsampling, which libtiff takes from the first strip."""
    from PIL import Image

    rng = np.random.default_rng(len(layout))
    if layout == "frame_sizes":
        for gray, tile in itertools.product((False, True), (None, (16, 32))):
            img = codec_source(1, 40, 48, gray=gray)
            img = img[..., None] if gray else np.ascontiguousarray(img[..., ::-1])
            data = tiff_file(img, compression=7, photometric=1, tile=tile, rows_per_strip=16)
            sh, sw = (32, 16) if tile else (16, 48)
            for k, (fh, fw) in enumerate(((sh - 8, sw), (sh, sw - 8), (sh + 4, sw), (sh, sw + 8))):
                path = tmp_path / f"{gray}_{tile}_{k}.tif"
                path.write_bytes(data.replace(struct.pack(">HH", sh, sw),
                                              struct.pack(">HH", fh, fw)))
                assert (cv2.imread(str(path)) is None) == (k >= 2)
                _same_as_cv2(path)
        return
    if layout == "pil":
        for q, mode in itertools.product((60, 95), ("RGB", "YCbCr", "L", "CMYK")):
            rgb = np.ascontiguousarray(codec_source(q, 37, 53)[..., ::-1])
            path = tmp_path / f"{q}_{mode}.tif"
            data = _pil_tiff(Image.fromarray(rgb).convert(mode), compression="jpeg", quality=q)
            path.write_bytes(data)
            _same_as_cv2(path)
            if mode == "YCbCr":  # the YCbCrSubsampling entry renamed YCbCrPositioning
                at = data.index(struct.pack("<HHI", 530, 3, 2))
                path.write_bytes(data[:at] + struct.pack("<H", 531) + data[at + 2:])
                assert cv2.imread(str(path)) is not None
                _same_as_cv2(path)
        return
    for k, (h, w) in enumerate([(45, 71), (64, 64), (5, 3), (33, 17)]):
        gray = layout == "gray"
        img = codec_source(k, h, w, gray=gray)
        img = img[..., None] if gray else np.ascontiguousarray(img[..., ::-1])
        kw = dict(compression=7, photometric=1, quality=int(rng.integers(50, 100)),
                  jpeg_tables=layout in ("tables", "gray"))
        if layout in ("strips", "gray", "last_full"):
            kw["rows_per_strip"] = 16
        if layout in ("tiles", "tables"):
            kw["tile"] = (16, 32)
        path = tmp_path / f"{k}.tif"
        if layout == "last_full":  # the last strip's JPEG holds 16 rows, the image fewer
            tall = np.concatenate([img, img[::-1]], 0)[: -(-h // 16) * 16]
            data = bytearray(tiff_file(tall, **kw))
            (ifd,) = struct.unpack_from("<I", data, 4)
            for i in range(struct.unpack_from("<H", data, ifd)[0]):
                at = ifd + 2 + 12 * i
                if struct.unpack_from("<H", data, at)[0] == 257:
                    struct.pack_into("<I", data, at + 8, h)
            path.write_bytes(bytes(data))
        else:
            path.write_bytes(tiff_file(img, **kw))
        assert cv2.imread(str(path)) is not None
        _same_as_cv2(path)


@pytest.mark.parametrize("mode", ["rle", "g3", "g3_2d", "g3_2d_fill", "g4"])
def test_ccitt_equals_cv2(tmp_path, mode):
    """Pillow's (libtiff's) CCITT files of bilevel images, MinIsBlack and
    MinIsWhite, in both fill orders, at widths that need the make-up codes
    of both colours (2600 pixels: the extended ones) and of one pixel, in
    one strip or several."""
    from PIL import Image

    comp, opts = {"rle": ("tiff_ccitt", None), "g3": ("group3", None), "g3_2d": ("group3", 1),
                  "g3_2d_fill": ("group3", 5), "g4": ("group4", None)}[mode]
    for k, ((h, w), fill, white, rps) in enumerate(itertools.product(
            [(37, 53), (12, 2600), (1, 1), (40, 9)], (1, 2), (False, True), (None, 7))):
        im = _bilevel(k, h, w)
        info = {}
        if opts is not None:
            info[292] = opts
        if fill == 2:
            info[266] = 2
        if white:
            info[262] = 0
        if rps:
            info[278] = rps
        path = tmp_path / f"{k}.tif"
        path.write_bytes(_pil_tiff(im.convert("1"), compression=comp, tiffinfo=info))
        assert cv2.imread(str(path)) is not None
        _same_as_cv2(path)


@pytest.mark.parametrize("mode", ["rle", "g3", "g3_2d", "g4"])
def test_damaged_ccitt_equals_cv2(tmp_path, mode):
    """Cut and corrupted CCITT strips read as libtiff reads them: a bad code
    ends its row, padded out, decoding going on; data that ends early ends
    the strip (its last row padded, the rows after it zero); a Group 3 strip
    that runs out while seeking an EOL switches libtiff to rows without EOLs
    and reads that row again from the strip's first bit."""
    comp, opts = {"rle": ("tiff_ccitt", None), "g3": ("group3", None), "g3_2d": ("group3", 1),
                  "g4": ("group4", None)}[mode]
    for h, w in ((40, 77), (9, 300)):
        info = {292: opts} if opts is not None else {}
        data = _pil_tiff(_bilevel(h + w, h, w), compression=comp, tiffinfo=info)
        (ifd,) = struct.unpack_from("<I", data, 4)
        tags = {}
        for i in range(struct.unpack_from("<H", data, ifd)[0]):
            tag, kind, _, value = struct.unpack_from("<HHII", data, ifd + 2 + 12 * i)
            tags[tag] = (ifd + 2 + 12 * i + 8, value if kind == 4 else value & 0xFFFF, kind)
        off, cnt = tags[273][1], tags[279][1]
        rng = np.random.default_rng(h)
        for k, cut in enumerate((3, cnt // 3, cnt // 2, cnt - 5)):
            zeroed = bytearray(data)
            zeroed[off + cut: off + cnt] = bytes(cnt - cut)
            cut_short = bytearray(data)
            struct.pack_into("<I" if tags[279][2] == 4 else "<H", cut_short, tags[279][0], cut)
            for name, d in (("zeroed", zeroed), ("cut", cut_short)):
                path = tmp_path / f"{w}_{name}{k}.tif"
                path.write_bytes(bytes(d))
                _same_as_cv2(path)
        for seed in range(8):
            bad = bytearray(data)
            for at in rng.integers(off, off + cnt, 2):
                bad[at] = int(rng.integers(0, 256))
            path = tmp_path / f"{w}_bad{seed}.tif"
            path.write_bytes(bytes(bad))
            _same_as_cv2(path)


@pytest.mark.parametrize("align", [8, 16], ids=["rle", "rlew"])
def test_modified_huffman_rows_equal_cv2(tmp_path, align):
    """Modified Huffman rows written here (``mh_strip``): compression 2
    byte-aligned, 32771 (RLEW) word-aligned, whose alignment libtiff takes
    from the data's address (a strip at an odd offset reads otherwise), and
    both fill orders."""
    rng = np.random.default_rng(align)
    for k, (w, odd, fill) in enumerate(itertools.product((20, 77, 140), (False, True), (1, 2))):
        rows = mh_rows(rng, w, 9)
        strip = mh_strip(rows, align)
        if fill == 2:
            strip = strip.translate(bytes(int(f"{i:08b}"[::-1], 2) for i in range(256)))
        head = tiff_file(np.zeros((9, w, 1), np.uint8), bits=1, photometric=0,
                         compression=2 if align == 8 else 32771, fill_order=fill)
        data = bytearray(head + bytes((len(head) + odd) % 2 == 0 and odd))
        (ifd,) = struct.unpack_from("<I", data, 4)
        for i in range(struct.unpack_from("<H", data, ifd)[0]):
            at = ifd + 2 + 12 * i
            tag = struct.unpack_from("<H", data, at)[0]
            if tag in (273, 279):
                struct.pack_into("<I", data, at + 8, len(data) if tag == 273 else len(strip))
        path = tmp_path / f"{k}.tif"
        path.write_bytes(bytes(data) + strip)
        assert cv2.imread(str(path)) is not None
        _same_as_cv2(path)


@pytest.mark.parametrize("bits", [8, 16])
def test_cielab_equals_cv2(tmp_path, bits):
    """CIELab through libtiff's TIFFCIELab16ToXYZ and TIFFXYZToRGB against
    the display_sRGB tables, in single precision: random samples, a grid of
    every a* and b* at several L*, the default D50 WhitePoint and a D65 one,
    strips and tiles, and (8 bits) Pillow's LAB file."""
    rng = np.random.default_rng(bits)
    dtype = np.uint16 if bits == 16 else np.uint8
    step = 257 if bits == 16 else 1
    grid = np.stack(np.meshgrid(np.arange(256), np.arange(256)), -1) * step
    for k, (lv, wp, tile) in enumerate(itertools.product(
            (0, 9, 20, 128, 255), (None, [(3127, 10000), (3290, 10000)]), (None, (32, 32)))):
        lab = np.concatenate([np.full((256, 256, 1), lv * step), grid], 2).astype(dtype)
        if k % 2:
            lab = rng.integers(0, 1 << bits, (40, 50, 3)).astype(dtype)
        path = tmp_path / f"{k}.tif"
        path.write_bytes(tiff_file(lab, bits=bits, photometric=8, tile=tile,
                                   tags={318: (5, wp)} if wp else None))
        assert cv2.imread(str(path)) is not None
        _same_as_cv2(path)
    if bits == 8:
        from PIL import Image

        path = tmp_path / "pil.tif"
        path.write_bytes(_pil_tiff(Image.fromarray(np.ascontiguousarray(
            codec_source(3, 45, 71)[..., ::-1])).convert("LAB")))
        _same_as_cv2(path)


@pytest.mark.parametrize("case, feature", [
    ("icclab", "ICCLab"), ("itulab", "ITULab"), ("lab_planar", "CIELab"),
    ("zstd", "ZSTD"), ("webp", "WebP"), ("dng_lossless", "DNG")])
def test_modes_cv2_refuses_raise(tmp_path, case, feature):
    """ICCLab and ITULab (libtiff's RGBA interface has no put for them),
    CIELab in separate planes, and ZSTD, WebP and DNG's lossless JPEG
    (compressions cv2's libtiff is built without): cv2.imread gives None,
    the port raises naming the mode."""
    from ayolov2_torch.data.image_io import imread

    img = np.random.default_rng(0).integers(0, 256, (20, 30, 3), dtype=np.uint8)
    kw = {"icclab": dict(photometric=9), "itulab": dict(photometric=10),
          "lab_planar": dict(photometric=8, planar=2), "zstd": dict(compression=50000),
          "webp": dict(compression=50001), "dng_lossless": dict(compression=34887)}[case]
    path = tmp_path / "a.tif"
    path.write_bytes(tiff_file(img, **kw))
    assert cv2.imread(str(path)) is None
    with pytest.raises(OSError, match=feature):
        imread(str(path))


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
    the JAX package's ``exif_size`` returns, also for each committed TIFF
    fixture (JPEG, CCITT, YCbCr and Lab among them)."""
    from PIL import Image

    from ayolov2_tpu.data.datasets import exif_size
    from ayolov2_torch.data.image_io import image_size

    import _torch_codec_fixtures as fx

    for path in fx.fixture_files():
        if path.suffix == ".tif":
            with Image.open(path) as pil:
                assert image_size(str(path)) == exif_size(pil), path.name

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
