"""The committed image fixtures of the port's codecs and their manifest.

``tests/res/torch_codec/`` holds small JPEGs written by OpenCV (each chroma
sampling, progressive, restart markers, gray, a 16-bit quantisation table, no
Huffman tables, EXIF orientations 1-8, a baseline and a progressive file cut
short, and a 640x480 progressive file that the card's phase also times) and by
Pillow (CMYK, and the same file marked YCCK); PNGs of every colour type and bit
depth (Adam7, ``tRNS``, ``eXIf``) written by :func:`png_file`; BMPs written by
OpenCV (gray: an 8-bit palette), by Pillow (1- and 8-bit palettes, 32-bit RGBA)
and here (RLE8 and RLE4 with end-of-line, delta and end-of-bitmap escapes,
4-bit, BI_BITFIELDS 565 and 32-bit, 16-bit 555, a core header, a V5 header,
top-down rows); TIFFs written by OpenCV (no compression, LZW, PackBits,
Deflate), by ``chip_smoke.tiff_file`` (big-endian, tiled, planar configuration
2, predictor 2 at 8 and 16 bits, 16-bit gray, palettes, MinIsWhite, bilevel,
unassociated alpha, CMYK, Orientation 3, YCbCr at each subsampling libtiff
puts, JPEG strips and tiles from the port's encoder with and without
JPEGTables, FillOrder 2 and RLEW rows from :func:`mh_strip`)
and by Pillow (JPEG in RGB, YCbCr and grey, CCITT RLE, Group 3 1D and 2D,
Group 4 in both fill orders and at 640x480, which the card's phase 16.4 times,
and CIELab); lossless JPEGs (:func:`lossless_jpeg`) and arithmetic-coded ones
(:func:`arith_jpeg`, and an OpenCV progressive file marked SOF10); WebPs
written by OpenCV (lossless and quality 90, and at 640x480 lossless and
quality 75, which the card's phase 16.5 validates and 16.4 times) and by
Pillow (EXIF orientations 5-8, alpha, an animation). ``manifest.json``
records each file's ``cv2.imread`` shape and sha256, for a left-out mode (none
now) the feature the port names when it raises, and for an OpenCV JPEG its
source (``chip_smoke.codec_source``: seed, size, gray), quality and the sha256
of ``cv2.imencode`` of the source at that quality. The JPEG modes that cv2
refuses (12-bit samples, lossless grey or YCbCr) are written by
:func:`jpeg12` and :func:`lossless_jpeg` in the tests. ``chip_smoke.py``
phase 16 holds the port's codecs on the card's machine, which has no OpenCV,
against these digests.

Write them again (with OpenCV and Pillow): ``python tests/_torch_codec_fixtures.py``.
"""

from __future__ import annotations

import binascii
import hashlib
import json
import struct
import sys
import zlib
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
FIXTURES = ROOT / "tests/res/torch_codec"
sys.path.insert(0, str(ROOT))

from chip_smoke import (bmp_file, bmp_rows, codec_source, exif_app1,  # noqa: E402
                        synthetic_image, tiff_file, with_exif)

JPEG_H, JPEG_W = 45, 71  # a partial MCU at the right and bottom edges
PNG_H, PNG_W = 19, 27
SAMPLING = {"411": 0x411111, "420": 0x221111, "422": 0x211111, "440": 0x121111,
            "444": 0x111111}
PNG_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
         (0, 1, 1, 2))


# ---- JPEG ------------------------------------------------------------------------------


def segments(jpeg: bytes):
    """(marker, start of its FF, end) of each segment before the first SOS."""
    pos = 2
    while True:
        m = jpeg[pos + 1]
        end = pos + 2 + struct.unpack(">H", jpeg[pos + 2: pos + 4])[0]
        yield m, pos, end
        if m == 0xDA:
            return
        pos = end


def dqt_16bit(jpeg: bytes) -> bytes:
    """``jpeg`` with each DQT table stored with 16-bit entries (Pq = 1): the
    same values, so the same pixels; SOF0 becomes SOF1 (extended)."""
    out, pos = [], 0
    for m, start, end in segments(jpeg):
        if m == 0xDB:
            body, tables = jpeg[start + 4: end], b""
            i = 0
            while i < len(body):
                assert body[i] >> 4 == 0
                vals = body[i + 1: i + 65]
                tables += bytes([0x10 | (body[i] & 15)]) + b"".join(struct.pack(">H", v) for v in vals)
                i += 65
            out += [jpeg[pos:start], b"\xff\xdb" + struct.pack(">H", len(tables) + 2) + tables]
            pos = end
        elif m == 0xC0:
            out += [jpeg[pos:start], b"\xff\xc1"]
            pos = start + 2
    return b"".join(out) + jpeg[pos:]


def without_dht(jpeg: bytes) -> bytes:
    """``jpeg`` with its DHT segments taken out (a Motion-JPEG frame): the
    decoder takes the standard tables, which the encoder used."""
    out, pos = [], 0
    for m, start, end in segments(jpeg):
        if m == 0xC4:
            out.append(jpeg[pos:start])
            pos = end
    return b"".join(out) + jpeg[pos:]


def jpeg_fixtures():
    """name -> (bytes, source description): every JPEG fixture."""
    import cv2

    def enc(src, q, *params):
        ok, buf = cv2.imencode(".jpg", src, [cv2.IMWRITE_JPEG_QUALITY, q, *params])
        assert ok
        return buf.tobytes()

    out = {}
    for k, (name, factor) in enumerate(SAMPLING.items()):
        src = dict(seed=100 + k, h=JPEG_H, w=JPEG_W, gray=False, quality=90)
        out[f"j{name}.jpg"] = (enc(codec_source(100 + k, JPEG_H, JPEG_W), 90,
                                   cv2.IMWRITE_JPEG_SAMPLING_FACTOR, factor), src)
    base = dict(seed=110, h=JPEG_H, w=JPEG_W, gray=False)
    img = codec_source(110, JPEG_H, JPEG_W)
    out["jprog.jpg"] = (enc(img, 75, cv2.IMWRITE_JPEG_PROGRESSIVE, 1), dict(base, quality=75))
    # cut short: zero-bit padding, and libjpeg's block smoothing of a progressive file
    seq = enc(img, 85)
    out["jcut.jpg"] = (seq[: seq.index(b"\xff\xda") + 300], dict(base, quality=85))
    prog = enc(img, 85, cv2.IMWRITE_JPEG_PROGRESSIVE, 1)
    fourth_scan = [i for i in range(len(prog) - 1) if prog[i: i + 2] == b"\xff\xda"][3]
    out["jprogcut.jpg"] = (prog[: fourth_scan + 30], dict(base, quality=85))
    big = dict(seed=112, h=480, w=640, gray=False, quality=75)  # timed on the card too
    out["jprog640.jpg"] = (enc(codec_source(112, 480, 640), 75, cv2.IMWRITE_JPEG_PROGRESSIVE, 1),
                           big)
    out["jrst.jpg"] = (enc(img, 85, cv2.IMWRITE_JPEG_RST_INTERVAL, 3), dict(base, quality=85))
    out["jdqt16.jpg"] = (dqt_16bit(enc(img, 95)), dict(base, quality=95))
    out["jstd.jpg"] = (without_dht(enc(img, 95)), dict(base, quality=95))
    gray = codec_source(111, JPEG_H, JPEG_W, gray=True)
    out["jgray.jpg"] = (enc(gray, 95), dict(seed=111, h=JPEG_H, w=JPEG_W, gray=True, quality=95))
    for o in range(1, 9):
        out[f"jexif{o}.jpg"] = (with_exif(enc(img, 95), o, little=o % 2 == 1),
                                dict(base, quality=95))
    return out


# ---- PNG -------------------------------------------------------------------------------


def chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", binascii.crc32(kind + body) & 0xFFFFFFFF))


def _pack(samples: np.ndarray, depth: int) -> bytes:
    """One row of samples at ``depth`` bits, big-endian, packed MSB first."""
    if depth == 8:
        return samples.astype(np.uint8).tobytes()
    if depth == 16:
        return samples.astype(">u2").tobytes()
    per = 8 // depth
    v = np.zeros(-(-len(samples) // per) * per, np.int64)
    v[: len(samples)] = samples
    v = v.reshape(-1, per)
    packed = np.zeros(len(v), np.int64)
    for i in range(per):
        packed = (packed << depth) | v[:, i]
    return packed.astype(np.uint8).tobytes()


def _filter(rows, bpp: int, rng) -> bytes:
    """Each row behind a random filter type (0-4)."""
    out, prev = [], np.zeros(len(rows[0]), np.int64)
    for r in rows:
        x = np.frombuffer(r, np.uint8).astype(np.int64)
        f = int(rng.integers(0, 5))
        res = np.empty_like(x)
        for i in range(len(x)):
            a = x[i - bpp] if i >= bpp else 0
            b, c = prev[i], (prev[i - bpp] if i >= bpp else 0)
            if f == 4:
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
            else:
                pred = (0, a, b, (a + b) >> 1)[f]
            res[i] = (x[i] - pred) & 255
        out.append(bytes([f]) + res.astype(np.uint8).tobytes())
        prev = x
    return b"".join(out)


def png_file(seed: int, w: int, h: int, depth: int, ctype: int, interlace: int = 0,
             trns: bool = False, exif: int = 0, n_palette: int = 7, extra_rows: int = 0) -> bytes:
    """A PNG of random samples (a palette of ``n_palette`` entries, indices up
    to ``n_palette`` + 1, so some fall past it), rows behind random filters;
    ``trns`` adds a tRNS chunk, ``exif`` an eXIf chunk with that orientation
    after IDAT; ``extra_rows`` appends rows past the image to the stream."""
    rng = np.random.default_rng(seed)
    ch = PNG_CHANNELS[ctype]
    top = n_palette + 2 if ctype == 3 else 1 << depth
    img = rng.integers(0, min(top, 1 << depth), (h, w, ch))
    bpp = max(1, ch * depth // 8)
    raw = b""
    for x0, y0, dx, dy in (ADAM7 if interlace else ((0, 0, 1, 1),)):
        sub = img[y0::dy, x0::dx]
        if sub.size:
            raw += _filter([_pack(r.ravel(), depth) for r in sub], bpp, rng)
    raw += bytes(extra_rows * (len(_pack(img[0].ravel(), depth)) + 1))
    body = chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, interlace))
    if ctype == 3:
        body += chunk(b"PLTE", rng.integers(0, 256, 3 * n_palette).astype(np.uint8).tobytes())
    if trns:
        body += chunk(b"tRNS", {0: bytes([0, 9]), 2: bytes([0, 9] * 3)}.get(ctype, bytes([128, 7])))
    body += chunk(b"IDAT", zlib.compress(raw))
    if exif:
        body += chunk(b"eXIf", exif_app1(exif)[10:])
    return b"\x89PNG\r\n\x1a\n" + body + chunk(b"IEND", b"")


def png_fixtures():
    out = {}
    for ctype, depths in PNG_DEPTHS.items():
        for depth in depths:
            out[f"p{ctype}_{depth}.png"] = png_file(ctype * 100 + depth, PNG_W, PNG_H, depth, ctype)
    out["p2_8_adam7.png"] = png_file(7, PNG_W, PNG_H, 8, 2, interlace=1)
    out["p3_4_adam7_trns.png"] = png_file(8, PNG_W, PNG_H, 4, 3, interlace=1, trns=True)
    out["p0_16_trns.png"] = png_file(9, PNG_W, PNG_H, 16, 0, trns=True)
    out["p2_8_exif6.png"] = png_file(10, PNG_W, PNG_H, 8, 2, exif=6)
    return out


# ---- BMP, TIFF, WebP and CMYK JPEG -------------------------------------------------------

IMG_H, IMG_W = 45, 71  # each fixture's size, as the JPEGs'


def rle(idx: np.ndarray, bits: int, delta_row: int = -1) -> bytes:
    """BMP RLE8 (``bits`` 8) or RLE4 data of (h, w) palette indices, rows in
    file order: runs of three or more as encoded runs, the rest as absolute
    runs (or encoded runs of one or two); each row ends with end-of-line,
    the last with end-of-bitmap. Row ``delta_row`` is skipped by a delta
    escape halfway along it (its pixels left to palette entry 0) and an
    end-of-line, the delta moving right only, as OpenCV reads it in RLE4."""
    out = bytearray()
    h, w = idx.shape
    for y, row in enumerate(idx.tolist()):
        x = 0
        if y == delta_row:
            out += bytes([0, 2, w // 2, 0, 0, 0])
            continue
        while x < w:
            n = 1
            while x + n < w and row[x + n] == row[x] and n < 255:
                n += 1
            if n >= 3 or w - x < 3:
                c = row[x] if bits == 8 else row[x] << 4 | row[x]
                out += bytes([n, c])
                x += n
                continue
            k = 3
            while x + k < w and k < 255 and row[x + k] != row[x + k - 1]:
                k += 1
            vals = row[x: x + k]
            if bits == 8:
                body = bytes(vals)
            else:
                vals = vals + [0] * (k % 2)
                body = bytes(a << 4 | b for a, b in zip(vals[::2], vals[1::2]))
            out += bytes([0, k]) + body + bytes(len(body) % 2)
            x += k
        out += bytes([0, 1]) if y == h - 1 else bytes([0, 0])
    return bytes(out)


def _stored(rows: bytes, h: int) -> bytes:
    """BMP rows given top first, stored bottom-up."""
    n = len(rows) // h
    return b"".join(rows[i * n: (i + 1) * n] for i in range(h - 1, -1, -1))


def bmp_fixtures() -> dict:
    import io

    import cv2
    from PIL import Image

    rng = np.random.default_rng(200)
    h, w = IMG_H, IMG_W
    img = codec_source(200, h, w)
    out = {}
    ok, buf = cv2.imencode(".bmp", codec_source(201, h, w, gray=True))
    out["bgray_cv2.bmp"] = buf.tobytes()

    def pil(im, mode):
        b = io.BytesIO()
        Image.fromarray(im, mode).save(b, "BMP")
        return b.getvalue()

    out["bp1_pil.bmp"] = pil((codec_source(202, h, w, gray=True) > 127), "1")
    pal_img = Image.fromarray(img[..., ::-1]).quantize(colors=200, method=Image.Quantize.MEDIANCUT)
    b = io.BytesIO()
    pal_img.save(b, "BMP")
    out["bp8_pil.bmp"] = b.getvalue()
    rgba = np.concatenate([img[..., ::-1], rng.integers(0, 256, (h, w, 1), dtype=np.uint8)], 2)
    out["brgba_pil.bmp"] = pil(rgba, "RGBA")
    pal16 = rng.integers(0, 256, (16, 3))
    pal256 = rng.integers(0, 256, (256, 3))
    idx4 = (codec_source(203, h, w, gray=True) // 64).astype(np.int64)  # runs and changes
    idx8 = (codec_source(204, h, w, gray=True) // 8).astype(np.int64)
    out["brle8.bmp"] = bmp_file(rle(idx8[::-1], 8, delta_row=7), w, h, 8, 1, palette=pal256)
    out["brle4.bmp"] = bmp_file(rle(idx4[::-1], 4, delta_row=7), w, h, 4, 2, palette=pal16)
    out["b4.bmp"] = bmp_file(_stored(bmp_rows(idx4, 4), h), w, h, 4, palette=pal16, colors_used=16)
    v16 = rng.integers(0, 1 << 16, (h, w))
    out["b565.bmp"] = bmp_file(_stored(bmp_rows(v16, 16), h), w, h, 16, 3,
                               masks=(0xF800, 0x7E0, 0x1F))
    out["b555.bmp"] = bmp_file(_stored(bmp_rows(v16, 16), h), w, h, 16)
    bgra = np.concatenate([img, rng.integers(0, 256, (h, w, 1))], 2).reshape(h, -1)
    out["b32bf.bmp"] = bmp_file(_stored(bmp_rows(bgra, 8), h), w, h, 32, 3,
                                masks=(0xFF0000, 0xFF00, 0xFF, 0xFF000000))
    out["bcore8.bmp"] = bmp_file(_stored(bmp_rows(idx8, 8), h), w, h, 8, palette=pal256,
                                 header=12)
    out["bcore24.bmp"] = bmp_file(_stored(bmp_rows(img.reshape(h, -1), 8), h), w, h, 24,
                                  header=12)
    out["btopdown.bmp"] = bmp_file(bmp_rows(img.reshape(h, -1), 8), w, h, 24, top_down=True)
    out["bv5.bmp"] = bmp_file(_stored(bmp_rows(img.reshape(h, -1), 8), h), w, h, 24, header=124)
    return out


def tiff_fixtures() -> dict:
    import cv2

    rng = np.random.default_rng(300)
    h, w = IMG_H, IMG_W
    img = codec_source(300, h, w)
    rgb = np.ascontiguousarray(img[..., ::-1])
    out = {}
    for name, comp in (("none", 1), ("lzw", 5), ("packbits", 32773), ("deflate", 8)):
        ok, buf = cv2.imencode(".tif", img, [cv2.IMWRITE_TIFF_COMPRESSION, comp])
        out[f"t{name}_cv2.tif"] = buf.tobytes()
    out["tmm_lzw_pred.tif"] = tiff_file(rgb, little=False, compression=5, predictor=2,
                                        rows_per_strip=8)
    out["ttiled.tif"] = tiff_file(rgb, compression=8, tile=(32, 16))
    out["tplanar.tif"] = tiff_file(rgb, compression=32773, planar=2, rows_per_strip=10)
    v16 = (rgb.astype(np.uint16) * 257 + rng.integers(0, 257, rgb.shape)).astype(np.uint16)
    out["t16_lzw_pred.tif"] = tiff_file(v16, bits=16, compression=5, predictor=2)
    out["tgray16.tif"] = tiff_file(v16[..., :1], bits=16, photometric=1, compression=32946,
                                   little=False)
    idx = (codec_source(301, h, w, gray=True) // 4)
    out["tpal8.tif"] = tiff_file(idx[..., None], photometric=3,
                                 colormap=rng.integers(0, 1 << 16, (3, 256)))
    out["tpal4.tif"] = tiff_file((idx // 16)[..., None], bits=4, photometric=3,
                                 colormap=rng.integers(0, 256, (3, 16)), compression=5)
    out["tminwhite.tif"] = tiff_file(codec_source(302, h, w, gray=True)[..., None], photometric=0)
    out["tbilevel.tif"] = tiff_file((codec_source(303, h, w, gray=True) > 127)[..., None]
                                    .astype(np.uint8), bits=1, photometric=1, compression=32773)
    rgba = np.concatenate([rgb, rng.integers(0, 256, (h, w, 1), dtype=np.uint8)], 2)
    out["trgba_unassoc.tif"] = tiff_file(rgba, extra_samples=(2,), compression=8)
    out["tcmyk.tif"] = tiff_file(rng.integers(0, 256, (h, w, 4), dtype=np.uint8), photometric=5)
    out["torient3.tif"] = tiff_file(rgb, orientation=3, tile=(16, 16))
    out["tycbcr.tif"] = tiff_file(rgb, photometric=6)  # no YCbCrSubsampling: 2x2 packed blocks
    for sh, sv in ((4, 4), (4, 2), (4, 1), (2, 1), (1, 2), (1, 1)):
        out[f"tycbcr{sh}{sv}.tif"] = tiff_file(rgb, photometric=6, subsampling=(sh, sv),
                                               compression=5, tile=(16, 16) if sh == 4 else None)
    out["tjpeg_strips.tif"] = tiff_file(rgb, compression=7, rows_per_strip=16)
    out["tjpeg_tiles_tables.tif"] = tiff_file(rgb, compression=7, tile=(32, 16), jpeg_tables=True)
    out["tjpeg_gray.tif"] = tiff_file(codec_source(304, h, w, gray=True)[..., None], compression=7,
                                      photometric=1, rows_per_strip=24, jpeg_tables=True)
    out["tfill2_lzw.tif"] = tiff_file(rgb, compression=5, predictor=2, fill_order=2)
    out["tfill2_bilevel.tif"] = tiff_file((codec_source(305, h, w, gray=True) > 127)[..., None]
                                          .astype(np.uint8), bits=1, photometric=0, fill_order=2)
    rows = mh_rows(rng, w, h)
    out["trlew.tif"] = tiff_file(np.zeros((h, w, 1), np.uint8), bits=1, photometric=0,
                                 compression=32771)
    out["trlew.tif"] = _with_strip(out["trlew.tif"], mh_strip(rows, 16))
    return out


def _with_strip(tiff: bytes, strip: bytes) -> bytes:
    """A one-strip little-endian TIFF from ``tiff_file`` with its strip
    replaced by ``strip`` (appended after the directory)."""
    data = bytearray(tiff) + bytes(len(tiff) & 1)  # the strip at an even offset
    (ifd,) = struct.unpack_from("<I", data, 4)
    (n,) = struct.unpack_from("<H", data, ifd)
    for i in range(n):
        at = ifd + 2 + 12 * i
        tag = struct.unpack_from("<H", data, at)[0]
        if tag == 273:
            struct.pack_into("<I", data, at + 8, len(data))
        elif tag == 279:
            struct.pack_into("<I", data, at + 8, len(strip))
    return bytes(data) + strip


def pil_tiff_fixtures() -> dict:
    """TIFFs written by Pillow (libtiff): JPEG-compressed RGB (photometric
    2, stored as RGB), YCbCr and grey, CCITT RLE, Group 3 1D and 2D, Group 4
    (also FillOrder 2, and at 640x480 for the card's timing) and CIELab."""
    import io

    from PIL import Image

    h, w = IMG_H, IMG_W
    rgb = np.ascontiguousarray(codec_source(600, h, w)[..., ::-1])
    bilevel = Image.fromarray(codec_source(601, h, w, gray=True) > 127)
    lab = Image.fromarray(rgb).convert("LAB")
    lab.info.pop("icc_profile", None)  # lcms stamps its profile with the time

    def save(im, **kw):
        b = io.BytesIO()
        im.save(b, "TIFF", **kw)
        return b.getvalue()

    out = {"tjpeg_rgb_pil.tif": save(Image.fromarray(rgb), compression="jpeg", quality=85),
           "tjpeg_ycbcr_pil.tif": save(Image.fromarray(rgb).convert("YCbCr"), compression="jpeg"),
           "tjpeg_gray_pil.tif": save(Image.fromarray(rgb).convert("L"), compression="jpeg"),
           "tccitt_rle_pil.tif": save(bilevel, compression="tiff_ccitt"),
           "tg3_pil.tif": save(bilevel, compression="group3"),
           "tg3_2d_pil.tif": save(bilevel, compression="group3", tiffinfo={292: 5}),
           "tg4_pil.tif": save(bilevel, compression="group4"),
           "tg4_fill2_pil.tif": save(bilevel, compression="group4", tiffinfo={266: 2}),
           "tlab_pil.tif": save(lab)}
    page = Image.fromarray(scene_640()).convert("L").point(lambda v: 255 if v > 110 else 0)
    out["t640_g4_pil.tif"] = save(page.convert("1"), compression="group4")  # timed on the card
    return out


def rare_jpeg_fixtures() -> dict:
    """Lossless JPEGs (predictors 1 and 7, a point transform and restarts,
    an Adobe marker of transform 0) and arithmetic-coded JPEGs (sequential
    from ``arith_jpeg`` with restarts and a DAC segment; progressive: an
    OpenCV progressive file marked SOF10, whose Huffman data the arithmetic
    decoder reads as cv2 reads it)."""
    import cv2

    img = codec_source(700, IMG_H, IMG_W)
    prog = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, 90,
                                      cv2.IMWRITE_JPEG_PROGRESSIVE, 1])[1].tobytes()
    return {"jlossless1.jpg": lossless_jpeg(img, predictor=1),
            "jlossless7_pt_rst.jpg": lossless_jpeg(img, predictor=7, pt=2, restart_rows=5),
            "jlossless_adobe.jpg": lossless_jpeg(img, predictor=4, adobe=0, interleaved=False),
            "jarith.jpg": arith_jpeg(701, IMG_W, IMG_H, restart=4, dac=(1, 4, 3)),
            "jarith_prog.jpg": prog.replace(b"\xff\xc2", b"\xff\xca", 1)}


def scene_640() -> np.ndarray:
    """A 640x480 image of phase 7's kind (``chip_smoke.synthetic_image``:
    shapes on a gradient) with a little noise, as a camera's."""
    img = synthetic_image(np.random.default_rng(112), 480, 640).astype(np.int64)
    img += np.random.default_rng(113).integers(-3, 4, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def webp_fixtures() -> dict:
    import io

    import cv2
    from PIL import Image

    h, w = IMG_H, IMG_W
    out = {}
    ok, buf = cv2.imencode(".webp", codec_source(400, h, w))
    out["wlossless_cv2.webp"] = buf.tobytes()
    ok, buf = cv2.imencode(".webp", codec_source(401, h, w), [cv2.IMWRITE_WEBP_QUALITY, 90])
    out["wlossy_cv2.webp"] = buf.tobytes()
    big = scene_640()  # phase 16.5 validates these, 16.4 times them
    out["w640_lossless_cv2.webp"] = cv2.imencode(".webp", big)[1].tobytes()
    out["w640_lossy_cv2.webp"] = cv2.imencode(".webp", big,
                                              [cv2.IMWRITE_WEBP_QUALITY, 75])[1].tobytes()
    src = Image.fromarray(codec_source(402, h, w)[..., ::-1])
    for o in (5, 6, 7, 8):
        exif = Image.Exif()
        exif[0x0112] = o
        b = io.BytesIO()
        src.save(b, "WEBP", quality=80, lossless=o % 2 == 1, exif=exif.tobytes())
        out[f"wexif{o}_pil.webp"] = b.getvalue()
    rgba = np.concatenate([codec_source(403, h, w)[..., ::-1],
                           codec_source(404, h, w, gray=True)[..., None]], 2)
    for lossless in (True, False):
        b = io.BytesIO()
        Image.fromarray(rgba, "RGBA").save(b, "WEBP", lossless=lossless, quality=85)
        out[f"walpha_{'lossless' if lossless else 'lossy'}_pil.webp"] = b.getvalue()
    frames = [Image.fromarray(codec_source(405 + k, h, w)[..., ::-1]) for k in range(3)]
    b = io.BytesIO()
    frames[0].save(b, "WEBP", save_all=True, append_images=frames[1:], quality=80)
    out["wanim_pil.webp"] = b.getvalue()
    return out


def cmyk_jpeg_fixtures() -> dict:
    """A CMYK JPEG written by Pillow (Adobe marker, transform 0) and the
    same file marked YCCK (transform 2)."""
    import io

    from PIL import Image

    rng = np.random.default_rng(500)
    cmyk = np.concatenate([codec_source(500, IMG_H, IMG_W),
                           rng.integers(0, 256, (IMG_H, IMG_W, 1), dtype=np.uint8)], 2)
    b = io.BytesIO()
    Image.fromarray(cmyk, "CMYK").save(b, "JPEG", quality=90, subsampling=2)
    data = bytearray(b.getvalue())
    at = data.index(b"Adobe")
    out = {"jcmyk_pil.jpg": bytes(data)}
    data[at + 11] = 2
    out["jycck_pil.jpg"] = bytes(data)
    return out


def webp_with_exif(webp: bytes, orientation: int) -> bytes:
    """A simple-format WebP (one VP8 or VP8L chunk) as an extended one: VP8X
    with the EXIF flag, the image, and an EXIF chunk holding a TIFF IFD0
    with the orientation tag only."""
    tag, (size,) = webp[12:16], struct.unpack_from("<I", webp, 16)
    payload = webp[20: 20 + size]
    if tag == b"VP8L":
        (v,) = struct.unpack_from("<I", payload, 1)
        w, h = (v & 0x3FFF) + 1, ((v >> 14) & 0x3FFF) + 1
    else:
        w, h = (struct.unpack_from("<H", payload, k)[0] & 0x3FFF for k in (6, 8))
    exif = exif_app1(orientation)[10:]
    vp8x = bytes([8, 0, 0, 0]) + (w - 1).to_bytes(3, "little") + (h - 1).to_bytes(3, "little")
    body = b"".join(t + struct.pack("<I", len(p)) + p + bytes(len(p) % 2)
                    for t, p in ((b"VP8X", vp8x), (tag, payload), (b"EXIF", exif)))
    return b"RIFF" + struct.pack("<I", 4 + len(body)) + b"WEBP" + body


# the fixtures of modes the port leaves out: name -> the feature its error names
LEFT_OUT: dict = {}


# ---- JPEG modes no tool here writes: lossless, arithmetic-coded, 12-bit ------------------


def _segment(marker: int, body: bytes) -> bytes:
    return bytes([0xFF, marker]) + struct.pack(">H", len(body) + 2) + body


class BitWriter:
    """Entropy-coded bits MSB first, 0xFF stuffed with 0x00, padded with 1s."""

    def __init__(self):
        self.out, self.acc, self.n = bytearray(), 0, 0

    def put(self, value: int, nbits: int) -> None:
        for i in range(nbits - 1, -1, -1):
            self.acc = (self.acc << 1) | ((value >> i) & 1)
            self.n += 1
            if self.n == 8:
                self.out.append(self.acc)
                if self.acc == 0xFF:
                    self.out.append(0)
                self.acc = self.n = 0

    def flush(self) -> bytes:
        if self.n:
            self.put((1 << (8 - self.n)) - 1, 8 - self.n)
        return bytes(self.out)


def _huffman(bits):
    """(code, length) of each value of a table of 1-based ``bits`` counts
    whose values are 0, 1, 2, ... in order."""
    codes, code, v = {}, 0, 0
    for length in range(1, 17):
        for _ in range(bits[length - 1] if length - 1 < len(bits) else 0):
            codes[v] = (code, length)
            code += 1
            v += 1
        code <<= 1
    return codes


LOSSLESS_BITS = (0, 0, 0, 8, 8, 1)  # 17 categories: 0-7 in 4 bits, 8-15 in 5, 16 in 6


def lossless_jpeg(img: np.ndarray, predictor: int = 1, pt: int = 0, restart_rows: int = 0,
                  adobe=None, jfif: bool = False, interleaved: bool = True,
                  precision: int = 8, sampling=(1, 1)) -> bytes:
    """A lossless JPEG (SOF3) of ``img`` (h, w, components; its values
    stored as they are, in the components' order) with ``predictor`` 1-7,
    point transform ``pt``, a restart every ``restart_rows`` MCU rows, an
    Adobe marker of that transform, a JFIF marker, one scan or one a
    component, the first component sampled ``sampling`` (h, v) and the
    others 1x1 (taken every h-th column and v-th row)."""
    img = np.asarray(img)
    if img.ndim == 2:
        img = img[..., None]
    h, w, nc = img.shape
    hs, vs = sampling if nc > 1 else (1, 1)
    factors = [(hs, vs)] + [(1, 1)] * (nc - 1)
    planes = []
    for c, (a, b) in enumerate(factors):
        cw, ch = -(-w * a // hs), -(-h * b // vs)
        planes.append(img[:: vs // b, :: hs // a, c][:ch, :cw].astype(np.int64) >> pt)
    codes = _huffman(LOSSLESS_BITS)
    head = b"\xff\xd8"
    if jfif:
        head += _segment(0xE0, b"JFIF\0\x01\x01\0\0\x01\0\x01\0\0")
    if adobe is not None:
        head += _segment(0xEE, b"Adobe\0\x64\0\0\0\0" + bytes([adobe]))
    head += _segment(0xC3, struct.pack(">BHHB", precision, h, w, nc)
                     + b"".join(bytes([i + 1, (a << 4) | b, 0]) for i, (a, b) in enumerate(factors)))
    head += _segment(0xC4, bytes([0]) + bytes(LOSSLESS_BITS + (0,) * (16 - len(LOSSLESS_BITS)))
                     + bytes(range(17)))
    mcus_x, mcus_y = -(-w // hs), -(-h // vs)
    interval = restart_rows * (mcus_x if interleaved else planes[0].shape[1])  # in MCUs
    if restart_rows:
        head += _segment(0xDD, struct.pack(">H", interval))

    def diffs(c, rows_per_mcu, every):  # jdlossls.c's prediction, first rows from 2^(P-Pt-1)
        x = planes[c]
        d = np.zeros(x.shape, np.int64)
        for y in range(x.shape[0]):
            r = x[y]
            mcu_row = y // rows_per_mcu
            first = y % rows_per_mcu == 0 and (y == 0 or (every and mcu_row % every == 0))
            if first:
                pred = np.r_[1 << (precision - pt - 1), r[:-1]]
            else:
                p = x[y - 1]
                ra, rb, rc = np.r_[0, r[:-1]], p, np.r_[0, p[:-1]]
                pr = {1: ra, 2: rb, 3: rc, 4: ra + rb - rc, 5: ra + ((rb - rc) >> 1),
                      6: rb + ((ra - rc) >> 1), 7: (ra + rb) >> 1}[predictor]
                pred = np.r_[rb[0], pr[1:]]
            d[y] = (r - pred) & 0xFFFF
        return d

    def put(bw, v):
        v = int(v)
        v = v - 65536 if v >= 32768 else v
        if v == -32768:
            bw.put(*codes[16])
            return
        s_ = abs(v).bit_length()
        bw.put(*codes[s_])
        if s_:
            bw.put(v if v >= 0 else v - 1 + (1 << s_), s_)

    out = head
    for comps in ([list(range(nc))] if interleaved else [[c] for c in range(nc)]):
        f = [factors[c] if interleaved else (1, 1) for c in comps]
        rows, cols = (mcus_y, mcus_x) if interleaved else planes[comps[0]].shape
        every = max(interval // cols, 1) if restart_rows else 0  # libjpeg's restart rows
        d = [diffs(c, f[k][1], every) for k, c in enumerate(comps)]
        out += _segment(0xDA, bytes([len(comps)]) + b"".join(bytes([c + 1, 0]) for c in comps)
                        + bytes([predictor, 0, pt]))
        bw, rst = BitWriter(), 0
        for my in range(rows):
            if every and my and my % every == 0:
                out += bw.flush() + bytes([0xFF, 0xD0 + rst % 8])
                bw, rst = BitWriter(), rst + 1
            for mx in range(cols):
                for k in range(len(comps)):
                    a, b = f[k]
                    for yy in range(b):
                        for xx in range(a):
                            y, x = my * b + yy, mx * a + xx
                            inside = y < d[k].shape[0] and x < d[k].shape[1]
                            put(bw, d[k][y, x] if inside else 0)
        out += bw.flush()
    return out + b"\xff\xd9"


def _zigzag_blocks(rng, n: int, dc_step: int, ac: int) -> np.ndarray:
    """(n, 64) quantised coefficients in zigzag order: a random walk of DC
    values and a few small low-frequency AC terms."""
    blocks = np.zeros((n, 64), np.int64)
    blocks[:, 0] = np.cumsum(rng.integers(-dc_step, dc_step + 1, n))
    for k in range(1, 10):
        keep = rng.random(n) < 0.5
        blocks[:, k] = np.where(keep, rng.integers(-ac, ac + 1, n), 0)
    blocks[rng.random(n) < 0.05, int(rng.integers(10, 64))] = int(rng.integers(1, 200))
    return blocks


class QMEncoder:
    """jcarith.c's arith_encode and finish_pass (T.81 annex D)."""

    def __init__(self, table):
        self.table, self.out = table, bytearray()
        self.c, self.a, self.ct, self.sc, self.zc, self.buffer = 0, 0x10000, 11, 0, 0, -1

    def _emit(self, b: int) -> None:
        self.out.append(b & 0xFF)

    def _flush_stacked(self, byte: int, carry: bool) -> None:
        if carry:
            if self.buffer >= 0:
                self.out += bytes(self.zc)
                self.zc = 0
                self._emit(self.buffer + 1)
                if self.buffer + 1 == 0xFF:
                    self._emit(0)
            self.zc += self.sc
            self.sc = 0
        else:
            if self.buffer == 0:
                self.zc += 1
            elif self.buffer >= 0:
                self.out += bytes(self.zc)
                self.zc = 0
                self._emit(self.buffer)
            if self.sc:
                self.out += bytes(self.zc)
                self.zc = 0
                self.out += b"\xff\0" * self.sc
                self.sc = 0
        self.buffer = byte

    def encode(self, st: bytearray, i: int, val: int) -> None:
        sv = st[i]
        qe = self.table[sv & 0x7F]
        nl, nm, qe = qe & 0xFF, (qe >> 8) & 0xFF, qe >> 16
        self.a -= qe
        if val != (sv >> 7):
            if self.a >= qe:
                self.c += self.a
                self.a = qe
            st[i] = (sv & 0x80) ^ nl
        else:
            if self.a >= 0x8000:
                return
            if self.a < qe:
                self.c += self.a
                self.a = qe
            st[i] = (sv & 0x80) ^ nm
        while True:
            self.a <<= 1
            self.c <<= 1
            self.ct -= 1
            if self.ct == 0:
                temp = self.c >> 19
                if temp > 0xFF:
                    self._flush_stacked(temp & 0xFF, True)
                elif temp == 0xFF:
                    self.sc += 1
                else:
                    self._flush_stacked(temp & 0xFF, False)
                self.c &= 0x7FFFF
                self.ct += 8
            if self.a >= 0x8000:
                break

    def finish(self) -> bytes:
        temp = (self.a - 1 + self.c) & 0xFFFF0000
        self.c = temp + 0x8000 if temp < self.c else temp
        self.c <<= self.ct
        if self.c & 0xF8000000:
            if self.buffer >= 0:
                self.out += bytes(self.zc)
                self.zc = 0
                self._emit(self.buffer + 1)
                if self.buffer + 1 == 0xFF:
                    self._emit(0)
            self.zc += self.sc
            self.sc = 0
        else:
            self._flush_stacked(self.buffer, False)
        if self.c & 0x7FFF800:
            self.out += bytes(self.zc)
            self._emit(self.c >> 19)
            if (self.c >> 19) & 0xFF == 0xFF:
                self._emit(0)
            if self.c & 0x7F800:
                self._emit(self.c >> 11)
                if (self.c >> 11) & 0xFF == 0xFF:
                    self._emit(0)
        return bytes(self.out)


def _arith_table():
    """jpeg_aritab as the port's decoder holds it, parsed from its source
    (Qe << 16 | NMPS << 8 | switch << 7 | NLPS)."""
    import re

    src = (ROOT / "ayolov2_torch/csrc/image_codec.cpp").read_text()
    body = src[src.index("kAriTab[114]"): src.index("#undef V")]
    return [int(qe, 16) << 16 | int(nm) << 8 | int(sw) << 7 | int(nl)
            for qe, nl, nm, sw in re.findall(r"V\((0x[0-9a-f]+), (\d+), (\d+), (\d+)\)", body)]


def arith_jpeg(seed: int, w: int, h: int, sampling=(2, 2), gray: bool = False,
               restart: int = 0, dac=None) -> bytes:
    """A sequential arithmetic-coded JPEG (SOF9) of random quantised
    coefficients (``_zigzag_blocks``), as jcarith.c's encode_mcu codes them:
    luma sampled ``sampling``, a restart every ``restart`` MCUs, and a DAC
    segment of ``dac`` (L, U, K) where given."""
    rng = np.random.default_rng(seed)
    table = _arith_table()
    nc = 1 if gray else 3
    hs, vs = (1, 1) if gray else sampling
    mx, my = -(-w // (8 * hs)), -(-h // (8 * vs))
    per = [(hs, vs)] + [(1, 1)] * (nc - 1)
    coefs = [_zigzag_blocks(rng, mx * my * a * b, 6 if i == 0 else 3, 4)
             for i, (a, b) in enumerate(per)]
    L, U, K = dac or (0, 1, 5)
    head = b"\xff\xd8" + _segment(0xDB, bytes([0]) + bytes([2] * 64))
    head += _segment(0xC9, struct.pack(">BHHB", 8, h, w, nc) + b"".join(
        bytes([i + 1, (a << 4) | b, 0]) for i, (a, b) in enumerate(per)))
    if dac:
        head += _segment(0xCC, bytes([0, L | (U << 4), 16, K]))
    if restart:
        head += _segment(0xDD, struct.pack(">H", restart))
    head += _segment(0xDA, bytes([nc]) + b"".join(bytes([i + 1, 0]) for i in range(nc))
                     + bytes([0, 63, 0]))
    out, rst = bytearray(), 0

    def fresh():
        return QMEncoder(table), bytearray(64), bytearray(256), bytearray([113, 0, 0, 0])

    enc, dc_st, ac_st, fixed = fresh()
    last, ctx, used = [0] * nc, [0] * nc, [0] * nc
    for n in range(mx * my):
        if restart and n and n % restart == 0:
            out += enc.finish() + bytes([0xFF, 0xD0 + rst % 8])
            rst += 1
            enc, dc_st, ac_st, fixed = fresh()
            last, ctx = [0] * nc, [0] * nc
        for i, (a, b) in enumerate(per):
            for _ in range(a * b):
                blk = coefs[i][used[i]]
                used[i] += 1
                v = int(blk[0]) - last[i]
                s0 = ctx[i]
                if v == 0:
                    enc.encode(dc_st, s0, 0)
                    ctx[i] = 0
                else:
                    last[i] = int(blk[0])
                    enc.encode(dc_st, s0, 1)
                    enc.encode(dc_st, s0 + 1, int(v < 0))
                    st = s0 + (3 if v < 0 else 2)
                    ctx[i] = 8 if v < 0 else 4
                    v = abs(v) - 1
                    m = 0
                    if v:
                        enc.encode(dc_st, st, 1)
                        m, v2, st = 1, v, 20
                        while v2 >> 1:
                            v2 >>= 1
                            enc.encode(dc_st, st, 1)
                            m <<= 1
                            st += 1
                    enc.encode(dc_st, st, 0)
                    if m < (1 << L) >> 1:
                        ctx[i] = 0
                    elif m > (1 << U) >> 1:
                        ctx[i] += 8
                    st += 14
                    while m >> 1:
                        m >>= 1
                        enc.encode(dc_st, st, int(bool(m & v)))
                nz = np.flatnonzero(blk[1:])
                ke = int(nz[-1]) + 1 if nz.size else 0
                k = 1
                while k <= ke:
                    st = 3 * (k - 1)
                    enc.encode(ac_st, st, 0)
                    while blk[k] == 0:
                        enc.encode(ac_st, st + 1, 0)
                        st += 3
                        k += 1
                    enc.encode(ac_st, st + 1, 1)
                    v = int(blk[k])
                    enc.encode(fixed, 0, int(v < 0))
                    v = abs(v) - 1
                    st += 2
                    m = 0
                    if v:
                        enc.encode(ac_st, st, 1)
                        m, v2 = 1, v
                        if v2 >> 1:
                            v2 >>= 1
                            enc.encode(ac_st, st, 1)
                            m <<= 1
                            st = 189 if k <= K else 217
                            while v2 >> 1:
                                v2 >>= 1
                                enc.encode(ac_st, st, 1)
                                m <<= 1
                                st += 1
                    enc.encode(ac_st, st, 0)
                    st += 14
                    while m >> 1:
                        m >>= 1
                        enc.encode(ac_st, st, int(bool(m & v)))
                    k += 1
                if k <= 63:
                    enc.encode(ac_st, 3 * (k - 1), 1)
    out += enc.finish()
    return head + bytes(out) + b"\xff\xd9"


def jpeg12(seed: int, w: int, h: int, progressive: bool = False) -> bytes:
    """A 12-bit DCT JPEG (SOF1, or SOF2 with one DC scan, P = 12), one
    component, DC terms only: Huffman categories up to 15 of a random walk."""
    rng = np.random.default_rng(seed)
    n = -(-w // 8) * -(-h // 8)
    dc = np.cumsum(rng.integers(-300, 301, n))
    dc_bits = (0, 0, 0, 14, 2)  # categories 0-13 in 4 bits, 14 and 15 in 5
    codes = _huffman(dc_bits)
    head = b"\xff\xd8" + _segment(0xDB, bytes([0]) + bytes([1] * 64))
    head += _segment(0xC2 if progressive else 0xC1, struct.pack(">BHHB", 12, h, w, 1)
                     + bytes([1, 0x11, 0]))
    head += _segment(0xC4, bytes([0]) + bytes(dc_bits + (0,) * 11) + bytes(range(16)))
    head += _segment(0xC4, bytes([0x10, 1] + [0] * 15) + bytes([0]))  # AC: EOB only
    head += _segment(0xDA, bytes([1, 1, 0]) + bytes([0, 0 if progressive else 63, 0]))
    bw, last = BitWriter(), 0
    for v in dc.tolist():
        d, last = v - last, v
        s_ = abs(d).bit_length()
        bw.put(*codes[s_])
        if s_:
            bw.put(d if d >= 0 else d - 1 + (1 << s_), s_)
        if not progressive:
            bw.put(0, 1)  # EOB
    return head + bw.flush() + b"\xff\xd9"


# ---- CCITT modified Huffman rows (compression 2 and RLEW) ----------------------------------

# a few T.4 codes: terminating white and black runs and the make-up run of 64
MH_WHITE = {0: "00110101", 1: "000111", 2: "0111", 3: "1000", 4: "1011", 5: "1100", 6: "1110",
            7: "1111", 64: "11011"}
MH_BLACK = {0: "0000110111", 1: "010", 2: "11", 3: "10", 4: "011", 5: "0011", 6: "0010",
            64: "0000001111"}


def mh_rows(rng, width: int, rows: int):
    """Random rows of runs (white first) of 1-7 pixels, now and then 64 more."""
    out = []
    for _ in range(rows):
        runs, x = [], 0
        while x < width:
            r = int(rng.integers(1, 7)) + (64 if rng.random() < 0.1 else 0)
            if r > width - x:
                r = min(width - x, 6)
            runs.append(r)
            x += r
        out.append(runs)
    return out


def mh_strip(rows, align: int) -> bytes:
    """Modified Huffman rows (each ending where its runs reach the width),
    each padded to ``align`` bits: 8 for compression 2, 16 for RLEW."""
    bits = ""
    for runs in rows:
        for i, r in enumerate(runs):
            table = MH_BLACK if i % 2 else MH_WHITE
            bits += (table[64] + table[r - 64]) if r >= 64 else table[r]
        bits += "0" * (-len(bits) % align)
    return bytes(int(bits[i: i + 8], 2) for i in range(0, len(bits), 8))


# ---- manifest ----------------------------------------------------------------------------


def sha256(b) -> str:
    return hashlib.sha256(bytes(b)).hexdigest()


def fixture_files(root: Path = FIXTURES):
    return sorted(p for p in root.iterdir() if p.name != "manifest.json")


def manifest(root: Path = FIXTURES) -> dict:
    """Each fixture's ``cv2.imread`` shape and digest; for a left-out mode
    the feature the port names; for an OpenCV JPEG its source and the digest
    of ``cv2.imencode`` of the source."""
    import cv2

    files = {}
    sources = {name: src for name, (_, src) in jpeg_fixtures().items()}
    for path in fixture_files(root):
        im = cv2.imread(str(path))
        entry = {"shape": list(im.shape), "sha256": sha256(np.ascontiguousarray(im).tobytes())}
        if path.name in LEFT_OUT:
            entry["left_out"] = LEFT_OUT[path.name]
        if path.name in sources:
            src = dict(sources[path.name])
            ok, buf = cv2.imencode(".jpg", codec_source(src["seed"], src["h"], src["w"], src["gray"]),
                                   [cv2.IMWRITE_JPEG_QUALITY, src["quality"]])
            src["imencode_sha256"] = sha256(buf.tobytes())
            entry["source"] = src
        files[path.name] = entry
    return {"reference": f"cv2 {cv2.__version__}", "files": files}


def write(root: Path = FIXTURES) -> None:
    root.mkdir(parents=True, exist_ok=True)
    for name, (data, _) in jpeg_fixtures().items():
        (root / name).write_bytes(data)
    for group in (png_fixtures, bmp_fixtures, tiff_fixtures, webp_fixtures, cmyk_jpeg_fixtures,
                  pil_tiff_fixtures, rare_jpeg_fixtures):
        for name, data in group().items():
            (root / name).write_bytes(data)
    (root / "manifest.json").write_text(json.dumps(manifest(root), indent=1, sort_keys=True) + "\n")


if __name__ == "__main__":
    write()
