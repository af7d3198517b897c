"""Image files without OpenCV or PIL: the port's own codecs.

The pixels come from C++ libraries built by the host compiler at first use
into ``build/torch_kernels/`` (``ops/_build.load``) and called through
``ctypes``, which releases the GIL, so the loader's threads decode at once:
``csrc/image_codec.cpp`` (JPEG, TIFF's JPEG strips, PNG),
``csrc/raster_codec.cpp`` (BMP's run-length data, TIFF's LZW and
PackBits), ``csrc/fax_codec.cpp`` (TIFF's CCITT) and ``csrc/webp_codec.cpp``
(VP8L and VP8). A library that does not build raises with the compiler's
output; nothing falls back to OpenCV.

- :func:`decode_jpeg` is ``cv2.imread`` of a file holding ``data``, before
  the EXIF rotation: libjpeg-turbo's baseline, extended and progressive
  decoding, Huffman or arithmetic-coded, islow IDCT, fancy upsampling and
  YCbCr -> BGR, bit for bit, CMYK and YCCK (Adobe's transform flag) through
  OpenCV's inverted-CMYK formula, lossless frames at 8 bits in the colour
  spaces libjpeg passes unconverted (RGB, CMYK), and a cut file read on as
  libjpeg's stdio source reads it (block smoothing of a cut progressive
  file included).
- :func:`encode_jpeg` gives the bytes of ``cv2.imencode('.jpg', im,
  [IMWRITE_JPEG_QUALITY, quality])`` (4:2:0, baseline, standard tables).
- :func:`decode_png` is ``cv2.imread`` of a PNG, without the rotation, for
  every colour type and bit depth, ``tRNS`` and Adam7: the chunks are read
  and inflated here (``zlib``), unfiltered and converted in C++. A critical
  chunk with a bad CRC, a cut file or too little image data raise as
  ``cv2.imread`` gives None; an ancillary chunk with a bad CRC is skipped.
- :func:`decode_bmp` is OpenCV's own BMP reader: every header size, 1- to
  32-bit pixels, RLE4 and RLE8, top-down rows.
- :func:`decode_tiff` is ``cv2.imread`` of a TIFF's first image through
  libtiff's RGBA interface: the directory is parsed here, Deflate inflated
  with ``zlib``, LZW, PackBits and CCITT unpacked and JPEG strips decoded in
  C++, the samples turned into BGR as libtiff turns them (YCbCr and CIELab
  through its tables, in numpy).
- :func:`decode_webp` is libwebp's ``WebPDecodeBGRInto`` (the RIFF chunks
  are parsed here, the VP8L and VP8 bitstreams decoded in C++), the first
  frame of an animation as cv2's reader gives it.
- :func:`header_size` reads (w, h) from a JPEG's SOF, a PNG's IHDR, a BMP's
  header, a TIFF's IFD0 or a WebP's canvas; :func:`exif_orientation` and
  :func:`webp_orientation` read the orientation tag, and
  :func:`apply_orientation` turns an image as cv2's ``ApplyExifOrientation``.

Errors raise ``OSError`` (or ``ValueError`` for a bad argument) naming the
file and what failed; a mode that cv2.imread refuses (12-bit DCT JPEG,
lossless JPEG in grey or YCbCr or above 8 bits, hierarchical and arithmetic
lossless JPEG; TIFF's old-style JPEG and the compressions OpenCV's libtiff
lacks, ICCLab and ITULab, float samples) is named in the message, and a
header beyond OpenCV's size limits (``CV_IO_MAX_IMAGE_*``) raises before any
allocation.
"""

from __future__ import annotations

import binascii
import ctypes
import struct
import threading
import zlib
from typing import Iterator, Optional, Tuple

import numpy as np

from ayolov2_torch.ops import _build

JPEG_SIGNATURE = b"\xff\xd8\xff"
PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_SOF = set(range(0xC0, 0xD0)) - {0xC4, 0xC8, 0xCC}
_MSG = 256
_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None  # image_codec
_LIBS: dict = {}  # the other host libraries, by name


def _lib(name: str = "image_codec") -> ctypes.CDLL:
    """The host library ``csrc/<name>.cpp``, built at first use."""
    global _LIB
    with _LOCK:
        if (_LIB if name == "image_codec" else _LIBS.get(name)) is None:
            lib = _build.load(name)
            u8p, i64, c_int, c_str = (ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64, ctypes.c_int,
                                      ctypes.c_char_p)
            if name == "image_codec":
                lib.ayolo_jpeg_decode.argtypes = [c_str, i64, c_int, c_int, c_int, u8p, c_str,
                                                  c_int]
                lib.ayolo_jpeg_encode.argtypes = [u8p, c_int, c_int, c_int, c_int,
                                                  ctypes.POINTER(u8p), ctypes.POINTER(i64)]
                lib.ayolo_free.argtypes = [u8p]
                lib.ayolo_free.restype = None
                lib.ayolo_png_pixels.argtypes = [u8p, i64, c_int, c_int, c_int, c_int, c_int, c_str,
                                                 c_int, u8p, c_str, c_int]
            elif name == "raster_codec":
                lib.ayolo_bmp_rle.argtypes = [c_str, i64, c_int, c_int, c_int, c_str, u8p, c_str,
                                              c_int]
                lib.ayolo_bmp_rle.restype = c_int
                lib.ayolo_tiff_unpack.argtypes = [c_str, i64, c_int, u8p, i64, c_str, c_int]
                lib.ayolo_tiff_unpack.restype = i64
            elif name == "fax_codec":
                lib.ayolo_fax_decode.argtypes = [c_str, i64, c_int, c_int, c_int, c_int, c_int,
                                                 c_int, ctypes.POINTER(c_int), u8p, c_str, c_int]
                lib.ayolo_fax_decode.restype = c_int
            else:
                for fn in (lib.ayolo_vp8l_decode, lib.ayolo_vp8_decode):
                    fn.argtypes = [c_str, i64, c_int, c_int, u8p, c_str, c_int]
                    fn.restype = c_int
            if name == "image_codec":
                _LIB = lib
            else:
                _LIBS[name] = lib
    return _LIB if name == "image_codec" else _LIBS[name]


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _check_size(w: int, h: int, name: str) -> None:
    """cv2.imread's limits (``CV_IO_MAX_IMAGE_WIDTH``, ``_HEIGHT``,
    ``_PIXELS``): a larger header gives None there, and an error here."""
    if w > 1 << 20 or h > 1 << 20 or w * h > 1 << 30:
        raise OSError(f"{name}: an image of {w}x{h} pixels is beyond OpenCV's limits")


# ---- JPEG ------------------------------------------------------------------------


def _jpeg_segments(data: bytes, name: str) -> Iterator[Tuple[int, int, int]]:
    """(marker, payload start, payload end) of each marker segment up to and
    including the first SOS, skipping bytes between markers as libjpeg does."""
    if not data.startswith(JPEG_SIGNATURE):
        raise OSError(f"{name}: not a JPEG file")
    n, pos = len(data), 2
    while True:
        while pos < n and data[pos] != 0xFF:
            pos += 1
        while pos < n and data[pos] == 0xFF:
            pos += 1
        if pos >= n:
            raise OSError(f"{name}: JPEG data ends before the first scan")
        m = data[pos]
        pos += 1
        if m == 0 or m == 0x01 or 0xD0 <= m <= 0xD7:
            continue
        if m == 0xD9 or m == 0xD8:
            raise OSError(f"{name}: JPEG file without an image")
        if pos + 2 > n:
            raise OSError(f"{name}: JPEG data ends inside a marker segment")
        length = (data[pos] << 8) | data[pos + 1]
        if length < 2 or pos + length > n:
            raise OSError(f"{name}: JPEG data ends inside a marker segment")
        yield m, pos + 2, pos + length
        if m == 0xDA:
            return
        pos += length


def _jpeg_frame(data: bytes, name: str) -> Tuple[int, int]:
    for m, start, end in _jpeg_segments(data, name):
        if m in _SOF:
            if end - start < 6:
                raise OSError(f"{name}: bad SOF marker")
            h, w = struct.unpack_from(">HH", data, start + 1)
            return w, h
    raise OSError(f"{name}: JPEG file without a frame header")


def _tiff_orientation(tiff: bytes) -> int:
    """Tag 0x0112 of IFD0 of a TIFF structure, both byte orders; 1 if absent
    or out of range."""
    if len(tiff) < 8 or tiff[:2] not in (b"II", b"MM"):
        return 1
    e = "<" if tiff[:2] == b"II" else ">"
    (ifd,) = struct.unpack_from(e + "I", tiff, 4)
    if ifd + 2 > len(tiff):
        return 1
    (count,) = struct.unpack_from(e + "H", tiff, ifd)
    for i in range(count):
        at = ifd + 2 + 12 * i
        if at + 12 > len(tiff):
            break
        tag, _, _ = struct.unpack_from(e + "HHI", tiff, at)
        if tag == 0x0112:
            (value,) = struct.unpack_from(e + "H", tiff, at + 8)
            return value if 1 <= value <= 8 else 1
    return 1


def exif_orientation(data: bytes, exif_id: bool = False, name: str = "<bytes>") -> int:
    """The EXIF orientation (1-8) of a JPEG or PNG held in ``data``; 1 where
    there is none. For a JPEG it is read from the first APP1 segment past its
    6-byte identifier, as OpenCV reads it; with ``exif_id`` only from the
    first APP1 that starts with ``Exif\\0\\0``, as PIL does. For a PNG it is
    read from the first ``eXIf`` chunk."""
    if data.startswith(PNG_SIGNATURE):
        for kind, body, crc_ok in _png_chunks(data, name, strict=False):
            if kind == b"eXIf" and crc_ok:
                return _tiff_orientation(body)
        return 1
    try:
        for m, start, end in _jpeg_segments(data, name):
            if m == 0xE1 and (not exif_id or data[start: start + 6] == b"Exif\0\0"):
                return _tiff_orientation(data[start + 6: end]) if end - start > 6 else 1
    except (OSError, struct.error):
        return 1
    return 1


def apply_orientation(im: np.ndarray, orientation: int) -> np.ndarray:
    """``im`` turned as cv2's ``ApplyExifOrientation`` turns it for each of
    the eight EXIF orientations (1: as stored)."""
    o = int(orientation)
    if o in (5, 6, 7, 8):
        im = im.transpose(1, 0, 2) if im.ndim == 3 else im.T
    if o in (2, 3, 6, 7):
        im = im[:, ::-1]
    if o in (3, 4, 7, 8):
        im = im[::-1]
    return np.ascontiguousarray(im)


def decode_jpeg(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """(h, w, 3) BGR uint8 of a JPEG, as ``cv2.imread`` of a file holding
    ``data`` before its EXIF rotation; raises ``OSError`` where cv2 gives
    None or the file uses a feature that is not decoded."""
    data = bytes(data)
    w, h = _jpeg_frame(data, name)
    if w == 0 or h == 0:
        raise OSError(f"{name}: empty JPEG image")
    _check_size(w, h, name)
    out = np.empty((h, w, 3), np.uint8)
    msg = ctypes.create_string_buffer(_MSG)
    rc = _lib().ayolo_jpeg_decode(data, len(data), w, h, 0, _ptr(out), msg, _MSG)
    if rc:
        raise OSError(f"{name}: {msg.value.decode(errors='replace')}")
    return out


def encode_jpeg(im: np.ndarray, quality: int = 95) -> bytes:
    """The bytes of ``cv2.imencode('.jpg', im, [IMWRITE_JPEG_QUALITY,
    quality])`` for (h, w, 3) BGR or (h, w) gray uint8."""
    im = np.asarray(im)
    if im.dtype != np.uint8 or not (im.ndim == 2 or (im.ndim == 3 and im.shape[2] in (1, 3))):
        raise ValueError(f"encode_jpeg takes (h, w, 3) or (h, w) uint8, got {im.dtype} {im.shape}")
    h, w = im.shape[:2]
    if not (0 < h <= 65500 and 0 < w <= 65500):
        raise ValueError(f"a JPEG image of {w}x{h} pixels cannot be written")
    ch = 3 if im.ndim == 3 and im.shape[2] == 3 else 1
    im = np.ascontiguousarray(im)
    buf = ctypes.POINTER(ctypes.c_uint8)()
    size = ctypes.c_int64()
    lib = _lib()
    if lib.ayolo_jpeg_encode(_ptr(im), w, h, ch, min(max(int(quality), 0), 100),
                             ctypes.byref(buf), ctypes.byref(size)):
        raise OSError("JPEG encoding failed")
    try:
        return ctypes.string_at(buf, size.value)
    finally:
        lib.ayolo_free(buf)


# ---- PNG -------------------------------------------------------------------------

_PNG_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
          (0, 1, 1, 2))


def _png_chunks(data: bytes, name: str, strict: bool = True):
    """(kind, body, crc ok) of each chunk up to IEND. ``strict``: a cut file
    or one without IEND raises, as cv2.imread gives None for it."""
    if not data.startswith(PNG_SIGNATURE):
        raise OSError(f"{name}: not a PNG file")
    pos, n = len(PNG_SIGNATURE), len(data)
    while True:
        if pos + 12 > n:
            if strict:
                raise OSError(f"{name}: PNG data is cut short")
            return
        (length,) = struct.unpack_from(">I", data, pos)
        kind = data[pos + 4: pos + 8]
        if pos + 12 + length > n:
            if strict:
                raise OSError(f"{name}: PNG data is cut short in chunk {kind!r}")
            return
        body = data[pos + 8: pos + 8 + length]
        (crc,) = struct.unpack_from(">I", data, pos + 8 + length)
        yield kind, body, binascii.crc32(kind + body) & 0xFFFFFFFF == crc
        if kind == b"IEND":
            return
        pos += 12 + length


def _png_header(body: bytes, name: str) -> Tuple[int, int, int, int, int]:
    if len(body) != 13:
        raise OSError(f"{name}: bad IHDR chunk")
    w, h, depth, ctype, comp, filt, interlace = struct.unpack(">IIBBBBB", body)
    if (w == 0 or h == 0 or w > 0x7FFFFFFF or h > 0x7FFFFFFF or ctype not in _PNG_DEPTHS
            or depth not in _PNG_DEPTHS[ctype] or comp or filt or interlace > 1):
        raise OSError(f"{name}: bad IHDR chunk ({w}x{h}, depth {depth}, colour type {ctype}, "
                      f"interlace {interlace})")
    return w, h, depth, ctype, interlace


def _png_data_size(w: int, h: int, depth: int, ctype: int, interlace: int) -> int:
    bits = _PNG_CHANNELS[ctype] * depth
    passes = _ADAM7 if interlace else ((0, 0, 1, 1),)
    total = 0
    for x0, y0, dx, dy in passes:
        pw, ph = -(-(w - x0) // dx) if w > x0 else 0, -(-(h - y0) // dy) if h > y0 else 0
        if pw and ph:
            total += ph * ((pw * bits + 7) // 8 + 1)
    return total


def decode_png(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """(h, w, 3) BGR uint8 of a PNG, as ``cv2.imread`` before its EXIF
    rotation: 16-bit samples keep their high byte, alpha and ``tRNS`` are
    dropped, gray and palettes expanded (an index past the palette is
    black)."""
    data = bytes(data)
    header, palette, idat = None, b"", []
    for kind, body, crc_ok in _png_chunks(data, name):
        critical = not (kind[0] & 0x20)
        if header is None and kind != b"IHDR":
            raise OSError(f"{name}: the first PNG chunk is not IHDR")
        if not crc_ok:
            if critical:
                raise OSError(f"{name}: CRC error in PNG chunk {kind!r}")
            continue
        if kind == b"IHDR":
            if header is not None:
                raise OSError(f"{name}: a second IHDR chunk")
            header = _png_header(body, name)
        elif kind == b"PLTE":
            if len(body) % 3 or not body or len(body) > 768:
                raise OSError(f"{name}: bad PLTE chunk")
            if not idat:
                palette = body
        elif kind == b"IDAT":
            idat.append(body)
        elif critical and kind != b"IEND":
            raise OSError(f"{name}: unknown critical PNG chunk {kind!r}")
    w, h, depth, ctype, interlace = header
    _check_size(w, h, name)
    if ctype == 3 and not palette:
        raise OSError(f"{name}: a palette PNG without a PLTE chunk")
    if not idat:
        raise OSError(f"{name}: PNG file without image data")
    need = _png_data_size(w, h, depth, ctype, interlace)
    inflater = zlib.decompressobj()
    try:
        raw = inflater.decompress(b"".join(idat), need)
    except zlib.error as e:
        raise OSError(f"{name}: PNG image data is corrupt ({e})") from e
    if len(raw) < need:
        raise OSError(f"{name}: not enough PNG image data ({len(raw)} of {need} bytes)")
    try:  # past the image, libpng only warns
        inflater.decompress(inflater.unconsumed_tail)
    except zlib.error:
        pass
    raw = np.frombuffer(raw, np.uint8).copy()
    out = np.empty((h, w, 3), np.uint8)
    msg = ctypes.create_string_buffer(_MSG)
    if _lib().ayolo_png_pixels(_ptr(raw), raw.size, w, h, depth, ctype, interlace, palette,
                               len(palette) // 3, _ptr(out), msg, _MSG):
        raise OSError(f"{name}: {msg.value.decode(errors='replace')}")
    return out


# ---- BMP -------------------------------------------------------------------------

BMP_SIGNATURE = b"BM"


def _bmp_header(data: bytes, name: str) -> dict:
    """The fields OpenCV's BmpDecoder reads: a BITMAPCOREHEADER (12 bytes)
    or a header of 36 bytes or more (40, 52, 56, 64, V4 108, V5 124).
    Raises ``OSError`` where cv2.imread gives None."""
    if len(data) < 26 or not data.startswith(BMP_SIGNATURE):
        raise OSError(f"{name}: not a BMP file")
    offset, size = struct.unpack_from("<iI", data, 10)
    if size >= 36 and size < 1 << 31:
        if len(data) < 50:
            raise OSError(f"{name}: BMP header is cut short")
        w, h, planes_bpp, comp = struct.unpack_from("<iiIi", data, 18)
        (colors,) = struct.unpack_from("<i", data, 46)
        core = False
    elif size == 12:
        w, h, planes_bpp = struct.unpack_from("<HHI", data, 18)
        comp, colors, core = 0, 0, True
    else:
        raise OSError(f"{name}: BMP header of {size} bytes")
    if not 0 <= comp <= 3:
        kind = {4: "JPEG", 5: "PNG"}.get(comp, f"compression {comp}")
        raise OSError(f"{name}: a BMP holding {kind} data is not read (cv2.imread gives None)")
    return dict(offset=offset, size=size, w=w, h=h, bpp=planes_bpp >> 16, comp=comp,
                colors=colors, core=core)


def decode_bmp(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """(h, w, 3) BGR uint8 of a BMP, as ``cv2.imread`` (OpenCV's own reader):
    1-, 4- and 8-bit palettes (RLE4 and RLE8 too), 16 bits (555, or
    BI_BITFIELDS 565/555 with the masks after the header), 24 and 32 bits
    (BI_BITFIELDS as BGRA, alpha dropped), bottom-up or top-down, core or
    later headers."""
    data = bytes(data)
    hd = _bmp_header(data, name)
    w, h, bpp, comp = hd["w"], hd["h"], hd["bpp"], hd["comp"]
    pos = 14 + hd["size"]
    if hd["core"]:
        ok = w > 0 and h != 0 and bpp in (1, 4, 8, 24, 32)
    else:
        ok = w > 0 and h != 0 and ((bpp in (1, 4, 8, 24, 32) and comp == 0)
                                   or (bpp in (16, 32) and comp in (0, 3))
                                   or (bpp == 4 and comp == 2) or (bpp == 8 and comp == 1))
    if not ok:
        raise OSError(f"{name}: a BMP of {bpp} bits with compression {comp} is not read "
                      "(cv2.imread gives None)")
    palette = np.zeros((256, 3), np.uint8)
    if bpp <= 8:
        n = 1 << bpp
        if not hd["core"]:
            if not 0 <= hd["colors"] <= 256:
                raise OSError(f"{name}: BMP palette of {hd['colors']} colours")
            n = hd["colors"] or n
        entry = 3 if hd["core"] else 4
        if pos + n * entry > len(data):
            raise OSError(f"{name}: BMP palette is cut short")
        palette[:n] = np.frombuffer(data, np.uint8, n * entry, pos).reshape(n, entry)[:, :3]
    elif bpp == 16:
        if comp == 3:
            if pos + 12 > len(data):
                raise OSError(f"{name}: BMP bit fields are cut short")
            masks = struct.unpack_from("<III", data, pos)  # red, green, blue
            if masks == (0x7C00, 0x3E0, 0x1F):
                bpp = 15
            elif masks != (0xF800, 0x7E0, 0x1F):
                raise OSError(f"{name}: BMP bit fields {[hex(m) for m in masks]} are not read "
                              "(cv2.imread gives None)")
        else:
            bpp = 15
    ah = abs(h)
    _check_size(w, ah, name)
    if ah * w * 3 >= 1 << 30:
        raise OSError(f"{name}: a BMP of {w}x{ah} pixels is beyond OpenCV's BMP reader")
    offset = hd["offset"]
    if offset < 0 or offset > len(data):
        raise OSError(f"{name}: BMP pixel data lies past the end of the file")
    if comp in (1, 2):
        out = np.zeros((ah + 1, w, 3), np.uint8)
        msg = ctypes.create_string_buffer(_MSG)
        pal = np.ascontiguousarray(palette).tobytes()
        if _lib("raster_codec").ayolo_bmp_rle(data[offset:], len(data) - offset, w, ah,
                                              8 if comp == 1 else 4, pal, _ptr(out), msg, _MSG):
            raise OSError(f"{name}: {msg.value.decode(errors='replace')}")
        im = out[:ah]
    else:
        pitch = ((w * (16 if bpp == 15 else bpp) + 7) // 8 + 3) & -4
        if offset + pitch * ah > len(data):
            raise OSError(f"{name}: BMP pixel data is cut short ({len(data)} bytes, need "
                          f"{offset + pitch * ah})")
        rows = np.frombuffer(data, np.uint8, pitch * ah, offset).reshape(ah, pitch)
        if bpp <= 8:
            idx = np.unpackbits(rows, axis=1).reshape(ah, -1, bpp) if bpp < 8 else rows[..., None]
            if bpp < 8:
                idx = (idx * (1 << np.arange(bpp - 1, -1, -1, dtype=np.uint8))).sum(2)
            im = palette[idx.reshape(ah, -1)[:, :w]]
        elif bpp in (15, 16):
            t = rows[:, : 2 * w].view("<u2").astype(np.int32)
            if bpp == 15:
                im = np.stack([(t << 3) & 0xF8, (t >> 2) & 0xF8, (t >> 7) & 0xF8], -1)
            else:
                im = np.stack([(t << 3) & 0xF8, (t >> 3) & 0xFC, (t >> 8) & 0xF8], -1)
            im = im.astype(np.uint8)
        else:
            k = bpp // 8
            im = rows[:, : k * w].reshape(ah, w, k)[..., :3]
    return np.ascontiguousarray(im[::-1] if h > 0 else im)


# ---- TIFF ------------------------------------------------------------------------

TIFF_SIGNATURES = (b"II*\0", b"MM\0*", b"II+\0", b"MM\0+")
_TIFF_TYPES = {1: "B", 2: "B", 3: "H", 4: "I", 5: "II", 6: "b", 7: "B", 8: "h", 9: "i", 10: "ii",
               11: "f", 12: "d", 16: "Q", 17: "q", 18: "Q"}
_TIFF_COMPRESSION = {1: "none", 5: "LZW", 32773: "PackBits", 8: "Deflate", 32946: "Deflate",
                     7: "JPEG", 2: "CCITT RLE", 3: "CCITT Group 3", 4: "CCITT Group 4",
                     32771: "CCITT RLEW"}
# compressions cv2's libtiff is built without ("not configured": cv2.imread gives None)
_TIFF_LEFT_OUT = {6: "old-style JPEG", 34925: "LZMA", 50000: "ZSTD", 50001: "WebP",
                  34712: "JPEG 2000", 34887: "lossless JPEG (DNG)", 52546: "JPEG XL"}
_CCITT = (2, 3, 4, 32771)
_PHOTOMETRIC = {0: "MinIsWhite", 1: "MinIsBlack", 2: "RGB", 3: "Palette", 4: "Mask",
                5: "Separated (CMYK)", 6: "YCbCr", 8: "CIELab", 9: "ICCLab", 10: "ITULab",
                32803: "CFA", 32844: "LogL", 32845: "LogLuv", 34892: "LinearRaw"}
# (photometric, bits) -> samples cv2.imread turns into BGR, as libtiff's RGBA
# reader does (other bit depths give None there)
_TIFF_BITS = {0: (1, 8, 16), 1: (1, 8, 16), 2: (8, 16), 3: (1, 4, 8), 5: (8,), 6: (8,),
              8: (8, 16)}
# the YCbCr subsamplings of libtiff's put functions (putcontig8bitYCbCr44tile,
# ...) -> the bytes each skips per sampling block cut off a clipped tile's
# row (putcontig8bitYCbCr44tile skips 10, not the 18 its blocks hold)
_YCBCR_SKIP = {(4, 4): 10, (4, 2): 10, (4, 1): 6, (2, 2): 6, (2, 1): 4, (1, 2): 4, (1, 1): 3}
_BIT_REVERSE = bytes(int(f"{i:08b}"[::-1], 2) for i in range(256))


_ROUND16 = ((np.arange(1 << 16) + 128) // 257).astype(np.uint8)


def _tiff_ifd0(data: bytes, name: str) -> Tuple[str, dict]:
    """(byte order, {tag: values}) of a TIFF's (or BigTIFF's) first IFD."""
    if len(data) < 8 or data[:4] not in TIFF_SIGNATURES:
        raise OSError(f"{name}: not a TIFF file")
    e = "<" if data[:2] == b"II" else ">"
    big = data[2:4] in (b"+\0", b"\0+")
    try:
        if big:
            (at,) = struct.unpack_from(e + "Q", data, 8)
            (count,) = struct.unpack_from(e + "Q", data, at)
            entry, start, inline = 20, at + 8, 8
        else:
            (at,) = struct.unpack_from(e + "I", data, 4)
            (count,) = struct.unpack_from(e + "H", data, at)
            entry, start, inline = 12, at + 2, 4
        tags = {}
        for i in range(count):
            pos = start + entry * i
            tag, kind = struct.unpack_from(e + "HH", data, pos)
            (n,) = struct.unpack_from(e + ("Q" if big else "I"), data, pos + 4)
            fmt = _TIFF_TYPES.get(kind)
            if fmt is None or n > 1 << 24:
                continue
            size = struct.calcsize(e + fmt) * n
            where = pos + 4 + inline
            if size > inline:
                (where,) = struct.unpack_from(e + ("Q" if big else "I"), data, where)
            vals = struct.unpack_from(e + fmt * n, data, where)
            if kind in (5, 10):  # rationals as libtiff reads them: float numerator / denominator
                f = np.float32
                vals = [float(f(a) / f(b)) if b else 0.0 for a, b in zip(vals[::2], vals[1::2])]
            tags[tag] = list(vals)
    except struct.error as err:
        raise OSError(f"{name}: TIFF directory is cut short") from err
    return e, tags


def _tiff_left_out(name: str, what: str):
    return OSError(f"{name}: TIFF {what} is not read by the port")


def _ycbcr_blocks(chunk: np.ndarray, rows: int, cols: int, sh: int, sv: int,
                  stride: int) -> np.ndarray:
    """(rows, cols, 3) Y, Cb, Cr of a chunk of packed sampling blocks (sh x
    sv luma samples, then Cb and Cr), each pixel given its block's chroma, as
    libtiff's putcontig8bitYCbCr*tile put them: a row of blocks every
    ``stride`` bytes, a partial block at the right or bottom edge showing
    only its pixels."""
    bsz = sh * sv + 2
    across, down = -(-cols // sh), -(-rows // sv)
    at = np.arange(down)[:, None] * stride + np.arange(across * bsz)
    b = np.concatenate([chunk, np.zeros(max(0, int(at.max()) + 1 - chunk.size), np.uint8)])[at]
    b = b.reshape(down, across, bsz)
    y = b[..., : sh * sv].reshape(down, across, sv, sh).transpose(0, 2, 1, 3)
    y = y.reshape(down * sv, across * sh)
    chroma = np.repeat(np.repeat(b[..., sh * sv:], sv, 0), sh, 1)
    return np.concatenate([y[..., None], chroma], 2)[:rows, :cols]


def _jpeg_sof(data: bytes, name: str) -> Tuple[int, int, int, list]:
    """(SOF payload offset, height, width, [(h, v) of each component]) of a
    JPEG stream."""
    for m, start, end in _jpeg_segments(data, name):
        if m in _SOF:
            nc = data[start + 5] if end - start >= 6 else 0
            if nc == 0 or end - start < 6 + 3 * nc:
                break
            h, w = struct.unpack_from(">HH", data, start + 1)
            return start, h, w, [(data[start + 7 + 3 * i] >> 4, data[start + 7 + 3 * i] & 15)
                                 for i in range(nc)]
    raise OSError(f"{name}: a TIFF JPEG strip or tile without a good frame header")


def _jpeg_strip(raw: bytes, tables: Optional[bytes], seg_w: int, seg_h: int, last_strip: bool,
                mode: int, components: int, sampling: Tuple[int, int], name: str) -> np.ndarray:
    """A TIFF's JPEG strip or tile as libtiff's JPEGPreDecode and JPEGDecode
    read it: the JPEGTables stream (tag 347) read before the strip's own
    abbreviated stream (spliced in before its first marker after SOI), the
    frame checked against the strip's size, component count and sampling
    (a last strip coded at the full RowsPerStrip is cut to its rows, as
    libtiff sets the frame's height; a frame larger than its strip is
    refused, one smaller leaves the rest of the strip zero), and decoded by
    the port's JPEG decoder in libtiff's colour mode: ``mode`` 1 YCbCr ->
    RGB, 2 the components as stored. Returns (seg_h, seg_w, 3 or
    components)."""
    if tables is not None and len(tables) >= 4 and raw[:2] == b"\xff\xd8":
        body = tables[2:]
        end = body.rfind(b"\xff\xd9")
        raw = raw[:2] + (body[:end] if end >= 0 else body) + raw[2:]
    raw = bytearray(raw)
    sof, h, w, factors = _jpeg_sof(bytes(raw), name)
    if w == seg_w and h > seg_h and last_strip:
        struct.pack_into(">H", raw, sof + 1, seg_h)  # libtiff cuts the frame to the strip
        h = seg_h
    if w > seg_w or h > seg_h:
        raise OSError(f"{name}: a TIFF JPEG strip or tile of {w}x{h} pixels, larger than its "
                      f"{seg_w}x{seg_h} (cv2.imread gives None)")
    if len(factors) != components:
        raise OSError(f"{name}: a TIFF JPEG strip or tile of {len(factors)} components, "
                      f"expected {components} (cv2.imread gives None)")
    if factors[0] != sampling or any(f != (1, 1) for f in factors[1:]):
        raise OSError(f"{name}: a TIFF JPEG strip or tile sampled {factors}, expected "
                      f"{sampling} then 1x1 (cv2.imread gives None)")
    out = np.empty((h, w, 3 if mode == 1 else components), np.uint8)
    msg = ctypes.create_string_buffer(_MSG)
    if _lib().ayolo_jpeg_decode(bytes(raw), len(raw), w, h, mode, _ptr(out), msg, _MSG):
        raise OSError(f"{name}: TIFF JPEG strip or tile: {msg.value.decode(errors='replace')}")
    if (w, h) == (seg_w, seg_h):
        return out
    strip = np.zeros((seg_h, seg_w, out.shape[2]), np.uint8)  # libtiff only warns
    strip[:h, :w] = out
    return strip


def decode_tiff(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """(h, w, 3) BGR uint8 of a TIFF's first image, as ``cv2.imread`` reads
    it through libtiff's RGBA interface: strips or tiles, planar
    configuration 1 or 2, no compression, LZW, PackBits, Deflate, JPEG
    (with or without JPEGTables) or CCITT (RLE, Group 3 1D and 2D, Group 4,
    RLEW), FillOrder 2 (each chunk's bits reversed, except JPEG's; CCITT
    reads it itself), predictor 2, MinIsBlack/MinIsWhite at 1, 8 or 16 bits
    (16 bits keep the high byte), RGB at 8 or 16 bits (16 bits rounded to
    8), an unassociated alpha premultiplied and then dropped, palettes at 1,
    4 or 8 bits (8-bit colour maps as libtiff detects them), 8-bit CMYK,
    8-bit YCbCr at each subsampling libtiff puts (JPEG's through libjpeg's
    conversion, as libtiff asks for it), CIELab at 8 or 16 bits, and
    Orientation 1-4 as libtiff applies them (5-8 of a square image as cv2
    turns it; of any other, cv2.imread gives None and the port raises
    naming the tag). What cv2 refuses (old-style JPEG, LZMA, ZSTD and the
    other compressions its libtiff lacks, float samples, ICCLab and the
    other colour spaces) raises ``OSError`` naming the feature."""
    data = bytes(data)
    e, tags = _tiff_ifd0(data, name)
    if 256 not in tags or 257 not in tags:
        raise OSError(f"{name}: TIFF without ImageWidth or ImageLength")
    w, h = tags[256][0], tags[257][0]
    if w == 0 or h == 0:
        raise OSError(f"{name}: empty TIFF image")
    _check_size(w, h, name)
    spp = tags.get(277, [1])[0]
    bits = tags.get(258, [1])[0]
    comp = tags.get(259, [1])[0]
    planar = tags.get(284, [1])[0]
    fmt = tags.get(339, [1])[0]
    extra = tags.get(338, [])
    orient = tags.get(274, [1])[0]
    orient = orient if 1 <= orient <= 8 else 1
    reverse = tags.get(266, [1])[0] == 2 and comp not in (7, *_CCITT)  # libtiff's TIFF_NOBITREV
    if comp in _TIFF_LEFT_OUT:
        raise _tiff_left_out(name, f"compression {comp} ({_TIFF_LEFT_OUT[comp]}; cv2.imread gives "
                                   "None)")
    if comp not in _TIFF_COMPRESSION:
        raise _tiff_left_out(name, f"compression {comp}")
    if 262 in tags:
        photo = tags[262][0]
    elif spp - len(extra) in (1, 3):
        photo = 1 if spp - len(extra) == 1 else 2
    else:
        raise OSError(f"{name}: TIFF without PhotometricInterpretation")
    if photo not in _TIFF_BITS:
        raise _tiff_left_out(name, f"photometric {photo} ({_PHOTOMETRIC.get(photo, 'unknown')}; "
                                   "cv2.imread gives None)")
    if fmt == 3:
        raise _tiff_left_out(name, "float samples (SampleFormat 3; cv2.imread gives None)")
    if spp > 4 or spp < 1:
        raise OSError(f"{name}: a TIFF of {spp} samples a pixel (cv2.imread gives None)")
    if bits not in _TIFF_BITS[photo] or (bits < 8 and spp > 1):
        raise OSError(f"{name}: a {_PHOTOMETRIC[photo]} TIFF of {bits} bits a sample "
                      "(cv2.imread gives None)")
    if orient >= 5 and w != h:
        raise OSError(f"{name}: TIFF Orientation {orient} of a {w}x{h} image (cv2.imread gives "
                      "None for 5-8 unless the image is square)")
    colour = spp - len(extra)
    if ((photo == 2 and colour < 3) or (photo == 5 and (spp != 4 or tags.get(332, [1])[0] != 1))
            or (photo in (6, 8) and spp != 3)):
        raise OSError(f"{name}: a {_PHOTOMETRIC[photo]} TIFF of {spp} samples "
                      "(cv2.imread gives None)")
    if photo == 3 and 320 not in tags:
        raise OSError(f"{name}: palette TIFF without a ColorMap")
    if comp in _CCITT and (bits != 1 or spp != 1):
        raise OSError(f"{name}: a CCITT TIFF of {spp} samples of {bits} bits (cv2.imread gives "
                      "None)")
    if comp == 7 and bits != 8:
        raise OSError(f"{name}: a JPEG TIFF of {bits} bits a sample (cv2.imread gives None)")
    predictor = tags.get(317, [1])[0] if comp in (5, 8, 32946) else 1
    if predictor not in (1, 2) or (predictor == 2 and bits < 8):
        raise _tiff_left_out(name, f"predictor {predictor} at {bits} bits")

    tiled = 322 in tags
    planes = spp if planar == 2 and spp > 1 else 1
    per = 1 if planes > 1 else spp  # samples in one chunk's pixel
    sh, sv = (tags.get(530, []) + [2, 2])[:2] if photo == 6 else (1, 1)
    first = tags.get(324 if tiled else 273, [0])[:1] + tags.get(325 if tiled else 279, [0])[:1]
    if comp == 7 and photo == 6 and planes == 1 and 530 not in tags and len(first) == 2:
        # libtiff's JPEGFixupTagsSubsampling: the first strip's sampling
        sh, sv = _jpeg_sof(data[first[0]: first[0] + first[1]], name)[3][0]
    if photo == 6 and comp != 7 and ((sh, sv) not in _YCBCR_SKIP
                                     or (planes > 1 and (sh, sv) != (1, 1))):
        raise OSError(f"{name}: YCbCr subsampling {sh}x{sv} of planar configuration {planar} is "
                      "not one libtiff puts (cv2.imread gives None)")
    if photo == 8 and planes > 1:
        raise OSError(f"{name}: a CIELab TIFF of planar configuration 2 (cv2.imread gives None)")
    if tiled:
        tw, th = tags[322][0], tags.get(323, [0])[0]
        if tw == 0 or th == 0:
            raise OSError(f"{name}: TIFF tile of {tw}x{th}")
        offsets, counts = tags.get(324, []), tags.get(325, [])
        across, down = -(-w // tw), -(-h // th)
    else:
        rps = tags.get(278, [h])[0]
        rps = h if rps == 0 or rps > h else rps
        tw, th = w, rps
        offsets, counts = tags.get(273, []), tags.get(279, [])
        across, down = 1, -(-h // rps)
    if tw * th * per * max(1, bits // 8) >= 1 << 30:  # OpenCV's limit on one strip or tile
        raise OSError(f"{name}: a TIFF strip or tile of {tw}x{th} pixels is beyond OpenCV's limits")
    n_chunks = across * down * planes
    if len(offsets) < n_chunks or len(counts) < n_chunks:
        raise OSError(f"{name}: TIFF has {len(offsets)} strip or tile offsets, needs {n_chunks}")
    row_bytes = (tw * per * bits + 7) // 8
    skewed = tiled and planes == 1 and photo in (0, 1) and (per > 1 or bits == 16)
    dtype = np.dtype(e + "u2") if bits == 16 else np.dtype(np.uint8)
    jpeg_mode = 1 if photo == 6 and planes == 1 else 2  # libtiff's JPEGCOLORMODE_RGB, else raw
    tables = bytes(tags[347]) if comp == 7 and 347 in tags else None
    out_per = 3 if photo == 6 and planes == 1 else per
    noeol = ctypes.c_int(0)  # libtiff's Group 3 "no EOL" mode, kept from strip to strip
    samples = np.zeros((planes, down * th, across * tw, out_per), dtype.newbyteorder("="))
    lib = None
    for k in range(n_chunks):
        plane, rest = divmod(k, across * down)
        ty, tx = divmod(rest, across)
        rows = th if tiled else min(th, h - ty * th)
        raw = data[offsets[k]: offsets[k] + counts[k]]
        if reverse:
            raw = raw.translate(_BIT_REVERSE)
        if comp == 7:
            samples[plane, ty * th: ty * th + rows, tx * tw: (tx + 1) * tw] = _jpeg_strip(
                raw, tables, tw, rows, not tiled and ty == down - 1, jpeg_mode, per,
                (sh, sv) if jpeg_mode == 1 else (1, 1), name)
            continue
        if photo == 6 and planes == 1:
            # packed sampling blocks; libtiff reads a strip's rows rounded up
            # to whole blocks, as rows x (a block row's bytes / sv) bytes
            block_row = -(-tw // sh) * (sh * sv + 2)
            full = -(-rows // sv) * block_row
            want = full if tiled else min(full, -(-rows // sv) * sv * (block_row // sv))
        else:
            want = rows * row_bytes
        if comp == 1:
            if reverse and tiled and want % 1024:
                # libtiff reads a bit-reversed tile into a buffer rounded up
                # to 1024 bytes and then refuses its byte count
                raise OSError(f"{name}: an uncompressed FillOrder 2 tile of {want} bytes, not a "
                              "multiple of 1024 (libtiff refuses it: cv2.imread gives None)")
            chunk = raw[:want]
        elif comp in (8, 32946):
            try:
                chunk = zlib.decompressobj().decompress(raw, want)
            except zlib.error as err:
                raise OSError(f"{name}: TIFF Deflate data is corrupt ({err})") from err
        elif comp in _CCITT:
            buf = np.zeros(want, np.uint8)
            msg = ctypes.create_string_buffer(_MSG)
            options = tags.get(292 if comp == 3 else 293, [0])[0]
            got = _lib("fax_codec").ayolo_fax_decode(raw, len(raw), comp, options,
                                                     tags.get(266, [1])[0], tw, rows,
                                                     offsets[k] & 1, ctypes.byref(noeol),
                                                     _ptr(buf), msg, _MSG)
            if got < 0:
                raise OSError(f"{name}: {msg.value.decode(errors='replace')}")
            chunk = buf.tobytes()  # a damaged row and those after it as libtiff leaves them
        else:
            buf = np.zeros(want, np.uint8)
            msg = ctypes.create_string_buffer(_MSG)
            lib = lib or _lib("raster_codec")
            got = lib.ayolo_tiff_unpack(raw, len(raw), comp, _ptr(buf), want, msg, _MSG)
            if got < 0:
                raise OSError(f"{name}: {msg.value.decode(errors='replace')}")
            chunk = buf[:got].tobytes()
        if len(chunk) < want:
            raise OSError(f"{name}: TIFF strip or tile {k} holds {len(chunk)} of {want} bytes")
        if photo == 6 and planes == 1:
            packed = np.frombuffer(chunk, np.uint8, want)
            rowsize = tw * 3 if tiled else block_row // sv
            if predictor == 2 and not (want % rowsize or rowsize % 3):
                # libtiff's horAcc8 over its rows of the packed bytes (rows it
                # cannot divide so fail, leaving the differences as decoded)
                packed = np.cumsum(packed.reshape(-1, rowsize // 3, 3), 1, dtype=np.uint8).ravel()
            npix = min(tw, w - tx * tw)
            stride = block_row if npix == tw else (-(-npix // sh) * (sh * sv + 2)
                                                  + (tw - npix) // sh * _YCBCR_SKIP[(sh, sv)])
            samples[plane, ty * th: ty * th + rows, tx * tw: tx * tw + npix] = _ycbcr_blocks(
                packed, rows, npix, sh, sv, stride)
            continue
        rows_u8 = np.frombuffer(chunk, np.uint8, want).reshape(rows, row_bytes)
        if bits < 8:
            px = np.unpackbits(rows_u8, axis=1)[:, : tw * bits].reshape(rows, tw, bits)
            px = (px * (1 << np.arange(bits - 1, -1, -1, dtype=np.uint8))).sum(2, dtype=np.uint8)
            px = px[..., None]
        elif bits == 8:
            px = rows_u8.reshape(rows, tw, per)
        else:
            px = rows_u8.view(dtype).astype(dtype.newbyteorder("=")).reshape(rows, tw, per)
        if predictor == 2:
            px = np.cumsum(px, axis=1, dtype=px.dtype)
        npix = min(tw, w - tx * tw)
        if skewed and npix < tw:
            # libtiff's grey put functions step through a clipped tile's
            # buffer (native byte order) by the pixels shown plus the
            # pixels cut, the latter counted as bytes
            native = np.frombuffer(px.astype("<u2" if bits == 16 else np.uint8).tobytes(), np.uint8)
            size = per * bits // 8
            step = npix * size + (tw - npix)
            shown = np.zeros((rows, npix * size), np.uint8)
            for r in range(rows):
                shown[r] = native[r * step: r * step + npix * size]
            px = np.zeros_like(px)
            px[:, :npix] = shown.view("<u2" if bits == 16 else np.uint8).reshape(rows, npix, per)
        samples[plane, ty * th: ty * th + rows, tx * tw: (tx + 1) * tw] = px
    samples = np.concatenate(list(samples), axis=2) if planes > 1 else samples[0]
    s = samples[:h, :w]
    flips = orient - 4 if orient >= 5 else orient  # libtiff reads 5-8 as 1-4
    if flips in (2, 3):  # libtiff mirrors each strip or tile within its width
        for tx in range(across):
            s[:, tx * tw: min((tx + 1) * tw, w)] = s[:, tx * tw: min((tx + 1) * tw, w)][:, ::-1]
    if flips in (3, 4):
        s = s[::-1]
    if orient >= 5:  # then cv2 turns a square image (transposed, 6 and 8 also flipped)
        s = apply_orientation(s, 5 if orient in (5, 7) else 7)
    if planes > 1 and photo in (0, 1):
        # separate planes of grey and alpha go through libtiff's RGB path:
        # no inversion, 16 bits rounded, an unassociated alpha applied
        s = np.concatenate([np.repeat(s[..., :1], 3, 2), s[..., 1:2]], 2)
        photo = 2
    if comp == 7 and photo == 6 and planes == 1:
        photo = 2  # libjpeg turned it into RGB
    return _tiff_bgr(s, photo, bits, extra, tags, name)


def _ycbcr_rgb(s: np.ndarray, tags: dict) -> np.ndarray:
    """libtiff's TIFFYCbCrToRGBInit tables (float arithmetic as libtiff
    computes them, ``YCbCrCoefficients`` and ``ReferenceBlackWhite`` or
    their defaults) and TIFFYCbCrtoRGB of (h, w, 3) Y, Cb, Cr: (h, w, 3)
    RGB."""
    f = np.float32
    luma = [f(v) for v in (tags.get(529, []) + [0.299, 0.587, 0.114][len(tags.get(529, [])):])[:3]]
    ref = [f(v) for v in tags.get(532, [0, 255, 128, 255, 128, 255])[:6]]
    if len(ref) < 6 or not luma[1]:
        raise OSError("bad YCbCrCoefficients or ReferenceBlackWhite")

    def fix(v):  # FIX(CLAMP(v, 0, 2)): the float times 65536, plus 0.5 in double
        v = min(max(v, f(0)), f(2))
        return int(float(v * f(65536)) + 0.5)

    f1 = f(2) - f(2) * luma[0]
    f3 = f(2) - f(2) * luma[2]
    d1, d2 = fix(f1), -fix(luma[0] * f1 / luma[1])
    d3, d4 = fix(f3), -fix(luma[2] * f3 / luma[1])

    def code2v(c, rb, rw, cr):  # ((c - (int)RB) * (float)CR) / (float)(RW - RB or 1)
        den = rw - rb
        v = (c - np.trunc(rb).astype(np.int64)).astype(f) * f(cr) / (den if den != 0 else f(1))
        return np.trunc(np.clip(v, f(-4096), f(4096))).astype(np.int64)

    x = np.arange(256) - 128
    cr = code2v(x, ref[4] - f(128), ref[5] - f(128), 127)
    cb = code2v(x, ref[2] - f(128), ref[3] - f(128), 127)
    ytab = code2v(x + 128, ref[0], ref[1], 255)
    y, b, r = ytab[s[..., 0]], cb[s[..., 1]], cr[s[..., 2]]
    red = y + ((d1 * r + (1 << 15)) >> 16)
    green = y + ((d4 * b + (1 << 15) + d2 * r) >> 16)
    blue = y + ((d3 * b + (1 << 15)) >> 16)
    return np.clip(np.stack([red, green, blue], -1), 0, 255).astype(np.uint8)


def _lab_rgb(s: np.ndarray, bits: int, tags: dict) -> np.ndarray:
    """libtiff's putcontig8bitCIELab8 and ...16 of (h, w, 3) L*a*b* samples:
    TIFFCIELab16ToXYZ against the WhitePoint (D50 where absent) and
    TIFFXYZToRGB through the display_sRGB tables of TIFFCIELabToRGBInit, in
    single precision as libtiff computes it. (h, w, 3) RGB."""
    f = np.float32
    wp = tags.get(318)
    if wp is None or len(wp) < 2:
        total = f(96.4250) + f(100.0) + f(82.4680)
        wp = [f(96.4250) / total, f(100.0) / total]
    wp = [f(v) for v in wp[:2]]
    if not wp[1]:
        raise OSError("a CIELab TIFF's WhitePoint of zero luminance")
    x0, y0, z0 = wp[0] / wp[1] * f(100), f(100), (f(1) - wp[0] - wp[1]) / wp[1] * f(100)
    if bits == 8:
        l16 = s[..., 0].astype(np.int64) * 257
        a16 = s[..., 1].astype(np.int8).astype(np.int64) * 256
        b16 = s[..., 2].astype(np.int8).astype(np.int64) * 256
    else:
        l16 = s[..., 0].astype(np.int64)
        a16, b16 = (s[..., k].astype(np.int16).astype(np.int64) for k in (1, 2))
    big_l = l16.astype(f) * f(100) / f(65535)
    dark = big_l < f(8.856)
    y_dark = big_l * y0 / f(903.292)
    cby_dark = f(7.787) * (y_dark / y0) + f(16) / f(116)
    cby_lit = (big_l + f(16)) / f(116)
    cby = np.where(dark, cby_dark, cby_lit)
    yy = np.where(dark, y_dark, y0 * cby_lit * cby_lit * cby_lit)

    def cube(t, ref):
        return np.where(t < f(0.2069), ref * (t - f(0.13793)) / f(7.787), ref * t * t * t)

    xx = cube(a16.astype(f) / f(256) / f(500) + cby, x0)
    zz = cube(cby - b16.astype(f) / f(256) / f(200), z0)
    mat = np.array([[3.2410, -1.5374, -0.4986], [-0.9692, 1.8760, 0.0416],
                    [0.0556, -0.2040, 1.0570]], f)
    table = f(255) * np.power(np.arange(1501) / 1500.0, 1.0 / float(f(2.4))).astype(f)
    step = (f(100) - f(1)) / f(1500)
    out = []
    for m in mat:
        lum = m[0] * xx + m[1] * yy + m[2] * zz
        lum = np.minimum(np.maximum(lum, f(1)), f(100))
        i = np.minimum(((lum - f(1)) / step).astype(np.int64), 1500)
        v = table[i].astype(np.float64)
        out.append(np.minimum(np.where(v > 0, v + 0.5, v - 0.5).astype(np.int64), 255))
    return np.stack(out, -1).astype(np.uint8)


def _tiff_bgr(s: np.ndarray, photo: int, bits: int, extra, tags: dict, name: str) -> np.ndarray:
    """libtiff's RGBA conversion of the samples (h, w, spp), then BGR."""
    if photo in (0, 1):
        g = s[..., 0].astype(np.int64)
        if bits == 16:
            g >>= 8
        top = 255 if bits == 16 else (1 << bits) - 1
        g = (g * 255 // top) if photo == 1 else ((top - g) * 255 // top)
        return np.repeat(g.astype(np.uint8)[..., None], 3, 2)
    if photo == 3:
        cmap = np.asarray(tags[320], np.int64)
        n = 1 << bits
        if cmap.size < 3 * n:
            raise OSError(f"{name}: TIFF ColorMap of {cmap.size} values, needs {3 * n}")
        cmap = cmap[: 3 * n].reshape(3, n)
        if (cmap >= 256).any():
            cmap >>= 8
        idx = s[..., 0].astype(np.int64)
        return np.stack([cmap[2][idx], cmap[1][idx], cmap[0][idx]], -1).astype(np.uint8)
    if photo == 6:
        try:
            return np.ascontiguousarray(_ycbcr_rgb(s, tags)[..., ::-1])
        except OSError as err:
            raise OSError(f"{name}: {err}") from err
    if photo == 8:
        try:
            return np.ascontiguousarray(_lab_rgb(s, bits, tags)[..., ::-1])
        except OSError as err:
            raise OSError(f"{name}: {err}") from err
    v = _ROUND16[s] if bits == 16 else s  # libtiff's Bitdepth16To8
    if photo == 5:
        k = 255 - v[..., 3:4].astype(np.uint16)
        rgb = k * (255 - v[..., :3].astype(np.uint16)) // 255
    else:
        rgb = v[..., :3]
        if len(extra) >= 1 and extra[0] == 2 and s.shape[2] >= 4:  # unassociated alpha
            rgb = (rgb.astype(np.uint16) * v[..., 3:4] + 127) // 255
    return np.ascontiguousarray(rgb[..., ::-1], dtype=np.uint8)


def tiff_orientation(data: bytes, name: str = "<bytes>") -> int:
    """IFD0's Orientation tag of a TIFF (1 where absent or out of range)."""
    o = _tiff_ifd0(data, name)[1].get(274, [1])[0]
    return o if 1 <= o <= 8 else 1


def tiff_size(data: bytes, name: str = "<bytes>") -> Tuple[int, int]:
    """(w, h) of a TIFF's first image, from its directory."""
    _, tags = _tiff_ifd0(data, name)
    if 256 not in tags or 257 not in tags:
        raise OSError(f"{name}: TIFF without ImageWidth or ImageLength")
    return tags[256][0], tags[257][0]


# ---- WebP ------------------------------------------------------------------------


def is_webp(data: bytes) -> bool:
    return len(data) >= 12 and data[:4] == b"RIFF" and data[8:12] == b"WEBP"


def _webp_chunks(data: bytes) -> Iterator[Tuple[bytes, int, int]]:
    """(tag, payload start, payload size) of each chunk of a RIFF WEBP file,
    as far as the data reaches."""
    pos = 12
    while pos + 8 <= len(data):
        tag = data[pos: pos + 4]
        (size,) = struct.unpack_from("<I", data, pos + 4)
        yield tag, pos + 8, size
        pos += 8 + size + (size & 1)


def _webp_frame_size(data: bytes, tag: bytes, at: int, size: int, name: str) -> Tuple[int, int]:
    """(w, h) of a VP8 or VP8L bitstream, checked as libwebp's GetInfo."""
    if tag == b"VP8L":
        if len(data) - at < 5 or data[at] != 0x2F or data[at + 4] >> 5:
            raise OSError(f"{name}: bad VP8L header")
        (v,) = struct.unpack_from("<I", data, at + 1)
        return (v & 0x3FFF) + 1, ((v >> 14) & 0x3FFF) + 1
    if len(data) - at < 10 or data[at + 3: at + 6] != b"\x9d\x01\x2a":
        raise OSError(f"{name}: bad VP8 header")
    bits = data[at] | (data[at + 1] << 8) | (data[at + 2] << 16)
    if bits & 1:
        raise OSError(f"{name}: VP8 data is not a key frame")
    if (bits >> 1) & 7 > 3 or not (bits >> 4) & 1 or (bits >> 5) >= size:
        raise OSError(f"{name}: bad VP8 frame header")
    w, h = (struct.unpack_from("<H", data, at + k)[0] & 0x3FFF for k in (6, 8))
    if w == 0 or h == 0:
        raise OSError(f"{name}: empty VP8 frame")
    return w, h


def _webp_parse(data: bytes, name: str) -> dict:
    """The container as libwebp (and cv2's WebP reader) reads it: the canvas
    size, the image chunk (tag, start, size) of the still image or of the
    first animation frame with its offset, and the EXIF payload."""
    if not is_webp(data):
        raise OSError(f"{name}: not a WebP file")
    (riff,) = struct.unpack_from("<I", data, 4)
    if riff < 12 or riff > len(data) - 8:
        raise OSError(f"{name}: WebP data is cut short (RIFF size {riff}, {len(data)} bytes)")
    data = data[: riff + 8]
    out = {"exif": None, "offset": (0, 0), "animated": False}
    canvas, flags = None, 0
    for tag, at, size in _webp_chunks(data):
        if at + size > len(data):
            raise OSError(f"{name}: WebP chunk {tag!r} is cut short")
        if tag == b"VP8X":
            if size != 10:
                raise OSError(f"{name}: bad VP8X chunk")
            flags = data[at]
            canvas = (1 + int.from_bytes(data[at + 4: at + 7], "little"),
                      1 + int.from_bytes(data[at + 7: at + 10], "little"))
            out["animated"] = bool(flags & 2)
        elif tag == b"EXIF" and out["exif"] is None and canvas and flags & 8:
            out["exif"] = data[at: at + size]  # libwebp's demuxer keeps it under the flag only
        elif tag in (b"VP8 ", b"VP8L") and "image" not in out:
            out["image"] = (tag, at, size)
        elif tag == b"ANMF" and "image" not in out:
            if size < 16:
                raise OSError(f"{name}: bad ANMF chunk")
            out["offset"] = (2 * int.from_bytes(data[at: at + 3], "little"),
                             2 * int.from_bytes(data[at + 3: at + 6], "little"))
            for sub, sat, ssize in _webp_chunks(b"\0" * 12 + data[at + 16: at + size]):
                if sub in (b"VP8 ", b"VP8L"):
                    out["image"] = (sub, at + 16 + sat - 12, ssize)
                    break
    if "image" not in out:
        raise OSError(f"{name}: WebP file without image data")
    tag, at, size = out["image"]
    frame = _webp_frame_size(data, tag, at, size, name)
    out["frame"] = frame
    out["canvas"] = canvas or frame
    if canvas and not out["animated"] and canvas != frame:
        raise OSError(f"{name}: WebP canvas {canvas} differs from its image {frame}")
    return out


def webp_orientation(data: bytes, name: str = "<bytes>", exif_id: bool = False) -> int:
    """The orientation tag of a WebP's EXIF chunk (kept only under the
    VP8X EXIF flag); 1 where there is none. cv2 reads it only from a chunk
    that starts with the TIFF header; with ``exif_id`` also after an
    ``Exif\0\0`` prefix, as PIL does."""
    try:
        exif = _webp_parse(data, name)["exif"]
    except OSError:
        return 1
    if not exif:
        return 1
    if exif_id and exif.startswith(b"Exif\0\0"):
        exif = exif[6:]
    return _tiff_orientation(exif)


def decode_webp(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """(h, w, 3) BGR uint8 of a WebP, as ``cv2.imread`` before its EXIF
    rotation: the VP8L or VP8 image decoded as libwebp's
    ``WebPDecodeBGRInto`` (alpha not decoded: BGR output drops it); of an
    animation, the first frame on a transparent black canvas."""
    data = bytes(data)
    info = _webp_parse(data, name)
    tag, at, size = info["image"]
    fw, fh = info["frame"]
    cw, ch = info["canvas"]
    _check_size(cw, ch, name)
    frame = np.empty((fh, fw, 3), np.uint8)
    msg = ctypes.create_string_buffer(_MSG)
    lib = _lib("webp_codec")
    fn = lib.ayolo_vp8l_decode if tag == b"VP8L" else lib.ayolo_vp8_decode
    if fn(data[at:], len(data) - at, fw, fh, _ptr(frame), msg, _MSG):
        raise OSError(f"{name}: {msg.value.decode(errors='replace')}")
    if (fw, fh) == (cw, ch):
        return frame
    x, y = info["offset"]
    if x + fw > cw or y + fh > ch:
        raise OSError(f"{name}: WebP frame lies outside its canvas")
    out = np.zeros((ch, cw, 3), np.uint8)
    out[y: y + fh, x: x + fw] = frame
    return out


def webp_size(data: bytes, name: str = "<bytes>") -> Tuple[int, int]:
    """(w, h) of a WebP's canvas (of its image where there is no VP8X)."""
    return _webp_parse(data, name)["canvas"]


def header_size(data: bytes, name: str = "<bytes>") -> Tuple[int, int]:
    """(w, h) of a JPEG (its SOF), PNG (IHDR), BMP (its header), TIFF (IFD0)
    or WebP (its canvas) without decoding a pixel; raises ``OSError`` for
    anything else."""
    if data.startswith(PNG_SIGNATURE):
        if len(data) < 33 or data[12:16] != b"IHDR":
            raise OSError(f"{name}: PNG file without an IHDR chunk")
        return struct.unpack_from(">II", data, 16)
    if data.startswith(JPEG_SIGNATURE):
        return _jpeg_frame(data, name)
    if data.startswith(BMP_SIGNATURE):
        hd = _bmp_header(data, name)
        return hd["w"], abs(hd["h"])
    if data.startswith(TIFF_SIGNATURES):
        return tiff_size(data, name)
    if is_webp(data):
        return webp_size(data, name)
    raise OSError(f"{name}: not a JPEG, PNG, BMP, TIFF or WebP file")
