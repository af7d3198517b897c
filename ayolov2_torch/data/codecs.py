"""JPEG and PNG without OpenCV or PIL: the port's own codecs.

The pixels come from ``csrc/image_codec.cpp``, a C++ library built by the
host compiler at first use into ``build/torch_kernels/`` (``ops/_build.
load``) and called through ``ctypes``, which releases the GIL, so the
loader's threads decode at once. A library that does not build raises with
the compiler's output; nothing falls back to OpenCV.

- :func:`decode_jpeg` is ``cv2.imread`` of a file holding ``data``, before
  the EXIF rotation: libjpeg-turbo's baseline, extended and progressive
  Huffman decoding, islow IDCT, fancy upsampling and YCbCr -> BGR, bit for
  bit, and a cut file read on as libjpeg's stdio source reads it (block
  smoothing of a cut progressive file included).
- :func:`encode_jpeg` gives the bytes of ``cv2.imencode('.jpg', im,
  [IMWRITE_JPEG_QUALITY, quality])`` (4:2:0, baseline, standard tables).
- :func:`decode_png` is ``cv2.imread`` of a PNG, without the rotation, for
  every colour type and bit depth, ``tRNS`` and Adam7: the chunks are read
  and inflated here (``zlib``), unfiltered and converted in C++. A critical
  chunk with a bad CRC, a cut file or too little image data raise as
  ``cv2.imread`` gives None; an ancillary chunk with a bad CRC is skipped.
- :func:`header_size` reads (w, h) from a JPEG's SOF or a PNG's IHDR;
  :func:`exif_orientation` reads the orientation tag, and
  :func:`apply_orientation` turns an image as cv2's ``ApplyExifOrientation``.

Errors raise ``OSError`` (or ``ValueError`` for a bad argument) naming the
file and what failed; a JPEG feature that is not decoded (arithmetic coding,
lossless, 12-bit, CMYK/YCCK) is named in the message, and a header beyond
OpenCV's size limits (``CV_IO_MAX_IMAGE_*``) raises before any allocation.
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
_LIB: Optional[ctypes.CDLL] = None


def _lib() -> ctypes.CDLL:
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = _build.load("image_codec")
            u8p, i64 = ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64
            lib.ayolo_jpeg_decode.argtypes = [ctypes.c_char_p, i64, ctypes.c_int, ctypes.c_int,
                                              u8p, ctypes.c_char_p, ctypes.c_int]
            lib.ayolo_jpeg_encode.argtypes = [u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                              ctypes.c_int, ctypes.POINTER(u8p),
                                              ctypes.POINTER(i64)]
            lib.ayolo_free.argtypes = [u8p]
            lib.ayolo_free.restype = None
            lib.ayolo_png_pixels.argtypes = [u8p, i64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                             ctypes.c_int, ctypes.c_int, ctypes.c_char_p,
                                             ctypes.c_int, u8p, ctypes.c_char_p, ctypes.c_int]
            _LIB = lib
    return _LIB


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
    rc = _lib().ayolo_jpeg_decode(data, len(data), w, h, _ptr(out), msg, _MSG)
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


def header_size(data: bytes, name: str = "<bytes>") -> Tuple[int, int]:
    """(w, h) of a JPEG (its SOF) or PNG (its IHDR) without decoding a pixel;
    raises ``OSError`` for anything else."""
    if data.startswith(PNG_SIGNATURE):
        if len(data) < 33 or data[12:16] != b"IHDR":
            raise OSError(f"{name}: PNG file without an IHDR chunk")
        return struct.unpack_from(">II", data, 16)
    if data.startswith(JPEG_SIGNATURE):
        return _jpeg_frame(data, name)
    raise OSError(f"{name}: neither a JPEG nor a PNG file")
