"""Host image I/O without OpenCV: reading, shapes and resizes as cv2 does them.

- :func:`imread` decodes 24-bit uncompressed (BI_RGB) ``.bmp`` files itself,
  bottom-up or top-down, rows padded to 4 bytes, into the BGR uint8 array
  ``cv2.imread`` gives. Every other file goes to ``cv2``, imported only then;
  without it the error names the file and the package.
- :func:`image_size` reads a ``.bmp``'s (w, h) from its header, and asks
  ``cv2`` for other formats (the ``exif_size`` of a file without an EXIF
  rotation).
- :func:`imwrite` writes a ``.bmp`` itself (24-bit, bottom-up) and gives
  every other format to ``cv2``.
- :func:`resize_linear` is ``cv2.resize(..., INTER_LINEAR)`` on uint8: the
  same source positions, 11-bit fixed-point weights and integer rounding.
  :func:`resize_area` is ``INTER_AREA`` for shrinking: per axis the overlap
  weights of ``computeResizeAreaTab``, summed in f32 in OpenCV's order (an
  integer factor takes its block mean, rounded as OpenCV's fast path does).
  Both equal OpenCV 5.0's output on the CPU tests' images; the tests hold
  them to one grey level.
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import Optional, Tuple

import numpy as np


def _bmp_header(data: bytes) -> Optional[Tuple[int, int, int, int, int]]:
    """(offset, width, height, bits per pixel, compression) of a BMP with a
    BITMAPINFOHEADER or a later header; None for anything else."""
    if len(data) < 54 or data[:2] != b"BM":
        return None
    offset, dib = struct.unpack_from("<II", data, 10)
    if dib < 40:
        return None
    width, height, _, bpp, compression = struct.unpack_from("<iiHHI", data, 18)
    return offset, width, height, bpp, compression


def _cv2(path: str, what: str):
    try:
        import cv2
    except ImportError as e:
        raise ImportError(
            f"{path}: {what} needs OpenCV (the package 'cv2'), which is not installed; "
            "the port decodes 24-bit uncompressed .bmp files itself") from e
    return cv2


def _read_bmp(data: bytes) -> Optional[np.ndarray]:
    head = _bmp_header(data)
    if head is None:
        return None
    offset, width, height, bpp, compression = head
    if bpp != 24 or compression != 0 or width <= 0 or height == 0:
        return None
    h = abs(height)
    pitch = (width * 3 + 3) // 4 * 4
    if offset + pitch * h > len(data):
        raise ValueError(f"BMP pixel data is truncated ({len(data)} bytes, need "
                         f"{offset + pitch * h})")
    rows = np.frombuffer(data, np.uint8, pitch * h, offset).reshape(h, pitch)
    im = rows[:, : width * 3].reshape(h, width, 3)
    return np.ascontiguousarray(im[::-1] if height > 0 else im)


def imread(path: str) -> np.ndarray:
    """(h, w, 3) BGR uint8, as ``cv2.imread(path)``; raises if unreadable."""
    if Path(path).suffix.lower() == ".bmp":
        im = _read_bmp(Path(path).read_bytes())
        if im is not None:
            return im
    im = _cv2(path, "decoding this image").imread(path)
    if im is None:
        raise OSError(f"Image read failed: {path}")
    return im


def write_bmp(path: str, im: np.ndarray) -> None:
    """(h, w, 3) BGR uint8 as a 24-bit bottom-up BMP, rows padded to 4 bytes
    (what :func:`imread` decodes)."""
    h, w, _ = im.shape
    pitch = (w * 3 + 3) // 4 * 4
    rows = np.zeros((h, pitch), np.uint8)
    rows[:, : w * 3] = np.ascontiguousarray(im[::-1]).reshape(h, w * 3)
    head = struct.pack("<2sIHHI", b"BM", 54 + pitch * h, 0, 0, 54)
    head += struct.pack("<IiiHHIIiiII", 40, w, h, 1, 24, 0, pitch * h, 2835, 2835, 0, 0)
    Path(path).write_bytes(head + rows.tobytes())


def imwrite(path: str, im: np.ndarray) -> None:
    """``cv2.imwrite(path, im)`` of a BGR uint8 image: a ``.bmp`` is written
    by :func:`write_bmp`, any other format needs cv2."""
    if Path(path).suffix.lower() == ".bmp":
        write_bmp(path, im)
    elif not _cv2(path, "encoding this image").imwrite(str(path), im):
        raise OSError(f"Image write failed: {path}")


def image_size(path: str) -> Tuple[int, int]:
    """(w, h) of an image file."""
    if Path(path).suffix.lower() == ".bmp":
        with open(path, "rb") as f:
            head = _bmp_header(f.read(54))
        if head is not None:
            return head[1], abs(head[2])
    h, w = imread(path).shape[:2]
    return w, h


def _linear_taps(src: int, dst: int, columns: bool, scale: Optional[float] = None):
    """cv2's INTER_LINEAR taps per output index, as resize.cpp computes them:
    (i0, i1, w0, w1), 11-bit weights. ``scale`` (source pixels per output
    pixel) defaults to ``src / dst``. For columns a source index outside
    the image is clamped with its weight; for rows only the index is."""
    if scale is None:
        scale = 1.0 / (dst / src)
    f = ((np.arange(dst, dtype=np.float64) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    f = (f - s.astype(np.float32)).astype(np.float32)
    if columns:
        low, high = s < 0, s >= src - 1
        f[low | high] = 0.0
        s[low] = 0
        s[high] = src - 1
    w0 = np.rint((np.float32(1.0) - f) * np.float32(2048)).astype(np.int64)
    w1 = np.rint(f * np.float32(2048)).astype(np.int64)
    return np.clip(s, 0, src - 1), np.clip(s + 1, 0, src - 1), w0, w1


def resize_linear(im: np.ndarray, size: Tuple[int, int],
                  scale: Optional[Tuple[float, float]] = None) -> np.ndarray:
    """``cv2.resize(im, size, interpolation=cv2.INTER_LINEAR)`` for (h, w, c)
    uint8; ``size`` is (w, h). ``scale`` (x, y) is the source step per
    output pixel where it is not ``w / size``: ``cv2.resize(im, (0, 0),
    fx=f, fy=f)`` maps by ``1 / f``."""
    dw, dh = size
    h, w = im.shape[:2]
    sx, sy = scale if scale is not None else (None, None)
    x0, x1, a0, a1 = _linear_taps(w, dw, columns=True, scale=sx)
    src = im.astype(np.int64)
    rows = src[:, x0] * a0[None, :, None] + src[:, x1] * a1[None, :, None]
    y0, y1, b0, b1 = _linear_taps(h, dh, columns=False, scale=sy)
    # the rows combine as OpenCV's vector code does: 16-bit products of the
    # sums shifted right by 4, high halves added, rounded off by 2 bits
    out = ((rows[y0] >> 4) * b0[:, None, None] >> 16) + ((rows[y1] >> 4) * b1[:, None, None] >> 16)
    return np.clip((out + 2) >> 2, 0, 255).astype(np.uint8)


def _area_taps(src: int, dst: int):
    """``computeResizeAreaTab``: (dst index, src index, f32 weight) entries."""
    scale = 1.0 / (dst / src)
    di, si, alpha = [], [], []
    for dx in range(dst):
        fsx1 = dx * scale
        fsx2 = fsx1 + scale
        cell = min(scale, src - fsx1)
        sx1, sx2 = int(np.ceil(fsx1)), int(np.floor(fsx2))
        sx2 = min(sx2, src - 1)
        sx1 = min(sx1, sx2)
        if sx1 - fsx1 > 1e-3:
            di.append(dx), si.append(sx1 - 1), alpha.append((sx1 - fsx1) / cell)
        for sx in range(sx1, sx2):
            di.append(dx), si.append(sx), alpha.append(1.0 / cell)
        if fsx2 - sx2 > 1e-3:
            di.append(dx), si.append(sx2), alpha.append(min(min(fsx2 - sx2, 1.0), cell) / cell)
    return np.array(di), np.array(si), np.array(alpha, np.float32)


def resize_area(im: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """``cv2.resize(im, size, interpolation=cv2.INTER_AREA)`` for shrinking
    (h, w, c) uint8; ``size`` is (w, h)."""
    dw, dh = size
    h, w, c = im.shape
    sx, sy = 1.0 / (dw / w), 1.0 / (dh / h)
    if sx < 1 or sy < 1:
        raise ValueError(f"resize_area shrinks only: {w}x{h} -> {dw}x{dh}")
    kx, ky = int(round(sx)), int(round(sy))
    if abs(sx - kx) < np.finfo(np.float64).eps and abs(sy - ky) < np.finfo(np.float64).eps:
        blocks = im[: dh * ky, : dw * kx].astype(np.int64)
        total = blocks.reshape(dh, ky, dw, kx, c).sum((1, 3))
        if kx == ky == 2:
            return ((total + 2) >> 2).astype(np.uint8)
        mean = total.astype(np.float32) * np.float32(1.0 / (kx * ky))
        return np.clip(np.rint(mean), 0, 255).astype(np.uint8)
    xd, xs, xa = _area_taps(w, dw)
    yd, ys, ya = _area_taps(h, dh)
    src = im.astype(np.float32)
    # each output column sums its entries in table order
    rows = np.zeros((h, dw, c), np.float32)
    slot = np.zeros(len(xd), np.int64)
    for k in range(1, len(xd)):
        slot[k] = slot[k - 1] + 1 if xd[k] == xd[k - 1] else 0
    for j in range(slot.max() + 1):
        sel = slot == j
        rows[:, xd[sel]] += src[:, xs[sel]] * xa[sel][None, :, None]
    out = np.zeros((dh, dw, c), np.float32)
    first = np.ones(len(yd), bool)
    first[1:] = yd[1:] != yd[:-1]
    for k in range(len(yd)):
        term = ya[k] * rows[ys[k]]
        out[yd[k]] = term if first[k] else out[yd[k]] + term
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)
