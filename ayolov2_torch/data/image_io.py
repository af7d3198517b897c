"""Host image I/O without OpenCV: reading, shapes and resizes as cv2 does them.

- :func:`imread` chooses the decoder from the file's first bytes, as cv2
  does, not from its suffix: JPEG (``FF D8 FF``), PNG, BMP (``BM``), TIFF
  (``II*``/``MM*``, DNG included) and WebP (``RIFF....WEBP``) go to the
  port's own codecs (``data/codecs.py``, C++ libraries built at first use),
  equal to ``cv2.imread`` bit for bit in every mode cv2 reads (TIFF's
  JPEG, CCITT, YCbCr and CIELab, lossless and arithmetic-coded JPEG
  included), and JPEG, PNG and WebP are turned by their EXIF orientation as
  ``cv2.imread`` turns them (TIFF's Orientation 1-4 as libtiff applies it).
  A mode cv2 refuses raises ``OSError`` naming it, with cv2 installed or
  not; only a file of another signature goes to ``cv2``, imported only
  then; without it the error names the file and the package.
- :func:`image_size` reads (w, h) from any of these headers without
  decoding a pixel, as the JAX package's ``exif_size(PIL.Image.open(f))``
  gives it: swapped for EXIF orientations 6 and 8 of a JPEG, PNG or WebP,
  for a TIFF's Orientation 5-8 (PIL sizes it turned) and never for a BMP.
- :func:`imwrite` writes ``.jpg``/``.jpeg`` through the port's encoder
  (the bytes of ``cv2.imwrite`` at its defaults: quality 95, 4:2:0),
  ``.png`` through ``utils/png.write_png`` and ``.bmp`` itself (24-bit,
  bottom-up); every other format needs cv2.
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

from ayolov2_torch.data import codecs
from ayolov2_torch.utils.png import write_png


def _cv2(path: str, what: str):
    try:
        import cv2
    except ImportError as e:
        raise ImportError(
            f"{path}: {what} needs OpenCV (the package 'cv2'), which is not installed; "
            "the port reads JPEG, PNG, BMP, TIFF and WebP files itself") from e
    return cv2


def imread(path: str) -> np.ndarray:
    """(h, w, 3) BGR uint8, as ``cv2.imread(path)``; raises ``OSError``
    where cv2 gives None."""
    data = Path(path).read_bytes()
    if data.startswith(codecs.JPEG_SIGNATURE):
        return codecs.apply_orientation(codecs.decode_jpeg(data, path),
                                        codecs.exif_orientation(data, name=path))
    if data.startswith(codecs.PNG_SIGNATURE):
        return codecs.apply_orientation(codecs.decode_png(data, path),
                                        codecs.exif_orientation(data, name=path))
    if data.startswith(codecs.BMP_SIGNATURE):
        return codecs.decode_bmp(data, path)
    if data.startswith(codecs.TIFF_SIGNATURES):
        return codecs.decode_tiff(data, path)
    if codecs.is_webp(data):
        return codecs.apply_orientation(codecs.decode_webp(data, path),
                                        codecs.webp_orientation(data, path))
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
    """``cv2.imwrite(path, im)`` of a BGR uint8 image (or a gray one for
    ``.jpg`` and ``.png``): ``.jpg``/``.jpeg`` through the port's JPEG
    encoder at cv2's defaults, ``.png`` by ``write_png``, ``.bmp`` by
    :func:`write_bmp`; any other format needs cv2."""
    suffix = Path(path).suffix.lower()
    if suffix in (".jpg", ".jpeg"):
        Path(path).write_bytes(codecs.encode_jpeg(im))
    elif suffix == ".png":
        write_png(path, im)
    elif suffix == ".bmp":
        write_bmp(path, im)
    elif not _cv2(path, "encoding this image").imwrite(str(path), im):
        raise OSError(f"Image write failed: {path}")


def image_size(path: str) -> Tuple[int, int]:
    """(w, h) of an image file from its header, as the JAX package's
    ``exif_size(PIL.Image.open(path))``: swapped where the EXIF orientation
    is 6 or 8 (PIL's first ``Exif`` APP1 of a JPEG, the ``eXIf`` chunk of a
    PNG, the ``EXIF`` chunk of a WebP) and for a TIFF whose Orientation is
    5-8, which PIL sizes turned; raises ``OSError`` for a file whose header
    cannot be read."""
    with open(path, "rb") as f:
        data = f.read(1 << 16)
    if data.startswith((codecs.PNG_SIGNATURE, *codecs.TIFF_SIGNATURES)) or codecs.is_webp(data):
        data = Path(path).read_bytes()  # eXIf, EXIF or an IFD may lie past the first 64 KiB
    elif data.startswith(codecs.JPEG_SIGNATURE):
        try:
            codecs.header_size(data, path)
        except OSError:  # a header past the first 64 KiB
            data = Path(path).read_bytes()
    if not (data.startswith((codecs.JPEG_SIGNATURE, codecs.PNG_SIGNATURE, codecs.BMP_SIGNATURE,
                             *codecs.TIFF_SIGNATURES)) or codecs.is_webp(data)):
        h, w = imread(path).shape[:2]  # another format: cv2 decodes it
        return w, h
    w, h = codecs.header_size(data, path)
    if data.startswith(codecs.JPEG_SIGNATURE) or data.startswith(codecs.PNG_SIGNATURE):
        swap = codecs.exif_orientation(data, exif_id=True, name=path) in (6, 8)
    elif codecs.is_webp(data):
        swap = codecs.webp_orientation(data, path, exif_id=True) in (6, 8)
    else:  # PIL sizes a TIFF with Orientation 5-8 turned
        swap = data.startswith(codecs.TIFF_SIGNATURES) and codecs.tiff_orientation(data) >= 5
    return (h, w) if swap else (w, h)


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
