"""PNG files without OpenCV or PIL: 8-bit RGB and gray, written and read.

The port's plots are written by :func:`write_png`. Colour arrays are BGR,
as ``cv2.imwrite`` takes them, and the file stores RGB; so ``cv2.imread``
of the file gives back the array that was written. :func:`read_png` is the
inverse (BGR out) for the files ``write_png`` writes (every row unfiltered),
for the tests and for checking written plots where OpenCV is absent. Only
the standard library's ``zlib``, ``struct`` and ``binascii`` and numpy are
used.
"""

from __future__ import annotations

import binascii
import struct
import zlib
from pathlib import Path
from typing import Union

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_GRAY, _RGB = 0, 2  # PNG colour types


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", binascii.crc32(kind + data) & 0xFFFFFFFF))


def write_png(path: Union[str, Path], img: np.ndarray) -> None:
    """Write an (H, W) gray or (H, W, 3) BGR uint8 array as a PNG file."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim not in (2, 3) or (img.ndim == 3 and img.shape[2] != 3):
        raise ValueError(f"write_png takes (H, W) or (H, W, 3) uint8, got {img.dtype} {img.shape}")
    h, w = img.shape[:2]
    if h == 0 or w == 0:
        raise ValueError(f"an image of {h}x{w} pixels has no PNG")
    rows = img[..., ::-1].reshape(h, -1) if img.ndim == 3 else img
    raw = np.empty((h, rows.shape[1] + 1), np.uint8)
    raw[:, 0] = 0  # filter type None on every row
    raw[:, 1:] = rows
    header = struct.pack(">IIBBBBB", w, h, 8, _RGB if img.ndim == 3 else _GRAY, 0, 0, 0)
    Path(path).write_bytes(_SIGNATURE + _chunk(b"IHDR", header)
                           + _chunk(b"IDAT", zlib.compress(raw.tobytes())) + _chunk(b"IEND", b""))


def read_png(path: Union[str, Path]) -> np.ndarray:
    """An 8-bit non-interlaced gray or RGB PNG as (H, W) or (H, W, 3) BGR."""
    blob = Path(path).read_bytes()
    if not blob.startswith(_SIGNATURE):
        raise ValueError(f"{path} is not a PNG file")
    pos, idat, header = len(_SIGNATURE), [], None
    while pos < len(blob):
        (n,) = struct.unpack(">I", blob[pos: pos + 4])
        kind, data = blob[pos + 4: pos + 8], blob[pos + 8: pos + 8 + n]
        (crc,) = struct.unpack(">I", blob[pos + 8 + n: pos + 12 + n])
        if binascii.crc32(kind + data) & 0xFFFFFFFF != crc:
            raise ValueError(f"{path}: bad CRC in chunk {kind!r}")
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", data)
        elif kind == b"IDAT":
            idat.append(data)
        elif kind == b"IEND":
            break
        pos += 12 + n
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, ctype, _, _, interlace = header
    if depth != 8 or ctype not in (_GRAY, _RGB) or interlace:
        raise ValueError(f"{path}: only 8-bit non-interlaced gray or RGB is read "
                         f"(depth {depth}, colour type {ctype}, interlace {interlace})")
    ch = 3 if ctype == _RGB else 1
    data = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(h, w * ch + 1)
    if data[:, 0].any():
        raise ValueError(f"{path}: rows with filters other than None (this reader takes the "
                         "files write_png writes)")
    rows = data[:, 1:]
    return rows.reshape(h, w, 3)[..., ::-1].copy() if ch == 3 else rows.reshape(h, w).copy()
