"""PNG files without OpenCV or PIL: written, and read through the port's codec.

The port's plots are written by :func:`write_png`. Colour arrays are BGR,
as ``cv2.imwrite`` takes them, and the file stores RGB; so ``cv2.imread``
of the file gives back the array that was written. :func:`read_png` is the
inverse for any PNG: it decodes through ``data/codecs.decode_png`` (every
colour type and depth, Adam7, as ``cv2.imread``) and gives a gray file's
one channel as (H, W). Writing uses only the standard library's ``zlib``,
``struct`` and ``binascii`` and numpy.
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
    """A PNG as (H, W, 3) BGR uint8, or (H, W) for the gray colour types
    (0 and 4); raises ``OSError`` where ``cv2.imread`` gives None."""
    from ayolov2_torch.data.codecs import decode_png

    blob = Path(path).read_bytes()
    img = decode_png(blob, str(path))
    return img[..., 0].copy() if blob[25:26] in (b"\x00", b"\x04") else img
