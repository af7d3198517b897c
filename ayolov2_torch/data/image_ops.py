"""The pixel operations of host augmentation, in numpy, computed as OpenCV 5.0
computes them.

Each function stands for one ``cv2`` call of the JAX package's augmentation
path and takes and returns (h, w, 3) BGR uint8 unless it says otherwise:

- :func:`warp_affine` / :func:`warp_perspective`: ``cv2.warpAffine`` /
  ``cv2.warpPerspective`` with INTER_LINEAR and a constant border. OpenCV
  5.0 inverts the matrix in f64 and rounds it to f32; per output pixel it
  maps ``x`` and ``y`` with fused multiply-adds in f32 (``X = fma(x, m0,
  fma(y, m1, m2))``; in perspective ``W`` the same way, then ``X * (1 /
  W)``), and blends the four taps with f32 fused multiply-adds ``v0 =
  fma(fx, p01 - p00, p00)``, ``v1`` alike, ``v = fma(fy, v1 - v0, v0)``,
  rounded to nearest. A tap outside the image takes the border value. The
  fused products are emulated in f64, where the product of two f32 values
  is exact. An axis-aligned affine matrix maps x and y apart, so its
  coordinates are computed once per column and once per row.
- :func:`bgr2hsv` (OpenCV's integer division tables), :func:`hsv2bgr` (its
  f32 path, truncated) and :func:`lut`, for ``augment_hsv``.
- :func:`fill_polygons` (``cv2.drawContours(..., FILLED)``: the 8-connected
  outline of each edge, then the scanline fill of ``FillEdgeCollection``
  in 16-bit fixed point), :func:`flip`, and ``np.bitwise_and`` for
  ``cv2.bitwise_and``.
- :func:`resize_scale`: ``cv2.resize(im, (0, 0), fx=f, fy=f)``, INTER_LINEAR
  with the scale ``1 / f`` rather than ``w / dsize``.
- The pixel policies' primitives: :func:`box_blur`, :func:`median_blur`,
  :func:`bgr2gray` / :func:`gray2bgr`, :func:`bgr2lab` / :func:`lab2bgr` and
  :func:`clahe`, :func:`convert_scale_abs`, :func:`filter2d`,
  :func:`add_weighted` and :func:`jpeg_roundtrip`.

The tests hold each against ``cv2`` on seeded images
(``tests/test_torch_port_image_ops.py``).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

from ayolov2_torch.data.image_io import resize_linear

F32 = np.float32


def _fma32(a, b, c) -> np.ndarray:
    """f32 ``a * b + c`` with one rounding (the product of two f32 values
    is exact in f64)."""
    return (np.asarray(a, np.float64) * b + c).astype(F32)


# ---- warps ---------------------------------------------------------------------------


def _invert_affine(M: np.ndarray) -> np.ndarray:
    """(2, 3) inverse as ``warpAffine`` computes it (f64)."""
    M = np.asarray(M, np.float64)
    d = M[0, 0] * M[1, 1] - M[0, 1] * M[1, 0]
    d = 1.0 / d if d != 0 else 0.0
    a11, a22, a12, a21 = M[1, 1] * d, M[0, 0] * d, -M[0, 1] * d, -M[1, 0] * d
    return np.array([[a11, a12, -a11 * M[0, 2] - a12 * M[1, 2]],
                     [a21, a22, -a21 * M[0, 2] - a22 * M[1, 2]]])


def _invert_3x3(S: np.ndarray) -> np.ndarray:
    """``cv::invert`` of a 3x3 f64 matrix (its direct formula)."""
    S = np.asarray(S, np.float64)
    d = (S[0, 0] * (S[1, 1] * S[2, 2] - S[1, 2] * S[2, 1])
         - S[0, 1] * (S[1, 0] * S[2, 2] - S[1, 2] * S[2, 0])
         + S[0, 2] * (S[1, 0] * S[2, 1] - S[1, 1] * S[2, 0]))
    if d == 0:
        return np.zeros((3, 3))
    d = 1.0 / d
    return np.array([
        [(S[1, 1] * S[2, 2] - S[1, 2] * S[2, 1]) * d, (S[0, 2] * S[2, 1] - S[0, 1] * S[2, 2]) * d,
         (S[0, 1] * S[1, 2] - S[0, 2] * S[1, 1]) * d],
        [(S[1, 2] * S[2, 0] - S[1, 0] * S[2, 2]) * d, (S[0, 0] * S[2, 2] - S[0, 2] * S[2, 0]) * d,
         (S[0, 2] * S[1, 0] - S[0, 0] * S[1, 2]) * d],
        [(S[1, 0] * S[2, 1] - S[1, 1] * S[2, 0]) * d, (S[0, 1] * S[2, 0] - S[0, 0] * S[2, 1]) * d,
         (S[0, 0] * S[1, 1] - S[0, 1] * S[1, 0]) * d]])


def _taps(coord: np.ndarray, size: int):
    """Integer taps (i0, i1) and f32 fractions of f32 source coordinates; a
    tap outside [0, size) points at index ``size`` (the border)."""
    fl = np.floor(np.clip(coord, -4.0, size + 4.0))
    frac = (coord - fl.astype(F32)).astype(F32)
    i0 = fl.astype(np.int64)
    i1 = i0 + 1
    i0 = np.where((i0 >= 0) & (i0 < size), i0, size)
    i1 = np.where((i1 >= 0) & (i1 < size), i1, size)
    return i0, i1, frac


def _bordered(im: np.ndarray, border) -> np.ndarray:
    """``im`` with one more row and column of the border value."""
    h, w = im.shape[:2]
    out = np.empty((h + 1, w + 1) + im.shape[2:], im.dtype)
    out[h] = border
    out[:h, w] = border
    out[:h, :w] = im
    return out


_CHUNK = 32  # output rows a pass: the f64 temporaries stay in the cache


def _blend(p0: np.ndarray, p1: np.ndarray, frac: np.ndarray) -> np.ndarray:
    """f32 ``fma(frac, p1 - p0, p0)``, the difference taken in f32."""
    d = np.subtract(p1, p0, dtype=F32).astype(np.float64)
    d *= frac
    d += p0
    return d.astype(F32)


def _round_u8(v: np.ndarray, out: np.ndarray) -> None:
    np.rint(v, out=v)
    np.clip(v, 0, 255, out=v)
    out[...] = v


def _sample(im: np.ndarray, sx: np.ndarray, sy: np.ndarray, border) -> np.ndarray:
    """Bilinear samples of ``im`` at f32 source coordinates (H, W)."""
    h, w = im.shape[:2]
    src = _bordered(im, border).reshape((h + 1) * (w + 1), -1)
    x0, x1, fx = _taps(sx, w)
    y0, y1, fy = _taps(sy, h)
    out = np.empty(sx.shape + (src.shape[1],), np.uint8)
    for r in range(0, sx.shape[0], _CHUNK):
        rows = slice(r, r + _CHUNK)
        a, b = y0[rows] * (w + 1), y1[rows] * (w + 1)
        c0, c1 = x0[rows], x1[rows]
        fxr, fyr = fx[rows, :, None], fy[rows, :, None]
        v0 = _blend(src[a + c0], src[a + c1], fxr)
        v1 = _blend(src[b + c0], src[b + c1], fxr)
        _round_u8(_blend(v0, v1, fyr), out[rows])
    return out.reshape(sx.shape + im.shape[2:])


def _sample_separable(im: np.ndarray, sx: np.ndarray, sy: np.ndarray, border) -> np.ndarray:
    """:func:`_sample` where the x coordinate depends on the column alone and
    y on the row alone: (W,) and (H,) coordinates. Each needed source row is
    blended along x once; then rows are blended along y."""
    h, w = im.shape[:2]
    src = _bordered(im, border).reshape(h + 1, w + 1, -1)
    x0, x1, fx = _taps(sx, w)
    y0, y1, fy = _taps(sy, h)
    rows, inv = np.unique(np.concatenate([y0, y1]), return_inverse=True)
    fxr = fx[None, :, None]
    across = np.empty((len(rows), len(sx), src.shape[2]), F32)
    for r in range(0, len(rows), _CHUNK):
        picked = src[rows[r:r + _CHUNK]]
        across[r:r + _CHUNK] = _blend(picked[:, x0], picked[:, x1], fxr)
    i0, i1 = inv[: len(y0)], inv[len(y0):]
    out = np.empty((len(sy), len(sx), src.shape[2]), np.uint8)
    for r in range(0, len(sy), _CHUNK):
        sl = slice(r, r + _CHUNK)
        _round_u8(_blend(across[i0[sl]], across[i1[sl]], fy[sl, None, None]), out[sl])
    return out.reshape((len(sy), len(sx)) + im.shape[2:])


def warp_affine(im: np.ndarray, M: np.ndarray, dsize: Tuple[int, int],
                border=114) -> np.ndarray:
    """``cv2.warpAffine(im, M, dsize, borderValue=(border,) * 3)`` with
    INTER_LINEAR; ``M`` (2, 3) maps source to output, ``dsize`` is (w, h)."""
    m = _invert_affine(np.asarray(M)[:2]).astype(F32)
    W, H = int(dsize[0]), int(dsize[1])
    x = np.arange(W, dtype=np.float64)
    y = np.arange(H, dtype=np.float64)
    if m[0, 1] == 0 and m[1, 0] == 0:
        # fma(y, 0, m2) is m2 exactly: x maps from the column alone
        return _sample_separable(im, _fma32(x, m[0, 0], m[0, 2]), _fma32(y, m[1, 1], m[1, 2]),
                                 border)
    xx, yy = x[None, :], y[:, None]
    sx = _fma32(xx, m[0, 0], _fma32(yy, m[0, 1], m[0, 2]).astype(np.float64))
    sy = _fma32(xx, m[1, 0], _fma32(yy, m[1, 1], m[1, 2]).astype(np.float64))
    return _sample(im, sx, sy, border)


def warp_perspective(im: np.ndarray, M: np.ndarray, dsize: Tuple[int, int],
                     border=114) -> np.ndarray:
    """``cv2.warpPerspective(im, M, dsize, borderValue=(border,) * 3)``
    with INTER_LINEAR; ``M`` (3, 3) maps source to output."""
    m = _invert_3x3(M).astype(F32).ravel()
    W, H = int(dsize[0]), int(dsize[1])
    xx = np.arange(W, dtype=np.float64)[None, :]
    yy = np.arange(H, dtype=np.float64)[:, None]

    def row(k):
        return _fma32(xx, m[k], _fma32(yy, m[k + 1], m[k + 2]).astype(np.float64))

    X, Y, Wd = row(0), row(3), row(6)
    with np.errstate(divide="ignore"):
        inv = np.where(Wd != 0, F32(1) / Wd, F32(0)).astype(F32)
    return _sample(im, (X * inv).astype(F32), (Y * inv).astype(F32), border)


# ---- colour --------------------------------------------------------------------------

_HSV_SHIFT = 12
_I = np.arange(256)
_SDIV = np.concatenate([[0], np.rint((255 << _HSV_SHIFT) / _I[1:])]).astype(np.int32)
_HDIV = np.concatenate([[0], np.rint((180 << _HSV_SHIFT) / (6.0 * _I[1:]))]).astype(np.int32)
# HSV2RGB's sector -> (b, g, r) picks of (v, v(1-s), v(1-sf), v(1-s(1-f)))
_SECTORS = np.array([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1], [0, 1, 3], [2, 1, 0]])


def bgr2hsv(im: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(im, COLOR_BGR2HSV)`` for uint8: H in [0, 180),
    OpenCV's 12-bit division tables."""
    b, g, r = (im[..., k].astype(np.int32) for k in range(3))
    v = np.maximum(np.maximum(b, g), r)
    diff = v - np.minimum(np.minimum(b, g), r)
    half = 1 << (_HSV_SHIFT - 1)
    s = (diff * _SDIV[v] + half) >> _HSV_SHIFT
    h = np.where(v == r, g - b, np.where(v == g, b - r + 2 * diff, r - g + 4 * diff))
    h = (h * _HDIV[diff] + half) >> _HSV_SHIFT
    h += np.where(h < 0, 180, 0)
    out = np.empty(im.shape, np.uint8)
    out[..., 0], out[..., 1], out[..., 2] = h, s, v
    return out


def _hsv_factors() -> np.ndarray:
    """(256 * 256, 3) f32: for each (h, s) the factor of v behind each of
    b, g and r in HSV2RGB's f32 path."""
    h = np.repeat(np.arange(256, dtype=F32), 256)
    s = np.tile(np.arange(256, dtype=F32) * F32(1 / 255.0), 256).astype(F32)
    hs = (h * F32(6 / 180.0)).astype(F32)
    pre = np.trunc(hs)
    frac = (hs - pre).astype(F32)
    sector = (pre - np.trunc((pre * F32(1 / 6.0)).astype(F32)) * 6).astype(np.int64)
    one = np.ones_like(s)
    tab = np.stack([one, (one - s).astype(F32), _fma32(-s, frac, one),
                    _fma32(-s, (one - frac).astype(F32), one)], -1)
    return np.take_along_axis(tab, _SECTORS[sector], 1)


_HSV_FACTORS = _hsv_factors()
_HSV_BLOCK = 32
_V_SCALED = (np.arange(256, dtype=F32) * F32(1 / 255.0)).astype(F32)


def hsv2bgr(hsv: np.ndarray, dst: Optional[np.ndarray] = None) -> np.ndarray:
    """``cv2.cvtColor(hsv, COLOR_HSV2BGR[, dst])`` for uint8: OpenCV's f32
    path, each channel ``v * factor`` times 255, truncated in whole blocks of
    32 pixels of a row and rounded after them. Writes into ``dst`` when
    given."""
    idx = hsv[..., 0].astype(np.int32) * 256 + hsv[..., 1]
    v = _V_SCALED[hsv[..., 2]][..., None]
    out = (v * _HSV_FACTORS[idx]).astype(F32) * F32(255)
    # OpenCV's vector loop (32 pixels a step) truncates; the
    # scalar code that finishes each row rounds
    step = hsv.shape[1] // _HSV_BLOCK * _HSV_BLOCK
    np.floor(out[:, :step], out=out[:, :step])
    np.rint(out[:, step:], out=out[:, step:])
    if dst is None:
        return out.astype(np.uint8)
    dst[...] = out
    return dst


def lut(im: np.ndarray, table: np.ndarray) -> np.ndarray:
    """``cv2.LUT(im, table)``: a table of 256 entries maps every channel, a
    (256, c) or (1, 256, c) table maps channel k by column k."""
    t = np.asarray(table).reshape(256, -1)
    out = np.empty(im.shape, t.dtype)
    if t.shape[1] == 1:
        np.take(t[:, 0], im, out=out)
    else:
        for k in range(im.shape[-1]):
            out[..., k] = np.take(t[:, k], im[..., k])
    return out


# ---- masks, flips, resizes ----------------------------------------------------------

_XY_SHIFT = 16
_XY_ONE = 1 << _XY_SHIFT


def _clip_line(w: int, h: int, p0, p1):
    """``cv::clipLine``: the segment clipped to the image, or None."""
    (x1, y1), (x2, y2) = p0, p1
    right, bottom = w - 1, h - 1

    def code(x, y):
        return (x < 0) + (x > right) * 2 + (y < 0) * 4 + (y > bottom) * 8

    c1, c2 = code(x1, y1), code(x2, y2)
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int((a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int((a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int((a - x1) * (y2 - y1) / (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int((a - x2) * (y2 - y1) / (x2 - x1))
                x2 = a
                c2 = 0
    return ((x1, y1), (x2, y2)) if (c1 | c2) == 0 else None


def _line_pixels(w: int, h: int, p0, p1) -> Tuple[np.ndarray, np.ndarray]:
    """(ys, xs) of ``cv::line(..., LINE_8)``: the segment clipped to the
    image, walked left to right by Bresenham's rule."""
    clipped = _clip_line(w, h, p0, p1)
    if clipped is None:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    (x1, y1), (x2, y2) = clipped
    if x2 < x1:
        x1, y1, x2, y2 = x2, y2, x1, y1
    dx, dy = x2 - x1, abs(y2 - y1)
    sy = 1 if y2 >= y1 else -1
    major, minor = (dy, dx) if dy > dx else (dx, dy)
    # the minor axis steps after each point whose error is below zero
    steps = np.zeros(major + 1, np.int64)
    e = major - 2 * minor
    for i in range(1, major + 1):  # the error depends on earlier steps
        if e < 0:
            steps[i] = steps[i - 1] + 1
            e += 2 * major - 2 * minor
        else:
            steps[i] = steps[i - 1]
            e -= 2 * minor
    along = np.arange(major + 1)
    if dy > dx:
        return y1 + sy * along, x1 + steps
    return y1 + sy * steps, x1 + along


def fill_polygons(mask: np.ndarray, polys: Sequence[np.ndarray], color=255) -> np.ndarray:
    """``cv2.drawContours(mask, polys, -1, (color,) * 3, cv2.FILLED)`` in
    place: each polygon's edges drawn as 8-connected lines, then the
    even-odd scanline fill of OpenCV's edge collection (x in 16-bit fixed
    point from the pixel centre, rows [y0, y1) of each edge)."""
    h, w = mask.shape[:2]
    ys_all, xs_all = [], []
    edge_rows = []
    for poly in polys:
        pts = np.asarray(poly, np.int64).reshape(-1, 2)
        n = len(pts)
        for i in range(n):
            (x0, y0), (x1, y1) = pts[i - 1], pts[i]
            ly, lx = _line_pixels(w, h, (int(x0), int(y0)), (int(x1), int(y1)))
            ys_all.append(ly)
            xs_all.append(lx)
            if y0 == y1:
                continue
            c0, c1 = (int(y0), int(x0) << _XY_SHIFT), (int(y1), int(x1) << _XY_SHIFT)
            if not ((0 <= x0 < w) and (0 <= x1 < w) and (0 <= y0 < h) and (0 <= y1 < h)):
                clipped = _clip_line(w, h, (int(x0), int(y0)), (int(x1), int(y1)))
                if clipped is not None and clipped[0][1] != clipped[1][1]:
                    (tx0, ty0), (tx1, ty1) = clipped
                    c0, c1 = (ty0, tx0 << _XY_SHIFT), (ty1, tx1 << _XY_SHIFT)
            num, den = c1[1] - c0[1], c1[0] - c0[0]
            dx = abs(num) // abs(den) * (1 if (num >= 0) == (den >= 0) else -1)
            if y0 < y1:
                top, bot, x_top = int(y0), int(y1), c0[1] + (int(y0) - c0[0]) * dx
            else:
                top, bot, x_top = int(y1), int(y0), c1[1] + (int(y1) - c1[0]) * dx
            rows = np.arange(max(top, 0), min(bot, h))
            if len(rows):
                edge_rows.append((rows, x_top + (rows - top) * dx))
    if edge_rows:
        ys = np.concatenate([r for r, _ in edge_rows])
        xs = np.concatenate([x for _, x in edge_rows])
        order = np.lexsort((xs, ys))
        ys, xs = ys[order], xs[order]
        # pair the crossings of each row in order of x
        first = np.ones(len(ys), bool)
        first[1:] = ys[1:] != ys[:-1]
        rank = np.arange(len(ys)) - np.maximum.accumulate(np.where(first, np.arange(len(ys)), 0))
        left = np.flatnonzero(rank % 2 == 0)
        left = left[(left + 1 < len(ys))]
        left = left[ys[left + 1] == ys[left]]
        row = ys[left]
        x1 = (xs[left] + _XY_ONE - 1) >> _XY_SHIFT  # pixel centres in [left, right]
        x2 = xs[left + 1] >> _XY_SHIFT
        keep = (x1 < w) & (x2 >= 0)
        row, x1, x2 = row[keep], np.maximum(x1[keep], 0), np.minimum(x2[keep], w - 1)
        if len(row):
            top = row.min()
            runs = np.zeros((row.max() - top + 1, w + 1), np.int32)
            np.add.at(runs, (row - top, x1), 1)
            np.add.at(runs, (row - top, x2 + 1), -1)
            mask[top:top + len(runs)][np.cumsum(runs[:, :w], 1) > 0] = color
    if ys_all:
        ly, lx = np.concatenate(ys_all), np.concatenate(xs_all)
        mask[ly, lx] = color
    return mask


def flip(im: np.ndarray, code: int) -> np.ndarray:
    """``cv2.flip`` of an (h, w, c) image: 1 mirrors left-right, 0
    top-bottom; a new contiguous array."""
    if code == 0:
        return np.ascontiguousarray(im[::-1])
    im = np.ascontiguousarray(im)
    # a pixel as one c-byte item: the mirror copies items, not bytes
    pixels = im.view(np.dtype((np.void, im.itemsize * im.shape[2]))).reshape(im.shape[:2])
    return np.ascontiguousarray(pixels[:, ::-1]).view(im.dtype).reshape(im.shape)


def resize_scale(im: np.ndarray, fx: float, fy: float) -> np.ndarray:
    """``cv2.resize(im, (0, 0), fx=fx, fy=fy)`` (INTER_LINEAR): the output
    is (round(h * fy), round(w * fx)) and sources map by ``1 / fx``,
    ``1 / fy``. An empty input gives an empty output."""
    h, w = im.shape[:2]
    dw, dh = int(round(w * fx)), int(round(h * fy))
    if h == 0 or w == 0 or dw == 0 or dh == 0:
        return np.zeros((dh, dw) + im.shape[2:], im.dtype)
    if (dw, dh) == (w, h):
        return im.copy()
    return resize_linear(im, (dw, dh), scale=(1.0 / fx, 1.0 / fy))


# ---- the pixel policies' primitives --------------------------------------------------


def _pad_reflect101(im: np.ndarray, r: int) -> np.ndarray:
    pad = ((r, r), (r, r)) + ((0, 0),) * (im.ndim - 2)
    return np.pad(im, pad, mode="reflect")


def box_blur(im: np.ndarray, k: int) -> np.ndarray:
    """``cv2.blur(im, (k, k))``: the k x k mean, BORDER_REFLECT_101, rounded."""
    r = k // 2
    p = _pad_reflect101(im, r).astype(np.int32)
    c = np.cumsum(p, 0)
    c = np.concatenate([c[k - 1:k], c[k:] - c[:-k]], 0)
    c = np.cumsum(c, 1)
    s = np.concatenate([c[:, k - 1:k], c[:, k:] - c[:, :-k]], 1)
    return np.clip(np.rint(s.astype(F32) * F32(1.0 / (k * k))), 0, 255).astype(np.uint8)


def median_blur(im: np.ndarray, k: int) -> np.ndarray:
    """``cv2.medianBlur(im, k)``: the median of each k x k window,
    BORDER_REPLICATE. Found bit by bit: a bit is set where fewer than half
    the window lies below the candidate."""
    r = k // 2
    h, w = im.shape[:2]
    p = np.pad(im, ((r, r), (r, r)) + ((0, 0),) * (im.ndim - 2), mode="edge")
    need = k * k // 2 + 1
    out = np.zeros(im.shape, np.uint8)
    for r0 in range(0, h, _CHUNK):
        rows = min(_CHUNK, h - r0)
        res = out[r0:r0 + rows]
        below = np.empty(res.shape, bool)
        for bit in range(7, -1, -1):
            cand = res | np.uint8(1 << bit)
            count = np.zeros(res.shape, np.uint8)
            for dy in range(k):
                for dx in range(k):
                    np.less(p[r0 + dy:r0 + dy + rows, dx:dx + w], cand, out=below)
                    count += below
            np.copyto(res, cand, where=count < need)
    return out


def bgr2gray(im: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(im, COLOR_BGR2GRAY)``: 15-bit fixed-point weights."""
    s = (im[..., 0].astype(np.int32) * 3735 + im[..., 1].astype(np.int32) * 19235
         + im[..., 2].astype(np.int32) * 9798)
    return ((s + (1 << 14)) >> 15).astype(np.uint8)


def gray2bgr(g: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(g, COLOR_GRAY2BGR)``."""
    return np.repeat(g[..., None], 3, -1)


def convert_scale_abs(im: np.ndarray, alpha: float, beta: float) -> np.ndarray:
    """``cv2.convertScaleAbs(im, alpha=alpha, beta=beta)``: |im * alpha +
    beta| in f32, rounded and saturated."""
    v = _fma32(im, F32(alpha), F32(beta))
    return np.clip(np.rint(np.abs(v)), 0, 255).astype(np.uint8)


def filter2d(im: np.ndarray, kernel: np.ndarray) -> np.ndarray:
    """``cv2.filter2D(im, -1, kernel)`` for a small f32 kernel on uint8:
    the correlation summed in f32 in the kernel's row order,
    BORDER_REFLECT_101, rounded and saturated."""
    kernel = np.asarray(kernel, F32)
    kh, kw = kernel.shape
    h, w = im.shape[:2]
    p = _pad_reflect101(im, max(kh, kw) // 2).astype(F32)
    acc = np.zeros(im.shape, F32)
    for i in range(kh):
        for j in range(kw):
            acc = _fma32(p[i:i + h, j:j + w], kernel[i, j], acc)
    return np.clip(np.rint(acc), 0, 255).astype(np.uint8)


def add_weighted(a: np.ndarray, alpha: float, b: np.ndarray, beta: float,
                 gamma: float = 0.0) -> np.ndarray:
    """``cv2.addWeighted(a, alpha, b, beta, gamma)`` for uint8: f32, rounded
    and saturated."""
    v = _fma32(a, F32(alpha), _fma32(b, F32(beta), F32(gamma)))
    return np.clip(np.rint(v), 0, 255).astype(np.uint8)


# ---- Lab (8-bit, OpenCV's fixed-point paths) and CLAHE ----------------------------------

_LAB_SHIFT, _GAMMA_SHIFT = 12, 3
_LAB_SHIFT2 = _LAB_SHIFT + _GAMMA_SHIFT
_LAB_BASE = 1 << 14
_MIN_AB = -8145
_RGB2XYZ = np.array([0.412453, 0.357580, 0.180423, 0.212671, 0.715160, 0.072169,
                     0.019334, 0.119193, 0.950227], F32).astype(np.float64).reshape(3, 3)
_XYZ2RGB = np.array([3.240479, -1.53715, -0.498535, -0.969256, 1.875991, 0.041556,
                     0.055648, -0.204043, 1.057311], F32).astype(np.float64).reshape(3, 3)
_D65 = np.array([0.950456, 1.0, 1.088754], F32).astype(np.float64)


def _lab_tables():
    x = np.arange(256) / 255.0
    gamma = np.rint(255.0 * (1 << _GAMMA_SHIFT) * np.where(
        x <= 0.04045, x / 12.92, ((x + 0.055) / 1.055) ** 2.4)).astype(np.int64)
    c = (np.arange(256 * 3 // 2 * (1 << _GAMMA_SHIFT), dtype=F32)
         / F32(255 * (1 << _GAMMA_SHIFT))).astype(np.float64)
    cbrt = np.rint((1 << _LAB_SHIFT2) * np.where(c < 216 / 24389, c * (841 / 108) + 16 / 116,
                                                 np.cbrt(c))).astype(np.int64)
    cbrt[49] -= 1  # 0.50019 above a half in f64; OpenCV's f32 cube root rounds it down
    to_xyz = np.rint((1 << _LAB_SHIFT) * _RGB2XYZ / _D65[:, None]).astype(np.int64)
    # the way back: L -> (y, f(y)), f -> x or z, XYZ -> linear RGB, inverse gamma
    L = np.arange(256) * 100 / 255.0
    low = L <= 0.008856 * 903.3
    fy = np.where(low, 16 / 116 + 7.787 * L / 903.3, (L + 16) / 116)
    y = np.rint(_LAB_BASE * np.where(low, L / 903.3, fy ** 3)).astype(np.int64)
    ify = np.rint(_LAB_BASE * fy).astype(np.int64)
    # f -> x or z in integers: (f - 16/116) * 108/841 up to 6/29, else f^3
    f = np.arange(_MIN_AB, 9 * _LAB_BASE // 2 - 2 * _MIN_AB)

    def tdiv(a, b):  # C's division, truncating toward zero
        return np.sign(a) * (np.abs(a) // b)

    ab_to_xz = np.where(f <= 3390, tdiv(f * 108, 841) - (_LAB_BASE * 16 // 116) * 108 // 841,
                        tdiv(tdiv(f * f, _LAB_BASE) * f, _LAB_BASE))
    from_xyz = np.rint(4096 * _XYZ2RGB * _D65[None, :]).astype(np.int64)
    v = np.arange(4096) / 4096.0
    inv_gamma = np.rint(255 * np.where(v <= 0.0031308, 12.92 * v,
                                       1.055 * v ** (1 / 2.4) - 0.055)).astype(np.int64)
    # the steps of f(x) and f(z) per a and b: a * 2^14 / 500 and b * 2^14 / 200
    # less their value at 128, as OpenCV 5.0's vector code gives them (the
    # CPU tests found b one step above C's division throughout, and a at 69)
    i = np.arange(256)
    a_step = i * _LAB_BASE // 500 - 128 * _LAB_BASE // 500
    a_step[69] += 1
    b_step = i * _LAB_BASE // 200 - 128 * _LAB_BASE // 200 + 1
    return gamma, cbrt, to_xyz, y, ify, ab_to_xz, from_xyz, inv_gamma, a_step, b_step


(_GAMMA_B, _CBRT_B, _TO_XYZ, _LAB_Y, _LAB_FY, _AB_TO_XZ, _FROM_XYZ, _INV_GAMMA_B, _A_STEP,
 _B_STEP) = _lab_tables()


def _descale(v, n):
    return (v + (1 << (n - 1))) >> n


def bgr2lab(im: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(im, COLOR_BGR2LAB)`` for uint8: sRGB gamma and cube
    root tables, 12-bit XYZ weights (OpenCV's bit-exact path)."""
    rgb = [_GAMMA_B[im[..., k]] for k in (2, 1, 0)]
    fx, fy, fz = (_CBRT_B[_descale(sum(_TO_XYZ[i, k] * rgb[k] for k in range(3)), _LAB_SHIFT)]
                  for i in range(3))
    one = 1 << _LAB_SHIFT2
    L = _descale((116 * 255 + 50) // 100 * fy - (16 * 255 * one + 50) // 100, _LAB_SHIFT2)
    a = _descale(500 * (fx - fy) + 128 * one, _LAB_SHIFT2)
    b = _descale(200 * (fy - fz) + 128 * one, _LAB_SHIFT2)
    return np.clip(np.stack([L, a, b], -1), 0, 255).astype(np.uint8)


def lab2bgr(lab: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(lab, COLOR_LAB2BGR)`` for uint8: OpenCV's integer path
    (14-bit Y and f(Y) per L, the a and b steps, an integer f -> x table,
    12-bit weights, an inverse gamma table of 4096 entries)."""
    L = lab[..., 0]
    y, fy = _LAB_Y[L], _LAB_FY[L]
    x = _AB_TO_XZ[fy + _A_STEP[lab[..., 1]] - _MIN_AB]
    z = _AB_TO_XZ[fy - _B_STEP[lab[..., 2]] - _MIN_AB]
    out = np.empty(lab.shape, np.uint8)
    for ch, row in ((0, 2), (1, 1), (2, 0)):
        c = _FROM_XYZ[row]
        out[..., ch] = _INV_GAMMA_B[np.clip(_descale(c[0] * x + c[1] * y + c[2] * z, 14), 0, 4095)]
    return out


def clahe(gray: np.ndarray, clip_limit: float = 4.0, tiles: Tuple[int, int] = (8, 8)) -> np.ndarray:
    """``cv2.createCLAHE(clip_limit, tiles).apply(gray)`` for uint8: a
    histogram per tile (the image padded by BORDER_REFLECT_101 to a whole
    number of tiles, as OpenCV pads it), clipped and redistributed, its
    cumulative LUT, and each pixel blended from its four nearest tiles' LUTs
    in f32."""
    tx, ty = int(tiles[0]), int(tiles[1])
    h, w = gray.shape
    src = gray
    if w % tx or h % ty:
        src = np.pad(gray, ((0, ty - h % ty), (0, tx - w % tx)), mode="reflect")
    th, tw = src.shape[0] // ty, src.shape[1] // tx
    area = th * tw
    blocks = src[: th * ty, : tw * tx].reshape(ty, th, tx, tw).transpose(0, 2, 1, 3).reshape(
        ty * tx, area)
    hist = np.zeros((ty * tx, 256), np.int64)
    np.add.at(hist, (np.repeat(np.arange(ty * tx), area), blocks.ravel()), 1)
    if clip_limit > 0:
        limit = max(int(clip_limit * area / 256), 1)
        clipped = np.maximum(hist - limit, 0).sum(1)
        hist = np.minimum(hist, limit)
        batch = clipped // 256
        hist += batch[:, None]
        residual = clipped - batch * 256
        for t in np.flatnonzero(residual):
            step = max(256 // int(residual[t]), 1)
            hist[t, np.arange(0, 256, step)[: int(residual[t])]] += 1
    scale = F32(255.0 / area)
    luts = np.clip(np.rint((np.cumsum(hist, 1).astype(F32) * scale).astype(F32)), 0, 255)
    luts = luts.astype(F32).reshape(ty, tx, 256)

    def axis(n, tile, count):
        t = (np.arange(n, dtype=F32) * F32(1.0 / tile) - F32(0.5)).astype(F32)
        i1 = np.floor(t).astype(np.int64)
        frac = (t - i1.astype(F32)).astype(F32)
        return np.maximum(i1, 0), np.minimum(i1 + 1, count - 1), frac, (F32(1) - frac).astype(F32)

    x1, x2, xa, xa1 = axis(w, tw, tx)
    y1, y2, ya, ya1 = axis(h, th, ty)
    v = gray.astype(np.int64)
    out = np.empty((h, w), np.uint8)
    for r in range(h):
        top, bot = luts[y1[r]], luts[y2[r]]
        row = v[r]
        res = ((top[x1, row] * xa1 + top[x2, row] * xa) * ya1[r]
               + (bot[x1, row] * xa1 + bot[x2, row] * xa) * ya[r])
        out[r] = np.clip(np.rint(res), 0, 255)
    return out


# ---- JPEG round trip (libjpeg's islow path: what decides the pixels) --------------------

_LUMA_Q = np.array([16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
                    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
                    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
                    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])
_CHROMA_Q = np.array([17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
                      24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99]
                     + [99] * 32)
# islow's constants, 13 fractional bits
_C_0298, _C_0390, _C_0541, _C_0765 = 2446, 3196, 4433, 6270
_C_0899, _C_1175, _C_1501, _C_1847 = 7373, 9633, 12299, 15137
_C_1961, _C_2053, _C_2562, _C_3072 = 16069, 16819, 20995, 25172
_CONST_BITS, _PASS1_BITS = 13, 2


def _quant_table(base: np.ndarray, quality: int) -> np.ndarray:
    """``jpeg_set_quality(quality, force_baseline=TRUE)``'s table (8, 8)."""
    quality = min(max(int(quality), 1), 100)
    scale = 5000 // quality if quality < 50 else 200 - quality * 2
    return np.clip((base * scale + 50) // 100, 1, 255).reshape(8, 8)


def _fdct_1d(d, last: bool):
    """One pass of ``jpeg_fdct_islow`` along the last axis (int64)."""
    d0, d1, d2, d3, d4, d5, d6, d7 = (d[..., k] for k in range(8))
    tmp0, tmp7, tmp1, tmp6 = d0 + d7, d0 - d7, d1 + d6, d1 - d6
    tmp2, tmp5, tmp3, tmp4 = d2 + d5, d2 - d5, d3 + d4, d3 - d4
    tmp10, tmp13, tmp11, tmp12 = tmp0 + tmp3, tmp0 - tmp3, tmp1 + tmp2, tmp1 - tmp2
    out = np.empty_like(d)
    if last:
        out[..., 0] = _descale(tmp10 + tmp11, _PASS1_BITS)
        out[..., 4] = _descale(tmp10 - tmp11, _PASS1_BITS)
        shift = _CONST_BITS + _PASS1_BITS
    else:
        out[..., 0] = (tmp10 + tmp11) << _PASS1_BITS
        out[..., 4] = (tmp10 - tmp11) << _PASS1_BITS
        shift = _CONST_BITS - _PASS1_BITS
    z1 = (tmp12 + tmp13) * _C_0541
    out[..., 2] = _descale(z1 + tmp13 * _C_0765, shift)
    out[..., 6] = _descale(z1 - tmp12 * _C_1847, shift)
    z1, z2, z3, z4 = tmp4 + tmp7, tmp5 + tmp6, tmp4 + tmp6, tmp5 + tmp7
    z5 = (z3 + z4) * _C_1175
    tmp4, tmp5, tmp6, tmp7 = tmp4 * _C_0298, tmp5 * _C_2053, tmp6 * _C_3072, tmp7 * _C_1501
    z1, z2, z3, z4 = z1 * -_C_0899, z2 * -_C_2562, z3 * -_C_1961 + z5, z4 * -_C_0390 + z5
    out[..., 7] = _descale(tmp4 + z1 + z3, shift)
    out[..., 5] = _descale(tmp5 + z2 + z4, shift)
    out[..., 3] = _descale(tmp6 + z2 + z3, shift)
    out[..., 1] = _descale(tmp7 + z1 + z4, shift)
    return out


def _idct_1d(d, shift: int):
    """One pass of ``jpeg_idct_islow`` along the last axis (int64), each
    output descaled by ``shift``."""
    z2, z3 = d[..., 2], d[..., 6]
    z1 = (z2 + z3) * _C_0541
    tmp2, tmp3 = z1 - z3 * _C_1847, z1 + z2 * _C_0765
    tmp0, tmp1 = (d[..., 0] + d[..., 4]) << _CONST_BITS, (d[..., 0] - d[..., 4]) << _CONST_BITS
    tmp10, tmp13, tmp11, tmp12 = tmp0 + tmp3, tmp0 - tmp3, tmp1 + tmp2, tmp1 - tmp2
    tmp0, tmp1, tmp2, tmp3 = d[..., 7], d[..., 5], d[..., 3], d[..., 1]
    z1, z2, z3, z4 = tmp0 + tmp3, tmp1 + tmp2, tmp0 + tmp2, tmp1 + tmp3
    z5 = (z3 + z4) * _C_1175
    tmp0, tmp1, tmp2, tmp3 = tmp0 * _C_0298, tmp1 * _C_2053, tmp2 * _C_3072, tmp3 * _C_1501
    z1, z2, z3, z4 = z1 * -_C_0899, z2 * -_C_2562, z3 * -_C_1961 + z5, z4 * -_C_0390 + z5
    tmp0, tmp1, tmp2, tmp3 = tmp0 + z1 + z3, tmp1 + z2 + z4, tmp2 + z2 + z3, tmp3 + z1 + z4
    out = np.empty_like(d)
    for k, v in enumerate((tmp10 + tmp3, tmp11 + tmp2, tmp12 + tmp1, tmp13 + tmp0,
                           tmp13 - tmp0, tmp12 - tmp1, tmp11 - tmp2, tmp10 - tmp3)):
        out[..., k] = _descale(v, shift)
    return out


def _code_plane(plane: np.ndarray, q: np.ndarray) -> np.ndarray:
    """A plane whose sides are multiples of 8 through islow's forward DCT,
    libjpeg's rounding quantisation, dequantisation and islow's inverse:
    the decoded samples."""
    h, w = plane.shape
    blocks = plane.reshape(h // 8, 8, w // 8, 8).transpose(0, 2, 1, 3).astype(np.int64) - 128
    coef = np.swapaxes(_fdct_1d(np.swapaxes(_fdct_1d(blocks, False), -1, -2), True), -1, -2)
    div = q.astype(np.int64) << 3  # islow's output is 8 times the coefficient
    level = np.sign(coef) * ((np.abs(coef) + (div >> 1)) // div)
    deq = level * q
    rows = _idct_1d(np.swapaxes(deq, -1, -2), _CONST_BITS - _PASS1_BITS)
    out = _idct_1d(np.swapaxes(rows, -1, -2), _CONST_BITS + _PASS1_BITS + 3)
    out = np.clip(out + 128, 0, 255)
    return out.transpose(0, 2, 1, 3).reshape(h, w)


def _pad_edge(a: np.ndarray, h: int, w: int) -> np.ndarray:
    return np.pad(a, ((0, h - a.shape[0]), (0, w - a.shape[1])), mode="edge")


def _fancy_upsample(c: np.ndarray, h: int, w: int) -> np.ndarray:
    """libjpeg's h2v2 fancy (triangle) upsampling of the (ceil(h/2),
    ceil(w/2)) real chroma samples, cropped to (h, w); rows of at most two
    samples are repeated instead, as libjpeg does."""
    c = c.astype(np.int64)
    if c.shape[1] <= 2:
        return np.repeat(np.repeat(c, 2, 0), 2, 1)[:h, :w]
    above = np.concatenate([c[:1], c[:-1]], 0)
    below = np.concatenate([c[1:], c[-1:]], 0)
    out = np.empty((2 * c.shape[0], 2 * c.shape[1]), np.int64)
    for v, near in ((0, above), (1, below)):
        col = c * 3 + near  # the column sums of the output row
        left = np.concatenate([col[:, :1], col[:, :-1]], 1)
        right = np.concatenate([col[:, 1:], col[:, -1:]], 1)
        even = (col * 3 + left + 8) >> 4
        odd = (col * 3 + right + 7) >> 4
        even[:, 0] = (col[:, 0] * 4 + 8) >> 4
        odd[:, -1] = (col[:, -1] * 4 + 7) >> 4
        out[v::2, 0::2], out[v::2, 1::2] = even, odd
    return out[:h, :w]


def _fix(x: float) -> int:
    return int(x * 65536 + 0.5)


def jpeg_roundtrip(im: np.ndarray, quality: int) -> np.ndarray:
    """``cv2.imdecode(cv2.imencode('.jpg', im, [IMWRITE_JPEG_QUALITY,
    quality])[1], IMREAD_COLOR)`` for (h, w, 3) BGR uint8. The entropy
    coding is lossless, so this computes only what decides the pixels, as
    libjpeg does: YCbCr in 16-bit fixed point, 4:2:0 by 2x2 means with the
    alternating bias, edges replicated to whole blocks, the islow forward
    DCT, quantisation by the quality-scaled tables (rounding), the islow
    inverse DCT, fancy upsampling and the fixed-point YCbCr -> RGB."""
    h, w = im.shape[:2]
    r, g, b = (im[..., k].astype(np.int64) for k in (2, 1, 0))
    half, offset = 1 << 15, 128 << 16
    y = (_fix(0.299) * r + _fix(0.587) * g + _fix(0.114) * b + half) >> 16
    cb = (-_fix(0.16874) * r - _fix(0.33126) * g + _fix(0.5) * b + offset + half - 1) >> 16
    cr = (_fix(0.5) * r - _fix(0.41869) * g - _fix(0.08131) * b + offset + half - 1) >> 16

    yh, yw = -(-h // 8) * 8, -(-w // 8) * 8
    ch, cw = -(-h // 2), -(-w // 2)
    cbw = -(-cw // 8) * 8
    y_out = _code_plane(_pad_edge(y, yh, yw), _quant_table(_LUMA_Q, quality))[:h, :w]
    q_chroma = _quant_table(_CHROMA_Q, quality)
    bias = np.tile([1, 2], cbw // 2)
    chroma = []
    for c in (cb, cr):
        full = _pad_edge(c, 2 * ch, 2 * cbw)
        down = (full[0::2, 0::2] + full[0::2, 1::2] + full[1::2, 0::2] + full[1::2, 1::2]
                + bias) >> 2
        coded = _code_plane(_pad_edge(down, -(-ch // 8) * 8, cbw), q_chroma)[:ch, :cw]
        chroma.append(_fancy_upsample(coded, h, w) - 128)
    cb, cr = chroma
    red = y_out + ((_fix(1.402) * cr + half) >> 16)
    green = y_out + ((-_fix(0.34414) * cb - _fix(0.71414) * cr + half) >> 16)
    blue = y_out + ((_fix(1.772) * cb + half) >> 16)
    return np.clip(np.stack([blue, green, red], -1), 0, 255).astype(np.uint8)
