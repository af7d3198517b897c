"""The port's OpenCV counterparts (``ayolov2_torch/data/image_ops.py``)
against ``cv2`` on seeded images: odd sizes, borders, every parameter the
augmentation path uses.

Gates: equal where OpenCV's arithmetic is integer (HSV forward, LUT, gray,
box blur, median, flips, polygon fill, CLAHE, Lab both ways); within one
level on at most 0.5% of the pixels where it is float (the warps, HSV back,
``filter2D``, ``addWeighted``, ``convertScaleAbs``, the scaled resize); within
two levels on at most 1% for the JPEG round trip.
"""

import cv2
import numpy as np
import pytest

from ayolov2_torch.data import image_ops

FLOAT_SHARE = 0.005  # of the pixels, each within one level


def _rng(*key):
    return np.random.default_rng(list(key))


def _image(rng, h, w, smooth=False):
    if not smooth:
        return rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    y, x = np.mgrid[0:h, 0:w]
    im = rng.uniform(40, 200, 3) + y[..., None] * rng.uniform(-1, 1, 3) + x[..., None] * \
        rng.uniform(-1, 1, 3)
    return np.clip(im + rng.normal(0, 8, im.shape), 0, 255).astype(np.uint8)


def _diff(a, b):
    assert a.shape == b.shape and a.dtype == b.dtype
    d = np.abs(a.astype(np.int64) - b.astype(np.int64))
    return int(d.max()), float((d > 0).mean())


def _within_one(a, b):
    mx, share = _diff(a, b)
    assert mx <= 1 and share <= FLOAT_SHARE, (mx, share)


def _all_colours():
    return np.stack(np.meshgrid(np.arange(256), np.arange(256), np.arange(256), indexing="ij"),
                    -1).reshape(4096, 4096, 3).astype(np.uint8)


# ---- warps -------------------------------------------------------------------------------


def _rotation(rng, w, h):
    M = cv2.getRotationMatrix2D((w / 2, h / 2), rng.uniform(-40, 40), rng.uniform(0.6, 1.4))
    M[:, 2] += rng.uniform(-12, 12, 2)
    return M


@pytest.mark.parametrize("shape,dsize", [((61, 83), (70, 57)), ((64, 64), (64, 64)),
                                         ((33, 120), (97, 41))])
@pytest.mark.parametrize("kind", ["axis_aligned", "integer_shift", "rotation", "perspective"])
def test_warps_match_cv2(shape, dsize, kind):
    rng = _rng(1, shape[0], dsize[0], len(kind))
    for _ in range(3):
        im = _image(rng, *shape)
        w, h = shape[1], shape[0]
        if kind == "axis_aligned":
            M = np.array([[rng.uniform(0.5, 1.5), 0, rng.uniform(-20, 20)],
                          [0, rng.uniform(0.5, 1.5), rng.uniform(-20, 20)]])
        elif kind == "integer_shift":
            M = np.array([[1.0, 0, -7], [0, 1.0, 5]])
        else:
            M = _rotation(rng, w, h)
        if kind == "perspective":
            P = np.eye(3)
            P[:2] = M
            P[2, :2] = rng.uniform(-0.002, 0.002, 2)
            got = image_ops.warp_perspective(im, P, dsize)
            want = cv2.warpPerspective(im, P, dsize, borderValue=(114, 114, 114))
        else:
            got = image_ops.warp_affine(im, M, dsize)
            want = cv2.warpAffine(im, M, dsize, borderValue=(114, 114, 114))
        _within_one(got, want)


def test_warp_of_a_mosaic_canvas_matches_cv2():
    """The default recipe's warp: a 2s canvas to s, axis-aligned (coordinates
    per row and column), and the rotated one beside it."""
    rng = _rng(2)
    canvas = _image(rng, 320, 320, smooth=True)
    for M in (np.array([[0.8, 0, -60.5], [0, 0.8, -40.25]]),
              cv2.getRotationMatrix2D((160, 160), 7.5, 0.9)):
        _within_one(image_ops.warp_affine(canvas, M, (160, 160)),
                    cv2.warpAffine(canvas, M, (160, 160), borderValue=(114, 114, 114)))


# ---- colour ------------------------------------------------------------------------------


def test_bgr2hsv_equals_cv2_on_every_colour():
    im = _all_colours()
    np.testing.assert_array_equal(image_ops.bgr2hsv(im), cv2.cvtColor(im, cv2.COLOR_BGR2HSV))


def test_hsv2bgr_equals_cv2_on_every_hsv_value():
    """OpenCV's f32 path, truncated: equal on all 180 x 256 x 256 inputs
    (inside the float gate), and ``dst=`` writes in place."""
    hsv = np.stack(np.meshgrid(np.arange(180), np.arange(256), np.arange(256), indexing="ij"),
                   -1).reshape(180 * 256, 256, 3).astype(np.uint8)
    want = cv2.cvtColor(hsv, cv2.COLOR_HSV2BGR)
    _within_one(image_ops.hsv2bgr(hsv), want)
    dst = np.zeros_like(hsv)
    assert image_ops.hsv2bgr(hsv, dst=dst) is dst
    np.testing.assert_array_equal(dst, image_ops.hsv2bgr(hsv))
    for width in (16, 17, 100, 150, 300):  # OpenCV rounds each row's tail after whole blocks
        n = len(hsv.reshape(-1, 3)) // width * width
        part = hsv.reshape(-1, 3)[:n].reshape(-1, width, 3)
        _within_one(image_ops.hsv2bgr(part), cv2.cvtColor(part, cv2.COLOR_HSV2BGR))


@pytest.mark.parametrize("channels", [1, 3])
def test_lut_equals_cv2(channels):
    rng = _rng(3, channels)
    im = _image(rng, 47, 65)
    table = rng.integers(0, 256, (1, 256, channels), dtype=np.uint8)
    np.testing.assert_array_equal(image_ops.lut(im, table), cv2.LUT(im, table))


def test_bgr2gray_equals_cv2_on_every_colour():
    im = _all_colours()
    np.testing.assert_array_equal(image_ops.bgr2gray(im), cv2.cvtColor(im, cv2.COLOR_BGR2GRAY))
    g = image_ops.bgr2gray(im[:64, :64])
    np.testing.assert_array_equal(image_ops.gray2bgr(g), cv2.cvtColor(g, cv2.COLOR_GRAY2BGR))


@pytest.mark.parametrize("direction", ["bgr2lab", "lab2bgr"])
def test_lab_equals_cv2_on_every_value(direction):
    im = _all_colours()
    if direction == "bgr2lab":
        np.testing.assert_array_equal(image_ops.bgr2lab(im), cv2.cvtColor(im, cv2.COLOR_BGR2LAB))
    else:
        np.testing.assert_array_equal(image_ops.lab2bgr(im), cv2.cvtColor(im, cv2.COLOR_LAB2BGR))


@pytest.mark.parametrize("shape", [(64, 64), (77, 123), (160, 96)])
@pytest.mark.parametrize("clip", [4.0, 1.0])
def test_clahe_equals_cv2(shape, clip):
    """Tiles of any size (OpenCV pads to whole tiles), clip limits that clip
    and that do not."""
    rng = _rng(4, *shape, int(clip))
    for smooth in (False, True):
        gray = image_ops.bgr2gray(_image(rng, *shape, smooth=smooth))
        want = cv2.createCLAHE(clipLimit=clip, tileGridSize=(8, 8)).apply(gray)
        np.testing.assert_array_equal(image_ops.clahe(gray, clip, (8, 8)), want)


# ---- masks, flips, resizes ---------------------------------------------------------------


@pytest.mark.parametrize("kind", ["star", "random", "outside"])
def test_fill_polygons_matches_draw_contours(kind):
    """Star-shaped and self-crossing polygons, and polygons partly outside
    the image: equal to ``cv2.drawContours(..., FILLED)``; the share of
    differing pixels (all on the polygon's edge) is printed."""
    rng = _rng(5, len(kind))
    h, w = 120, 150
    differ = edge = 0
    for _ in range(30):
        n = int(rng.integers(3, 14))
        if kind == "random":
            poly = rng.uniform(0, 149, (n, 2))
        else:
            c = rng.uniform(20, 130, 2) if kind == "star" else rng.uniform(-20, 170, 2)
            ang = np.sort(rng.uniform(0, 2 * np.pi, n))
            r = rng.uniform(5, 70, n)
            poly = np.stack([c[0] + r * np.cos(ang), c[1] + r * np.sin(ang)], 1)
        poly = poly.astype(np.int32)
        got = image_ops.fill_polygons(np.zeros((h, w, 3), np.uint8), [poly])
        want = cv2.drawContours(np.zeros((h, w, 3), np.uint8), [poly], -1, (255, 255, 255),
                                cv2.FILLED)
        outline = cv2.polylines(np.zeros((h, w), np.uint8), [poly], True, 255) > 0
        d = (got != want).any(-1)
        differ += int(d.sum())
        edge += int((d & outline).sum())
    print(f"fill_polygons {kind}: {differ} pixels differ, {edge} of them on the outline")
    assert differ == 0


@pytest.mark.parametrize("code", [1, 0])
def test_flip_equals_cv2(code):
    im = _image(_rng(6, code), 37, 53)
    np.testing.assert_array_equal(image_ops.flip(im, code), cv2.flip(im, code))


@pytest.mark.parametrize("sf", [0.35, 0.5, 0.77, 0.9134, 1.0])
@pytest.mark.parametrize("shape", [(37, 53), (12, 90)])
def test_resize_scale_matches_cv2(sf, shape):
    im = _image(_rng(7, int(sf * 1e4), *shape), *shape)
    _within_one(image_ops.resize_scale(im, sf, sf), cv2.resize(im, (0, 0), fx=sf, fy=sf))


def test_resize_scale_of_an_empty_slice_is_empty():
    out = image_ops.resize_scale(np.zeros((0, 7, 3), np.uint8), 0.5, 0.5)
    assert out.shape == (0, 4, 3) and out.dtype == np.uint8


# ---- the pixel policies' primitives -------------------------------------------------------


@pytest.mark.parametrize("k", [3, 5, 7])
@pytest.mark.parametrize("shape", [(37, 51), (64, 64), (9, 140)])
def test_blurs_equal_cv2(k, shape):
    im = _image(_rng(8, k, *shape), *shape)
    np.testing.assert_array_equal(image_ops.box_blur(im, k), cv2.blur(im, (k, k)))
    np.testing.assert_array_equal(image_ops.median_blur(im, k), cv2.medianBlur(im, k))


@pytest.mark.parametrize("alpha,beta", [(1.13, 20.4), (0.83, -30.2), (1.0, 0.0), (1.2, -51.0)])
def test_convert_scale_abs_matches_cv2(alpha, beta):
    im = _image(_rng(9, int(alpha * 100)), 45, 67)
    _within_one(image_ops.convert_scale_abs(im, alpha, beta),
                cv2.convertScaleAbs(im, alpha=alpha, beta=beta))


@pytest.mark.parametrize("lightness", [0.5, 0.77, 1.0])
def test_sharpen_filter_and_blend_match_cv2(lightness):
    im = _image(_rng(10, int(lightness * 100)), 41, 59, smooth=True)
    kernel = np.array([[-1, -1, -1], [-1, 8 + lightness, -1], [-1, -1, -1]], np.float32)
    kernel /= max(kernel.sum(), 1e-6)
    want = cv2.filter2D(im, -1, kernel)
    _within_one(image_ops.filter2d(im, kernel), want)
    for a in (0.2, 0.37, 0.5):
        _within_one(image_ops.add_weighted(im, 1 - a, want, a, 0),
                    cv2.addWeighted(im, 1 - a, want, a, 0))


@pytest.mark.parametrize("shape", [(64, 64), (77, 123), (33, 17), (2, 3), (1, 1)])
@pytest.mark.parametrize("quality", [75, 90, 100, 30])
def test_jpeg_roundtrip_matches_cv2(shape, quality):
    """Equal bit for bit to ``imdecode(imencode)`` (smooth and noisy images,
    odd sizes, narrow chroma rows)."""
    rng = _rng(11, quality, *shape)
    for smooth in (True, False):
        im = _image(rng, *shape, smooth=smooth)
        ok, enc = cv2.imencode(".jpg", im, [cv2.IMWRITE_JPEG_QUALITY, quality])
        assert ok
        np.testing.assert_array_equal(image_ops.jpeg_roundtrip(im, quality),
                                      cv2.imdecode(enc, cv2.IMREAD_COLOR))
