"""The port's JPEG codec (``ayolov2_torch/data/codecs.py``, ``csrc/image_codec.cpp``)
against the sandbox's OpenCV 5.0 (libjpeg-turbo 3.1.2), which is the reference:
the tests import cv2, the port never does.

- ``imread`` equals ``cv2.imread`` bit for bit over chroma sampling 4:1:1,
  4:2:0, 4:2:2, 4:4:0 and 4:4:4, qualities 30/75/95/100, baseline and
  progressive, restart intervals 0 and 3, gray, sizes 1x1 to 480x640, smooth
  and noisy images, 16-bit quantisation tables, files without Huffman
  tables and progressive files, whose tables change between scans;
- ``encode_jpeg`` / ``imwrite`` give ``cv2.imencode``'s bytes at the default
  quality and at each tested one, colour and gray;
- cut and corrupt files give what ``cv2.imread`` gives (an image, or
  ``OSError`` where it gives None), block smoothing of cut progressive files
  included; CMYK and YCCK files (Pillow's, Adobe's transform flag) equal
  ``cv2.imread``; arithmetic coding, lossless and 12-bit files raise naming
  the feature.
"""

from __future__ import annotations

import itertools
import struct
import sys
from pathlib import Path

import cv2  # the reference; the port never imports it
import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent))

from _torch_codec_fixtures import SAMPLING, dqt_16bit, segments, without_dht  # noqa: E402

SIZES = [(1, 1), (2, 3), (17, 33), (77, 123)]
QUALITIES = [30, 75, 95, 100]


def _image(h, w, seed, noisy):
    rng = np.random.default_rng(seed)
    if noisy:
        return rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    y, x = np.mgrid[0:h, 0:w]
    im = np.stack([x * 255 / max(w, 1), y * 255 / max(h, 1), (x + y) * 128 / max(h + w, 1)], -1)
    return np.clip(im + rng.normal(0, 4, im.shape), 0, 255).astype(np.uint8)


def _encode(im, quality=95, sampling="420", progressive=0, restart=0):
    ok, buf = cv2.imencode(".jpg", im, [cv2.IMWRITE_JPEG_QUALITY, quality,
                                        cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling],
                                        cv2.IMWRITE_JPEG_PROGRESSIVE, progressive,
                                        cv2.IMWRITE_JPEG_RST_INTERVAL, restart])
    assert ok
    return buf.tobytes()


def _same_as_cv2(path: Path):
    """``imread`` of the file equals ``cv2.imread``'s array, or raises
    ``OSError`` where cv2 gives None."""
    from ayolov2_torch.data.image_io import imread

    want = cv2.imread(str(path))
    if want is None:
        with pytest.raises(OSError):
            imread(str(path))
    else:
        np.testing.assert_array_equal(imread(str(path)), want)


@pytest.mark.parametrize("sampling", list(SAMPLING))
@pytest.mark.parametrize("mode", ["baseline", "progressive", "restart3"])
def test_decode_equals_cv2(tmp_path, sampling, mode):
    """Every size, quality and image kind under one sampling and mode."""
    for (h, w), q, noisy in itertools.product(SIZES, QUALITIES, (False, True)):
        data = _encode(_image(h, w, h * w + q, noisy), q, sampling,
                       progressive=int(mode == "progressive"), restart=3 if mode == "restart3" else 0)
        path = tmp_path / f"{h}x{w}_{q}_{noisy}.jpg"
        path.write_bytes(data)
        _same_as_cv2(path)


@pytest.mark.parametrize("sampling, mode", [("420", "baseline"), ("420", "progressive"),
                                            ("444", "baseline"), ("422", "restart3")])
def test_decode_480x640_equals_cv2(tmp_path, sampling, mode):
    im = _image(480, 640, 5, noisy=False)
    data = _encode(im, 95, sampling, progressive=int(mode == "progressive"),
                   restart=3 if mode == "restart3" else 0)
    (tmp_path / "a.jpg").write_bytes(data)
    _same_as_cv2(tmp_path / "a.jpg")


@pytest.mark.parametrize("progressive", [0, 1])
def test_gray_decodes_to_bgr_as_cv2(tmp_path, progressive):
    for (h, w), q in itertools.product(SIZES + [(480, 640)], (75, 95)):
        gray = _image(h, w, q, noisy=False)[..., 1]
        ok, buf = cv2.imencode(".jpg", gray, [cv2.IMWRITE_JPEG_QUALITY, q,
                                              cv2.IMWRITE_JPEG_PROGRESSIVE, progressive])
        path = tmp_path / f"g{h}x{w}_{q}.jpg"
        path.write_bytes(buf.tobytes())
        _same_as_cv2(path)


@pytest.mark.parametrize("variant", ["dqt16", "no_dht", "progressive_tables"])
def test_table_variants_decode_as_cv2(tmp_path, variant):
    """16-bit DQT entries (SOF1), a Motion-JPEG frame without DHT (libjpeg's
    standard tables), and a progressive file whose Huffman tables are
    defined anew before its scans."""
    for (h, w), noisy in itertools.product(SIZES, (False, True)):
        im = _image(h, w, h + w, noisy)
        if variant == "dqt16":
            data = dqt_16bit(_encode(im, 75))
            assert b"\xff\xc1" in data
        elif variant == "no_dht":
            data = without_dht(_encode(im, 75))
            assert 0xC4 not in [m for m, _, _ in segments(data)]
        else:
            data = _encode(im, 75, progressive=1)
            assert data.count(b"\xff\xc4") > 2
        (tmp_path / "a.jpg").write_bytes(data)
        _same_as_cv2(tmp_path / "a.jpg")


@pytest.mark.parametrize("quality", [None, 30, 75, 95, 100])
def test_encode_equals_cv2_bytes(tmp_path, quality):
    from ayolov2_torch.data.codecs import encode_jpeg
    from ayolov2_torch.data.image_io import imwrite

    for (h, w), noisy in itertools.product(SIZES + [(480, 640)], (False, True)):
        im = _image(h, w, 7, noisy)
        params = [] if quality is None else [cv2.IMWRITE_JPEG_QUALITY, quality]
        want = cv2.imencode(".jpg", im, params)[1].tobytes()
        assert encode_jpeg(im, 95 if quality is None else quality) == want
        assert encode_jpeg(im[..., 1], 95 if quality is None else quality) == \
            cv2.imencode(".jpg", im[..., 1], params)[1].tobytes()
        if quality is None:
            imwrite(str(tmp_path / "a.jpg"), im)
            cv2.imwrite(str(tmp_path / "b.jpg"), im)
            assert (tmp_path / "a.jpg").read_bytes() == (tmp_path / "b.jpg").read_bytes()


@pytest.mark.parametrize("mode", ["baseline", "restart3"])
def test_cut_files_give_what_cv2_gives(tmp_path, mode):
    """Cut in the headers: cv2 gives None, the port raises; cut in the scan:
    both pad with zero bits and leave the rest grey."""
    im = _image(77, 123, 3, noisy=True)
    data = _encode(im, 95, restart=3 if mode == "restart3" else 0)
    for cut in (3, 20, 100, 300, 600, len(data) // 4, len(data) // 2, len(data) - 300,
                len(data) - 2, len(data) - 1):
        (tmp_path / "a.jpg").write_bytes(data[:cut])
        _same_as_cv2(tmp_path / "a.jpg")


@pytest.mark.parametrize("progressive", [0, 1])
def test_corrupt_scan_data_gives_what_cv2_gives(tmp_path, progressive):
    """Bytes of the entropy-coded data overwritten: bad Huffman codes, stray
    markers and lost restart markers decode as libjpeg decodes them."""
    im = _image(77, 123, 4, noisy=False)
    for restart, seed in itertools.product((0, 2), range(6)):
        data = bytearray(_encode(im, 90, restart=restart, progressive=progressive))
        start = data.index(b"\xff\xda") + 14
        rng = np.random.default_rng(seed)
        for at in rng.integers(start, len(data) - 2, 3):
            data[at] = int(rng.integers(0, 256))
        (tmp_path / "a.jpg").write_bytes(bytes(data))
        _same_as_cv2(tmp_path / "a.jpg")


@pytest.mark.parametrize("patch, feature", [
    (lambda d: d.replace(b"\xff\xc0", b"\xff\xc9", 1), "arithmetic"),
    (lambda d: d.replace(b"\xff\xc0", b"\xff\xc3", 1), "lossless"),
    (lambda d: d.replace(b"\xff\xc0\x00\x11\x08", b"\xff\xc1\x00\x11\x0c", 1), "12-bit"),
], ids=["arithmetic", "lossless", "12bit"])
def test_unsupported_modes_raise_naming_the_feature(tmp_path, patch, feature):
    from ayolov2_torch.data.image_io import imread

    data = patch(_encode(_image(16, 16, 0, noisy=False)))
    path = tmp_path / "a.jpg"
    path.write_bytes(data)
    with pytest.raises(OSError, match=feature) as err:
        imread(str(path))
    assert str(path) in str(err.value)


def _cmyk_jpeg(h: int, w: int, seed: int, quality: int, subsampling: int, progressive: bool):
    """A CMYK JPEG as Pillow writes it (libjpeg with an Adobe marker,
    transform 0, Adobe's inverted values)."""
    import io

    from PIL import Image

    rng = np.random.default_rng(seed)
    cmyk = np.concatenate([_image(h, w, seed, noisy=seed % 2 == 1),
                           rng.integers(0, 256, (h, w, 1), dtype=np.uint8)], 2)
    b = io.BytesIO()
    Image.fromarray(cmyk, "CMYK").save(b, "JPEG", quality=quality, subsampling=subsampling,
                                       progressive=progressive)
    return b.getvalue()


@pytest.mark.parametrize("transform", ["cmyk", "ycck", "unknown", "no_adobe"])
def test_cmyk_and_ycck_equal_cv2(tmp_path, transform):
    """Four components: CMYK (Adobe transform 0, or no Adobe marker) or YCCK
    (transform 2, and libjpeg's guess for any other), upsampled and turned
    into BGR by OpenCV's inverted-CMYK formula, each size, sampling and
    mode; and a frame of four components whose scans name only three."""
    for (h, w), sub, prog in itertools.product(SIZES, (0, 2), (False, True)):
        data = bytearray(_cmyk_jpeg(h, w, h * w + sub, 80, sub, prog))
        at = data.index(b"Adobe")
        if transform == "no_adobe":
            seg = at - 4
            del data[seg: seg + 2 + ((data[seg + 2] << 8) | data[seg + 3])]
        else:
            data[at + 11] = {"cmyk": 0, "ycck": 2, "unknown": 1}[transform]
        path = tmp_path / f"{h}x{w}_{sub}_{prog}.jpg"
        path.write_bytes(bytes(data))
        _same_as_cv2(path)
    four = _encode(_image(16, 16, 0, noisy=False)).replace(
        b"\xff\xc0\x00\x11\x08", b"\xff\xc0\x00\x14\x08", 1).replace(
        b"\x03\x01\x22\x00\x02\x11\x01\x03\x11\x01",
        b"\x04\x01\x22\x00\x02\x11\x01\x03\x11\x01\x04\x11\x01", 1)
    (tmp_path / "four.jpg").write_bytes(four)
    _same_as_cv2(tmp_path / "four.jpg")


@pytest.mark.parametrize("sampling", ["420", "422", "444", "gray"])
def test_cut_progressive_files_are_smoothed_as_cv2(tmp_path, sampling):
    """A progressive file cut before its last scan: libjpeg estimates the
    low AC terms it lacks from the neighbouring blocks' DC values (block
    smoothing, with DC interpolation where a component has no AC term yet,
    and the status before the cut scan below the row where its data ran
    out); a cut in a marker segment reads on through libjpeg's fake EOI
    bytes; a cut at a scan's first bytes decodes garbage coefficients,
    which overflow the 16-bit arithmetic of libjpeg-turbo's SIMD IDCT."""
    for (h, w), noisy in itertools.product([(8, 8), (17, 33), (77, 123)], (False, True)):
        im = _image(h, w, h + w, noisy)
        if sampling == "gray":
            ok, buf = cv2.imencode(".jpg", im[..., 1], [cv2.IMWRITE_JPEG_QUALITY, 85,
                                                        cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
            data = buf.tobytes()
        else:
            data = _encode(im, 85, sampling, progressive=1)
        start = data.index(b"\xff\xda")
        for cut in sorted(set(np.linspace(start + 12, len(data) - 1, 40).astype(int))):
            (tmp_path / "a.jpg").write_bytes(data[:cut])
            _same_as_cv2(tmp_path / "a.jpg")


def test_frames_beyond_cv2_limits_raise(tmp_path):
    """A frame header beyond ``CV_IO_MAX_IMAGE_PIXELS``: cv2 refuses it
    (cv2.error), the port raises ``OSError`` before allocating anything."""
    from ayolov2_torch.data.image_io import imread

    data = bytearray(_encode(_image(8, 8, 0, noisy=False)))
    at = data.index(b"\xff\xc0") + 5
    data[at: at + 4] = struct.pack(">HH", 60000, 60000)
    path = tmp_path / "a.jpg"
    path.write_bytes(bytes(data))
    with pytest.raises(cv2.error):
        cv2.imread(str(path))
    with pytest.raises(OSError, match="beyond OpenCV's limits"):
        imread(str(path))


def test_decode_bytes_match_imdecode():
    """``decode_jpeg`` of bytes is ``cv2.imdecode`` (no EXIF in the file)."""
    from ayolov2_torch.data.codecs import decode_jpeg

    data = _encode(_image(33, 47, 9, noisy=True), 80, "422", progressive=1)
    np.testing.assert_array_equal(decode_jpeg(data),
                                  cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR))
