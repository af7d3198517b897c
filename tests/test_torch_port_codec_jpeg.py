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
  ``cv2.imread``;
- lossless files (SOF3; ``_torch_codec_fixtures.lossless_jpeg``) equal it
  for predictors 1-7, point transforms, restarts, one scan or one a
  component, RGB and CMYK, cut and corrupt; grey, YCbCr (JFIF or Adobe
  transform 1), YCCK and 12- or 16-bit lossless files give None there and
  raise naming the mode here;
- arithmetic-coded files equal it: sequential ones from
  ``_torch_codec_fixtures.arith_jpeg`` (each sampling, restarts, DAC
  conditioning), OpenCV's Huffman files marked SOF9 or SOF10 (whose data the
  QM decoder reads as garbage, as cv2 does: error paths included), cut and
  corrupt; 12-bit DCT files (SOF1 and SOF2, ``jpeg12``) and arithmetic
  lossless ones give None there and raise naming the mode here.
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

from _torch_codec_fixtures import (SAMPLING, arith_jpeg, dqt_16bit, jpeg12,  # noqa: E402
                                   lossless_jpeg, segments, without_dht)

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


@pytest.mark.parametrize("patch, feature, read", [
    (lambda d: d.replace(b"\xff\xc0", b"\xff\xc9", 1), "arithmetic", True),
    (lambda d: d.replace(b"\xff\xc0", b"\xff\xc3", 1), "lossless", False),
    (lambda d: d.replace(b"\xff\xc0\x00\x11\x08", b"\xff\xc1\x00\x11\x0c", 1), "12-bit",
     False),
], ids=["arithmetic", "lossless", "12bit"])
def test_unsupported_modes_raise_naming_the_feature(tmp_path, patch, feature, read):
    """A baseline file marked arithmetic-coded (SOF9) is read as cv2 reads
    it; marked lossless its scan's parameters are not a lossless scan's, and
    at 12 bits libjpeg's 8-bit interface refuses it: cv2 gives None, the
    port raises naming the mode."""
    from ayolov2_torch.data.image_io import imread

    data = patch(_encode(_image(16, 16, 0, noisy=False)))
    path = tmp_path / "a.jpg"
    path.write_bytes(data)
    want = cv2.imread(str(path))
    assert (want is not None) == read
    if read:
        np.testing.assert_array_equal(imread(str(path)), want)
        return
    with pytest.raises(OSError, match=feature) as err:
        imread(str(path))
    assert str(path) in str(err.value)


@pytest.mark.parametrize("coding", ["huffman", "arithmetic", "lossless"])
def test_markers_after_the_only_scan_are_ignored(tmp_path, coding):
    """After the scan of a single-scan file libjpeg reads markers only in
    ``jpeg_finish_decompress``, whose error OpenCV ignores: another scan, an
    unknown marker or a bad table there leave cv2's image whole, and the
    port's."""
    im = _image(16, 24, 5, noisy=True)
    data = {"huffman": lambda: _encode(im),
            "arithmetic": lambda: arith_jpeg(5, 24, 16),
            "lossless": lambda: lossless_jpeg(im)}[coding]()
    sos = data.index(b"\xff\xda")
    sos = data[sos: sos + 2 + ((data[sos + 2] << 8) | data[sos + 3])]
    for k, extra in enumerate((sos + b"\x12\x34", b"\xff\xf3\x00\x04ab", b"\xff\xf3",
                               b"\xff\xc4\x00\x03\x00", b"\xff\xdb\x00\x03\x09")):
        path = tmp_path / f"{k}.jpg"
        path.write_bytes(data[:-2] + extra + b"\xff\xd9")
        assert cv2.imread(str(path)) is not None
        _same_as_cv2(path)


def _lossless_image(h, w, seed, nc=3):
    rng = np.random.default_rng(seed)
    if seed % 2:
        return rng.integers(0, 256, (h, w, nc), dtype=np.uint8)
    return np.concatenate([_image(h, w, seed, noisy=False)] * 2, 2)[..., :nc]


@pytest.mark.parametrize("predictor", range(1, 8))
def test_lossless_equals_cv2(tmp_path, predictor):
    """SOF3 at 8 bits, 3 components (no marker, or Adobe transform 0) and 4
    (CMYK): each predictor with point transforms 0-3, restarts every 1 or 3
    rows, one scan or one a component, at each size; libjpeg converts no
    colours, so cv2 gives the samples as stored (BGR of RGB)."""
    for k, ((h, w), pt, rst, inter) in enumerate(itertools.product(
            SIZES, (0, 3), (0, 1, 3), (True, False))):
        for nc, adobe in ((3, None), (3, 0), (4, None)):
            if (k + nc + (adobe or 0)) % 3:
                continue
            data = lossless_jpeg(_lossless_image(h, w, k, nc), predictor, pt, rst, adobe=adobe,
                                 interleaved=inter)
            path = tmp_path / f"{k}_{nc}.jpg"
            path.write_bytes(data)
            assert cv2.imread(str(path)) is not None
            _same_as_cv2(path)


@pytest.mark.parametrize("sampling", [(2, 1), (1, 2), (2, 2), (4, 1), (1, 4), (3, 1)])
def test_subsampled_lossless_equals_cv2(tmp_path, sampling):
    """A lossless frame with its first component subsampled: libjpeg
    decodes the dummy samples of its MCUs and drops them, upsamples by
    replication, and in a scan of one component undifferences v rows at a
    time, so a restart's first-row predictor falls on the first of them; a
    restart interval that is no multiple of a scan's MCUs in a row gives
    None there, and the port raises."""
    for k, ((h, w), rst, inter) in enumerate(itertools.product(
            [(23, 37), (16, 16), (1, 1), (9, 4)], (0, 1, 2), (True, False))):
        data = lossless_jpeg(_lossless_image(h, w, k), 1 + k % 7, 0, rst, sampling=sampling,
                             interleaved=inter)
        path = tmp_path / f"{k}.jpg"
        path.write_bytes(data)
        _same_as_cv2(path)


@pytest.mark.parametrize("case, feature", [
    ("gray", "grey"), ("jfif", "YCbCr"), ("adobe1", "YCbCr"), ("ycck", "YCCK"),
    ("12bit", "12-bit"), ("16bit", "16-bit"), ("arith", "arithmetic")])
def test_lossless_modes_cv2_refuses_raise(tmp_path, case, feature):
    """Lossless files whose colour space libjpeg would have to convert (it
    converts none in lossless mode) or of other than 8 bits, and
    arithmetic-coded lossless (SOF11): cv2.imread gives None, the port raises
    naming the mode."""
    from ayolov2_torch.data.image_io import imread

    img = _lossless_image(9, 13, 0)
    data = {"gray": lambda: lossless_jpeg(img[..., 0]),
            "jfif": lambda: lossless_jpeg(img, jfif=True),
            "adobe1": lambda: lossless_jpeg(img, adobe=1),
            "ycck": lambda: lossless_jpeg(_lossless_image(9, 13, 0, 4), adobe=2),
            "12bit": lambda: lossless_jpeg(img.astype(np.uint16) * 16, precision=12),
            "16bit": lambda: lossless_jpeg(img.astype(np.uint16) * 257, precision=16),
            "arith": lambda: lossless_jpeg(img).replace(b"\xff\xc3", b"\xff\xcb", 1)}[case]()
    path = tmp_path / "a.jpg"
    path.write_bytes(data)
    assert cv2.imread(str(path)) is None
    with pytest.raises(OSError, match=feature):
        imread(str(path))


def test_lossless_cut_and_corrupt_give_what_cv2_gives(tmp_path):
    """Data cut short: the rows after it get zero differences from the
    first-row predictor (grey 128); corrupt bytes decode as libjpeg decodes
    them, restarts resynchronising."""
    for rst in (0, 4):
        data = lossless_jpeg(_lossless_image(40, 31, 1), 5, restart_rows=rst)
        start = data.index(b"\xff\xda") + 14
        for cut in np.linspace(start, len(data) - 1, 12).astype(int):
            (tmp_path / "a.jpg").write_bytes(data[:cut])
            _same_as_cv2(tmp_path / "a.jpg")
        for seed in range(6):
            bad = bytearray(data)
            rng = np.random.default_rng(seed)
            for at in rng.integers(start, len(data) - 2, 3):
                bad[at] = int(rng.integers(0, 256))
            (tmp_path / "a.jpg").write_bytes(bytes(bad))
            _same_as_cv2(tmp_path / "a.jpg")


@pytest.mark.parametrize("sampling", [(1, 1), (2, 1), (1, 2), (2, 2), "gray"])
def test_arithmetic_coded_equals_cv2(tmp_path, sampling):
    """Sequential arithmetic coding (SOF9) of random coefficients with
    restarts every 0, 1 or 3 MCUs and DAC conditioning (default, and L, U, K
    set), each size; cut and corrupt files as libjpeg reads them (a marker
    stops the input and zeros are decoded on)."""
    gray = sampling == "gray"
    for k, ((h, w), rst, dac) in enumerate(itertools.product(
            SIZES, (0, 1, 3), (None, (1, 3, 2), (0, 0, 1)))):
        data = arith_jpeg(k, w, h, sampling=(1, 1) if gray else sampling, gray=gray, restart=rst,
                          dac=dac)
        path = tmp_path / f"{k}.jpg"
        path.write_bytes(data)
        assert cv2.imread(str(path)) is not None
        _same_as_cv2(path)
    data = arith_jpeg(99, 61, 45, sampling=(1, 1) if gray else sampling, gray=gray, restart=2)
    start = data.index(b"\xff\xda") + 10
    for cut in np.linspace(start, len(data) - 1, 10).astype(int):
        (tmp_path / "a.jpg").write_bytes(data[:cut])
        _same_as_cv2(tmp_path / "a.jpg")
    for seed in range(6):
        bad = bytearray(data)
        rng = np.random.default_rng(seed)
        for at in rng.integers(start, len(data) - 2, 3):
            bad[at] = int(rng.integers(0, 256))
        (tmp_path / "a.jpg").write_bytes(bytes(bad))
        _same_as_cv2(tmp_path / "a.jpg")


@pytest.mark.parametrize("mode", ["sequential", "progressive"])
def test_huffman_data_read_as_arithmetic_equals_cv2(tmp_path, mode):
    """OpenCV's files marked arithmetic-coded (SOF0 as SOF9, SOF2 as SOF10):
    the QM decoder reads their Huffman data as garbage, magnitude and
    spectral overflows and every progressive scan kind (DC first and
    refinement, AC first and refinement) included, as cv2 does."""
    for (h, w), q, rst, gray in itertools.product(SIZES, (50, 95), (0, 2), (False, True)):
        im = _image(h, w, h + w + q, noisy=q == 95)
        if gray:
            im = im[..., 1]
        params = [cv2.IMWRITE_JPEG_QUALITY, q, cv2.IMWRITE_JPEG_RST_INTERVAL, rst,
                  cv2.IMWRITE_JPEG_PROGRESSIVE, int(mode == "progressive")]
        data = cv2.imencode(".jpg", im, params)[1].tobytes()
        data = (data.replace(b"\xff\xc2", b"\xff\xca", 1) if mode == "progressive"
                else data.replace(b"\xff\xc0", b"\xff\xc9", 1))
        path = tmp_path / f"{h}_{q}_{rst}_{gray}.jpg"
        path.write_bytes(data)
        assert cv2.imread(str(path)) is not None
        _same_as_cv2(path)


@pytest.mark.parametrize("progressive", [False, True], ids=["sof1", "sof2"])
def test_12bit_dct_gives_none_and_raises(tmp_path, progressive):
    """A 12-bit DCT file (P = 12): libjpeg-turbo decodes it only through its
    12-bit interface, which OpenCV does not call, so cv2 gives None; the port
    raises naming the precision."""
    from ayolov2_torch.data.image_io import imread

    path = tmp_path / "a.jpg"
    path.write_bytes(jpeg12(3, 45, 33, progressive))
    assert cv2.imread(str(path)) is None
    with pytest.raises(OSError, match="12-bit"):
        imread(str(path))


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
