"""The port's WebP reader (``ayolov2_torch/data/codecs.decode_webp``, VP8L
and VP8 in ``csrc/webp_codec.cpp``) against the installed OpenCV 5.0
(libwebp through ``WebPDecodeBGRInto``), the reference: lossless files at
every size (prefix codes, LZ77, the colour cache, the four transforms,
palettes with pixel bundling), lossy files at every quality (intra modes,
segments, the loop filters, the fancy upsampler), files that Pillow writes
with other encoder settings, alpha (dropped), EXIF orientations 1-8 (with
and without the ``Exif`` prefix, with and without the VP8X flag), an
animation's first frame, and damaged files, where cv2 gives None and the
port raises.
"""

from __future__ import annotations

import itertools
import struct
import sys
from pathlib import Path

import cv2  # the reference; the port never imports it
import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from chip_smoke import codec_source  # noqa: E402

SIZES = [(1, 1), (2, 3), (17, 33), (45, 71), (120, 200)]


def _same_as_cv2(path: Path):
    from ayolov2_torch.data.image_io import imread

    try:
        want = cv2.imread(str(path))
    except cv2.error:
        want = None
    if want is None:
        with pytest.raises(OSError):
            imread(str(path))
    else:
        np.testing.assert_array_equal(imread(str(path)), want)


def _images(h: int, w: int, seed: int):
    """A gradient with noise, pure noise, and a few-colour image (which the
    lossless encoder stores behind a colour-indexing transform)."""
    rng = np.random.default_rng(seed)
    smooth = codec_source(seed, h, w)
    return [smooth, rng.integers(0, 256, (h, w, 3), dtype=np.uint8), smooth // 85 * 85,
            np.ascontiguousarray(np.broadcast_to(rng.integers(0, 256, 3, dtype=np.uint8),
                                                 (h, w, 3)))]


def test_lossless_equals_cv2(tmp_path):
    for (h, w), k in itertools.product(SIZES, range(4)):
        im = _images(h, w, h * w)[k]
        path = tmp_path / f"{h}x{w}_{k}.webp"
        assert cv2.imwrite(str(path), im)
        _same_as_cv2(path)


@pytest.mark.parametrize("quality", [1, 30, 75, 90, 100])
def test_lossy_equals_cv2(tmp_path, quality):
    for (h, w), k in itertools.product(SIZES, range(4)):
        im = _images(h, w, h + w + quality)[k]
        path = tmp_path / f"{h}x{w}_{k}.webp"
        assert cv2.imwrite(str(path), im, [cv2.IMWRITE_WEBP_QUALITY, quality])
        _same_as_cv2(path)


def test_lossy_480x640_equals_cv2(tmp_path):
    path = tmp_path / "a.webp"
    assert cv2.imwrite(str(path), codec_source(9, 480, 640), [cv2.IMWRITE_WEBP_QUALITY, 80])
    _same_as_cv2(path)


@pytest.mark.parametrize("options", [
    dict(lossless=True, method=0), dict(lossless=True, method=6, quality=100),
    dict(lossless=True, exact=True), dict(quality=50, method=0), dict(quality=95, method=6),
    dict(quality=10, method=3)], ids=["ll_m0", "ll_m6", "ll_exact", "q50_m0", "q95_m6", "q10"])
def test_pillow_encoder_settings_equal_cv2(tmp_path, options):
    """Other encoder choices (methods, which change the transforms, filter
    strengths and partitions used), colour and with alpha."""
    from PIL import Image

    for (h, w), alpha in itertools.product(SIZES[1:], (False, True)):
        im = codec_source(h * 3 + w, h, w)[..., ::-1]
        if alpha:
            im = np.concatenate([im, codec_source(h, h, w, gray=True)[..., None]], 2)
        path = tmp_path / f"{h}x{w}_{alpha}.webp"
        Image.fromarray(np.ascontiguousarray(im), "RGBA" if alpha else "RGB").save(path, "WEBP",
                                                                                   **options)
        _same_as_cv2(path)


def _riff(chunks) -> bytes:
    body = b"".join(tag + struct.pack("<I", len(p)) + p + bytes(len(p) % 2) for tag, p in chunks)
    return b"RIFF" + struct.pack("<I", 4 + len(body)) + b"WEBP" + body


def _vp8x(flags: int, w: int, h: int) -> bytes:
    return bytes([flags, 0, 0, 0]) + (w - 1).to_bytes(3, "little") + (h - 1).to_bytes(3, "little")


def _exif(o: int, little: bool) -> bytes:
    e = "<" if little else ">"
    return ((b"II" if little else b"MM") + struct.pack(e + "HI", 42, 8) + struct.pack(e + "H", 1)
            + struct.pack(e + "HHIHH", 0x0112, 3, 1, o, 0) + struct.pack(e + "I", 0))


def _image_chunk(lossless: bool):
    ok, buf = cv2.imencode(".webp", codec_source(1, 30, 50),
                           [] if lossless else [cv2.IMWRITE_WEBP_QUALITY, 80])
    data = buf.tobytes()
    return data[12:16], data[20: 20 + struct.unpack_from("<I", data, 16)[0]]


@pytest.mark.parametrize("lossless", [True, False], ids=["vp8l", "vp8"])
def test_exif_orientation_is_applied_as_cv2(tmp_path, lossless):
    """cv2 turns the image by an EXIF chunk that starts with the TIFF header
    and that the VP8X flag announces; ``image_size`` equals the JAX
    package's ``exif_size``, which reads the chunk with or without the
    ``Exif`` prefix (PIL)."""
    from PIL import Image

    from ayolov2_tpu.data.datasets import exif_size
    from ayolov2_torch.data.image_io import image_size

    tag, payload = _image_chunk(lossless)
    for o, prefix, flag, first in itertools.product(range(1, 9), (b"", b"Exif\0\0"), (8, 0),
                                                     (False, True)):
        exif = (b"EXIF", prefix + _exif(o, o % 2 == 0))
        chunks = [(b"VP8X", _vp8x(flag, 50, 30))] + ([exif, (tag, payload)] if first
                                                      else [(tag, payload), exif])
        path = tmp_path / f"{o}_{len(prefix)}_{flag}_{first}.webp"
        path.write_bytes(_riff(chunks))
        _same_as_cv2(path)
        with Image.open(path) as pil:
            assert image_size(str(path)) == exif_size(pil), path.name


def test_animation_gives_its_first_frame_as_cv2(tmp_path):
    from PIL import Image

    for lossless, (h, w) in itertools.product((True, False), SIZES[2:4]):
        frames = [Image.fromarray(codec_source(k + h, h, w)[..., ::-1]) for k in range(3)]
        path = tmp_path / f"{lossless}_{h}.webp"
        frames[0].save(path, "WEBP", save_all=True, append_images=frames[1:], lossless=lossless,
                       quality=80)
        _same_as_cv2(path)


def test_animation_frame_off_the_canvas_origin(tmp_path):
    """A first frame smaller than its canvas, at an offset: cv2 gives the
    frame on a transparent black canvas, alpha dropped."""
    for lossless in (True, False):
        tag, payload = _image_chunk(lossless)
        anmf = (b"".join(v.to_bytes(3, "little") for v in (2, 3, 49, 29, 100)) + bytes(1)
                + tag + struct.pack("<I", len(payload)) + payload + bytes(len(payload) % 2))
        path = tmp_path / f"{lossless}.webp"
        path.write_bytes(_riff([(b"VP8X", _vp8x(0x02, 60, 40)), (b"ANIM", bytes(6)),
                                (b"ANMF", anmf)]))
        _same_as_cv2(path)


@pytest.mark.parametrize("lossless", [True, False], ids=["vp8l", "vp8"])
def test_damaged_files_give_what_cv2_gives(tmp_path, lossless):
    """Cut files, a RIFF size past the data, a wrong canvas size, a bad
    signature and flipped bytes in the bitstream's headers."""
    ok, buf = cv2.imencode(".webp", codec_source(2, 45, 71),
                           [] if lossless else [cv2.IMWRITE_WEBP_QUALITY, 75])
    good = buf.tobytes()
    tag, payload = good[12:16], good[20:]
    cases = [good[:cut] for cut in (10, 20, 30, len(good) // 2, len(good) - 1)]
    cases.append(good[:4] + struct.pack("<I", len(good) + 10) + good[8:])
    cases.append(_riff([(b"VP8X", _vp8x(0, 60, 45)), (tag, payload)]))
    cases.append(good[:20] + bytes([good[20] ^ 0xFF]) + good[21:])
    for at in (21, 23, 25):
        cases.append(good[:at] + bytes([good[at] ^ 0x55]) + good[at + 1:])
    for k, data in enumerate(cases):
        path = tmp_path / f"{k}.webp"
        path.write_bytes(data)
        _same_as_cv2(path)


def test_decode_bytes_match_imdecode():
    """``decode_webp`` of bytes is ``cv2.imdecode`` (no EXIF in the file)."""
    from ayolov2_torch.data.codecs import decode_webp

    for params in ([], [cv2.IMWRITE_WEBP_QUALITY, 60]):
        data = cv2.imencode(".webp", codec_source(3, 33, 47), params)[1].tobytes()
        np.testing.assert_array_equal(decode_webp(data),
                                      cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR))

