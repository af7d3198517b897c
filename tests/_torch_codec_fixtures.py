"""The committed JPEG and PNG fixtures of the port's codecs and their manifest.

``tests/res/torch_codec/`` holds small JPEGs written by OpenCV (each chroma
sampling, progressive, restart markers, gray, a 16-bit quantisation table,
no Huffman tables, EXIF orientations 1-8, a baseline and a progressive file
cut short, and a 640x480 progressive file that the card's phase also
times) and PNGs of every colour type and
bit depth (Adam7, ``tRNS``, ``eXIf``) written by :func:`png_file`.
``manifest.json`` records each file's ``cv2.imread`` shape and sha256 and,
for a JPEG, its source (``chip_smoke.codec_source``: seed, size, gray),
quality and the sha256 of ``cv2.imencode`` of the source at that quality.
``chip_smoke.py`` phase 16 holds the port's codecs on the card's machine,
which has no OpenCV, against these digests.

Write them again (with OpenCV): ``python tests/_torch_codec_fixtures.py``.
"""

from __future__ import annotations

import binascii
import hashlib
import json
import struct
import sys
import zlib
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
FIXTURES = ROOT / "tests/res/torch_codec"
sys.path.insert(0, str(ROOT))

from chip_smoke import codec_source, exif_app1, with_exif  # noqa: E402

JPEG_H, JPEG_W = 45, 71  # a partial MCU at the right and bottom edges
PNG_H, PNG_W = 19, 27
SAMPLING = {"411": 0x411111, "420": 0x221111, "422": 0x211111, "440": 0x121111,
            "444": 0x111111}
PNG_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
         (0, 1, 1, 2))


# ---- JPEG ------------------------------------------------------------------------------


def segments(jpeg: bytes):
    """(marker, start of its FF, end) of each segment before the first SOS."""
    pos = 2
    while True:
        m = jpeg[pos + 1]
        end = pos + 2 + struct.unpack(">H", jpeg[pos + 2: pos + 4])[0]
        yield m, pos, end
        if m == 0xDA:
            return
        pos = end


def dqt_16bit(jpeg: bytes) -> bytes:
    """``jpeg`` with each DQT table stored with 16-bit entries (Pq = 1): the
    same values, so the same pixels; SOF0 becomes SOF1 (extended)."""
    out, pos = [], 0
    for m, start, end in segments(jpeg):
        if m == 0xDB:
            body, tables = jpeg[start + 4: end], b""
            i = 0
            while i < len(body):
                assert body[i] >> 4 == 0
                vals = body[i + 1: i + 65]
                tables += bytes([0x10 | (body[i] & 15)]) + b"".join(struct.pack(">H", v) for v in vals)
                i += 65
            out += [jpeg[pos:start], b"\xff\xdb" + struct.pack(">H", len(tables) + 2) + tables]
            pos = end
        elif m == 0xC0:
            out += [jpeg[pos:start], b"\xff\xc1"]
            pos = start + 2
    return b"".join(out) + jpeg[pos:]


def without_dht(jpeg: bytes) -> bytes:
    """``jpeg`` with its DHT segments taken out (a Motion-JPEG frame): the
    decoder takes the standard tables, which the encoder used."""
    out, pos = [], 0
    for m, start, end in segments(jpeg):
        if m == 0xC4:
            out.append(jpeg[pos:start])
            pos = end
    return b"".join(out) + jpeg[pos:]


def jpeg_fixtures():
    """name -> (bytes, source description): every JPEG fixture."""
    import cv2

    def enc(src, q, *params):
        ok, buf = cv2.imencode(".jpg", src, [cv2.IMWRITE_JPEG_QUALITY, q, *params])
        assert ok
        return buf.tobytes()

    out = {}
    for k, (name, factor) in enumerate(SAMPLING.items()):
        src = dict(seed=100 + k, h=JPEG_H, w=JPEG_W, gray=False, quality=90)
        out[f"j{name}.jpg"] = (enc(codec_source(100 + k, JPEG_H, JPEG_W), 90,
                                   cv2.IMWRITE_JPEG_SAMPLING_FACTOR, factor), src)
    base = dict(seed=110, h=JPEG_H, w=JPEG_W, gray=False)
    img = codec_source(110, JPEG_H, JPEG_W)
    out["jprog.jpg"] = (enc(img, 75, cv2.IMWRITE_JPEG_PROGRESSIVE, 1), dict(base, quality=75))
    # cut short: zero-bit padding, and libjpeg's block smoothing of a progressive file
    seq = enc(img, 85)
    out["jcut.jpg"] = (seq[: seq.index(b"\xff\xda") + 300], dict(base, quality=85))
    prog = enc(img, 85, cv2.IMWRITE_JPEG_PROGRESSIVE, 1)
    fourth_scan = [i for i in range(len(prog) - 1) if prog[i: i + 2] == b"\xff\xda"][3]
    out["jprogcut.jpg"] = (prog[: fourth_scan + 30], dict(base, quality=85))
    big = dict(seed=112, h=480, w=640, gray=False, quality=75)  # timed on the card too
    out["jprog640.jpg"] = (enc(codec_source(112, 480, 640), 75, cv2.IMWRITE_JPEG_PROGRESSIVE, 1),
                           big)
    out["jrst.jpg"] = (enc(img, 85, cv2.IMWRITE_JPEG_RST_INTERVAL, 3), dict(base, quality=85))
    out["jdqt16.jpg"] = (dqt_16bit(enc(img, 95)), dict(base, quality=95))
    out["jstd.jpg"] = (without_dht(enc(img, 95)), dict(base, quality=95))
    gray = codec_source(111, JPEG_H, JPEG_W, gray=True)
    out["jgray.jpg"] = (enc(gray, 95), dict(seed=111, h=JPEG_H, w=JPEG_W, gray=True, quality=95))
    for o in range(1, 9):
        out[f"jexif{o}.jpg"] = (with_exif(enc(img, 95), o, little=o % 2 == 1),
                                dict(base, quality=95))
    return out


# ---- PNG -------------------------------------------------------------------------------


def chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", binascii.crc32(kind + body) & 0xFFFFFFFF))


def _pack(samples: np.ndarray, depth: int) -> bytes:
    """One row of samples at ``depth`` bits, big-endian, packed MSB first."""
    if depth == 8:
        return samples.astype(np.uint8).tobytes()
    if depth == 16:
        return samples.astype(">u2").tobytes()
    per = 8 // depth
    v = np.zeros(-(-len(samples) // per) * per, np.int64)
    v[: len(samples)] = samples
    v = v.reshape(-1, per)
    packed = np.zeros(len(v), np.int64)
    for i in range(per):
        packed = (packed << depth) | v[:, i]
    return packed.astype(np.uint8).tobytes()


def _filter(rows, bpp: int, rng) -> bytes:
    """Each row behind a random filter type (0-4)."""
    out, prev = [], np.zeros(len(rows[0]), np.int64)
    for r in rows:
        x = np.frombuffer(r, np.uint8).astype(np.int64)
        f = int(rng.integers(0, 5))
        res = np.empty_like(x)
        for i in range(len(x)):
            a = x[i - bpp] if i >= bpp else 0
            b, c = prev[i], (prev[i - bpp] if i >= bpp else 0)
            if f == 4:
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
            else:
                pred = (0, a, b, (a + b) >> 1)[f]
            res[i] = (x[i] - pred) & 255
        out.append(bytes([f]) + res.astype(np.uint8).tobytes())
        prev = x
    return b"".join(out)


def png_file(seed: int, w: int, h: int, depth: int, ctype: int, interlace: int = 0,
             trns: bool = False, exif: int = 0, n_palette: int = 7, extra_rows: int = 0) -> bytes:
    """A PNG of random samples (a palette of ``n_palette`` entries, indices up
    to ``n_palette`` + 1, so some fall past it), rows behind random filters;
    ``trns`` adds a tRNS chunk, ``exif`` an eXIf chunk with that orientation
    after IDAT; ``extra_rows`` appends rows past the image to the stream."""
    rng = np.random.default_rng(seed)
    ch = PNG_CHANNELS[ctype]
    top = n_palette + 2 if ctype == 3 else 1 << depth
    img = rng.integers(0, min(top, 1 << depth), (h, w, ch))
    bpp = max(1, ch * depth // 8)
    raw = b""
    for x0, y0, dx, dy in (ADAM7 if interlace else ((0, 0, 1, 1),)):
        sub = img[y0::dy, x0::dx]
        if sub.size:
            raw += _filter([_pack(r.ravel(), depth) for r in sub], bpp, rng)
    raw += bytes(extra_rows * (len(_pack(img[0].ravel(), depth)) + 1))
    body = chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, interlace))
    if ctype == 3:
        body += chunk(b"PLTE", rng.integers(0, 256, 3 * n_palette).astype(np.uint8).tobytes())
    if trns:
        body += chunk(b"tRNS", {0: bytes([0, 9]), 2: bytes([0, 9] * 3)}.get(ctype, bytes([128, 7])))
    body += chunk(b"IDAT", zlib.compress(raw))
    if exif:
        body += chunk(b"eXIf", exif_app1(exif)[10:])
    return b"\x89PNG\r\n\x1a\n" + body + chunk(b"IEND", b"")


def png_fixtures():
    out = {}
    for ctype, depths in PNG_DEPTHS.items():
        for depth in depths:
            out[f"p{ctype}_{depth}.png"] = png_file(ctype * 100 + depth, PNG_W, PNG_H, depth, ctype)
    out["p2_8_adam7.png"] = png_file(7, PNG_W, PNG_H, 8, 2, interlace=1)
    out["p3_4_adam7_trns.png"] = png_file(8, PNG_W, PNG_H, 4, 3, interlace=1, trns=True)
    out["p0_16_trns.png"] = png_file(9, PNG_W, PNG_H, 16, 0, trns=True)
    out["p2_8_exif6.png"] = png_file(10, PNG_W, PNG_H, 8, 2, exif=6)
    return out


# ---- manifest ----------------------------------------------------------------------------


def sha256(b) -> str:
    return hashlib.sha256(bytes(b)).hexdigest()


def manifest(root: Path = FIXTURES) -> dict:
    """Each fixture's ``cv2.imread`` shape and digest, and for a JPEG its
    source and the digest of ``cv2.imencode`` of the source."""
    import cv2

    files = {}
    sources = {name: src for name, (_, src) in jpeg_fixtures().items()}
    for path in sorted(root.glob("*.*g")):
        im = cv2.imread(str(path))
        entry = {"shape": list(im.shape), "sha256": sha256(np.ascontiguousarray(im).tobytes())}
        if path.name in sources:
            src = dict(sources[path.name])
            ok, buf = cv2.imencode(".jpg", codec_source(src["seed"], src["h"], src["w"], src["gray"]),
                                   [cv2.IMWRITE_JPEG_QUALITY, src["quality"]])
            src["imencode_sha256"] = sha256(buf.tobytes())
            entry["source"] = src
        files[path.name] = entry
    return {"reference": f"cv2 {cv2.__version__}", "files": files}


def write(root: Path = FIXTURES) -> None:
    root.mkdir(parents=True, exist_ok=True)
    for name, (data, _) in jpeg_fixtures().items():
        (root / name).write_bytes(data)
    for name, data in png_fixtures().items():
        (root / name).write_bytes(data)
    (root / "manifest.json").write_text(json.dumps(manifest(root), indent=1, sort_keys=True) + "\n")


if __name__ == "__main__":
    write()
