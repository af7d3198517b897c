"""Image files through the port: EXIF orientations, sizes, the committed
codec fixtures, the JPEG compression policy and the dataset on a directory of
JPEG, PNG, EXIF-rotated JPEG, TIFF (LZW, JPEG, YCbCr, Group 4, CIELab),
lossless and arithmetic-coded JPEG, EXIF-rotated WebP and palette BMP files,
each against the JAX package (which reads through cv2 and PIL) or the
installed OpenCV 5.0; and the port's reads and writes in an interpreter
where cv2 and PIL cannot be imported, as on the card's machine.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import cv2  # the reference; the port never imports it
import numpy as np
import pytest
import yaml

sys.path.insert(0, str(Path(__file__).resolve().parent))

import _torch_codec_fixtures as fx  # noqa: E402
from _torch_port_common import ROOT  # noqa: E402

IMG = 128


def _jpeg(im, quality=95):
    return cv2.imencode(".jpg", im, [cv2.IMWRITE_JPEG_QUALITY, quality])[1].tobytes()


@pytest.mark.parametrize("little", [True, False], ids=["II", "MM"])
def test_exif_orientations_read_and_size_as_cv2_and_jax(tmp_path, little):
    """``imread`` turns each of the eight orientations as ``cv2.imread``;
    ``image_size`` equals the JAX package's ``exif_size(Image.open(f))``,
    which swaps only for 6 and 8."""
    from PIL import Image

    from ayolov2_tpu.data.datasets import exif_size
    from ayolov2_torch.data.image_io import image_size, imread

    im = fx.codec_source(3, 24, 40)
    for o in range(1, 9):
        for name, data in (("j", fx.with_exif(_jpeg(im), o, little)),
                           ("p", fx.png_file(o, 40, 24, 8, 2, exif=o))):
            path = tmp_path / f"{name}{o}.{'jpg' if name == 'j' else 'png'}"
            path.write_bytes(data)
            np.testing.assert_array_equal(imread(str(path)), cv2.imread(str(path)))
            with Image.open(path) as pil:
                assert image_size(str(path)) == exif_size(pil), (name, o)


def test_decoder_follows_the_signature_not_the_suffix(tmp_path):
    from ayolov2_torch.data.image_io import image_size, imread

    im = fx.codec_source(4, 33, 21)
    files = {"jpeg.png": _jpeg(im), "png.jpg": fx.png_file(5, 21, 33, 8, 6),
             "jpeg.bmp": _jpeg(im, 80)}
    for name, data in files.items():
        (tmp_path / name).write_bytes(data)
        np.testing.assert_array_equal(imread(str(tmp_path / name)), cv2.imread(str(tmp_path / name)))
        assert image_size(str(tmp_path / name)) == (21, 33)


def test_imwrite_png_and_jpg_read_back_by_cv2(tmp_path):
    from ayolov2_torch.data.image_io import imwrite

    im = fx.codec_source(6, 37, 53)
    imwrite(str(tmp_path / "a.png"), im)
    np.testing.assert_array_equal(cv2.imread(str(tmp_path / "a.png")), im)
    imwrite(str(tmp_path / "a.jpeg"), im)
    assert (tmp_path / "a.jpeg").read_bytes() == _jpeg(im)


def test_fixture_manifest_is_current(tmp_path):
    """The committed fixtures are what their writer writes, and the manifest
    is what cv2 reads and encodes from them."""
    fx.write(tmp_path)
    committed = sorted(p.name for p in fx.FIXTURES.iterdir())
    assert sorted(p.name for p in tmp_path.iterdir()) == committed
    for name in committed:
        assert (tmp_path / name).read_bytes() == (fx.FIXTURES / name).read_bytes(), name


KINDS = {".jpg": "jpeg", ".png": "png", ".bmp": "bmp", ".tif": "tiff", ".webp": "webp"}


@pytest.mark.parametrize("kind", ["jpeg", "png", "bmp", "tiff", "webp"])
def test_port_decodes_fixtures_to_the_manifest(kind):
    """What ``chip_smoke.py`` phase 16 checks on the card: each fixture's
    array digest (a left-out mode raises naming its feature), and each
    JPEG source's re-encoded bytes."""
    from ayolov2_torch.data.codecs import encode_jpeg
    from ayolov2_torch.data.image_io import imread

    files = json.loads((fx.FIXTURES / "manifest.json").read_text())["files"]
    seen = 0
    for name, entry in files.items():
        if KINDS[Path(name).suffix] != kind:
            continue
        seen += 1
        if "left_out" in entry:
            with pytest.raises(OSError, match=entry["left_out"]):
                imread(str(fx.FIXTURES / name))
            continue
        im = imread(str(fx.FIXTURES / name))
        assert list(im.shape) == entry["shape"] and fx.sha256(im.tobytes()) == entry["sha256"], name
        if "source" in entry:
            s = entry["source"]
            enc = encode_jpeg(fx.codec_source(s["seed"], s["h"], s["w"], s["gray"]), s["quality"])
            assert fx.sha256(enc) == s["imencode_sha256"], name
    assert seen > 0


def test_image_size_equals_exif_size_on_every_fixture():
    """``image_size`` reads each fixture's header as the JAX package's
    ``exif_size(PIL.Image.open(f))`` sizes it: EXIF 6 and 8 swapped in JPEG,
    PNG and WebP files, 5 and 7 not (a WebP at 5 or 7 is turned by cv2,
    not by PIL), TIFF Orientation 5-8 swapped by PIL itself, BMP never."""
    from PIL import Image

    from ayolov2_tpu.data.datasets import exif_size
    from ayolov2_torch.data.image_io import image_size

    for path in fx.fixture_files():
        with Image.open(path) as pil:
            assert image_size(str(path)) == exif_size(pil), path.name


def test_a_failed_codec_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    """No fallback: a library that does not build raises, cv2 installed or
    not, and names the compiler's complaint."""
    from ayolov2_torch.data import codecs
    from ayolov2_torch.ops import _build

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "CXX_FLAGS", _build.CXX_FLAGS + ["--no-such-option"])
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(codecs, "_LIB", None)
    data = _jpeg(fx.codec_source(1, 8, 8))
    with pytest.raises(RuntimeError, match=r"(?s)host compiler failed for image_codec\.cpp.*"
                                           r"no-such-option"):
        codecs.decode_jpeg(data)
    assert not list(tmp_path.glob("*.so"))


def test_image_compression_equals_jax():
    """The ImageCompression policy draws its quality from the generator and
    round-trips through JPEG: the port's equals JAX's (cv2) bit for bit."""
    from ayolov2_tpu.data import augment as ja
    from ayolov2_torch.data import augment as pa

    for seed, (h, w) in enumerate([(64, 64), (77, 123), (130, 90), (1, 1), (480, 640)]):
        im = fx.codec_source(seed, h, w)
        ra, rb = np.random.default_rng(seed), np.random.default_rng(seed)
        np.testing.assert_array_equal(pa._image_compression(im.copy(), rb),
                                      ja._image_compression(im.copy(), ra))
        assert ra.random() == rb.random()


# ---- the dataset on JPEG, PNG and EXIF-rotated files ----------------------------------------


def _write_mixed_set(root: Path) -> Path:
    """``root/images``: JPEGs, PNGs (written by the port's writer and by the
    tests' writer with filters and Adam7), JPEGs stored turned with EXIF
    orientations 3, 5, 6 and 8, an LZW TIFF with predictor 2, a JPEG TIFF
    with JPEGTables, a 2x2 YCbCr TIFF, a Group 4 TIFF and a CIELab TIFF
    (Pillow's), a lossless and an arithmetic-coded JPEG, a WebP stored turned
    with EXIF orientation 6 and a palette BMP; ``labels/`` and ``segments/``
    for each."""
    from ayolov2_torch.utils.png import write_png
    from chip_smoke import bmp_file, bmp_rows, palette_332, tiff_file

    images, labels, segments = root / "images", root / "labels", root / "segments"
    for d in (images, labels, segments):
        d.mkdir(parents=True)
    rng = np.random.default_rng(0)
    files = [((96, 128), "jpeg", 0), ((128, 96), "png", 0), ((80, 80), "exif", 6),
             ((112, 64), "adam7", 0), ((64, 112), "exif", 8), ((100, 140), "jpeg", 0),
             ((90, 60), "exif", 5), ((128, 128), "exif", 3), ((72, 120), "png", 0),
             ((120, 72), "exif", 6), ((96, 96), "adam7", 0), ((60, 90), "jpeg", 0),
             ((88, 120), "tiff", 0), ((70, 110), "webp", 6), ((100, 76), "bmp", 0),
             ((80, 112), "tjpeg", 0), ((96, 64), "tycbcr", 0), ((64, 96), "tg4", 0),
             ((72, 88), "tlab", 0), ((88, 72), "jlossless", 0), ((64, 80), "jarith", 0)]
    for i, ((h, w), kind, o) in enumerate(files):
        im = fx.codec_source(20 + i, h, w)
        if kind == "jpeg":
            (images / f"{i}.jpg").write_bytes(_jpeg(im, 90))
        elif kind == "png":
            write_png(images / f"{i}.png", im)
        elif kind == "exif":  # stored turned, so that it reads upright
            stored = {3: im[::-1, ::-1], 5: im.transpose(1, 0, 2), 6: np.rot90(im, 1),
                      8: np.rot90(im, -1)}[o]
            (images / f"{i}.jpg").write_bytes(fx.with_exif(_jpeg(np.ascontiguousarray(stored)), o))
        elif kind == "tiff":
            (images / f"{i}.tif").write_bytes(tiff_file(im[..., ::-1], compression=5, predictor=2,
                                                        rows_per_strip=16))
        elif kind == "tjpeg":
            (images / f"{i}.tif").write_bytes(tiff_file(np.ascontiguousarray(im[..., ::-1]),
                                                        compression=7, rows_per_strip=32,
                                                        jpeg_tables=True))
        elif kind == "tycbcr":
            ycc = cv2.cvtColor(im, cv2.COLOR_BGR2YCrCb)[..., [0, 2, 1]]
            (images / f"{i}.tif").write_bytes(tiff_file(ycc, photometric=6, subsampling=(2, 2),
                                                        compression=5))
        elif kind in ("tg4", "tlab"):
            import io

            from PIL import Image

            pil = Image.fromarray(np.ascontiguousarray(im[..., ::-1]))
            b = io.BytesIO()
            if kind == "tg4":
                pil.convert("L").point(lambda v: 255 if v > 110 else 0).convert("1").save(
                    b, "TIFF", compression="group4")
            else:
                pil.convert("LAB").save(b, "TIFF")
            (images / f"{i}.tif").write_bytes(b.getvalue())
        elif kind == "jlossless":
            (images / f"{i}.jpg").write_bytes(fx.lossless_jpeg(im[..., ::-1], predictor=6))
        elif kind == "jarith":
            (images / f"{i}.jpg").write_bytes(fx.arith_jpeg(i, w, h, restart=5))
        elif kind == "webp":
            stored = np.ascontiguousarray(np.rot90(im, 1))
            webp = cv2.imencode(".webp", stored, [cv2.IMWRITE_WEBP_QUALITY, 90])[1].tobytes()
            (images / f"{i}.webp").write_bytes(fx.webp_with_exif(webp, o))
        elif kind == "bmp":
            idx, pal = palette_332(im)
            rows = bmp_rows(idx[::-1], 8)
            (images / f"{i}.bmp").write_bytes(bmp_file(rows, w, h, 8, palette=pal))
        else:
            (images / f"{i}.png").write_bytes(fx.png_file(30 + i, w, h, 8, 2, interlace=1))
        n = int(rng.integers(1, 4))
        xy = rng.uniform(0.25, 0.75, (n, 2))
        wh = rng.uniform(0.1, 0.4, (n, 2))
        cls = rng.integers(0, 5, n)
        (labels / f"{i}.txt").write_text("".join(
            f"{c} {x:.6f} {y:.6f} {bw:.6f} {bh:.6f}\n" for c, (x, y), (bw, bh) in zip(cls, xy, wh)))
        t = np.linspace(0, 2 * np.pi, 9, endpoint=False)
        (segments / f"{i}.txt").write_text("".join(
            f"{c} " + " ".join(f"{v:.6f}" for v in np.stack(
                [x + bw / 2 * np.cos(t), y + bh / 2 * np.sin(t)], 1).clip(0, 1).ravel()) + "\n"
            for c, (x, y), (bw, bh) in zip(cls, xy, wh)))
    return images


@pytest.fixture(scope="module")
def mixed(tmp_path_factory):
    return _write_mixed_set(tmp_path_factory.mktemp("mixed"))


def test_dataset_on_mixed_files_equals_jax(mixed):
    """Shapes (EXIF 6 and 8 swapped, 3 and 5 not, as PIL's exif_size) and
    rect batch shapes exactly; the letterboxed val items bit for bit."""
    from ayolov2_tpu.data import DetectionDataset as JaxDataset
    from ayolov2_torch.data import DetectionDataset

    kw = dict(img_size=IMG, batch_size=4, rect=True, pad=0.5, stride=32)
    jax_ds, port_ds = JaxDataset(str(mixed), **kw), DetectionDataset(str(mixed), **kw)
    np.testing.assert_array_equal(port_ds.shapes, jax_ds.shapes)
    np.testing.assert_array_equal(port_ds.batch_shapes, jax_ds.batch_shapes)
    assert port_ds.img_files == jax_ds.img_files
    for i in range(len(port_ds)):
        a, b = jax_ds[i], port_ds[i]
        np.testing.assert_array_equal(b[0], a[0])
        np.testing.assert_array_equal(b[1], a[1])
        assert b[2:] == a[2:]


def test_augmented_items_on_mixed_files_equal_jax(mixed):
    """``train_config.yaml``'s host augmentation, seeded, on the mixed set:
    labels bit for bit; at most 0.5% of the pixels differ, the share
    ``test_torch_port_host_augment.py::test_get_item_equals_jax`` holds the
    augmented output to (its float operations; the decoded files themselves
    are equal, as the val items show)."""
    from ayolov2_tpu.data import DetectionDataset as JaxDataset
    from ayolov2_torch.data import DetectionDataset

    cfg = yaml.safe_load((ROOT / "res/configs/cfg/train_config.yaml").read_text())
    kw = dict(img_size=IMG, batch_size=4, cache_images="mem",
              yolo_augmentation=cfg["yolo_augmentation"], augmentation=cfg.get("augmentation"),
              label_type=cfg["train"].get("label_type", "labels"))
    jax_ds, port_ds = JaxDataset(str(mixed), **kw), DetectionDataset(str(mixed), **kw)
    for i in range(len(port_ds)):
        a, b = jax_ds.get_item(i, 0), port_ds.get_item(i, 0)
        np.testing.assert_array_equal(b[1], a[1])
        assert b[2:] == a[2:] and b[0].shape == a[0].shape
        d = np.abs(b[0].astype(np.int64) - a[0].astype(np.int64))
        assert (d > 0).mean() <= 0.005, (i, d.max(), (d > 0).mean())


def test_no_cv2_or_pil_on_the_path(mixed, tmp_path):
    """With ``cv2`` and ``PIL`` blocked from import, as on the card's machine:
    every fixture (JPEG, PNG, BMP, TIFF, WebP) is read and sized, a left-out
    mode raises naming its feature, a JPEG is written, and the dataset gives
    an item of each file of the mixed set (JPEG, PNG, TIFF, WebP, BMP)."""
    left_out = {k: v["left_out"] for k, v in json.loads(
        (fx.FIXTURES / "manifest.json").read_text())["files"].items() if "left_out" in v}
    code = f"""
import sys
sys.modules["cv2"] = None
sys.modules["PIL"] = None
sys.path.insert(0, {str(ROOT)!r})
from pathlib import Path
from ayolov2_torch.data import DetectionDataset
from ayolov2_torch.data.image_io import image_size, imread, imwrite
n = raised = 0
kinds = set()
for p in sorted(Path({str(fx.FIXTURES)!r}).iterdir()):
    if p.name == "manifest.json":
        continue
    w, h = image_size(str(p))
    if p.name in {left_out!r}:
        try:
            imread(str(p))
        except OSError as e:
            assert {left_out!r}[p.name] in str(e), e
            raised += 1
        continue
    im = imread(str(p))
    assert im.ndim == 3 and im.shape[2] == 3 and {{w, h}} == {{im.shape[0], im.shape[1]}}, p
    n += 1
    kinds.add(p.suffix)
imwrite({str(tmp_path / "w.jpg")!r}, im)
assert imread({str(tmp_path / "w.jpg")!r}).shape == im.shape
ds = DetectionDataset({str(mixed)!r}, img_size={IMG}, batch_size=4, rect=True, pad=0.5)
for i in range(len(ds)):
    item = ds[i]
    assert item[0].ndim == 3
assert sys.modules["cv2"] is None and sys.modules["PIL"] is None
suffixes = sorted(Path(f).suffix for f in ds.img_files)
print("ok", n, raised, sorted(kinds), len(ds), sorted(set(suffixes)))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300,
                         cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    files = fx.fixture_files()
    assert out.stdout.split()[:3] == ["ok", str(len(files) - len(left_out)), str(len(left_out))]
    assert "['.bmp', '.jpg', '.png', '.tif', '.webp']" in out.stdout, out.stdout
