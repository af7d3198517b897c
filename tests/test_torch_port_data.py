"""The port's host data path against the JAX package on the same files:
image reading and resizes (against cv2), letterbox, the datasets, the
loader, the box helpers and the config reader."""

import json
import shutil
import struct
import sys

import cv2
import numpy as np
import pytest
import torch

from _torch_port_common import LABELLED_IMG, labelled_set

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def val_images(tmp_path_factory):
    return labelled_set(tmp_path_factory.mktemp("labelled"))


def _clear_caches(img_dir):
    for f in img_dir.glob(".*"):
        f.unlink()


# ---- image reading and resizes ----------------------------------------------

@pytest.mark.parametrize("h,w", [(5, 1), (3, 2), (7, 3), (4, 5), (9, 6), (2, 7), (33, 50)])
def test_bmp_reader_equals_cv2(tmp_path, h, w):
    from ayolov2_torch.data.image_io import image_size, imread

    img = np.random.default_rng(h * 100 + w).integers(0, 256, (h, w, 3), dtype=np.uint8)
    path = str(tmp_path / "a.bmp")
    assert cv2.imwrite(path, img)
    got = imread(path)
    assert got.dtype == np.uint8 and got.flags.c_contiguous
    np.testing.assert_array_equal(got, cv2.imread(path))
    assert image_size(path) == (w, h)


def test_top_down_bmp(tmp_path):
    from ayolov2_torch.data.image_io import image_size, imread

    img = np.random.default_rng(3).integers(0, 256, (6, 5, 3), dtype=np.uint8)
    path = tmp_path / "a.bmp"
    cv2.imwrite(str(path), img)
    data = bytearray(path.read_bytes())
    offset = struct.unpack_from("<I", data, 10)[0]
    pitch = (5 * 3 + 3) // 4 * 4
    rows = [data[offset + r * pitch: offset + (r + 1) * pitch] for r in range(6)]
    data[offset:offset + 6 * pitch] = b"".join(rows[::-1])
    struct.pack_into("<i", data, 22, -6)
    path.write_bytes(bytes(data))
    np.testing.assert_array_equal(imread(str(path)), img)
    assert image_size(str(path)) == (5, 6)


def test_other_formats_go_through_cv2_and_name_what_is_missing(tmp_path, monkeypatch):
    from ayolov2_torch.data.image_io import image_size, imread

    """A signature that none of the port's decoders claims (here a PPM) is
    still read through cv2, and without cv2 the error names the file and the
    package; TIFF (like JPEG, PNG, BMP and WebP) no longer goes to cv2
    (``test_torch_port_codec_*.py``)."""
    img = np.random.default_rng(4).integers(0, 256, (9, 11, 3), dtype=np.uint8)
    path = str(tmp_path / "a.ppm")
    cv2.imwrite(path, img)
    np.testing.assert_array_equal(imread(path), img)
    assert image_size(path) == (11, 9)
    tif = str(tmp_path / "a.tif")
    cv2.imwrite(tif, img)
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError, match=r"a\.ppm.*'cv2'"):
        imread(path)
    np.testing.assert_array_equal(imread(tif), img)
    assert image_size(tif) == (11, 9)


@pytest.mark.parametrize("src,dst", [((76, 100), (160, 121)), ((150, 200), (160, 120)),
                                     ((97, 131), (50, 37)), ((64, 64), (32, 32)),
                                     ((33, 47), (200, 150)), ((120, 160), (161, 119))])
def test_resize_linear_within_one_grey_level_of_cv2(src, dst):
    from ayolov2_torch.data.image_io import resize_linear

    img = np.random.default_rng(src[0]).integers(0, 256, (*src, 3), dtype=np.uint8)
    want = cv2.resize(img, dst, interpolation=cv2.INTER_LINEAR)
    got = resize_linear(img, dst)
    assert got.shape == want.shape and got.dtype == np.uint8
    assert np.abs(got.astype(int) - want).max() <= 1


@pytest.mark.parametrize("src,dst", [((200, 150), (120, 160)), ((97, 131), (50, 37)),
                                     ((64, 64), (32, 32)), ((90, 90), (30, 30)),
                                     ((157, 130), (128, 106))])
def test_resize_area_within_one_grey_level_of_cv2(src, dst):
    from ayolov2_torch.data.image_io import resize_area

    img = np.random.default_rng(src[1]).integers(0, 256, (*src, 3), dtype=np.uint8)
    want = cv2.resize(img, dst, interpolation=cv2.INTER_AREA)
    got = resize_area(img, dst)
    assert got.shape == want.shape
    assert np.abs(got.astype(int) - want).max() <= 1


@pytest.mark.parametrize("shape,new,auto,scale_up", [
    ((120, 160), (160, 160), False, False), ((96, 160), (128, 160), False, True),
    ((100, 76), (160, 160), False, True), ((200, 150), (160, 160), True, True),
    ((131, 97), (96, 128), False, True)])
def test_letterbox_matches_jax(shape, new, auto, scale_up):
    from ayolov2_tpu.data.datasets import letterbox as jax_letterbox
    from ayolov2_torch.data.datasets import letterbox

    img = np.random.default_rng(shape[0]).integers(0, 256, (*shape, 3), dtype=np.uint8)
    got, ratio, pad = letterbox(img, new, auto=auto, scale_up=scale_up)
    want, ratio_j, pad_j = jax_letterbox(img, new, auto=auto, scale_up=scale_up)
    assert (ratio, pad) == (ratio_j, pad_j)
    np.testing.assert_array_equal(got, want)


# ---- datasets and loader -----------------------------------------------------

def _datasets(img_dir, rect, **kw):
    from ayolov2_tpu.data import DetectionDataset as JaxDataset
    from ayolov2_torch.data import DetectionDataset

    _clear_caches(img_dir)
    port = DetectionDataset(str(img_dir), img_size=LABELLED_IMG, batch_size=4, rect=rect,
                            pad=0.5, stride=32, **kw)
    _clear_caches(img_dir)
    jax = JaxDataset(str(img_dir), img_size=LABELLED_IMG, batch_size=4, rect=rect, pad=0.5,
                     stride=32, **kw)
    return port, jax


@pytest.mark.parametrize("rect", [True, False])
def test_detection_dataset_matches_jax(val_images, rect):
    port, jax = _datasets(val_images, rect)
    assert port.img_files == jax.img_files
    np.testing.assert_array_equal(port.shapes, jax.shapes)
    if rect:
        np.testing.assert_array_equal(port.batch_shapes, jax.batch_shapes)
        assert len({tuple(s) for s in port.batch_shapes}) > 1
    assert sum(len(s) for s in port.segments) > 0 and min(len(lab) for lab in port.labels) == 0
    for a, b in zip(port.labels, jax.labels):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(port.segments, jax.segments):
        assert len(a) == len(b) and all(np.array_equal(x, y) for x, y in zip(a, b))
    resized = 0
    for i in range(len(port)):
        img, lab, path, shapes = port[i]
        img_j, lab_j, path_j, shapes_j = jax[i]
        assert path == path_j and shapes == shapes_j
        np.testing.assert_array_equal(lab, lab_j)
        assert img.shape == img_j.shape
        resized += max(shapes[0]) != LABELLED_IMG
        np.testing.assert_array_equal(img, img_j)  # the resizes are cv2's, bit for bit
    assert resized == 3


def test_datasets_share_the_cache_and_fold_single_class(val_images):
    from ayolov2_tpu.data import DetectionDataset as JaxDataset
    from ayolov2_torch.data import DetectionDataset

    _clear_caches(val_images)
    first = DetectionDataset(str(val_images), img_size=LABELLED_IMG, single_cls=True)
    assert all((lab[:, 0] == 0).all() for lab in first.labels)
    jax = JaxDataset(str(val_images), img_size=LABELLED_IMG)  # reads the port's cache files
    again = DetectionDataset(str(val_images), img_size=LABELLED_IMG)
    for a, b, c in zip(first.labels, jax.labels, again.labels):
        np.testing.assert_array_equal(a[:, 1:], b[:, 1:])
        np.testing.assert_array_equal(b, c)


def test_image_folder_dataset_matches_jax(val_images):
    from ayolov2_tpu.data import ImageFolderDataset as JaxFolder
    from ayolov2_torch.data import ImageFolderDataset

    _clear_caches(val_images)
    port = ImageFolderDataset(str(val_images), img_size=LABELLED_IMG, batch_size=4, rect=True,
                              pad=0.5, cache_images="mem")
    jax = JaxFolder(str(val_images), img_size=LABELLED_IMG, batch_size=4, rect=True, pad=0.5)
    assert port.img_files == jax.img_files
    for i in range(len(port)):
        a, b = port[i], jax[i]
        np.testing.assert_array_equal(a[0], b[0])
        assert a[1:] == b[1:]


@pytest.mark.parametrize("scale_up", [False, True])
def test_image_folder_dataset_scale_up_matches_jax(val_images, scale_up):
    """``scale_up`` (what an augmenting DetectionDataset passes): the shrunk
    image is resized by INTER_LINEAR instead of INTER_AREA, and the letterbox
    may enlarge."""
    from ayolov2_tpu.data import ImageFolderDataset as JaxFolder
    from ayolov2_torch.data import ImageFolderDataset

    kw = dict(img_size=LABELLED_IMG, batch_size=4, rect=True, pad=0.5, scale_up=scale_up)
    port = ImageFolderDataset(str(val_images), cache_images="mem", **kw)
    jax = JaxFolder(str(val_images), **kw)
    assert port.scale_up == jax.scale_up == scale_up
    shrunk = [i for i, (w, h) in enumerate(port.shapes) if max(w, h) > LABELLED_IMG]
    assert shrunk
    for i in range(len(port)):
        a, b = port[i], jax[i]
        np.testing.assert_array_equal(a[0], b[0])
        assert a[1:] == b[1:]
        np.testing.assert_array_equal(port.load_image(i)[0], jax.load_image(i)[0])


def test_load_image_copy_matches_jax(val_images):
    """``load_image(copy=False)`` hands out the cached array (readers that do
    not write), ``copy=True`` (the default) a copy, as in the JAX package."""
    from ayolov2_tpu.data import ImageFolderDataset as JaxFolder
    from ayolov2_torch.data import ImageFolderDataset

    for cls in (ImageFolderDataset, JaxFolder):
        ds = cls(str(val_images), img_size=LABELLED_IMG, cache_images="mem")
        shared, copied = ds.load_image(2, copy=False), ds.load_image(2)
        assert shared[0] is ds.load_image(2, copy=False)[0]
        assert copied[0] is not shared[0] and not np.shares_memory(copied[0], shared[0])
        np.testing.assert_array_equal(copied[0], shared[0])
        assert copied[1:] == shared[1:]
    uncached = ImageFolderDataset(str(val_images), img_size=LABELLED_IMG)
    np.testing.assert_array_equal(uncached.load_image(2, copy=False)[0], shared[0])


def test_unported_options_raise(val_images):
    """The disk caches, which raised before they were ported, write and read
    ``.ayolo.npy`` beside the images; the host path of training
    augmentation, which raised before it was ported, runs and gives the JAX
    package's labels."""
    from ayolov2_tpu.data import DetectionDataset as JaxDataset
    from ayolov2_torch.data import DetectionDataset, ImageFolderDataset

    for kw in (dict(yolo_augmentation={"mosaic": 1.0}),
               dict(augmentation=[{"policy": {"HorizontalFlip": {}}}]),
               dict(img_size=LABELLED_IMG, yolo_augmentation={"augment": True})):
        port, ref = (cls(str(val_images), **kw)[0] for cls in (DetectionDataset, JaxDataset))
        np.testing.assert_array_equal(port[1], ref[1])
        assert port[0].shape == ref[0].shape and port[2:] == ref[2:]
    cached = ImageFolderDataset(str(val_images), cache_images="disk")
    plain = ImageFolderDataset(str(val_images))
    try:
        for _ in range(2):  # written, then read back
            np.testing.assert_array_equal(cached.load_image(0)[0], plain.load_image(0)[0])
        assert cached._npy_path(0).exists()
    finally:
        for f in val_images.glob("*.ayolo.npy"):
            f.unlink()


@pytest.mark.parametrize("rect,kw", [(True, dict()), (True, dict(shard=(1, 2))),
                                     (False, dict(shard=(0, 3))),
                                     (False, dict(pad_final_batch=False)),
                                     (True, dict(workers=3, max_labels_per_image=2))])
def test_loader_matches_jax(val_images, rect, kw):
    from ayolov2_tpu.data import DataLoader as JaxLoader
    from ayolov2_torch.data import DataLoader

    port_ds, jax_ds = _datasets(val_images, rect)
    port, jax = list(DataLoader(port_ds, batch_size=4, **kw)), list(JaxLoader(jax_ds, batch_size=4, **kw))
    assert len(port) == len(jax) and port
    for a, b in zip(port, jax):
        np.testing.assert_array_equal(a.images, b.images)
        np.testing.assert_array_equal(a.targets, b.targets)
        np.testing.assert_array_equal(a.target_mask, b.target_mask)
        assert (a.paths, a.shapes, a.n_labels, a.n_real) == (b.paths, b.shapes, b.n_labels, b.n_real)
    if not kw:  # 9 images in 4s: the last batch is 1 real item padded to 4
        assert [b.n_real for b in port] == [4, 4, 1] and port[-1].images.shape[0] == 4


def test_image_loader_matches_jax(val_images):
    from ayolov2_tpu.data import DataLoader as JaxLoader
    from ayolov2_tpu.data import ImageFolderDataset as JaxFolder
    from ayolov2_torch.data import DataLoader, ImageFolderDataset

    port = ImageFolderDataset(str(val_images), img_size=LABELLED_IMG, batch_size=4, rect=True, pad=0.5)
    jax = JaxFolder(str(val_images), img_size=LABELLED_IMG, batch_size=4, rect=True, pad=0.5)
    got = list(DataLoader(port, batch_size=4, detection=False))
    want = list(JaxLoader(jax, batch_size=4, detection=False))
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a[0], b[0])
        assert a[1:] == b[1:]


def test_loader_raises_a_workers_error():
    from ayolov2_torch.data import DataLoader

    class Broken:
        def __len__(self):
            return 8

        def __getitem__(self, i):
            raise OSError(f"unreadable item {i}")

    with pytest.raises(OSError, match="unreadable item"):
        list(DataLoader(Broken(), batch_size=2, workers=3))


def test_pad_targets_matches_jax():
    from ayolov2_tpu.loss.yolo_loss import pad_targets as jax_pad
    from ayolov2_torch.loss.yolo_loss import pad_targets

    rng = np.random.default_rng(0)
    labels = [rng.uniform(0, 1, (n, 5)).astype(np.float32) for n in (3, 0, 5, 1)]
    for m in (4, 9, 40):
        for a, b in zip(pad_targets(labels, 4, m), jax_pad(labels, 4, m)):
            np.testing.assert_array_equal(a, b)


# ---- boxes, sizes, configs ---------------------------------------------------

@pytest.mark.parametrize("as_torch", [False, True])
def test_boxes_match_jax(as_torch):
    from ayolov2_tpu.utils import boxes as jb
    from ayolov2_torch.utils import boxes as pb

    rng = np.random.default_rng(1)
    xywh = np.concatenate([rng.uniform(-0.1, 1.1, (20, 2)), rng.uniform(0.01, 0.6, (20, 2))], 1)
    xyxy = np.asarray(jb.xywh2xyxy(xywh, wh=(160, 120)), np.float32)
    other = np.asarray(jb.xywh2xyxy(xywh[::-1].copy(), wh=(160, 120)), np.float32)
    wrap = (lambda a: torch.from_numpy(np.ascontiguousarray(a))) if as_torch else (lambda a: a)
    back = (lambda t: t.numpy()) if as_torch else (lambda a: a)
    cases = [
        (pb.xywh2xyxy(wrap(xywh), (0.5, 0.5), (160, 120), (3.0, 7.5)),
         jb.xywh2xyxy(xywh, (0.5, 0.5), (160, 120), (3.0, 7.5))),
        (pb.xyxy2xywh(wrap(xyxy), wh=(160, 120), clip_eps=1e-3), jb.xyxy2xywh(xyxy, wh=(160, 120))),
        (pb.xyxy2xywh(wrap(xyxy), check_validity=False), jb.xyxy2xywh(xyxy, check_validity=False)),
        (pb.xyn2xy(wrap(xywh[:, :2]), wh=(160, 120), pad=(1, 2)),
         jb.xyn2xy(xywh[:, :2], wh=(160, 120), pad=(1, 2))),
        (pb.clip_coords(wrap(xyxy), (150, 100)), jb.clip_coords(xyxy, (150, 100))),
        (pb.scale_coords((128, 160), wrap(xyxy), (200, 250)),
         jb.scale_coords((128, 160), xyxy, (200, 250))),
        (pb.scale_coords((128, 160), wrap(xyxy), (100, 76), ((1.6, 1.6), (19.2, 4.0))),
         jb.scale_coords((128, 160), xyxy, (100, 76), ((1.6, 1.6), (19.2, 4.0)))),
        (pb.box_area(wrap(xyxy)), jb.box_area(xyxy)),
        (pb.box_iou(wrap(xyxy), wrap(other)), jb.box_iou(xyxy, other)),
        (pb.bbox_ioa(wrap(xyxy[0]), wrap(other)), jb.bbox_ioa(xyxy[0], other)),
        (pb.bbox_ioa(wrap(xyxy[:3]), wrap(other)), jb.bbox_ioa(xyxy[:3], other)),
    ]
    for got, want in cases:
        got, want = back(got), np.asarray(want)
        assert got.shape == want.shape and got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_check_img_size_and_segments2boxes_match_jax():
    from ayolov2_tpu.utils import general as jg
    from ayolov2_torch.utils import general as pg

    for size, s in ((640, 32), (641, 32), (100, 64), (161, 8)):
        assert pg.check_img_size(size, s) == jg.check_img_size(size, s)
    rng = np.random.default_rng(2)
    segs = [rng.uniform(0, 1, (n, 2)).astype(np.float32) for n in (3, 8, 5)]
    np.testing.assert_array_equal(pg.segments2boxes(segs), jg.segments2boxes(segs))


def test_load_yaml_reads_json_and_yaml(tmp_path, monkeypatch):
    from ayolov2_tpu.utils.config import load_yaml as jax_load
    from ayolov2_torch.utils.config import load_yaml

    cfg = {"val_path": "a/b", "nc": 2, "names": ["x", "y"]}
    (tmp_path / "d.json").write_text(json.dumps(cfg))
    (tmp_path / "d.yaml").write_text("val_path: a/b\nnc: 2\nnames: [x, y]\n")
    assert load_yaml(tmp_path / "d.json") == cfg == jax_load(tmp_path / "d.json")
    assert load_yaml(tmp_path / "d.yaml") == cfg
    for name in ("coco", "voc_fixture"):
        path = f"res/configs/data/{name}.yaml"
        assert load_yaml(path) == jax_load(path)
    monkeypatch.setitem(sys.modules, "yaml", None)  # the port reads YAML without PyYAML
    assert load_yaml(tmp_path / "d.json") == cfg
    assert load_yaml(tmp_path / "d.yaml") == cfg


def test_copy_of_the_set_scans_anew(val_images, tmp_path):
    """A moved set keeps nothing stale: the cache key holds the paths."""
    from ayolov2_torch.data import DetectionDataset

    copy = tmp_path / "images"
    shutil.copytree(val_images, copy)
    shutil.copytree(val_images.parent / "labels", tmp_path / "labels")
    (tmp_path / "labels" / "000002.txt").write_text("")
    ds = DetectionDataset(str(copy), img_size=LABELLED_IMG)
    assert len(ds.labels[1]) == 0
