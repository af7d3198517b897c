"""Host augmentation: the JAX package (OpenCV) and the port (numpy) on the
same seeded inputs.

- each function of ``data/augment.py`` against JAX's: labels, segments and
  the generator's next draw bit for bit, pixels within the gates below;
- ``DetectionDataset.get_item`` against JAX's on the shared synthetic set
  (box and polygon labels) under the three shipped recipes' augmentation
  sections as written, each pixel policy forced to p = 1, rect batches with
  augmentation and copy_paste2, and mixup.

The loader's process pool and ``cli.train`` on it are tested in
``test_torch_port_process_loader.py``, each case in a fresh interpreter.

Pixel gates: within one level on at most 0.5% of the pixels (OpenCV's
float paths: warps, HSV back, filters, blends, the scaled resize); within
two levels on at most 1% for the JPEG round trip. Integer paths are equal.
"""

from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from _torch_port_common import LABELLED_IMG, ROOT, labelled_set

torch.set_num_threads(1)

CFGS = ROOT / "res/configs/cfg"
GATES = {"float": (1, 0.005), "jpeg": (2, 0.01)}
AFFINE = {"scale": [0.9, 1.1], "translate_percent": {"x": [-0.1, 0.1], "y": [-0.1, 0.1]},
          "rotate": [-10, 10], "shear": [-5, 5]}


def _recipe(name):
    cfg = yaml.safe_load((CFGS / f"{name}.yaml").read_text())
    return cfg["yolo_augmentation"], cfg.get("augmentation"), cfg["train"]


def _pixels(got, want, gate="float"):
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
    d = np.abs(got.astype(np.int64) - want.astype(np.int64))
    most, share = GATES[gate]
    assert d.max() <= most and (d > 0).mean() <= share, (d.max(), (d > 0).mean())


def _next(rng_a, rng_b):
    assert rng_a.random() == rng_b.random()


def _scene(seed, h=120, w=150, n=6):
    """An image, (n, 5) [cls, xyxy] labels and a 9-point polygon in each
    box."""
    rng = np.random.default_rng(seed)
    im = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    xy = rng.uniform(0, [w - 40, h - 40], (n, 2))
    wh = rng.uniform(12, 40, (n, 2))
    labels = np.concatenate([rng.integers(0, 5, (n, 1)), xy, xy + wh], 1)
    t = np.linspace(0, 2 * np.pi, 9, endpoint=False)
    segs = [np.stack([(a[1] + a[3]) / 2 + (a[3] - a[1]) / 2 * np.cos(t),
                      (a[2] + a[4]) / 2 + (a[4] - a[2]) / 2 * np.sin(t)], 1) for a in labels]
    return im, labels, segs


# ---- the functions of data/augment.py ----------------------------------------------


@pytest.mark.parametrize("what", ["augment_hsv", "mixup", "cutout", "copy_paste", "copy_paste2",
                                  "perspective_axis_aligned", "perspective_rotated",
                                  "perspective_projective", "affine"])
def test_augment_functions_equal_jax(what):
    from ayolov2_tpu.data import augment as ja
    from ayolov2_torch.data import augment as pa

    for seed in range(6):
        im, labels, segs = _scene(seed)
        ra, rb = np.random.default_rng(seed), np.random.default_rng(seed)
        if what == "augment_hsv":
            gains = (0.015, 0.7, 0.4) if seed % 3 else (0.5, 0.9, 0.9)
            a, b = im.copy(), im.copy()
            assert ja.augment_hsv(a, ra, *gains) is a and pa.augment_hsv(b, rb, *gains) is b
            _pixels(b, a)
        elif what == "mixup":
            im2 = np.random.default_rng(seed + 50).integers(0, 256, im.shape, dtype=np.uint8)
            a = ja.mixup(im, labels, im2, labels[:2], ra)
            b = pa.mixup(im, labels, im2, labels[:2], rb)
            np.testing.assert_array_equal(b[0], a[0])
            np.testing.assert_array_equal(b[1], a[1])
        elif what == "cutout":
            a, b = im.copy(), im.copy()
            la = ja.cutout(a, labels.copy(), ra, p=0.9)
            lb = pa.cutout(b, labels.copy(), rb, p=0.9)
            np.testing.assert_array_equal(b, a)
            np.testing.assert_array_equal(lb, la)
        elif what == "copy_paste":
            a = ja.copy_paste(im.copy(), labels.copy(), [s.copy() for s in segs], ra, p=0.8)
            b = pa.copy_paste(im.copy(), labels.copy(), [s.copy() for s in segs], rb, p=0.8)
            np.testing.assert_array_equal(b[0], a[0])
            np.testing.assert_array_equal(b[1], a[1])
            assert len(b[2]) == len(a[2]) > len(segs) - (seed == 0)
            for x, y in zip(b[2], a[2]):
                np.testing.assert_array_equal(x, y)
        elif what == "copy_paste2":
            im2, labels2, segs2 = _scene(seed + 100, 90, 110)
            kw = dict(p=1.0, area_thr=10, scale_min=0.35, scale_max=1.0)
            a = ja.copy_paste2(im.copy(), labels[:2].copy(), [s.copy() for s in segs[:2]], im2,
                               labels2, segs2, ra, **kw)
            b = pa.copy_paste2(im.copy(), labels[:2].copy(), [s.copy() for s in segs[:2]], im2,
                               labels2, segs2, rb, **kw)
            _pixels(b[0], a[0])
            np.testing.assert_array_equal(b[1], a[1])
            assert len(b[2]) == len(a[2]) > 2
            for x, y in zip(b[2], a[2]):
                np.testing.assert_array_equal(x, y)
        elif what.startswith("perspective"):
            hyp = {"perspective_axis_aligned": dict(degrees=0.0, shear=0.0),
                   "perspective_rotated": dict(degrees=10.0, shear=3.0),
                   "perspective_projective": dict(degrees=5.0, shear=2.0, perspective=0.001)}[what]
            border = (-30, -37) if seed % 2 else (0, 0)
            seg_arg = segs if seed % 3 == 0 else ()
            a = ja.random_perspective(im, labels.copy(), ra, segments=seg_arg, translate=0.2,
                                      scale=0.5, border=border, **hyp)
            b = pa.random_perspective(im, labels.copy(), rb, segments=seg_arg, translate=0.2,
                                      scale=0.5, border=border, **hyp)
            _pixels(b[0], a[0])
            np.testing.assert_array_equal(b[1], a[1])
        else:
            xywh = np.concatenate([labels[:, :1], np.full((len(labels), 2), 0.5),
                                   np.full((len(labels), 2), 0.2)], 1)
            a = ja._affine(im, xywh, ra, **AFFINE)
            b = pa._affine(im, xywh, rb, **AFFINE)
            _pixels(b[0], a[0])
            np.testing.assert_array_equal(b[1], a[1])
        _next(ra, rb)


@pytest.mark.parametrize("name", ["Blur", "MedianBlur", "ToGray", "CLAHE",
                                  "RandomBrightnessContrast", "RandomGamma", "ImageCompression",
                                  "Solarize", "Sharpen", "Cutout"])
def test_pixel_transforms_equal_jax(name):
    from ayolov2_tpu.data import augment as ja
    from ayolov2_torch.data import augment as pa

    for seed, shape in enumerate([(64, 64), (77, 123), (130, 90)]):
        rng = np.random.default_rng(seed)
        y, x = np.mgrid[0:shape[0], 0:shape[1]]
        im = np.clip(rng.uniform(40, 200, 3) + (x + y)[..., None] * rng.uniform(-1, 1, 3)
                     + rng.normal(0, 10, shape + (3,)), 0, 255).astype(np.uint8)
        ra, rb = np.random.default_rng(seed), np.random.default_rng(seed)
        a = ja._PIXEL_TRANSFORMS[name](im.copy(), ra)
        b = pa.PIXEL_TRANSFORMS[name](im.copy(), rb)
        _pixels(b, a, "jpeg" if name == "ImageCompression" else "float")
        _next(ra, rb)


def test_policies_call_equals_jax():
    from ayolov2_tpu.data.augment import MultiAugmentationPolicies as JaxPolicies
    from ayolov2_torch.data.augment import MultiAugmentationPolicies

    policies = [{"policy": {"Blur": {"p": 0.5}, "HorizontalFlip": {"p": 0.5},
                            "Affine": dict(AFFINE, p=0.5), "ToGray": {"p": 0.3}}, "prob": 0.9},
                {"policy": {"VerticalFlip": {"p": 0.5}, "Solarize": {}}, "prob": 1.0}]
    for seed in range(12):
        im, labels, _ = _scene(seed)
        xywh = np.concatenate([labels[:, :1], np.full((len(labels), 2), 0.4),
                               np.full((len(labels), 2), 0.1)], 1)
        ra, rb = np.random.default_rng(seed), np.random.default_rng(seed)
        a = JaxPolicies(policies)(im.copy(), xywh.copy(), ra)
        b = MultiAugmentationPolicies(policies)(im.copy(), xywh.copy(), rb)
        _pixels(b[0], a[0])
        np.testing.assert_array_equal(b[1], a[1])
        _next(ra, rb)


# ---- get_item -------------------------------------------------------------------------


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    """The shared labelled set: 9 BMPs of 76-200 px, one with polygon labels
    (segments), one without labels."""
    return labelled_set(tmp_path_factory.mktemp("host_aug"))


def _with_segments(images: Path) -> Path:
    """A ``segments/`` label dir beside ``labels/`` (for the recipe whose
    ``label_type`` is segments), every label file as polygons."""
    seg_dir = images.parent / "segments"
    if not seg_dir.exists():
        seg_dir.mkdir()
        t = np.linspace(0, 2 * np.pi, 10, endpoint=False)
        for f in (images.parent / "labels").glob("*.txt"):
            rows = []
            for line in f.read_text().splitlines():
                v = line.split()
                if len(v) == 5:
                    c, x, y, w, h = v[0], *(float(u) for u in v[1:])
                    pts = np.stack([x + w / 2 * np.cos(t), y + h / 2 * np.sin(t)], 1).clip(0, 1)
                    v = [c] + [f"{p:.6f}" for p in pts.ravel()]
                rows.append(" ".join(v))
            (seg_dir / f.name).write_text("\n".join(rows) + "\n")
    return images


def _cases():
    cases = {}
    for name in ("train_config", "finetune", "train_golden"):
        ya, policies, tcfg = _recipe(name)
        cases[name] = dict(yolo_augmentation=ya, augmentation=policies,
                           label_type=tcfg.get("label_type", "labels"))
    ya = _recipe("train_config")[0]
    for name in ("Blur", "MedianBlur", "ToGray", "CLAHE", "RandomBrightnessContrast",
                 "RandomGamma", "ImageCompression", "Solarize", "Sharpen", "Cutout", "Affine"):
        params = dict(AFFINE) if name == "Affine" else {}
        cases[f"policy_{name}"] = dict(
            yolo_augmentation=ya, augmentation=[{"policy": {name: dict(params, p=1.0)},
                                                 "prob": 1.0}])
    cases["rect_augment"] = dict(
        rect=True, yolo_augmentation=dict(ya, mosaic=0.0, copy_paste2=dict(
            ya["copy_paste2"], p=0.8, n_img=2, area_thr=10)))
    cases["mixup"] = dict(yolo_augmentation=dict(_recipe("finetune")[0], mixup=1.0))
    return cases


CASES = _cases()


def _item(ds, i, salt):
    """get_item and the next draw of the item's generator."""
    made = []
    own = ds._item_rng
    ds._item_rng = lambda index, s=0: made.append(own(index, s)) or made[-1]
    try:
        out = ds.get_item(i, salt)
    finally:
        del ds._item_rng
    return out, made[0].random()


def _gains_only(im, rng, hgain=0.5, sgain=0.5, vgain=0.5):
    """``augment_hsv``'s draw without its pixels: the image before the
    jitter."""
    from ayolov2_torch.data.augment import hsv_gains

    hsv_gains(rng, hgain, sgain, vgain)
    return im


@pytest.mark.parametrize("case", list(CASES))
def test_get_item_equals_jax(images, case, monkeypatch):
    """Labels, the rest of the item and the generator's next draw bit for
    bit; pixels within the gate before the HSV jitter (the hue scale jumps at
    its wrap, so one level there can move a saturated pixel by more after
    it), and on the output the gate's share of differing pixels."""
    import ayolov2_tpu.data.datasets as jax_datasets
    from ayolov2_tpu.data import DetectionDataset as JaxDataset
    import ayolov2_torch.data.datasets as port_datasets
    from ayolov2_torch.data import DetectionDataset

    kw = dict(img_size=LABELLED_IMG, batch_size=4, cache_images="mem", **CASES[case])
    if kw.get("label_type") == "segments":
        _with_segments(images)
    jax_ds, port_ds = JaxDataset(str(images), **kw), DetectionDataset(str(images), **kw)
    gate = "jpeg" if case == "policy_ImageCompression" else "float"
    n = len(port_ds) if case in ("train_config", "finetune", "train_golden", "rect_augment",
                                 "mixup") else 4
    for epoch in (0, 1):
        jax_ds.epoch = port_ds.epoch = epoch
        for i in range(n):
            (a, draw_a), (b, draw_b) = _item(jax_ds, i, 3 * epoch), _item(port_ds, i, 3 * epoch)
            np.testing.assert_array_equal(b[1], a[1])
            assert b[2:] == a[2:] and draw_b == draw_a
            d = np.abs(b[0].astype(np.int64) - a[0].astype(np.int64))
            assert b[0].shape == a[0].shape and (d > 0).mean() <= GATES[gate][1]
            with monkeypatch.context() as m:
                m.setattr(jax_datasets, "augment_hsv", _gains_only)
                m.setattr(port_datasets, "augment_hsv", _gains_only)
                _pixels(_item(port_ds, i, 3 * epoch)[0][0], _item(jax_ds, i, 3 * epoch)[0][0],
                        gate)
