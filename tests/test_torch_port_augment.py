"""Device augmentation: the JAX package and the port on the same seeded
inputs. Draws and label math bit for bit, plans and labels of
``plan_item`` bit for bit, the renderer within a rounding of JAX's
``make_render_fn`` in each mode, the loader's ``PlanBatch``es, and one
epoch of the trainer with ``device_aug`` on."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_common import LABELLED_IMG, ROOT, labelled_set, random_variables, write_image_set

torch.set_num_threads(1)

# tests/test_device_augment.py's recipes
FULL_AUG = dict(augment=True, mosaic=1.0, mixup=0.0, degrees=5.0, translate=0.1, scale=0.5,
                shear=2.0, perspective=0.0, hsv_h=0.015, hsv_s=0.7, hsv_v=0.4, copy_paste=0.0)
AXIS_ALIGNED = dict(FULL_AUG, degrees=0.0, shear=0.0)
FLIPS = [{"policy": {"HorizontalFlip": {"p": 0.5}, "VerticalFlip": {"p": 0.5}}, "prob": 1.0}]

# (yolo_augmentation, policies, resident): what plan_item plans
PLAN_CASES = {
    "mosaic_axis_aligned": (AXIS_ALIGNED, None, True),
    "full_aug": (FULL_AUG, None, True),
    "mixup": (dict(FULL_AUG, mixup=0.7, degrees=3.0, shear=1.0), None, True),
    "letterbox_augment": (dict(FULL_AUG, mosaic=0.0, perspective=0.0005), None, True),
    "letterbox_no_aug": (None, None, True),
    "flips": (dict(AXIS_ALIGNED, mosaic=0.5), FLIPS, True),
    "streaming": (dict(FULL_AUG, mixup=0.5), FLIPS, False),
}


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    """The shared labelled set: 9 BMPs of 76-200 px, one with segment labels,
    one without labels."""
    return labelled_set(tmp_path_factory.mktemp("aug"))


def _datasets(images, ya, policies=None, resident=True, **kw):
    """(JAX dataset, port dataset) in plan mode, same arguments."""
    from ayolov2_tpu.data import DetectionDataset as JaxDataset
    from ayolov2_torch.data import DetectionDataset

    common = dict(img_size=LABELLED_IMG, batch_size=4, cache_images="mem",
                  yolo_augmentation=ya, augmentation=policies, **kw)
    jax_ds, port_ds = JaxDataset(str(images), **common), DetectionDataset(str(images), **common)
    jax_ds.enable_device_aug(resident=resident)
    port_ds.enable_device_aug(resident=resident)
    return jax_ds, port_ds


def _plans(ds, epochs=(0, 1, 2), salts=(0, 3)):
    out = []
    for epoch in epochs:
        ds.epoch = epoch
        out += [ds.plan_item(i, salt) for i in range(len(ds)) for salt in salts]
    return out


# ---- (i) draws and label math -------------------------------------------------


def _boxes_and_segments(rng, n=6):
    """xyxy targets (n, 5) on a 320 canvas and a polygon around each."""
    xy = rng.uniform(0, 280, (n, 2))
    wh = rng.uniform(4, 120, (n, 2))
    t = np.concatenate([rng.integers(0, 20, (n, 1)), xy, xy + wh], 1)
    segs = [np.stack([rng.uniform(a[1], a[3], 7), rng.uniform(a[2], a[4], 7)], 1) for a in t]
    return t, segs


@pytest.mark.parametrize("what", ["perspective_matrix", "rotation_matrix_2d", "targets_boxes",
                                  "targets_segments", "box_candidates", "resample_segments",
                                  "segment2box", "hsv_gains"])
def test_geometry_equals_jax(what):
    """50 seeded draws each: matrices within 1e-12, labels and the rest
    bit for bit."""
    import cv2

    from ayolov2_tpu.data import augment as ja
    from ayolov2_tpu.utils import general as jg
    from ayolov2_torch.data import augment as pa
    from ayolov2_torch.utils import general as pg

    hyp = dict(degrees=10.0, translate=0.2, scale=0.5, shear=3.0, perspective=0.001)
    for seed in range(50):
        rng = np.random.default_rng(seed)
        if what == "perspective_matrix":
            shape = tuple(int(v) for v in rng.integers(32, 700, 2))
            border = (-shape[0] // 4, -shape[1] // 4) if seed % 2 else (0, 0)
            a = ja.perspective_matrix(shape, np.random.default_rng(seed), border=border, **hyp)
            b = pa.perspective_matrix(shape, np.random.default_rng(seed), border=border, **hyp)
            np.testing.assert_allclose(b[0], a[0], rtol=0, atol=1e-12)
            assert b[1:] == a[1:]
        elif what == "rotation_matrix_2d":
            angle, scale = rng.uniform(-180, 180), rng.uniform(0.2, 2)
            center = tuple(rng.uniform(-300, 300, 2)) if seed % 2 else (0, 0)
            np.testing.assert_allclose(pa.rotation_matrix_2d(angle, center, scale),
                                       cv2.getRotationMatrix2D(center, angle, scale),
                                       rtol=0, atol=1e-12)
        elif what in ("targets_boxes", "targets_segments"):
            t, segs = _boxes_and_segments(rng)
            segs = segs if what == "targets_segments" else [np.zeros((0, 2))] * len(t)
            M, s, w, h = ja.perspective_matrix((320, 320), rng, **hyp)
            persp = hyp["perspective"] if seed % 2 else 0.0
            a = ja.perspective_targets(t.copy(), [x.copy() for x in segs], M, s, w, h, persp)
            b = pa.perspective_targets(t.copy(), [x.copy() for x in segs], M, s, w, h, persp)
            np.testing.assert_array_equal(b, a)
        elif what == "box_candidates":
            b1 = rng.uniform(0, 100, (4, 30))
            b2 = b1 * rng.uniform(0.01, 2, (4, 30))
            for kw in ({}, {"area_thr": 0.01}, {"wh_thr": 5, "ar_thr": 4}):
                np.testing.assert_array_equal(pg.box_candidates(b1, b2, **kw),
                                              jg.box_candidates(b1, b2, **kw))
        elif what == "resample_segments":
            segs = [rng.uniform(-10, 300, (int(rng.integers(3, 40)), 2)) for _ in range(3)]
            n = 1000 if seed % 2 else int(rng.integers(2, 1200))
            got, want = pg.resample_segments(segs, n), jg.resample_segments(segs, n)
            assert len(got) == len(want) == 3
            for a, b in zip(got, want):
                assert a.shape == (n, 2)
                np.testing.assert_array_equal(a, b)
        elif what == "segment2box":
            seg = rng.uniform(-50, 350, (int(rng.integers(1, 30)), 2))
            if seed % 5 == 0:
                seg[:] = -1.0  # no point inside: the zero box
            np.testing.assert_array_equal(pg.segment2box(seg, 320, 300),
                                          jg.segment2box(seg, 320, 300))
        else:
            gains = rng.uniform(0, 1, 3) * (seed % 4 != 0)  # every fourth off: no draw
            a = ja.hsv_gains(np.random.default_rng(seed), *gains)
            b = pa.hsv_gains(np.random.default_rng(seed), *gains)
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_array_equal(b, a)


def test_policies_validate_names_as_jax():
    from ayolov2_tpu.data.augment import MultiAugmentationPolicies as JaxPolicies
    from ayolov2_torch.data.augment import MultiAugmentationPolicies

    good = [{"policy": {"Blur": {"p": 0.01}, "HorizontalFlip": {"p": 0.5}, "Affine": {},
                        "CLAHE": {}, "Cutout": {}}, "prob": 1.0}]
    assert MultiAugmentationPolicies(good).policies == JaxPolicies(good).policies
    for cls in (MultiAugmentationPolicies, JaxPolicies):
        with pytest.raises(ValueError, match="Unknown augmentation transform: Mosaic"):
            cls([{"policy": {"Mosaic": {}}}])
    im = np.random.default_rng(1).integers(0, 256, (24, 40, 3), dtype=np.uint8)
    labels = np.array([[1, 0.3, 0.4, 0.2, 0.2]])
    a = JaxPolicies(good)(im.copy(), labels.copy(), np.random.default_rng(0))
    b = MultiAugmentationPolicies(good)(im.copy(), labels.copy(), np.random.default_rng(0))
    np.testing.assert_array_equal(b[0], a[0])
    np.testing.assert_array_equal(b[1], a[1])


# ---- (ii) plans -------------------------------------------------------------------


@pytest.mark.parametrize("case", list(PLAN_CASES))
def test_plan_item_equals_jax(images, case):
    """Every plan array, the labels, path and shapes, bit for bit, over
    epochs 0-2 and two salts."""
    ya, policies, resident = PLAN_CASES[case]
    jax_ds, port_ds = _datasets(images, ya, policies, resident)
    if resident:
        np.testing.assert_array_equal(port_ds.resident_frames, jax_ds.resident_frames)
        np.testing.assert_array_equal(port_ds.frame_hw, jax_ds.frame_hw)
    plans_j, plans_p = _plans(jax_ds), _plans(port_ds)
    assert len(plans_j) == len(plans_p) == 3 * 2 * len(port_ds)
    for (pj, lj, fj, sj), (pp, lp, fp, sp) in zip(plans_j, plans_p):
        assert set(pp) == set(pj) and (("src" in pp) == (not resident))
        for k in pj:
            assert pp[k].dtype == pj[k].dtype, k
            np.testing.assert_array_equal(pp[k], pj[k], err_msg=k)
        np.testing.assert_array_equal(lp, lj)
        assert lp.dtype == lj.dtype == np.float32 and fp == fj and sp == sj
    if case == "mixup":
        assert sum(float(p["blend"]) < 1 for p, *_ in plans_p) >= 5
    if case == "flips":
        flips = np.stack([p["flips"] for p, *_ in plans_p])
        assert flips.any(0).all() and not flips.all(0).any()
    if case == "full_aug":  # segments and the unlabelled image took part
        assert sum(len(lab) for _, lab, _, _ in plans_p) > 0


# ---- (iii) the renderer -----------------------------------------------------------

RENDER_CASES = {
    # (recipe, pairs, mode, dtype, max |d|, bound on the fraction of pixels)
    "gather_f32": (dict(FULL_AUG, mixup=0.5), 2, "gather", "float32", 1, ("d>0", 1e-3)),
    "separable_f32": (dict(AXIS_ALIGNED, mosaic=0.5, mixup=0.5), 2, "separable", "float32", 1,
                      ("d>0", 1e-3)),
    "separable_bf16": (dict(AXIS_ALIGNED, mosaic=0.5, mixup=0.5), 2, "separable", "bfloat16", 8,
                       ("d>3", 2e-3)),
    "letterbox_gather": (None, 1, "gather", "float32", 0, ("d>0", 0.0)),
    "letterbox_separable": (None, 1, "separable", "bfloat16", 0, ("d>0", 0.0)),
}


@pytest.mark.parametrize("case", list(RENDER_CASES))
def test_renderer_matches_jax(images, case):
    """The port's renderer on the CPU against JAX's ``make_render_fn`` on the
    same plans and frames (uint8 output). f32 modes: max|d| <= 1 and at most
    1e-3 of the pixels differ; bf16 separable: max|d| <= 8 and at most 2e-3
    of the pixels differ by more than 3 (tests/test_device_augment.py's
    bf16 bound); the letterbox without augmentation: bit for bit."""
    from ayolov2_tpu.data.device_augment import DeviceAugmenter as JaxAugmenter
    from ayolov2_tpu.data.device_augment import collate_plans as jax_collate
    from ayolov2_torch.data.device_augment import DeviceAugmenter, collate_plans

    ya, pairs, mode, dtype, max_d, (kind, frac) = RENDER_CASES[case]
    jax_ds, port_ds = _datasets(images, ya, FLIPS if ya else None)
    plans_j, plans_p = _plans(jax_ds, epochs=(0, 1)), _plans(port_ds, epochs=(0, 1))
    jb, pb = jax_collate(plans_j, len(plans_j), 64), collate_plans(plans_p, len(plans_p), 64)
    want = np.asarray(JaxAugmenter(LABELLED_IMG, LABELLED_IMG, pairs, jax_ds.resident_frames,
                                   mode=mode, dtype=dtype)(jb))
    aug = DeviceAugmenter(LABELLED_IMG, LABELLED_IMG, pairs, port_ds.resident_frames, mode=mode,
                          dtype=dtype, device="cpu")
    got = aug(pb)
    assert got.dtype == torch.uint8 and got.device.type == "cpu"
    assert tuple(got.shape) == want.shape == (len(plans_p), LABELLED_IMG, LABELLED_IMG, 3)
    assert set(aug._render_fns) == {mode}
    d = np.abs(got.numpy().astype(np.int32) - want.astype(np.int32))
    share = (d > (0 if kind == "d>0" else 3)).mean()
    assert d.max() <= max_d and share <= frac, (d.max(), share)


def test_auto_picks_by_plan_and_separable_refuses_rotations(images):
    from ayolov2_torch.data.device_augment import DeviceAugmenter, collate_plans

    for ya, mode in ((AXIS_ALIGNED, "separable"), (FULL_AUG, "gather")):
        _, ds = _datasets(images, ya)
        batch = collate_plans([ds.plan_item(i, 0) for i in range(4)], 4, 64)
        aug = DeviceAugmenter(LABELLED_IMG, LABELLED_IMG, 1, ds.resident_frames, device="cpu")
        aug(batch)
        assert set(aug._render_fns) == {mode}
    strict = DeviceAugmenter(LABELLED_IMG, LABELLED_IMG, 1, ds.resident_frames, mode="separable",
                             device="cpu")
    with pytest.raises(ValueError, match="axis-aligned"):
        strict(batch)


def test_streaming_equals_resident(images):
    """The same plans rendered from the frames each plan carries and from the
    resident store: bit for bit."""
    from ayolov2_torch.data.device_augment import DeviceAugmenter, collate_plans

    ya = dict(FULL_AUG, mixup=0.5)
    _, res = _datasets(images, ya)
    _, stream = _datasets(images, ya, resident=False)
    assert stream.resident_frames is None
    pr = [res.plan_item(i, 1) for i in range(len(res))]
    ps = [stream.plan_item(i, 1) for i in range(len(stream))]
    br, bs = collate_plans(pr, len(pr), 64), collate_plans(ps, len(ps), 64)
    assert br.src is None and bs.src.shape == (len(ps), 2, 4, LABELLED_IMG, LABELLED_IMG, 3)
    out_r = DeviceAugmenter(LABELLED_IMG, LABELLED_IMG, 2, res.resident_frames, device="cpu")(br)
    out_s = DeviceAugmenter(LABELLED_IMG, LABELLED_IMG, 2, device="cpu")(bs)
    assert torch.equal(out_r, out_s)


def test_mode_and_dtype_overrides_and_mesh(monkeypatch):
    from ayolov2_torch.data.device_augment import DeviceAugmenter, make_render_fn

    monkeypatch.setenv("AYOLO_DEVICE_AUG_MODE", "gather")
    monkeypatch.setenv("AYOLO_DEVICE_AUG_DTYPE", "float32")
    aug = DeviceAugmenter(64, 64, device="cpu")
    assert aug.mode == "gather" and aug.dtype == torch.float32
    monkeypatch.setenv("AYOLO_DEVICE_AUG_MODE", "fast")
    with pytest.raises(ValueError, match="unknown render mode"):
        DeviceAugmenter(64, 64, device="cpu")
    monkeypatch.delenv("AYOLO_DEVICE_AUG_MODE")
    monkeypatch.setenv("AYOLO_DEVICE_AUG_DTYPE", "float16")
    with pytest.raises(ValueError, match="unknown render dtype"):
        DeviceAugmenter(64, 64, device="cpu")
    # the split render: rank 1 of a 2-way data axis renders rows 2-3 of 4,
    # equal to the one-device render's; a batch the axis does not divide raises
    class Rank1Of2:
        mesh_dim_names, shape = ("data",), (2,)

        def get_local_rank(self, axis):
            return 1

    rng = np.random.default_rng(0)
    plan = [torch.from_numpy(rng.integers(0, 256, (3, 64, 64, 3), dtype=np.uint8)),
            torch.from_numpy(rng.integers(0, 3, (4, 1, 4), dtype=np.int32)),
            torch.tensor([[[[0, 0, 64, 64]] + [[0, 0, 0, 0]] * 3]] * 4, dtype=torch.int32),
            torch.zeros((4, 1, 4, 2), dtype=torch.int32),
            torch.eye(3).expand(4, 1, 3, 3).contiguous(), torch.ones(4),
            torch.ones((4, 3)), torch.tensor([[0, 0], [1, 0], [0, 1], [1, 1]], dtype=torch.int32)]
    for mode in ("gather", "separable"):
        whole = make_render_fn(64, 64, mode=mode)(*plan)
        rows = make_render_fn(64, 64, mode=mode, mesh=Rank1Of2())(*plan)
        assert rows.shape[0] == 2 and torch.equal(rows, whole[2:])
        with pytest.raises(ValueError, match="not divisible by data-axis size 2"):
            make_render_fn(64, 64, mode=mode, mesh=Rank1Of2())(plan[0], *(a[:3] for a in plan[1:]))
    with pytest.raises(ValueError, match="unknown render mode"):
        make_render_fn(64, 64, mode="fast")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("AYOLO_DEVICE_AUG_DTYPE")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DeviceAugmenter(64, 64)


# ---- (iv) the HSV jitter ----------------------------------------------------------


def test_hsv_jitter_matches_jax():
    """Seeded f32 images (greys, saturated and dark pixels among them) and
    gains up to the reference's: after rounding, max|d| <= 1."""
    from ayolov2_tpu.data.device_augment import _hsv_jitter as jax_hsv
    from ayolov2_torch.data.device_augment import _hsv_jitter

    rng = np.random.default_rng(4)
    img = np.round(rng.uniform(0, 255, (6, 48, 40, 3))).astype(np.float32)
    img[0, :8] = img[0, :8, :, :1]  # greys: c == 0
    img[1, :8] = 0.0  # black: v == 0
    img[2, :8, :, 0] = 255.0
    gains = (rng.uniform(-1, 1, (6, 3)) * [0.015, 0.7, 0.4] + 1).astype(np.float32)
    want = np.round(np.asarray(jax.jit(jax.vmap(jax_hsv))(img, gains)))
    planar = torch.from_numpy(img).permute(0, 3, 1, 2)  # the renderer's (B, 3, h, w)
    got = torch.round(_hsv_jitter(planar, torch.from_numpy(gains))).permute(0, 2, 3, 1).numpy()
    assert np.abs(got - want).max() <= 1
    assert (got == want).mean() > 0.999


# ---- (v) the loader ---------------------------------------------------------------


@pytest.mark.parametrize("resident", [True, False])
def test_loader_plan_batches_match_jax(images, resident):
    from ayolov2_tpu.data import DataLoader as JaxLoader
    from ayolov2_torch.data import DataLoader
    from ayolov2_torch.data.device_augment import PlanBatch

    jax_ds, port_ds = _datasets(images, dict(FULL_AUG, mixup=0.5), FLIPS, resident)
    kw = dict(batch_size=4, shuffle=True, drop_last=True, workers=2, max_labels_per_image=8)
    jl, pl = JaxLoader(jax_ds, **kw), DataLoader(port_ds, **kw)
    for _ in range(2):  # two epochs: the order and the draws move on
        got, want = list(pl), list(jl)
        assert len(got) == len(want) == 2
        for a, b in zip(got, want):
            assert isinstance(a, PlanBatch) and a.images is None
            np.testing.assert_array_equal(a.targets, b.targets)
            np.testing.assert_array_equal(a.target_mask, b.target_mask)
            assert a.paths == b.paths and a.shapes == b.shapes and a.n_real == b.n_real == 4
            assert a.n_labels == b.n_labels
            for k in ("src_idx", "rects", "offs", "minv", "blend", "hsv", "flips", "src"):
                if getattr(b, k) is None:
                    assert getattr(a, k) is None and resident
                else:
                    np.testing.assert_array_equal(getattr(a, k), getattr(b, k), err_msg=k)


# ---- the dataset's other paths ----------------------------------------------------


def test_ineligible_configs_raise_jax_reasons(images):
    """enable_device_aug refuses what the JAX package refuses, with its
    reasons; the host path augments those configs, with JAX's labels."""
    from ayolov2_tpu.data import DetectionDataset as JaxDataset
    from ayolov2_torch.data import DetectionDataset

    cases = [
        (dict(rect=True), "rect"),
        (dict(yolo_augmentation=dict(FULL_AUG, copy_paste=0.5)), "copy_paste > 0"),
        (dict(yolo_augmentation=dict(FULL_AUG, copy_paste2={"p": 0.5})), "copy_paste2 > 0"),
        (dict(yolo_augmentation=FULL_AUG,
              augmentation=[{"policy": {"HorizontalFlip": {}, "Blur": {"p": 0.01}}}]),
         "pixel policy Blur"),
    ]
    for kw, reason in cases:
        for cls in (DetectionDataset, JaxDataset):
            ds = cls(str(images), img_size=LABELLED_IMG, **kw)
            assert reason in ds.device_aug_ineligible()
            with pytest.raises(ValueError, match=f"device augmentation unsupported: {reason}"):
                ds.enable_device_aug()
    for kw in (dict(yolo_augmentation={"mosaic": 1.0}), dict(yolo_augmentation={"augment": True}),
               dict(augmentation=FLIPS), *(kw for kw, _ in cases)):
        port, ref = (cls(str(images), img_size=LABELLED_IMG, **kw).get_item(0)
                     for cls in (DetectionDataset, JaxDataset))
        np.testing.assert_array_equal(port[1], ref[1])
        assert port[0].shape == ref[0].shape


def test_trainer_refuses_device_aug_with_multi_scale(tmp_path):
    from _torch_port_common import train_files

    from ayolov2_torch.data import DataLoader, DetectionDataset
    from ayolov2_torch.models import build_model, yolov5_cfg
    from ayolov2_torch.train.trainer import YoloTrainer
    from ayolov2_torch.utils.config import load_yaml

    _, _, cfg_path = train_files(tmp_path, device_aug=True)
    cfg = load_yaml(cfg_path)
    cfg["train"]["multi_scale"] = True
    ds = DetectionDataset(str(tmp_path / "images"), img_size=64, cache_images="mem",
                          yolo_augmentation=cfg["yolo_augmentation"],
                          augmentation=cfg["augmentation"])
    ds.enable_device_aug()
    loader = DataLoader(ds, batch_size=4, drop_last=True)
    trainer = YoloTrainer(build_model(yolov5_cfg("n", nc=3), device="cpu"), cfg, loader,
                          log_dir=str(tmp_path / "run"), device="cpu")
    with pytest.raises(ValueError, match="mutually exclusive"):
        trainer.training_step(next(iter(loader)), 0)


# ---- (vi) the trainer -------------------------------------------------------------

NC, IMG, BS, N_IMAGES = 4, 64, 16, 64


def _tiny_cfg():
    from ayolov2_torch.models import yolov5_cfg

    cfg = yolov5_cfg("s", nc=NC)
    cfg["width_multiple"] = 0.125
    return cfg


def _trainer_cfg():
    """The memorisation recipe at 64 px, f32, with the reference recipe's
    augmentation, mixup 0.5 and the flips, rendered in f32."""
    from ayolov2_torch.utils.config import load_yaml

    cfg = load_yaml(ROOT / "res/configs/cfg/train_golden_memorize.yaml")
    cfg["train"].update(epochs=1, batch_size=BS, image_size=IMG, workers=1, half=False,
                        plot=False, cache_image="mem", device_aug=True,
                        device_aug_dtype="float32")
    cfg["hyper_params"]["warmup_min_iters"] = 2
    cfg["yolo_augmentation"].update(augment=True, mosaic=1.0, mixup=0.5, translate=0.1,
                                    scale=0.5)
    cfg["augmentation"] = FLIPS
    return cfg


class _Recording:
    """Records the loss items and the rendered images of every step."""

    def on_epoch_start(self, epoch):
        super().on_epoch_start(epoch)
        self.items, self.rendered = getattr(self, "items", []), getattr(self, "rendered", [])
        step, render = self._train_step, self._render_batch

        def rec(state, images, *args):
            out = step(state, images, *args)
            items = out[1] if isinstance(out, tuple) else out
            self.items.append(np.asarray(items, np.float32).copy())
            return out

        def rec_render(batch):
            images = render(batch)
            self.rendered.append(np.asarray(images).copy())
            return images

        self._train_step, self._render_batch = rec, rec_render


def _dataset(cls, images, cfg):
    ds = cls(str(images), img_size=IMG, batch_size=BS, stride=32, cache_images="mem",
             yolo_augmentation=cfg["yolo_augmentation"], augmentation=cfg["augmentation"])
    ds.enable_device_aug(resident=True)
    return ds


@pytest.fixture(scope="module")
def trainers(tmp_path_factory):
    """One epoch of each trainer, device augmentation on, from the same
    seeded weights on the same 64 labelled BMPs, no validation."""
    from ayolov2_tpu.data import DataLoader as JaxLoader, DetectionDataset as JaxDataset
    from ayolov2_tpu.models import build_model as jax_build
    from ayolov2_tpu.train.trainer import YoloTrainer as JaxTrainer
    from ayolov2_torch.data import DataLoader, DetectionDataset
    from ayolov2_torch.models import build_model
    from ayolov2_torch.train.trainer import YoloTrainer
    from ayolov2_torch.utils.weights import load_flax_variables

    root = tmp_path_factory.mktemp("aug_trainer")
    write_image_set(root, [(64, 64), (48, 64), (64, 40), (56, 64)] * (N_IMAGES // 4), seed=5)
    (root / "labels").mkdir()
    rng = np.random.default_rng(5)
    for i in range(N_IMAGES):
        rows = [f"{rng.integers(0, NC)} {rng.uniform(0.25, 0.75):.5f} {rng.uniform(0.25, 0.75):.5f}"
                f" {rng.uniform(0.1, 0.5):.5f} {rng.uniform(0.1, 0.5):.5f}" for _ in range(3)]
        (root / "labels" / f"{i + 1:06d}.txt").write_text("\n".join(rows) + "\n")
    images = root / "images"
    model = jax_build(_tiny_cfg(), dtype=jnp.float32)
    variables = random_variables(jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, IMG, IMG, 3), jnp.float32), training=False)), 3)
    cfg = _trainer_cfg()
    loader_kw = dict(batch_size=BS, shuffle=True, drop_last=True, workers=1)

    class Jax(_Recording, JaxTrainer):
        pass

    class Port(_Recording, YoloTrainer):
        pass

    jt = Jax(model, copy.deepcopy(variables), copy.deepcopy(cfg),
             JaxLoader(_dataset(JaxDataset, images, cfg), **loader_kw),
             log_dir=str(root / "jax_run"), n_devices=1, model_cfg_dict=_tiny_cfg())
    jt.train()
    pt = Port(load_flax_variables(build_model(_tiny_cfg(), device="cpu"), variables),
              copy.deepcopy(cfg), DataLoader(_dataset(DetectionDataset, images, cfg), **loader_kw),
              log_dir=str(root / "port_run"), model_cfg_dict=_tiny_cfg(), device="cpu")
    pt.train()
    return jt, pt


def test_trainer_device_aug_epoch_matches_jax(trainers):
    """Loss items of every step within 1e-3 relative: not the 1e-4 of the
    trainer without augmentation, because a rendered pixel may differ by 1
    between the two renderers (and the HSV in float by a rounding)."""
    jt, pt = trainers
    assert len(jt.items) == len(pt.items) == N_IMAGES // BS == pt.state.step == int(jt.state.step)
    assert pt._augmenter.mode == "auto" and set(pt._augmenter._render_fns) == {"separable"}
    assert pt._augmenter.dtype == torch.float32
    for a, b in zip(pt.rendered, jt.rendered):
        assert a.shape == b.shape == (BS, IMG, IMG, 3) and a.dtype == np.uint8
        d = np.abs(a.astype(np.int32) - b.astype(np.int32))
        assert d.max() <= 1 and (d > 0).mean() <= 1e-3
    for a, b in zip(pt.items, jt.items):
        assert np.isfinite(a).all()
        np.testing.assert_allclose(a, b, rtol=1e-3, atol=0)
    assert (pt.wdir / "last.ckpt").exists()


# ---- (vii) the entry points -------------------------------------------------------


def test_train_cli_device_aug_on_cpu_then_val(tmp_path):
    """``cli.train --device cpu`` with device_aug (resident: auto) for one
    epoch writes last.ckpt and best.ckpt; ``cli.val --device cpu`` reads
    best.ckpt."""
    from _torch_port_common import train_files

    from ayolov2_torch.cli import train, val
    from ayolov2_torch.utils.checkpoint import load_checkpoint

    model_cfg, data, cfg = train_files(tmp_path, device_aug=True)
    trainer = train.main(["--model", str(model_cfg), "--data", str(data), "--cfg", str(cfg),
                          "--log-dir", str(tmp_path / "runs"), "--device", "cpu"])
    ds = trainer.train_loader.dataset
    assert ds.device_aug and ds.device_aug_resident and ds.resident_frames.shape == (8, 64, 64, 3)
    assert trainer._augmenter is not None and trainer._augmenter.device.type == "cpu"
    wdir = trainer.wdir
    meta = load_checkpoint(wdir / "last.ckpt")["meta"]
    assert meta["epoch"] == 0 and meta["step"] == 2 and (wdir / "best.ckpt").exists()
    assert np.isfinite(trainer.mloss).all()
    result = val.main(["--weights", str(wdir / "best.ckpt"), "--data-cfg", str(data), "-iw", "64",
                       "--batch-size", "4", "--device", "cpu", "--json-path",
                       str(tmp_path / "val.json")])
    assert result["seen"] == 8
