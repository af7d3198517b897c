"""Representation learning: the port's losses, view datasets, loader, box
crops and train step against the JAX package's on the same seeded inputs.

Tolerances: the losses 1e-6 (relative); the views and the crops bit for
bit; three train steps from the same weights (in f64, see the test), every
parameter and BN statistic within 1e-4 of its largest change (max|port -
jax| / max|jax - start| per tensor)."""

import copy
import tempfile

import numpy as np
import pytest
import torch

from _torch_port_common import ROOT, random_variables, write_image_set

torch.set_num_threads(1)

IMG, BS = 64, 4


@pytest.mark.parametrize("n_trans", [2, 3])
@pytest.mark.parametrize("loss", ["rl", "infonce"])
def test_losses_match_jax(loss, n_trans):
    import jax.numpy as jnp

    from ayolov2_tpu.loss.losses_repr import InfoNCELoss as JaxInfoNCE
    from ayolov2_tpu.loss.losses_repr import RLLoss as JaxRL

    from ayolov2_torch.loss.losses_repr import InfoNCELoss, RLLoss

    feats = np.random.default_rng(n_trans).normal(size=(6 * n_trans, 16)).astype(np.float32)
    if loss == "rl":
        port, ref = RLLoss(), JaxRL()
    else:
        port = InfoNCELoss(batch_size=6, n_trans=n_trans, temperature=0.07)
        ref = JaxInfoNCE(batch_size=6, n_trans=n_trans, temperature=0.07)
    total, items = port(torch.from_numpy(feats))
    want_total, want_items = ref(jnp.asarray(feats))
    np.testing.assert_allclose(float(total), float(want_total), rtol=1e-6)
    np.testing.assert_allclose(items.numpy(), np.asarray(want_items), rtol=1e-6)


@pytest.fixture(scope="module")
def image_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("repr")
    write_image_set(root, [(64, 64), (48, 64), (64, 40), (80, 64)] * 3, seed=5)
    return root / "images"


POLICIES = [{"policy": {"Blur": {"p": 0.3}, "ToGray": {"p": 0.3},
                        "RandomBrightnessContrast": {"p": 0.5}}, "prob": 1.0}]


@pytest.mark.parametrize("kind", ["RLImageDataset", "SimCLRDataset"])
def test_views_are_bit_equal_to_jax(image_dir, kind):
    """The same seed draws the same views: every item, both views, bit for
    bit (the policies, the HSV jitter, the flips; SimCLR's crop resize and
    gray conversion through the port's own cv2 counterparts)."""
    from ayolov2_tpu.data import datasets_repr as jax_repr

    from ayolov2_torch.data import datasets_repr

    kw = dict(img_size=IMG, batch_size=BS, n_trans=2, augmentation=POLICIES, seed=3)
    port = getattr(datasets_repr, kind)(str(image_dir), **kw)
    ref = getattr(jax_repr, kind)(str(image_dir), **kw)
    assert len(port) == len(ref) == 12
    for i in range(len(port)):
        (pv, pp, ps), (jv, jp, js) = port[i], ref[i]
        assert pv.shape == (2, IMG, IMG, 3) and pv.dtype == np.uint8
        np.testing.assert_array_equal(pv, jv)
        assert pp == jp and ps == js


def test_loader_is_image_major(image_dir):
    from ayolov2_tpu.data.datasets_repr import RLDataLoader as JaxLoader
    from ayolov2_tpu.data.datasets_repr import RLImageDataset as JaxDataset

    from ayolov2_torch.data.datasets_repr import RLDataLoader, RLImageDataset

    port = RLDataLoader(RLImageDataset(str(image_dir), img_size=IMG, n_trans=3), batch_size=5,
                        shuffle=True, seed=2)
    ref = JaxLoader(JaxDataset(str(image_dir), img_size=IMG, n_trans=3), batch_size=5,
                    shuffle=True, seed=2)
    assert len(port) == len(ref) == 2
    for epoch in range(2):
        batches, wanted = list(port), list(ref)
        assert len(batches) == len(wanted) == 2
        for (images, paths), (want, want_paths) in zip(batches, wanted):
            assert images.shape == (15, IMG, IMG, 3) and paths == want_paths
            np.testing.assert_array_equal(images, want)
        # rows 3i .. 3i+2 are the views of item i: each letterboxed from one path
        ds = RLImageDataset(str(image_dir), img_size=IMG, n_trans=3)
        for images, paths in batches:
            for i, p in enumerate(paths):
                views = ds[ds.img_files.index(p)][0]
                assert views.shape == images[3 * i: 3 * i + 3].shape
    assert port.epoch == ref.epoch == 2


def test_crops_match_jax_on_jpg_and_crop_bmp_sources(tmp_path):
    """The same file names and pixels as JAX's ``crop_and_save_bboxes`` on
    ``.jpg`` sources (cv2 reads and writes them in both); ``.bmp`` sources,
    which JAX skips, give ``.bmp`` crops of the same boxes."""
    import cv2

    from ayolov2_tpu.data.datasets_repr import crop_and_save_bboxes as jax_crop

    from ayolov2_torch.cli import crop_bboxes
    from ayolov2_torch.data.image_io import imread

    rng = np.random.default_rng(4)
    for suffix in ("jpg", "bmp"):
        img_dir = tmp_path / suffix / "images"
        (tmp_path / suffix / "labels").mkdir(parents=True)
        img_dir.mkdir()
        for i in range(3):
            img = rng.integers(0, 256, (90, 120, 3), dtype=np.uint8)
            assert cv2.imwrite(str(img_dir / f"im{i}.{suffix}"), img)
            rows = [f"{i % 2} 0.5 0.5 0.6 0.7", "1 0.2 0.3 0.1 0.1", "0 0.05 0.1 0.5 0.5", "bad"]
            (tmp_path / suffix / "labels" / f"im{i}.txt").write_text("\n".join(rows) + "\n")
    n_port = crop_bboxes.main(["--img-dir", str(tmp_path / "jpg/images"),
                               "--save-dir", str(tmp_path / "port_jpg")])
    n_jax = jax_crop(str(tmp_path / "jpg/images"), str(tmp_path / "jax_jpg"))
    names = sorted(p.name for p in (tmp_path / "port_jpg").iterdir())
    assert n_port == n_jax == 6 and names == sorted(p.name for p in (tmp_path / "jax_jpg").iterdir())
    for name in names:
        np.testing.assert_array_equal(cv2.imread(str(tmp_path / "port_jpg" / name)),
                                      cv2.imread(str(tmp_path / "jax_jpg" / name)))
    assert jax_crop(str(tmp_path / "bmp/images"), str(tmp_path / "jax_bmp")) == 0
    assert crop_bboxes.main(["--img-dir", str(tmp_path / "bmp/images"), "--save-dir",
                             str(tmp_path / "port_bmp"), "--min-size", "32"]) == 6
    for name in names:
        bmp = tmp_path / "port_bmp" / name.replace(".jpg", ".bmp")
        src = imread(str(tmp_path / "bmp/images" / (name.split("_")[0] + ".bmp")))
        i = int(name.split("_")[1][:3])
        _, cx, cy, bw, bh = (float(v) for v in
                             ["0 0.5 0.5 0.6 0.7", "1 0.2 0.3 0.1 0.1",
                              "0 0.05 0.1 0.5 0.5"][i].split())
        x0, y0 = int((cx - bw / 2) * 120), int((cy - bh / 2) * 90)
        want = src[max(y0, 0): y0 + int(bh * 90), max(x0, 0): x0 + int(bw * 120)]
        np.testing.assert_array_equal(imread(str(bmp)), want)


def _repr_cfg(width: float = 0.125):
    from ayolov2_torch.utils.config import load_yaml

    cfg = load_yaml(ROOT / "res/configs/model/simclr.yaml")
    cfg["width_multiple"] = width
    return cfg


@pytest.mark.parametrize("rl_type", ["base", "simclr"])
def test_three_train_steps_match_jax(rl_type):
    """Three updates of the repr trainer (``base``: SGD with Nesterov;
    ``simclr``: AdamW on the cosine schedule, whose decay runs over
    ``len(loader) * epochs`` = 4 updates, so the lr changes each step) from
    the same weights on the same view batches, both sides in f64 (the
    images /255 in f32 first, as in both trainers): in f32 both drift about
    1e-3 of a step's change from the exact result on these random weights
    (BatchNorm over 2x2 maps), in f64 they agree to 1e-4 of it. The pixels
    take all 256 values (the port's ``to_input`` rounds ``x / 255`` as XLA
    does: drawn from them, a one-ulp gap there moved AdamW's parameters by
    0.13 of a step's change)."""
    import jax
    import jax.numpy as jnp

    from ayolov2_tpu.models import build_model as jax_build
    from ayolov2_tpu.train.repr_trainer import RepresentationLearningTrainer as JaxTrainer

    from ayolov2_torch.models import build_model
    from ayolov2_torch.train.repr_trainer import RepresentationLearningTrainer
    from ayolov2_torch.utils.weights import flax_from_state_dict, load_flax_variables

    cfg = {"train": {"epochs": 2, "batch_size": 2, "n_trans": 2, "temperature": 0.5},
           "hyper_params": {"optimizer_params": {"lr": 0.01 if rl_type == "base" else 3e-3,
                                                 "momentum": 0.9, "nesterov": True}}}
    loader = [None, None]  # len() 2: the schedule's decay spans 4 updates
    rng = np.random.default_rng(11)
    batches = [rng.integers(0, 256, (4, IMG, IMG, 3), dtype=np.uint8) for _ in range(4)]
    with jax.enable_x64(True), tempfile.TemporaryDirectory() as tmp:
        jmodel = jax_build(_repr_cfg(), dtype=jnp.float64)
        variables = random_variables(jax.eval_shape(lambda: jmodel.init(
            jax.random.PRNGKey(0), jnp.zeros((1, IMG, IMG, 3), jnp.float32), training=False)), 7)
        v64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), variables)
        ref = JaxTrainer(jmodel, copy.deepcopy(v64), cfg, loader, rl_type=rl_type,
                         log_dir=tmp + "/jax", n_devices=1)
        port = RepresentationLearningTrainer(
            load_flax_variables(build_model(_repr_cfg(), device="cpu"), variables).double(), cfg,
            loader, rl_type=rl_type, log_dir=tmp + "/port", device="cpu")
        for i, batch in enumerate(batches[:3]):
            ref.training_step((batch, None), i)
            port.training_step((batch, None), i)
        assert port.state.optimizer.updates == 3
        got = flax_from_state_dict(port.model.state_dict())
        want = jax.device_get({"params": ref.state.params, "batch_stats": ref.state.batch_stats})

        def walk(g, w, s, path=""):
            if hasattr(w, "items"):
                for k in w:
                    yield from walk(g[k], w[k], s[k], f"{path}/{k}")
                return
            w, g, s = (np.asarray(x, np.float64) for x in (w, g, s))
            delta = np.abs(w - s).max()
            yield path, float(np.abs(g - w).max() / max(delta, 1e-12)), delta

        errs = list(walk(got, want, v64))
        # only the last bias may stay: the L1 of two views' features cancels it
        assert len(errs) > 20 and all(e[2] > 0 for e in errs
                                      if e[0] != "/params/model_13/fc/bias")
        worst = max(errs, key=lambda e: e[1])
        assert worst[1] < 1e-4, worst
        # the validation loss (eval mode) of a fourth batch
        got_v = port.eval_items(torch.from_numpy(batches[3])).numpy()
        want_v = np.asarray(ref._eval_step(ref.state.params, ref.state.batch_stats,
                                           jnp.asarray(batches[3])))
        np.testing.assert_allclose(got_v, want_v, rtol=1e-6)


@pytest.mark.parametrize("cfg_name", ["train_config_simclr.yaml", "train_config_repr.yaml"])
def test_train_repr_cli_on_cpu_on_box_crops(cfg_name, tmp_path, monkeypatch):
    """``cli.crop_bboxes`` of a labelled BMP set, then ``cli.train_repr
    --device cpu`` on the crops with the shipped config (1 epoch, bs 4 at 64
    px, width 0.125): best_e000.ckpt and last.ckpt, finite losses; without a
    card and without ``--device cpu`` it raises."""
    import json

    from _torch_port_common import train_files
    from ayolov2_torch.cli import crop_bboxes, train_repr
    from ayolov2_torch.utils.checkpoint import load_checkpoint

    train_files(tmp_path)
    crops = tmp_path / "crops" / "images"
    assert crop_bboxes.main(["--img-dir", str(tmp_path / "images"), "--save-dir", str(crops),
                             "--min-size", "8"]) == 8
    data = tmp_path / "repr_data.yaml"
    data.write_text(f"train_path: {crops}\nval_path: {crops}\nnc: 1\n")
    model = tmp_path / "model.json"
    model.write_text(json.dumps(_repr_cfg()))
    text = (ROOT / "res/configs/cfg" / cfg_name).read_text()
    for a, b in (("epochs: 30", "epochs: 1"), ("epochs: 20", "epochs: 1"),
                 ("batch_size: 32", "batch_size: 4"), ("batch_size: 16", "batch_size: 4"),
                 ("image_size: 320", "image_size: 64"), ("n_skip: 2", "n_skip: 0")):
        text = text.replace(a, b)
    cfg = tmp_path / cfg_name
    cfg.write_text(text)
    args = ["--model", str(model), "--data", str(data), "--cfg", str(cfg), "--log-dir",
            str(tmp_path / "runs")]
    trainer = train_repr.main(args + ["--device", "cpu"])
    assert trainer.rl_type == ("simclr" if "simclr" in cfg_name else "base")
    assert trainer.state.optimizer.updates == 2
    assert sorted(p.name for p in trainer.wdir.iterdir()) == ["best_e000.ckpt", "last.ckpt"]
    assert np.isfinite(trainer.state_dict["val_loss"]) and np.isfinite(trainer.last_items).all()
    meta = load_checkpoint(trainer.wdir / "best_e000.ckpt")["meta"]
    assert meta["best_score"] == -trainer.best_loss
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_repr.main(args)
