"""The training slice as a whole: ``YoloTrainer`` of the JAX package and of
the port, one epoch each on the same seeded BMP set from the same weights
(seeded numpy weights, bridged), f32 (``half: false``): the loss items of
every step, the validation's metrics and loss, the trained state, and the
``last.ckpt`` / ``best.ckpt`` the trainers write."""

import copy
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_common import ROOT, random_variables, to_numpy_tree, write_image_set

torch.set_num_threads(1)

NC, IMG, BS, N_IMAGES = 4, 64, 32, 128


def tiny_cfg():
    from ayolov2_torch.models import yolov5_cfg

    cfg = yolov5_cfg("s", nc=NC)
    cfg["width_multiple"] = 0.125
    return cfg


def train_cfg():
    from ayolov2_torch.utils.config import load_yaml

    cfg = load_yaml(ROOT / "res/configs/cfg/train_golden_memorize.yaml")
    cfg["train"].update(epochs=1, batch_size=BS, image_size=IMG, validate_period=1, workers=1,
                        half=False, plot=False, cache_image="mem")
    cfg["hyper_params"]["warmup_min_iters"] = 2
    return cfg


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """(images dir, the initial weights): 128 BMPs, each labelled with the
    initial model's own top 3 detections, so that the epoch's validation
    scores something the numbers can move."""
    from ayolov2_tpu.models import build_model

    from ayolov2_torch.data import DataLoader, ImageFolderDataset
    from ayolov2_torch.eval import YoloValidator
    from ayolov2_torch.models import build_model as port_build
    from ayolov2_torch.utils.boxes import scale_coords
    from ayolov2_torch.utils.weights import load_flax_variables

    root = tmp_path_factory.mktemp("slice")
    sizes = [(64, 64), (48, 64), (64, 48), (56, 64)] * (N_IMAGES // 4)
    write_image_set(root, sizes, seed=11)
    model = build_model(tiny_cfg(), dtype=jnp.float32)
    variables = random_variables(jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, IMG, IMG, 3), jnp.float32), training=False)), 3)
    port = load_flax_variables(port_build(tiny_cfg(), device="cpu"), variables)
    labeller = YoloValidator(port, None, cfg={"half": False, "early_pipeline": False},
                             device="cpu")
    ds = ImageFolderDataset(str(root / "images"), img_size=IMG, batch_size=BS)
    (root / "labels").mkdir()
    for imgs, metas, indices, n_real in DataLoader(ds, batch_size=BS, detection=False):
        det, n = (t.numpy() for t in labeller.detect(imgs))
        for j in range(n_real):
            (h0, w0), ratio_pad = metas[j]
            d = det[j, : min(int(n[j]), 3)].astype(np.float64)
            d[:, :4] = scale_coords(imgs.shape[1:3], d[:, :4], (h0, w0), ratio_pad)
            stem = Path(ds.img_files[indices[j]]).stem
            (root / "labels" / f"{stem}.txt").write_text("".join(
                f"{int(c)} {(x1 + x2) / 2 / w0:.6f} {(y1 + y2) / 2 / h0:.6f} "
                f"{(x2 - x1) / w0:.6f} {(y2 - y1) / h0:.6f}\n" for x1, y1, x2, y2, _, c in d))
    for f in (root / "images").glob(".*"):
        f.unlink()
    return root / "images", variables


class _Recording:
    """Records the loss items of every train step (the step function is
    wrapped anew when auto-anchor replaces it)."""

    def on_epoch_start(self, epoch):
        super().on_epoch_start(epoch)
        self.items = getattr(self, "items", [])
        step = self._train_step
        if not getattr(step, "recording", False):
            def rec(*args):
                out = step(*args)
                items = out[1] if isinstance(out, tuple) else out
                self.items.append(np.asarray(items, np.float32).copy())
                return out

            rec.recording = True
            self._train_step = rec


def run_jax(images, variables, log_dir):
    from ayolov2_tpu.data import DataLoader, DetectionDataset
    from ayolov2_tpu.models import build_model
    from ayolov2_tpu.train.trainer import YoloTrainer

    class Trainer(_Recording, YoloTrainer):
        pass

    cfg = train_cfg()
    tcfg = cfg["train"]
    common = dict(img_size=IMG, batch_size=BS, stride=32, cache_images="mem")
    train = DataLoader(DetectionDataset(str(images), yolo_augmentation=cfg["yolo_augmentation"],
                                        **common),
                       batch_size=BS, shuffle=True, drop_last=True, workers=1)
    val = DataLoader(DetectionDataset(str(images), **common), batch_size=BS)
    model = build_model(tiny_cfg(), dtype=jnp.float32)
    trainer = Trainer(model, copy.deepcopy(variables), cfg, train, val_loader=val,
                      log_dir=str(log_dir), n_devices=1, model_cfg_dict=tiny_cfg())
    trainer.train()
    assert tcfg["val_geometry"] == "train"
    return trainer


def run_port(images, variables, log_dir):
    from ayolov2_torch.data import DataLoader, DetectionDataset
    from ayolov2_torch.models import build_model
    from ayolov2_torch.train.trainer import YoloTrainer
    from ayolov2_torch.utils.weights import load_flax_variables

    class Trainer(_Recording, YoloTrainer):
        pass

    cfg = train_cfg()
    common = dict(img_size=IMG, batch_size=BS, stride=32, cache_images="mem")
    train = DataLoader(DetectionDataset(str(images), yolo_augmentation=cfg["yolo_augmentation"],
                                        augmentation=cfg["augmentation"], **common),
                       batch_size=BS, shuffle=True, drop_last=True, workers=1)
    val = DataLoader(DetectionDataset(str(images), **common), batch_size=BS)
    model = load_flax_variables(build_model(tiny_cfg(), device="cpu"), variables)
    trainer = Trainer(model, cfg, train, val_loader=val, log_dir=str(log_dir),
                      model_cfg_dict=tiny_cfg(), device="cpu")
    trainer.train()
    return trainer


@pytest.fixture(scope="module")
def both(setup, tmp_path_factory):
    images, variables = setup
    jt = run_jax(images, variables, tmp_path_factory.mktemp("jax_run"))
    pt = run_port(images, variables, tmp_path_factory.mktemp("port_run"))
    return jt, pt


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-6))


def tree_rel(got, want) -> float:
    """max |got - want| over a tree, relative to its largest |want|."""
    g, w = jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(g) == len(w) > 0
    return max(float(np.abs(np.asarray(a, np.float32) - np.asarray(b, np.float32)).max())
               for a, b in zip(g, w)) / max(float(np.abs(np.asarray(b)).max()) for b in w)


def test_epoch_loss_items_match(both):
    jt, pt = both
    assert len(jt.items) == len(pt.items) == N_IMAGES // BS
    for a, b in zip(pt.items, jt.items):
        assert rel(a, b) < 1e-4, (a, b)
    assert rel(pt.mloss, jt.mloss) < 1e-4
    assert pt.accumulate == jt.accumulate == 2


def test_validation_matches(both):
    jt, pt = both
    for k in ("mR", "mAP50", "mAP50_95"):
        assert abs(pt.state_dict[k] - jt.state_dict[k]) < 1e-4, (k, pt.state_dict[k],
                                                                   jt.state_dict[k])
    # mP is read off the precision curve at the best mean F1 of a 1000-point
    # confidence grid, between detections whose scores may lie 1e-4 apart:
    # a score moved by 1e-6 moves it by up to 1e-2 of a step (here 5e-4)
    assert abs(pt.state_dict["mP"] - jt.state_dict["mP"]) < 1e-3
    assert jt.state_dict["mAP50"] > 0.05  # the labels are the initial model's own boxes
    loss_p = pt._validator.validation()["loss"]
    loss_j = jt._validator.validation()["loss"]
    assert rel(loss_p, loss_j) < 1e-4 and min(loss_p) > 0


def test_trained_state_matches(both):
    from ayolov2_torch.utils.weights import flax_from_state_dict

    jt, pt = both
    s = jt.state
    assert pt.state.step == int(s.step) == 4 and pt.state.ema_updates == int(s.ema_updates)
    model = flax_from_state_dict(pt.state.model.state_dict())
    ema = flax_from_state_dict(pt.state.ema_model.state_dict())
    assert tree_rel(model["params"], to_numpy_tree(s.params)) < 1e-4
    assert tree_rel(model["batch_stats"], to_numpy_tree(s.batch_stats)) < 1e-4
    assert tree_rel(ema["params"], to_numpy_tree(s.ema_params)) < 1e-4
    assert tree_rel(ema["batch_stats"], to_numpy_tree(s.ema_batch_stats)) < 1e-4


@pytest.mark.parametrize("name", ["last.ckpt", "best.ckpt"])
def test_written_checkpoints_match(both, name):
    """Both files read by the JAX package's reader: f32 statistics within
    1e-4 of the tree's scale, params stored in bf16 within that plus one
    bf16 step (f32 weights 1e-6 apart may round to neighbouring values)."""
    from ayolov2_tpu.utils.checkpoint import load_checkpoint

    jt, pt = both
    a = load_checkpoint(pt.wdir / name)
    b = load_checkpoint(jt.wdir / name)
    for k in ("epoch", "step", "ema_updates", "version"):
        assert a["meta"][k] == b["meta"][k], k
    assert abs(a["meta"]["best_score"] - b["meta"]["best_score"]) < 1e-4
    for branch in ("model", "ema"):
        assert tree_rel(a[branch]["batch_stats"], b[branch]["batch_stats"]) < 1e-4
        pa = jax.tree_util.tree_leaves(a[branch]["params"])
        pb = jax.tree_util.tree_leaves(b[branch]["params"])
        assert len(pa) == len(pb) and all(x.dtype == jnp.bfloat16 for x in pa)
        scale = max(float(np.abs(np.asarray(y, np.float32)).max()) for y in pb)
        for x, y in zip(pa, pb):
            x32, y32 = np.asarray(x, np.float32), np.asarray(y, np.float32)
            step = np.abs(y32) * 2.0 ** -7  # one bf16 step at that magnitude
            assert (np.abs(x32 - y32) <= step + 1e-4 * scale).all()
    assert set(a) == set(b) == {"meta", "model", "ema", "optimizer"}
