"""Reading other runs into the port: the reference's ``.pt`` weights, a JAX
run's optimizer state, the disk image caches, and the evaluator's renders,
each against the JAX package on the same files.

Tolerances: imported variables bit for bit; a JAX run resumed mid-window in
both packages, three micro-steps in f64 (see the test), every parameter, BN
statistic and EMA tensor within 1e-4 of its largest change plus 1e-7 of its
scale (JAX's EMA rate is rounded to f32); cached images bit for bit."""

import copy
import json

import numpy as np
import pytest
import torch

from _torch_port_common import GOLDEN, random_variables, tree_leaves, write_image_set

torch.set_num_threads(1)

MODEL_YAML = str(GOLDEN / "model.yaml")


@pytest.fixture(scope="module")
def golden_sd():
    """JAX's ``pytree_to_torch_state_dict`` of the golden checkpoint's EMA
    branch: a reference-style (kindle-named, OIHW) state_dict."""
    from ayolov2_tpu.utils.checkpoint import load_variables
    from ayolov2_tpu.utils.torch_import import pytree_to_torch_state_dict

    v, _ = load_variables(GOLDEN / "weights/best.ckpt")
    sd = pytree_to_torch_state_dict(v["params"], v["batch_stats"])
    return {k: torch.from_numpy(np.ascontiguousarray(a, np.float32)) for k, a in sd.items()}


@pytest.mark.parametrize("layout", ["state_dict", "ema_model_dict"])
def test_pt_weights_load_as_in_jax(golden_sd, layout, tmp_path):
    """A ``.pt`` saved as a bare state_dict and as ``{"ema": sd, "model": sd}``
    gives the port's ``load_variables`` the JAX package's variables and meta
    (counts, the config with the class count used), bit for bit; the port's
    ``cli.import_torch_weights`` writes a ``.ckpt`` that JAX's
    ``load_variables`` reads to the same variables."""
    from ayolov2_tpu.utils.checkpoint import load_variables as jax_load

    from ayolov2_torch.cli import import_torch_weights
    from ayolov2_torch.utils.checkpoint import load_variables

    pt = tmp_path / "golden.pt"
    torch.save(golden_sd if layout == "state_dict" else
               {"epoch": 3, "ema": golden_sd, "model": {k: v * 0 for k, v in golden_sd.items()}},
               pt)
    got, meta = load_variables(pt, model_cfg=MODEL_YAML, nc=20)
    want, want_meta = jax_load(pt, model_cfg=MODEL_YAML, nc=20)
    g, w = tree_leaves(got), tree_leaves(want)
    assert sorted(g) == sorted(w) and len(g) > 250
    for k in w:
        np.testing.assert_array_equal(g[k], np.asarray(w[k], np.float32), err_msg=k)
    assert meta["torch_matched"] == want_meta["torch_matched"] == len(golden_sd)
    assert meta["torch_unmatched"] == want_meta["torch_unmatched"] == 0
    assert json.loads(meta["model_cfg"]) == json.loads(want_meta["model_cfg"])
    assert json.loads(meta["model_cfg"])["n_classes"] == 20

    out = tmp_path / "imported.ckpt"
    import_torch_weights.main(["--weights", str(pt), "--model-cfg", MODEL_YAML, "--nc", "20",
                               "--out", str(out)])
    again, again_meta = jax_load(out)
    a = tree_leaves(again)
    for k in w:  # the golden params are bf16 values: exact after the bf16 store
        np.testing.assert_array_equal(np.asarray(a[k], np.float32),
                                      np.asarray(w[k], np.float32), err_msg=k)
    assert again_meta["step"] == 0 and again_meta["epoch"] == 0
    with pytest.raises(ValueError, match="--model-cfg"):
        load_variables(pt)


def test_golden_optax_state_resumes():
    """The committed golden checkpoint (a JAX run: MultiSteps at mini_step 0,
    gradient_step 2250, SGD momentum in three groups) resumes into the
    port's optimizer: counters, nonzero traces in every parameter, and the
    schedules at update 2250."""
    from ayolov2_torch.models import build_model, init_model
    from ayolov2_torch.train.optimizer import build_optimizer
    from ayolov2_torch.train.train_state import create_train_state
    from ayolov2_torch.utils.checkpoint import load_checkpoint, restore_train_state

    model = init_model(build_model(MODEL_YAML, nc=20, device="cpu"))
    opt = build_optimizer(model, {"optimizer_params": {"lr": 0.01}}, epochs=1500,
                          steps_per_epoch=6, batch_size=16, accumulate=4)
    state, meta = restore_train_state(GOLDEN / "weights/best.ckpt", create_train_state(model, opt))
    assert (opt.updates, opt.mini_step, state.step, state.ema_updates) == (2250, 0, 9000, 9000)
    assert all(opt.opt.state[p]["momentum_buffer"].abs().sum() > 0 for p in opt.params)
    assert all(p.grad is None for p in opt.params)
    raw = load_checkpoint(GOLDEN / "weights/best.ckpt")["optimizer"]
    kernel = raw["inner_opt_state"]["inner_states"]["weight"]["inner_state"]["momentum"][
        "model_0"]["conv"]["kernel"]
    np.testing.assert_array_equal(opt.opt.state[model.model[0].conv.weight]["momentum_buffer"]
                                  .numpy(), kernel.transpose(3, 2, 0, 1))
    for group in ("weight", "bias"):
        assert opt.lr_fn(opt.updates, group) == opt.lr_fn(2250, group) > 0
    bad = dict(raw, inner_opt_state={"inner_states": {"weight": {"inner_state": {"x": 1}}}})
    with pytest.raises(ValueError, match="neither SGD's"):
        opt.load_optax_state(bad)


def _tiny_cfg():
    from ayolov2_torch.models import yolov5_cfg

    cfg = yolov5_cfg("s", nc=3)
    cfg["width_multiple"] = 0.125
    return cfg


@pytest.mark.parametrize("optimizer", ["SGD", "Adam"])
def test_jax_run_resumes_mid_window(optimizer, tmp_path):
    """A JAX train state at accumulate 4, after 6 micro-steps (one update,
    then 2 of the next window), is checkpointed by the JAX package; JAX and
    the port each resume it and take the same 3 micro-steps (the window's
    update at the second). Both sides in f64 (images /255 in f32 first, the
    loss in f32, as both steps do): in f32 BatchNorm over the 2x2 maps moves
    both about 1e-3 of a step's change. The pixels take all 256 values (the
    port's ``to_input`` rounds ``x / 255`` as XLA does)."""
    import jax
    import jax.numpy as jnp

    from ayolov2_tpu.loss.yolo_loss import ComputeLoss as JaxLoss
    from ayolov2_tpu.models import build_model as jax_build
    from ayolov2_tpu.models.yolo_head import YOLOHead
    from ayolov2_tpu.train import optimizer as jopt
    from ayolov2_tpu.train import train_state as jts
    from ayolov2_tpu.utils import checkpoint as jckpt

    from ayolov2_torch.loss.yolo_loss import ComputeLoss
    from ayolov2_torch.models import build_model
    from ayolov2_torch.train.optimizer import build_optimizer
    from ayolov2_torch.train.train_state import create_train_state, make_train_step
    from ayolov2_torch.utils.checkpoint import restore_train_state
    from ayolov2_torch.utils.weights import flax_from_state_dict

    img, bs, nc = 64, 16, 3
    hyp = {"optimizer_params": {"lr": 0.01, "momentum": 0.9}, "lrf": 0.1, "weight_decay": 5e-4,
           "warmup_epochs": 1.0, "warmup_min_iters": 4, "box": 0.05, "cls": 0.5, "obj": 1.0,
           "anchor_t": 4.0}
    rng = np.random.default_rng(3)
    batches = []
    for _ in range(9):
        t = np.zeros((bs * 2, 6), np.float32)
        t[:, 0] = np.arange(bs * 2) // 2
        t[:, 1] = rng.integers(0, nc, bs * 2)
        t[:, 2:4] = rng.uniform(0.2, 0.8, (bs * 2, 2))
        t[:, 4:] = rng.uniform(0.05, 0.4, (bs * 2, 2))
        batches.append((rng.integers(0, 256, (bs, img, img, 3), dtype=np.uint8),
                        t, rng.random(bs * 2) < 0.8))
    ckpt = tmp_path / "mid.ckpt"
    with jax.enable_x64(True):
        model = jax_build(_tiny_cfg(), dtype=jnp.float64)
        v = random_variables(jax.eval_shape(lambda: model.init(
            jax.random.PRNGKey(0), jnp.zeros((1, img, img, 3), jnp.float32), training=False)), 4)
        v = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), v)
        head = YOLOHead(nc=nc, anchors=model.anchors, strides=model.strides)
        loss = JaxLoss.from_hyp(head.stride_anchors(), nc, hyp)
        kw = dict(epochs=10, steps_per_epoch=8, batch_size=bs, accumulate=4, optimizer=optimizer)
        tx = jopt.build_optimizer(v["params"], hyp, **kw)
        step = jax.jit(jts.make_train_step(model, loss, tx, image_dtype=jnp.float32))
        state = jts.create_train_state(v, tx)
        for b in batches[:6]:
            state, _ = step(state, *map(jnp.asarray, b))
        assert int(state.opt_state.mini_step) == 2 and int(state.opt_state.gradient_step) == 1
        jckpt.save_checkpoint(ckpt, state, epoch=0, half=False)
        template = jts.create_train_state(v, tx)
        resumed, _ = jckpt.restore_train_state(ckpt, template)
        for b in batches[6:]:
            resumed, _ = step(resumed, *map(jnp.asarray, b))
        want = jax.device_get({"params": resumed.params, "batch_stats": resumed.batch_stats,
                               "ema_params": resumed.ema_params,
                               "ema_batch_stats": resumed.ema_batch_stats})
        start = jax.device_get({"params": state.params, "batch_stats": state.batch_stats,
                                "ema_params": state.ema_params,
                                "ema_batch_stats": state.ema_batch_stats})

    port = build_model(_tiny_cfg(), device="cpu").double()
    opt = build_optimizer(port, hyp, **kw)
    pstate, meta = restore_train_state(ckpt, create_train_state(port, opt))
    assert (opt.updates, opt.mini_step, pstate.step) == (1, 2, 6)
    pstep = make_train_step(ComputeLoss.from_hyp(port.head.stride_anchors(), nc, hyp),
                            image_dtype=torch.float32)
    for b in batches[6:]:
        pstep(pstate, *map(torch.from_numpy, b))
    assert (opt.updates, opt.mini_step, pstate.step) == (2, 1, 9)
    got = flax_from_state_dict(pstate.model.state_dict())
    got_ema = flax_from_state_dict(pstate.ema_model.state_dict())
    got = {"params": got["params"], "batch_stats": got["batch_stats"],
           "ema_params": got_ema["params"], "ema_batch_stats": got_ema["batch_stats"]}
    errs = []
    for part in want:
        g, w, s = tree_leaves(got[part]), tree_leaves(want[part]), tree_leaves(start[part])
        for k in w:
            gk, wk, sk = (np.asarray(x[k], np.float64) for x in (g, w, s))
            errs.append((f"{part}/{k}", np.abs(gk - wk).max(), np.abs(wk - sk).max(),
                         np.abs(wk).max()))
    assert sum(e[2] > 1e-6 * e[3] for e in errs) > 0.9 * len(errs)  # they moved
    # 1e-4 of the change, and 1e-7 of the scale: JAX's EMA rate is an f32
    worst = max(errs, key=lambda e: e[1] / (1e-4 * e[2] + 1e-7 * e[3]))
    assert worst[1] <= 1e-4 * worst[2] + 1e-7 * worst[3], worst


def test_disk_caches_are_shared_with_jax(tmp_path):
    """``cache_images: disk`` writes ``<image>.ayolo.npy``; each package reads
    the other's files to the same arrays; a corrupt file is deleted and
    written anew; ``dynamic_mem`` keeps what it loaded."""
    from ayolov2_tpu.data import ImageFolderDataset as JaxFolder

    from ayolov2_torch.data import ImageFolderDataset

    write_image_set(tmp_path, [(64, 48), (40, 64), (70, 70)], seed=2)
    images = str(tmp_path / "images")
    plain = ImageFolderDataset(images, img_size=64)
    want = [plain.load_image(i) for i in range(3)]
    for writer, reader in ((ImageFolderDataset, JaxFolder), (JaxFolder, ImageFolderDataset)):
        for f in (tmp_path / "images").glob("*.ayolo.npy"):
            f.unlink()
        w = writer(images, img_size=64, cache_images="disk")
        for i in range(3):
            w.load_image(i)
        npys = sorted((tmp_path / "images").glob("*.ayolo.npy"))
        assert len(npys) == 3
        r = reader(images, img_size=64, cache_images="dynamic_disk")
        for i in range(3):
            im, orig, resized = r.load_image(i)
            np.testing.assert_array_equal(im, want[i][0])
            assert tuple(orig) == want[i][1] and tuple(resized) == want[i][2]
    npys[0].write_bytes(b"not a numpy file")
    port = ImageFolderDataset(images, img_size=64, cache_images="disk")
    np.testing.assert_array_equal(port.load_image(0)[0], want[0][0])
    assert np.load(npys[0], allow_pickle=True).item()["orig"] == want[0][1]
    mem = ImageFolderDataset(images, img_size=64, cache_images="dynamic_mem")
    mem.load_image(1)
    assert list(mem._img_cache) == [1]
    np.testing.assert_array_equal(mem.load_image(1, copy=False)[0], want[1][0])


def test_renders_go_to_export_root_only(tmp_path):
    """``evaluate_per_class(debug=True)`` with ``img_root`` writes each image's
    predictions beside its labels into ``export_root`` (the image's width x
    2 + a 3% divider), as JAX's does, and never into ``img_root``."""
    import cv2

    from ayolov2_tpu.utils.metrics import COCOmAPEvaluator as JaxEvaluator

    from ayolov2_torch.utils.metrics import COCOmAPEvaluator

    img_root = tmp_path / "src"
    img_root.mkdir()
    rng = np.random.default_rng(0)
    gt = {"images": [{"id": i, "width": 100, "height": 80} for i in (1, 2)],
          "categories": [{"id": 0, "name": "a"}, {"id": 1, "name": "b"}],
          "annotations": [{"id": 1, "image_id": 1, "category_id": 0, "bbox": [10, 10, 30, 20],
                           "area": 600, "iscrowd": 0},
                          {"id": 2, "image_id": 2, "category_id": 1, "bbox": [40, 30, 20, 30],
                           "area": 600, "iscrowd": 0}]}
    for i in (1, 2):
        assert cv2.imwrite(str(img_root / f"{i:012d}.jpg"),
                           rng.integers(0, 256, (80, 100, 3), dtype=np.uint8))
    before = {p.name: p.read_bytes() for p in img_root.iterdir()}
    preds = [{"image_id": 1, "category_id": 0, "bbox": [11, 9, 30, 21], "score": 0.9},
             {"image_id": 2, "category_id": 0, "bbox": [40, 30, 20, 30], "score": 0.5}]
    for cls, out in ((COCOmAPEvaluator, tmp_path / "port"), (JaxEvaluator, tmp_path / "jax")):
        res = cls(copy.deepcopy(gt), img_root=str(img_root), export_root=str(out)) \
            .evaluate_per_class(preds, debug=True)
        assert res["map50"] >= 0
    for i in (1, 2):
        port = cv2.imread(str(tmp_path / "port" / f"{i:012d}.jpg"))
        ref = cv2.imread(str(tmp_path / "jax" / f"{i:012d}.jpg"))
        assert port.shape == ref.shape == (80, 203, 3)
    assert {p.name: p.read_bytes() for p in img_root.iterdir()} == before
    # export_root == img_root: nothing is written over the sources
    COCOmAPEvaluator(copy.deepcopy(gt), img_root=str(img_root),
                     export_root=str(img_root)).evaluate_per_class(preds, debug=True)
    assert {p.name: p.read_bytes() for p in img_root.iterdir() if p.suffix == ".jpg"} == before
