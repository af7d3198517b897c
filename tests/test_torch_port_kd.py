"""Soft-teacher distillation: the port's pseudo batches and KD student step
against the JAX package's ``SoftTeacherTrainer`` on the same seeded weights
and images, and the producer thread's failure path.

Tolerances: pseudo images bit for bit and targets within 1e-5 (both
teachers f32, no early-network kernel; the bf16 teacher with the kernel is
held to this one on the card, ``chip_smoke.py`` 14.5); one KD step in f64
(see the test), every parameter, BN statistic and EMA tensor within 1e-4 of
its largest change plus 1e-7 of its scale (JAX's EMA rate is rounded to
f32)."""

import copy
import tempfile
import threading
import time

import numpy as np
import pytest
import torch

from _torch_port_common import ROOT, random_variables

torch.set_num_threads(1)

NC, IMG = 4, 64


def tiny_cfg():
    from ayolov2_torch.models import yolov5_cfg

    cfg = yolov5_cfg("s", nc=NC)
    cfg["width_multiple"] = 0.125
    return cfg


def kd_cfg(bs: int):
    from ayolov2_torch.utils.config import load_yaml

    cfg = load_yaml(ROOT / "res/configs/cfg/distillation.yaml")
    cfg["train"].update(epochs=1, batch_size=bs, image_size=IMG, half=False, workers=1)
    return cfg


def _variables(seed: int, plant: bool = False):
    """Seeded numpy weights of the tiny model; ``plant``: the head's
    objectness and class-0 biases raised to 8, so that the teacher is sure
    of its boxes (scores above the 0.9 cut)."""
    import jax
    import jax.numpy as jnp

    from ayolov2_tpu.models import build_model

    model = build_model(tiny_cfg(), dtype=jnp.float32)
    v = random_variables(jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, IMG, IMG, 3), jnp.float32), training=False)), seed)
    if plant:
        for k, leaf in v["params"]["model_24"].items():
            b = leaf["bias"].reshape(3, 5 + NC)
            b[:, 4] = 8.0
            b[:, 5] = 8.0
            leaf["bias"] = b.reshape(-1)
    return v


def _images(n: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, (n, IMG, IMG, 3), dtype=np.uint8)


def _trainers(bs: int, tmp: str, teacher_vars, student_vars, dtype=None):
    """(JAX trainer, port trainer) over the same config and weights; the
    loaders are lists (the trainers read their lengths only)."""
    import jax.numpy as jnp

    from ayolov2_tpu.models import build_model as jax_build
    from ayolov2_tpu.models import fuse_params as jax_fuse
    from ayolov2_tpu.train.kd_trainer import SoftTeacherTrainer as JaxKD

    from ayolov2_torch.models import build_model
    from ayolov2_torch.train.kd_trainer import SoftTeacherTrainer, make_teacher
    from ayolov2_torch.utils.weights import load_flax_variables

    jdt = dtype or jnp.float32
    cfg = kd_cfg(bs)
    loader = [None]
    ref = JaxKD(jax_build(tiny_cfg(), dtype=jdt), copy.deepcopy(student_vars),
                jax_build(tiny_cfg(), dtype=jnp.float32, fused=True),
                jax_fuse(teacher_vars), cfg, loader, loader, log_dir=tmp + "/jax", n_devices=1)
    student = load_flax_variables(build_model(tiny_cfg(), device="cpu"), student_vars)
    teacher = load_flax_variables(build_model(tiny_cfg(), device="cpu"),
                                  teacher_vars).fuse()
    port = SoftTeacherTrainer(student.double() if dtype is not None else student, teacher, cfg,
                              loader, loader, log_dir=tmp + "/port", device="cpu",
                              early_pipeline=False)
    # the reference teacher: f32, no early-network kernel
    port.teacher = make_teacher(teacher, "cpu", torch.float32, early_pipeline=False)
    return ref, port


def test_pseudo_batches_match_jax():
    """Three pseudo batches in a row from the same teacher weights: the
    teacher's NMS, the score and size cuts, the strong augmentation as
    shipped in ``distillation.yaml`` (drawn from the trainers' generators,
    seed 0), ``pad_targets``."""
    teacher = _variables(5, plant=True)
    with tempfile.TemporaryDirectory() as tmp:
        ref, port = _trainers(4, tmp, teacher, _variables(6))
        kept = 0
        for k in range(3):
            images = _images(4, 20 + k)
            (gi, gt, gm), (wi, wt, wm) = (port.make_pseudo_batch(images),
                                          ref.make_pseudo_batch(images))
            np.testing.assert_array_equal(gi, wi)
            np.testing.assert_array_equal(gm, wm)
            np.testing.assert_allclose(gt, wt, atol=1e-5)
            kept += int(gm.sum())
        assert kept == sum(port.pseudo_counts) > 10
        assert port.pseudo_launches == [0, 0, 0]  # the f32 teacher runs no kernel


def at_update(opt_state, k: int):
    """JAX's 3-group optimizer state (``optax.multi_transform``; at
    accumulate 1 there is no ``MultiSteps`` around it) with every group's
    schedule counter at update ``k``."""
    import jax.numpy as jnp

    states = {g: st._replace(inner_state=dict(st.inner_state, step=jnp.asarray(k, jnp.int32)))
              for g, st in opt_state.inner_states.items()}
    return opt_state._replace(inner_states=states)


def test_kd_step_matches_jax():
    """One KD micro-step at bs 64 (accumulate 1, so the optimizer updates),
    labelled then pseudo forward in train mode, one backward of loss_l + 0.5
    loss_u, the 3-group SGD at update 300 of its 1000-update warmup (every
    group's lr above 0, so kernels, BN scales and biases all move) and the
    EMA, against JAX's jitted ``_make_step`` from the same weights and
    batches, pixels over all 256 values (the port's ``to_input`` rounds
    ``x / 255`` as XLA does). Both sides in f64 (images /255 in f32 first,
    as in both steps; the loss in f32 in both): in f32 BatchNorm over the
    2x2 maps moves both about 1e-3 of a step's change."""
    import jax
    import jax.numpy as jnp

    from ayolov2_torch.utils.weights import flax_from_state_dict

    rng = np.random.default_rng(41)
    imgs = [_images(64, 41 + i) for i in range(2)]
    targets = []
    for _ in range(2):
        t = np.zeros((64 * 2, 6), np.float32)
        t[:, 0] = np.arange(128) // 2
        t[:, 1] = rng.integers(0, NC, 128)
        t[:, 2:4] = rng.uniform(0.2, 0.8, (128, 2))
        t[:, 4:] = rng.uniform(0.05, 0.4, (128, 2))
        targets.append((t, rng.random(128) < 0.8))
    with jax.enable_x64(True), tempfile.TemporaryDirectory() as tmp:
        student = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), _variables(8))
        ref, port = _trainers(64, tmp, _variables(5), student, dtype=jnp.float64)
        assert ref.accumulate == port.accumulate == 1
        ref.state = ref.state.replace(opt_state=at_update(ref.state.opt_state, 300))
        port.state.optimizer.updates = 300
        opt = port.state.optimizer
        assert min(opt.lr_fn(300, g) for g in ("weight", "bias", "bn_scale")) > 0
        state, items_l, items_u = ref._student_step(
            ref.state, jnp.asarray(imgs[0]), *map(jnp.asarray, targets[0]),
            jnp.asarray(imgs[1]), *map(jnp.asarray, targets[1]))
        got_l, got_u = port._student_step(
            port.state, torch.from_numpy(imgs[0]), *map(torch.from_numpy, targets[0]),
            torch.from_numpy(imgs[1]), *map(torch.from_numpy, targets[1]))
        np.testing.assert_allclose(got_l.numpy(), np.asarray(items_l), rtol=1e-5)
        np.testing.assert_allclose(got_u.numpy(), np.asarray(items_u), rtol=1e-5)
        assert port.state.step == int(state.step) == 1 and port.state.optimizer.updates == 301
        pairs = {
            "params": (flax_from_state_dict(port.state.model.state_dict()), state.params),
            "ema": (flax_from_state_dict(port.state.ema_model.state_dict()), state.ema_params),
        }
        errs = []
        for name, (got, want) in pairs.items():
            for part, w in (("params", want), ("batch_stats", state.batch_stats if name ==
                                                "params" else state.ema_batch_stats)):
                errs += _delta_errs(got[part], jax.device_get(w), student[part], f"{name}/{part}")
    # every tensor moves: kernels, BN scales and biases by the optimizer,
    # the BN statistics in both forwards, the EMA after them
    assert len(errs) > 100 and all(e[2] > 0 for e in errs), [e for e in errs if e[2] == 0][:3]
    # 1e-4 of the change, and 1e-7 of the scale: JAX's EMA rate is an f32
    worst = max(errs, key=lambda e: e[1] / (1e-4 * e[2] + 1e-7 * e[3]))
    assert worst[1] <= 1e-4 * worst[2] + 1e-7 * worst[3], worst


def _delta_errs(got, want, start, path):
    """(path, max|got - want|, max|want - start|, max|want|) per tensor."""
    if hasattr(want, "items"):
        out = []
        for k in want:
            out += _delta_errs(got[k], want[k], start[k], f"{path}/{k}")
        return out
    g, w, s = (np.asarray(x, np.float64) for x in (got, want, start))
    return [(path, np.abs(g - w).max(), np.abs(w - s).max(), np.abs(w).max())]


def test_teacher_of_a_width_without_kernel_raises():
    """The early-network kernel is built for stems of 16, 32, 48, 64 or 80
    channels. ``can_fuse_early_model`` does not look at widths (the shipped
    ``yolov5_depth1.5_width1.05_800.yaml``, a stem of 72, passes it), so a
    teacher of another width asked to run with the kernel raises, naming
    the width, and runs on cuDNN with ``early_pipeline=False``."""
    from ayolov2_torch.models import build_model
    from ayolov2_torch.ops import early_pipeline as early
    from ayolov2_torch.train.kd_trainer import make_teacher
    from ayolov2_torch.utils.config import load_yaml

    big = build_model(load_yaml(ROOT / "res/configs/model/yolov5_depth1.5_width1.05_800.yaml"),
                      nc=NC, device="meta")
    assert early.can_fuse_early_model(big) and big.model[0].conv.out_channels == 72
    teacher = build_model(tiny_cfg(), device="cpu").fuse()
    with pytest.raises(ValueError, match="c0=8 .*16, 32, 48, 64 or 80 channels"):
        make_teacher(teacher, "cpu")
    serve = make_teacher(teacher, "cpu", early_pipeline=False)
    det, n = serve(torch.from_numpy(_images(2, 3)))
    assert not serve.early and det.shape[0] == 2 and n.shape == (2,)


def test_producer_error_reaches_train_and_nothing_hangs():
    """A ``make_pseudo_batch`` that raises in the producer thread makes
    ``train()`` raise within its bound, naming the cause; the thread is
    stopped and joined. (The JAX package's trainer waits forever there.)"""
    from ayolov2_torch.train import kd_trainer

    teacher = _variables(5, plant=True)

    class Labeled:
        max_labels = 64

        def __len__(self):
            return 3

        def __iter__(self):
            from ayolov2_torch.data import Batch

            for _ in range(3):
                yield Batch(_images(4, 1), np.zeros((256, 6), np.float32),
                            np.zeros(256, bool), [""] * 4, [None] * 4, 0)

    class Unlabeled:
        def __len__(self):
            return 1

        def __iter__(self):
            yield type("B", (), {"images": _images(4, 2)})()

    with tempfile.TemporaryDirectory() as tmp:
        _, port = _trainers(4, tmp, teacher, _variables(6))
        port.labeled_loader, port.unlabeled_loader = Labeled(), Unlabeled()
        port.PSEUDO_TIMEOUT_S = 30.0

        def broken(images):
            raise OSError("unreadable unlabeled image")

        port.make_pseudo_batch = broken
        t0 = time.monotonic()
        with pytest.raises(kd_trainer.PseudoProducerError) as err:
            port.train()
        assert isinstance(err.value.__cause__, OSError)
        assert time.monotonic() - t0 < 30.0
        assert port._producer is None
        assert not any(t.name == "pseudo-labels" for t in threading.enumerate())
        # a producer that stalls: the wait is bounded
        def stalled(images):
            time.sleep(3)
            raise OSError("too late")

        port.PSEUDO_TIMEOUT_S = 1.0
        port.make_pseudo_batch = stalled
        with pytest.raises(TimeoutError):
            port.train()
        assert port._producer is None


def test_distillation_cli_on_cpu(tmp_path, monkeypatch):
    """``cli.distillation --device cpu`` with ``distillation.yaml`` cut to 2
    epochs of bs 4 at 64 px: a checkpoint teacher, step = ema_updates = the
    micro-steps, a pseudo batch made for each step (the producer runs
    ahead), best.ckpt and last.ckpt that ``cli.val`` reads; without a card
    and without ``--device cpu`` it raises."""
    import json

    from _torch_port_common import train_files
    from ayolov2_torch.cli import distillation, val
    from ayolov2_torch.models import build_model, init_model
    from ayolov2_torch.utils.checkpoint import load_checkpoint, write_checkpoint
    from ayolov2_torch.utils.config import load_yaml
    from ayolov2_torch.utils.weights import flax_from_state_dict

    model_cfg, data, _ = train_files(tmp_path)
    mc = load_yaml(model_cfg)
    v = flax_from_state_dict(init_model(build_model(mc, nc=3, device="cpu"), seed=1).state_dict())
    teacher = tmp_path / "teacher.ckpt"
    write_checkpoint(teacher, {"meta": {"model_cfg": json.dumps(mc), "epoch": 0, "step": 0,
                                        "ema_updates": 0}, "model": v, "ema": v})
    text = (ROOT / "res/configs/cfg/distillation.yaml").read_text()
    for a, b in (("epochs: 10", "epochs: 2"), ("batch_size: 16", "batch_size: 4"),
                 ("image_size: 640", "image_size: 64"), ("workers: 4", "workers: 1\n  half: false")):
        assert a in text
        text = text.replace(a, b)
    cfg = tmp_path / "kd.yaml"
    cfg.write_text(text)
    args = ["--model", str(model_cfg), "--teacher", str(teacher), "--data", str(data), "--cfg",
            str(cfg), "--log-dir", str(tmp_path / "runs"), "--teacher-device", "1"]
    trainer = distillation.main(args + ["--device", "cpu"])
    meta = load_checkpoint(trainer.wdir / "last.ckpt")["meta"]
    assert meta["step"] == meta["ema_updates"] == trainer.state.step == 4 and meta["epoch"] == 1
    assert len(trainer.pseudo_counts) >= 4 and trainer._producer is None
    result = val.main(["--weights", str(trainer.wdir / "best.ckpt"), "--data-cfg", str(data),
                       "-iw", "64", "--batch-size", "4", "--device", "cpu", "--no-half"])
    assert result["seen"] == 8 and 0 <= result["map50"] <= 1
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        distillation.main(args)
