"""Test-time augmentation: the port's ``ops/tta.py`` and ``YoloValidator(tta=True)``
against the JAX package's on the same seeded inputs, f32.

- ``scale_img`` against ``jax.image.resize`` (bilinear, which antialiases
  when it shrinks) and the pad to the grid stride with 0.447, at 0.83 and
  0.67 on square and rect batches: max|d| <= 1e-5;
- ``descale_pred`` and ``clip_augmented``: equal;
- ``inference_with_tta`` on a bridged model (yolov5s at width 0.125, random
  weights) at 64x64 and at 384x672 (a rect batch shape of img 640, pad
  0.5): decoded predictions within 1e-4 of the peak;
- the validator with TTA on the golden checkpoint and the shared labelled
  set (labelled by the non-TTA path's own detections): mAP50 and
  mAP50-95 within 1e-3 of JAX's; the scores and the port's without TTA
  are printed (``-s``);
- ``--tta-cfg``: torch's NCHW flip dims mapped to NHWC axes as JAX's
  ``cli/val.py`` maps them.
"""

import numpy as np
import pytest
import torch

from _torch_port_common import (
    GOLDEN,
    LABELLED_IMG,
    ROOT,
    golden_variables,
    jax_model,
    labelled_set,
    random_variables,
    rel_to_peak,
)

torch.set_num_threads(1)


def _batch(shape, seed):
    return np.random.default_rng(seed).uniform(0, 1, shape).astype(np.float32)


@pytest.mark.parametrize("ratio", [0.83, 0.67])
@pytest.mark.parametrize("shape", [(2, 64, 64, 3), (2, 64, 96, 3), (1, 160, 96, 3)],
                         ids=["square", "rect", "tall"])
def test_scale_img_equals_jax(shape, ratio):
    import jax.numpy as jnp

    from ayolov2_tpu.ops import tta as jt
    from ayolov2_torch.ops import tta as pt

    x = _batch(shape, 3)
    want = np.asarray(jt.scale_img(jnp.asarray(x), ratio, gs=32))
    got = pt.scale_img(torch.from_numpy(x), ratio, gs=32).numpy()
    assert got.shape == want.shape
    assert got.shape[1] % 32 == 0 and got.shape[2] % 32 == 0
    assert float(np.abs(got - want).max()) <= 1e-5
    nh, nw = int(shape[1] * ratio), int(shape[2] * ratio)
    assert np.all(got[:, nh:] == np.float32(0.447)) and np.all(got[:, :, nw:] == np.float32(0.447))


def test_scale_img_antialiases_and_truncates():
    """640 at 0.83 and 0.67 is 531 and 428 pixels (truncated), padded to 544
    and 448; without the antialias the shrink is another function."""
    import torch.nn.functional as F

    from ayolov2_torch.ops.tta import scale_img

    x = torch.from_numpy(_batch((1, 640, 640, 3), 4))
    for ratio, n, padded in ((0.83, 531, 544), (0.67, 428, 448)):
        out = scale_img(x, ratio)
        assert out.shape == (1, padded, padded, 3)
        plain = F.interpolate(x.permute(0, 3, 1, 2), size=(n, n), mode="bilinear",
                              align_corners=False).permute(0, 2, 3, 1)
        assert float((out[:, :n, :n] - plain).abs().max()) > 0.1
    assert scale_img(x, 1.0) is x


def test_descale_and_clip_equal_jax():
    import jax.numpy as jnp

    from ayolov2_tpu.ops import tta as jt
    from ayolov2_torch.ops import tta as pt

    rng = np.random.default_rng(5)
    pred = rng.uniform(0, 100, (2, 84, 9)).astype(np.float32)
    for flip in (None, 1, 2):
        for scale in (1.0, 0.83, 0.67):
            want = np.asarray(jt.descale_pred(jnp.asarray(pred), flip, scale, (96, 64)))
            got = pt.descale_pred(torch.from_numpy(pred), flip, scale, (96, 64)).numpy()
            np.testing.assert_array_equal(got, want)
    ys = [rng.uniform(0, 1, (2, n, 9)).astype(np.float32) for n in (252, 168, 105)]
    want = jt.clip_augmented([jnp.asarray(y) for y in ys], 3, [y.shape[1] for y in ys])
    got = pt.clip_augmented([torch.from_numpy(y) for y in ys], 3, [y.shape[1] for y in ys])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.fixture(scope="module")
def tiny():
    """yolov5s at width 0.125, nc 3: the JAX model, its random f32
    variables and the port's model holding them."""
    import jax
    import jax.numpy as jnp

    from ayolov2_tpu.models import build_model as jax_build
    from ayolov2_torch.models import build_model, yolov5_cfg
    from ayolov2_torch.utils.weights import load_flax_variables

    cfg = yolov5_cfg("s", nc=3)
    cfg["width_multiple"] = 0.125
    jmodel = jax_build(cfg, dtype=jnp.float32)
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3), jnp.float32), training=False))
    variables = random_variables(shapes, 11)
    port = load_flax_variables(build_model(cfg, device="cpu"), variables).eval()
    return jmodel, variables, port


@pytest.mark.parametrize("hw", [(64, 64), (384, 672)], ids=["square", "rect"])
def test_inference_with_tta_equals_jax(tiny, hw):
    import jax.numpy as jnp

    from ayolov2_tpu.ops.tta import inference_with_tta as jax_tta
    from ayolov2_torch.ops.tta import inference_with_tta

    jmodel, variables, port = tiny
    x = _batch((2, *hw, 3), 6)
    want = np.asarray(jax_tta(lambda im: jmodel.apply(variables, im, training=False)[0],
                              jnp.asarray(x), nl=3, gs=32))
    with torch.inference_mode():
        got = inference_with_tta(
            lambda im: port.head.decode(port(im.permute(0, 3, 1, 2), training=True)),
            torch.from_numpy(x), nl=3, gs=32).numpy()
    assert got.shape == want.shape
    assert rel_to_peak(got, want) <= 1e-4


def test_tta_decode_takes_the_serving_forward_on_the_first_branch(tiny):
    """``tta_decode`` through a serving function equals ``inference_with_tta``
    over the model, and its unscaled branch is ``serve.raw_maps`` (counted)."""
    from ayolov2_torch.export import make_serving_fn
    from ayolov2_torch.ops.tta import inference_with_tta, tta_decode

    _, _, port = tiny
    serve = make_serving_fn(port, image_dtype=torch.float32, early_pipeline=False, device="cpu")
    images = torch.from_numpy(np.random.default_rng(7).integers(0, 256, (2, 64, 96, 3),
                                                                  dtype=np.uint8))
    calls = []
    raw_maps = serve.raw_maps
    serve.raw_maps = lambda im: calls.append(im.shape) or raw_maps(im)
    got = tta_decode(serve, images, torch.float32)
    assert calls == [(2, 64, 96, 3)]
    net = serve.model
    with torch.inference_mode():
        want = inference_with_tta(
            lambda im: net.head.decode(net(im.permute(0, 3, 1, 2), training=True)).float(),
            images.float() / 255.0, nl=3, gs=32)
    assert rel_to_peak(got, want.numpy()) <= 1e-4


@pytest.fixture(scope="module")
def golden(tmp_path_factory):
    from ayolov2_tpu.models import fuse_params
    from ayolov2_torch.utils.checkpoint import load_model

    img_dir = labelled_set(tmp_path_factory.mktemp("tta_labelled"))
    port = load_model(GOLDEN / "weights/best.ckpt", nc=20, device="cpu")
    return img_dir, port, jax_model("s", fused=True, nc=20), fuse_params(golden_variables())


@pytest.mark.parametrize("schedule", [{}, dict(tta_scales=[1, 0.67], tta_flips=[None, 1])],
                         ids=["default", "scales-flips"])
def test_validator_with_tta_matches_jax(golden, schedule):
    from ayolov2_tpu.data import DataLoader as JaxLoader, DetectionDataset as JaxDataset
    from ayolov2_tpu.eval import YoloValidator as JaxValidator
    from ayolov2_torch.data import DataLoader, DetectionDataset
    from ayolov2_torch.eval import YoloValidator

    img_dir, port, jmodel, jvars = golden
    cfg = dict(schedule, tta=True, half=False)
    kw = dict(img_size=LABELLED_IMG, batch_size=4, rect=True, pad=0.5)
    validator = YoloValidator(port, DataLoader(DetectionDataset(str(img_dir), **kw), batch_size=4),
                              cfg=dict(cfg, early_pipeline=False), device="cpu")
    assert validator.tta and not validator.use_fused
    got = validator.validation()
    want = JaxValidator(jmodel, jvars, JaxLoader(JaxDataset(str(img_dir), **kw), batch_size=4),
                        cfg=cfg).validation()
    assert got["seen"] == want["seen"] == 9
    for key in ("map50", "map50_95"):
        assert abs(got[key] - want[key]) <= 1e-3, (key, got[key], want[key])
    plain = YoloValidator(port, DataLoader(DetectionDataset(str(img_dir), **kw), batch_size=4),
                          cfg=dict(half=False, early_pipeline=False), device="cpu").validation()
    print(f"TTA {schedule or 'default'}: mAP50 port {got['map50']:.5f} JAX {want['map50']:.5f}, "
          f"mAP50-95 port {got['map50_95']:.5f} JAX {want['map50_95']:.5f}; without TTA "
          f"(port = JAX, test_torch_port_validator.py) mAP50 {plain['map50']:.5f} "
          f"mAP50-95 {plain['map50_95']:.5f}")


def test_tta_cfg_flips_map_to_nhwc_axes(tmp_path):
    import yaml

    from ayolov2_torch.cli.val import load_tta_cfg

    def jax_mapping(path):  # cli/val.py's mapping, as written there
        cfg = yaml.safe_load(open(path)) or {}
        raw = cfg.get("flips")
        return cfg.get("scales"), (None if raw is None else
                                   [None if f is None else {2: 1, 3: 2}[int(f)] for f in raw])

    shipped = ROOT / "res/configs/cfg/tta.yaml"
    assert load_tta_cfg(str(shipped)) == jax_mapping(shipped) == ([1, 0.83, 0.67], [None, 2, None])
    other = tmp_path / "tta.yaml"
    other.write_text("scales: [1, 0.5]\nflips: [2, 3]\n")
    assert load_tta_cfg(str(other)) == jax_mapping(other) == ([1, 0.5], [1, 2])
    only = tmp_path / "scales.yaml"
    only.write_text("scales: [1, 0.75]\n")
    assert load_tta_cfg(str(only)) == jax_mapping(only) == ([1, 0.75], None)
    assert load_tta_cfg(str(tmp_path / "missing.yaml")) == (None, None)
