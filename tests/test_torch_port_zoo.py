"""The rest of the model zoo against the JAX package: every shipped model
config builds, Focus/SPP (yolov5_v5), MV2Block/MobileViTBlock
(yolov5_mobilevit), the classification tail (simclr, yolov5s_repr), the
space-to-depth stem and the weight bridge, on the same seeded numpy weights
and inputs (training, remat and BN folding: test_torch_port_zoo_train.py)."""

import glob
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_common import (
    ROOT,
    as_np,
    images,
    jax_zoo_shapes,
    jax_zoo_variables,
    nchw,
    port_zoo_model,
    rel_to_peak,
    tree_leaves,
    zoo_cfg,
)

torch.set_num_threads(1)
CONFIGS = sorted(Path(p).stem for p in glob.glob(str(ROOT / "res/configs/model/*.yaml")))


def test_the_shipped_configs_are_the_zoo():
    assert len(CONFIGS) == 11 and {"yolov5_v5", "yolov5_mobilevit", "simclr",
                                   "yolov5s_repr"} <= set(CONFIGS)


@pytest.mark.parametrize("name", CONFIGS)
def test_param_counts_and_strides_equal_jax(name):
    """Every config of ``res/configs/model`` builds (on the meta device) with
    JAX's parameter count and strides."""
    from ayolov2_tpu.models.builder import count_params as jax_count
    from ayolov2_torch.models import build_model, count_params

    jm, shapes = jax_zoo_shapes(name)
    model = build_model(zoo_cfg(name), device="meta")
    assert count_params(model) == jax_count(shapes["params"])
    assert model.strides == tuple(jm.strides)


@pytest.mark.parametrize("name", ["yolov5_v5", "yolov5_mobilevit", "simclr", "yolov5s_repr",
                                  "yolov5_depth1.5_width1.05_800"])
def test_eval_forward_equals_jax(name):
    """f32, 64x64, BN with drawn statistics: raw maps per level (the
    embedding for the headless graphs) within 1e-4 of the peak of JAX's."""
    jm, v = jax_zoo_variables(name, seed=11)
    x = images((2, 64, 64, 3), seed=12).astype(np.float32) / 255.0
    want = jax.jit(lambda v, x: jm.apply(v, x, training=False))(v, jnp.asarray(x))
    model = port_zoo_model(name, v)
    with torch.no_grad():
        got = model(nchw(x))
    if isinstance(want, tuple):
        assert len(got[1]) == len(want[1]) == 3
        for g, w in zip(got[1], want[1]):
            assert g.shape == w.shape
            assert rel_to_peak(as_np(g), w) < 1e-4
        assert rel_to_peak(as_np(got[0]), want[0]) < 1e-4
    else:
        assert got.shape == want.shape == (2, 128)
        assert rel_to_peak(as_np(got), want) < 1e-4


@pytest.mark.parametrize("mode", [True, "reshape", "slice", "im2col"])
def test_s2d_stem_equals_the_plain_stem(mode):
    """yolov5s with its 6x6/s2 stem computed by space-to-depth (layer 0
    only): the same parameters, raw maps within 1e-5 of the plain stem's
    (which equals JAX's, test_torch_port_model.py), folded too."""
    from ayolov2_torch.models import build_model

    _, v = jax_zoo_variables("yolov5s", seed=17)
    x = images((2, 64, 96, 3), seed=18).astype(np.float32) / 255.0
    plain = port_zoo_model("yolov5s", v)
    s2d = port_zoo_model("yolov5s", v, s2d_stem=mode)
    assert s2d.model[0].s2d == ("reshape" if mode is True else mode)
    assert all(getattr(m, "s2d", None) is None for m in list(s2d.model)[1:])
    with torch.no_grad():
        want, got = plain(nchw(x), training=True), s2d(nchw(x), training=True)
        fused = s2d.fuse()(nchw(x), training=True)
    for g, w, f in zip(got, want, fused):
        assert rel_to_peak(as_np(g), as_np(w)) < 1e-5
        assert rel_to_peak(as_np(f), as_np(w)) < 1e-4
    with pytest.raises(ValueError, match="s2d_stem"):
        build_model(zoo_cfg("yolov5s"), device="meta", s2d_stem="tiles")


@pytest.mark.parametrize("name", ["yolov5_v5", "yolov5_mobilevit", "simclr"])
def test_bridge_round_trip_on_every_name(name):
    """flax -> state_dict -> flax is the identity on every leaf, the 3-D
    attention kernels and the 2-D Dense ones included, and the state_dict
    loads strictly into the port's model."""
    from ayolov2_torch.utils.weights import flax_from_state_dict, state_dict_from_flax

    _, v = jax_zoo_variables(name, seed=21)
    sd = state_dict_from_flax(v)
    model = port_zoo_model(name, v)
    assert set(model.state_dict()) == set(sd)
    back = flax_from_state_dict(model.state_dict())
    want, got = tree_leaves(v["params"]), tree_leaves(back["params"])
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape and np.array_equal(got[k], want[k]), k
    wstats, gstats = tree_leaves(v["batch_stats"]), tree_leaves(back["batch_stats"])
    assert set(gstats) == set(wstats)
    names = {p for k in want for p in k}
    if name == "yolov5_mobilevit":
        assert {"tr0", "ln1", "ln2", "ln_out", "attn", "query", "key", "value", "out", "fc1",
                "fc2", "expand", "depthwise", "project", "local_conv", "proj_in", "proj_out",
                "fusion"} <= names
        assert want[("model_5", "tr0", "attn", "query", "kernel")].shape == (144, 4, 36)
        assert want[("model_5", "tr0", "attn", "out", "kernel")].shape == (4, 36, 144)
    if name == "simclr":
        assert want[("model_12", "fc", "kernel")].shape == (512, 512)


def test_port_written_mobilevit_checkpoint_is_read_by_jax(tmp_path):
    """A checkpoint the port writes (f32 leaves) holds what JAX's
    ``load_variables`` reads and JAX's forward on it equals the port's."""
    from ayolov2_tpu.utils.checkpoint import load_variables
    from ayolov2_torch.models.builder import parse_model_config
    from ayolov2_torch.utils.checkpoint import checkpoint_payload, load_model, write_checkpoint

    jm, v = jax_zoo_variables("yolov5_mobilevit", seed=22)
    model = port_zoo_model("yolov5_mobilevit", v)
    state = types.SimpleNamespace(model=model, ema_model=model, ema_updates=3, step=3)
    path = tmp_path / "mvit.ckpt"
    write_checkpoint(path, checkpoint_payload(state, epoch=0, half=False, include_optimizer=False,
                                              model_cfg=parse_model_config(
                                                  zoo_cfg("yolov5_mobilevit"))))
    read, meta = load_variables(path)
    want, got = tree_leaves(v["params"]), tree_leaves(read["params"])
    assert set(got) == set(want) and all(np.array_equal(got[k], want[k]) for k in want)
    x = images((1, 64, 64, 3), seed=23).astype(np.float32) / 255.0
    _, raw = jax.jit(lambda v, x: jm.apply(v, x, training=False))(read, jnp.asarray(x))
    back = load_model(path, device="cpu")
    with torch.no_grad():
        _, mine = back(nchw(x))
    for g, w in zip(mine, raw):
        assert rel_to_peak(as_np(g), w) < 1e-4


def test_out_xyxy_equals_jax():
    """``build_model(out_xyxy=True)`` decodes boxes as xyxy, as JAX's."""
    from ayolov2_tpu.models import build_model as jax_build

    _, v = jax_zoo_variables("yolov5_v5", seed=24)
    jm = jax_build(zoo_cfg("yolov5_v5"), dtype=jnp.float32, out_xyxy=True)
    x = images((1, 64, 64, 3), seed=25).astype(np.float32) / 255.0
    want, _ = jax.jit(lambda v, x: jm.apply(v, x, training=False))(v, jnp.asarray(x))
    model = port_zoo_model("yolov5_v5", v, out_xyxy=True)
    with torch.no_grad():
        got, _ = model(nchw(x))
        plain, _ = port_zoo_model("yolov5_v5", v)(nchw(x))
    assert rel_to_peak(as_np(got), want) < 1e-4
    assert torch.allclose(got[..., 2:4] - got[..., 0:2], plain[..., 2:4], atol=1e-3)
