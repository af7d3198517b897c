"""The fused early network: the port's plain version against the JAX
package's Pallas kernel (interpret mode) and flax layers, and the serving
path built on it. The CUDA kernel itself is checked on the card
(tests/test_torch_port_cuda.py, chip_smoke.py)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_common import (
    as_np,
    golden_variables,
    images,
    jax_apply,
    jax_init,
    jax_model,
    nchw,
    p999_to_peak,
    rel_to_peak,
    to_numpy_tree,
)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def golden():
    """(JAX fused variables, the port's fused model) of the golden checkpoint."""
    from ayolov2_tpu.models import fuse_params as jax_fuse
    from ayolov2_torch.models import build_model, yolov5_cfg
    from ayolov2_torch.utils.weights import load_flax_variables

    fused = {"params": to_numpy_tree(jax_fuse(golden_variables())["params"])}
    model = build_model(yolov5_cfg("s", nc=20), fused=True, device="cpu")
    return fused, load_flax_variables(model, fused)


@pytest.fixture(scope="module")
def interpreted(golden):
    """The JAX kernel in interpret mode, run once per image shape (slow)."""
    from ayolov2_tpu.ops.early_pipeline import early_pipeline, extract_early_params

    cache = {}

    def get(hw, strip_h):
        if hw not in cache:
            ep = extract_early_params(jax.tree_util.tree_map(jnp.asarray, golden[0]))
            imgs = images((2, *hw, 3), seed=hw[1])
            out = early_pipeline(jnp.asarray(imgs), ep, strip_h=strip_h, interpret=True)
            cache[hw] = (imgs, np.asarray(out.astype(jnp.float32)))
        return cache[hw]

    return get


def test_extract_early_params_matches_jax(golden):
    from ayolov2_tpu.ops.early_pipeline import extract_early_params as jax_extract
    from ayolov2_torch.ops.early_pipeline import extract_early_params

    fused, model = golden
    want = jax_extract(jax.tree_util.tree_map(jnp.asarray, fused))
    got = extract_early_params(model.state_dict())
    assert (got.c0, got.c1, got.ch, got.c2, got.n) == (32, 64, 32, 128, 1)
    for name in want._fields:
        w, g = getattr(want, name), getattr(got, name)
        for wi, gi in zip(w if isinstance(w, tuple) else (w,), g if isinstance(g, tuple) else (g,)):
            assert gi.dtype == torch.bfloat16
            np.testing.assert_array_equal(as_np(gi), np.asarray(wi, np.float32).reshape(gi.shape),
                                          err_msg=name)


@pytest.mark.parametrize("hw,strip_h", [((64, 64), 4), ((64, 96), 8)])
def test_ref_matches_jax_interpreted_kernel(golden, interpreted, hw, strip_h):
    from ayolov2_torch.ops.early_pipeline import early_pipeline_ref, extract_early_params

    imgs, want = interpreted(hw, strip_h)
    got = early_pipeline_ref(torch.from_numpy(imgs), extract_early_params(golden[1].state_dict()))
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (2, hw[0] // 8, hw[1] // 8, 128)
    assert rel_to_peak(as_np(got), want) < 0.03
    assert p999_to_peak(as_np(got), want) < 0.015


def test_serving_early_raw_maps_match_jax(golden, interpreted):
    """make_serving_fn(early_pipeline=True): the plain early network, then
    the model from layer 4, against the JAX kernel + start_layer=4."""
    from ayolov2_torch.export import make_serving_fn

    fused, model = golden
    imgs, act = interpreted((64, 64), 4)
    jm = jax_model("s", fused=True, nc=20)
    want = jax_apply(jm, fused, jnp.asarray(act, jnp.bfloat16), training=True, start_layer=4)

    serve = make_serving_fn(model, image_dtype=torch.float32, device="cpu")
    assert serve.early
    got = serve.raw_maps(torch.from_numpy(imgs))
    for g, w in zip(got, want):
        assert rel_to_peak(as_np(g), w) < 0.03


def _flax_early(fused, x):
    """Layers 0..3 as the JAX serving model runs them (flax, bf16)."""
    from ayolov2_tpu.models import layers as L

    p = fused["params"]
    x = x.astype(jnp.bfloat16) / 255.0
    kw = dict(act="SiLU", dtype=jnp.bfloat16, fuse=True)
    c0 = p["model_0"]["conv"]["kernel"].shape[-1]
    c1 = p["model_1"]["conv"]["kernel"].shape[-1]
    c2 = p["model_3"]["conv"]["kernel"].shape[-1]
    n = sum(1 for k in p["model_2"] if k.startswith("m"))
    x = L.ConvBnAct(c0, 6, 2, 2, **kw).apply({"params": p["model_0"]}, x, True)
    x = L.ConvBnAct(c1, 3, 2, **kw).apply({"params": p["model_1"]}, x, True)
    x = L.C3(c1, n=n, **kw).apply({"params": p["model_2"]}, x, True)
    return L.ConvBnAct(c2, 3, 2, **kw).apply({"params": p["model_3"]}, x, True)


def test_ref_yolov5m_depth2_matches_flax_layers():
    from ayolov2_tpu.models import fuse_params as jax_fuse
    from ayolov2_torch.ops.early_pipeline import early_pipeline_ref, extract_early_params
    from ayolov2_torch.utils.weights import state_dict_from_flax

    _, v = jax_init("m", seed=11)
    fused = {"params": to_numpy_tree(jax_fuse(v)["params"])}
    ep = extract_early_params(state_dict_from_flax(fused))
    assert (ep.c0, ep.c1, ep.ch, ep.c2, ep.n) == (48, 96, 48, 192, 2)
    imgs = images((1, 64, 80, 3), seed=12)
    want = np.asarray(jax.jit(_flax_early)(fused, jnp.asarray(imgs)).astype(jnp.float32))
    got = early_pipeline_ref(torch.from_numpy(imgs), ep)
    assert rel_to_peak(as_np(got), want) < 0.03
    assert p999_to_peak(as_np(got), want) < 0.015


def test_ref_then_start_layer4_equals_full_forward(golden):
    from ayolov2_torch.ops.early_pipeline import early_pipeline_ref, extract_early_params

    model = golden[1]
    imgs = images((1, 64, 64, 3), seed=13)
    ep = extract_early_params(model.state_dict())
    with torch.no_grad():
        full = model(nchw(imgs).float() / 255.0, training=True)
        act = early_pipeline_ref(torch.from_numpy(imgs), ep)
        part = model(act.permute(0, 3, 1, 2), training=True, start_layer=4)
    assert len(full) == len(part) == 3
    for f, p in zip(full, part):
        assert rel_to_peak(as_np(p), as_np(f)) < 0.03


def test_can_fuse_early_rejects_non_6x6_stem():
    from ayolov2_torch.models import build_model, yolov5_cfg
    from ayolov2_torch.ops.early_pipeline import can_fuse_early

    specs = build_model(yolov5_cfg("s"), device="meta").specs
    assert can_fuse_early(specs)
    bad = (dataclasses.replace(specs[0], args=(32, 3, 1)),) + specs[1:]
    assert not can_fuse_early(bad)


def test_wrapper_on_cpu_runs_the_plain_version_uncounted(golden):
    from ayolov2_torch.ops import early_pipeline as early

    ep = early.extract_early_params(golden[1].state_dict())
    imgs = torch.from_numpy(images((1, 64, 72, 3), seed=14))
    before = early.early_pipeline.launches
    got = early.early_pipeline(imgs, ep)
    assert early.early_pipeline.launches == before
    assert torch.equal(got, early.early_pipeline_ref(imgs, ep))


@pytest.mark.parametrize("bad", ["float", "odd", "strided", "channels"])
def test_wrapper_rejects_what_the_kernel_does_not_take(golden, bad):
    from ayolov2_torch.ops import early_pipeline as early

    ep = early.extract_early_params(golden[1].state_dict())
    x = torch.from_numpy(images((1, 64, 64, 3), seed=15))
    x = {"float": x.float(), "odd": x[:, :60].contiguous(),
         "strided": torch.from_numpy(images((1, 64, 128, 3), seed=15))[:, :, ::2],
         "channels": torch.cat([x, x[..., :1]], -1)}[bad]
    with pytest.raises(ValueError):
        early.early_pipeline(x, ep)
