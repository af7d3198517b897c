"""The port's model graph against the JAX package's on the same weights."""

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
    port_model,
    rel_to_peak,
    to_numpy_tree,
)

torch.set_num_threads(1)


@pytest.mark.parametrize("variant,count", [
    ("s", 7_235_389), ("m", 21_190_557), ("l", 46_563_709), ("x", 86_749_405),
])
def test_param_counts_and_strides(variant, count):
    from ayolov2_torch.models import build_model, count_params, yolov5_cfg

    model = build_model(yolov5_cfg(variant), device="meta")
    assert count_params(model) == count
    assert model.strides == (8.0, 16.0, 32.0)


@pytest.mark.parametrize("variant", ["s", "m"])
def test_unfused_eval_forward_matches_jax(variant):
    """f32 raw maps per level, BN in eval mode with perturbed statistics."""
    jmodel, v = jax_init(variant, seed=3)
    x = images((2, 64, 64, 3), seed=4).astype(np.float32) / 255.0
    _, want = jax_apply(jmodel, v, x, training=False)

    model = port_model(variant, v)
    with torch.no_grad():
        decoded, got = model(nchw(x))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.shape == w.shape  # (bs, ny, nx, na, no)
        assert rel_to_peak(as_np(g), w) < 1e-4


def test_fuse_matches_jax_fuse_params_and_unfused_model():
    from ayolov2_tpu.models import fuse_params as jax_fuse
    from ayolov2_torch.models.builder import fuse_params
    from ayolov2_torch.utils.weights import state_dict_from_flax

    _, v = jax_init("s", seed=5)
    want = state_dict_from_flax({"params": to_numpy_tree(jax_fuse(v)["params"])})
    got = fuse_params(state_dict_from_flax(v))
    assert set(got) == set(want)
    for k in got:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=1e-5, atol=1e-5)

    model = port_model("s", v)
    fused = model.fuse()
    assert fused.fused and all(".bn." not in k for k in fused.state_dict())
    x = nchw(images((1, 64, 96, 3), seed=6).astype(np.float32) / 255.0)
    with torch.no_grad():
        a, b = model(x, training=True), fused(x, training=True)
    for p, q in zip(a, b):
        assert rel_to_peak(as_np(q), as_np(p)) < 1e-4


@pytest.mark.parametrize("hw", [(128, 128), (256, 192)])
def test_golden_checkpoint_matches_jax(hw):
    from ayolov2_torch.models import yolov5_cfg

    v = golden_variables()
    jm = jax_model("s", nc=20)
    x = images((1, *hw, 3), seed=7).astype(np.float32) / 255.0
    jdec, want = jax_apply(jm, v, x, training=False)

    model = port_model("s", v, nc=20)
    assert model.nc == 20 and yolov5_cfg("s", nc=20)["n_classes"] == 20
    with torch.no_grad():
        dec, got = model(nchw(x))
    for g, w in zip(got, want):
        assert rel_to_peak(as_np(g), w) < 1e-4
    assert rel_to_peak(as_np(dec), jdec) < 1e-4


def test_start_layer_rejects_skipped_saved_layers():
    from ayolov2_torch.models import build_model, yolov5_cfg

    model = build_model(yolov5_cfg("n"), device="cpu")
    with pytest.raises(ValueError, match="skips saved layers"):
        model(torch.zeros(1, 64, 8, 8), start_layer=5)

