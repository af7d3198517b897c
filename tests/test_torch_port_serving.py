"""The slice end to end on the CPU: uint8 images -> (bs, 100, 6) detections
against the JAX serving function, the host-to-device stream, and the
weight bridge."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_common import (
    golden_variables,
    images,
    jax_init,
    jax_model,
    port_model,
    to_numpy_tree,
)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def golden():
    """(JAX fused model, JAX fused variables, the port's fused model)."""
    from ayolov2_tpu.models import fuse_params as jax_fuse

    v = golden_variables()
    fused = {"params": to_numpy_tree(jax_fuse(v)["params"])}
    return jax_model("s", fused=True, nc=20), fused, port_model("s", v, nc=20).fuse()


def _box_iou(a, b):
    lt, rb = np.maximum(a[:2], b[:2]), np.minimum(a[2:4], b[2:4])
    inter = np.prod(np.clip(rb - lt, 0, None))
    area = lambda x: np.prod(x[2:4] - x[:2])  # noqa: E731
    return inter / (area(a) + area(b) - inter + 1e-9)


def _assert_detections_match(got, want):
    det, n = (t.numpy() for t in got)
    wdet, wn = (np.asarray(t) for t in want)
    assert det.shape == wdet.shape and n.shape == wn.shape
    np.testing.assert_array_equal(n, wn)
    assert n.sum() > 0
    rows = same = 0
    for b in range(len(n)):
        for i in range(int(n[b])):
            rows += 1
            same += int(det[b, i, 5] == wdet[b, i, 5] and _box_iou(det[b, i], wdet[b, i]) > 0.99)
    assert same >= 0.99 * rows, (same, rows)


@pytest.mark.parametrize("fused_decode", [True, False])
def test_serving_matches_jax_on_golden_checkpoint(golden, fused_decode):
    from ayolov2_tpu.export.exporter import make_serving_fn as jax_serving_fn
    from ayolov2_torch.export import make_serving_fn

    jm, fused, model = golden
    imgs = images((2, 256, 256, 3), seed=31)
    jserve = jax.jit(jax_serving_fn(jm, None, image_dtype=jnp.float32,
                                    fused_decode=fused_decode, img_hw=(256, 256)))
    want = jserve(fused, jnp.asarray(imgs))
    serve = make_serving_fn(model, image_dtype=torch.float32, fused_decode=fused_decode,
                            early_pipeline=False, device="cpu")
    assert not serve.early
    got = serve(torch.from_numpy(imgs))
    assert tuple(got[0].shape) == (2, 100, 6) and got[1].dtype == torch.int32
    _assert_detections_match(got, want)


def test_serving_early_path_shapes_and_default_dtype(golden):
    from ayolov2_torch.export import make_serving_fn

    serve = make_serving_fn(golden[2], device="cpu")
    assert serve.early and serve.ep.n == 1
    assert next(serve.model.parameters()).dtype == torch.bfloat16
    assert next(golden[2].parameters()).dtype == torch.float32  # caller's model untouched
    det, n = serve(torch.from_numpy(images((2, 64, 96, 3), seed=32)))
    assert tuple(det.shape) == (2, 100, 6) and tuple(n.shape) == (2,)
    assert torch.isfinite(det).all()
    plain = make_serving_fn(golden[2], fused_decode=False, device="cpu")
    raw = plain.raw_maps(torch.from_numpy(images((1, 64, 64, 3), seed=33)))
    decoded = plain.model.head.decode(raw)
    assert tuple(decoded.shape) == (1, 3 * (64 + 16 + 4), 25)


def test_serve_stream_keeps_order_is_lazy_and_honours_depth():
    from ayolov2_torch.parallel import serve_stream

    def fn(x):
        return x.float() * 2 + 1, x.sum(dim=(1, 2, 3))

    hosts = [images((4, 8, 8, 3), seed=s) for s in range(5)]
    want = [fn(torch.from_numpy(h)) for h in hosts]
    for depth in (1, 2, 3):
        consumed = []

        def feeder():
            for i, h in enumerate(hosts):
                consumed.append(i)
                yield h

        got = []
        for i, out in enumerate(serve_stream(fn, feeder(), depth=depth, device="cpu")):
            got.append(out)
            assert len(consumed) <= i + 1 + depth
            assert len(consumed) >= min(i + depth, len(hosts))
        assert len(got) == len(hosts)
        for (y, ny), (w, nw) in zip(got, want):
            assert torch.equal(y, w) and torch.equal(ny, nw)
    with pytest.raises(ValueError, match="depth"):
        list(serve_stream(fn, hosts, depth=0, device="cpu"))


def test_serve_stream_feeds_the_serving_fn(golden):
    from ayolov2_torch.export import make_serving_fn
    from ayolov2_torch.parallel import serve_stream

    serve = make_serving_fn(golden[2], image_dtype=torch.float32, early_pipeline=False,
                            device="cpu")
    hosts = [images((2, 64, 64, 3), seed=40 + s) for s in range(3)]
    outs = list(serve_stream(serve, hosts, device="cpu"))
    for h, (d, n) in zip(hosts, outs):
        dw, nw = serve(torch.from_numpy(h))
        assert torch.equal(d, dw) and torch.equal(n, nw)


@pytest.mark.parametrize("source", ["s", "m", "golden"])
def test_bridged_weights_load_strict_and_round_trip(source):
    from ayolov2_torch.models import build_model, yolov5_cfg
    from ayolov2_torch.utils.weights import (
        flax_from_state_dict,
        load_flax_variables,
        state_dict_from_flax,
    )

    if source == "golden":
        variant, nc, v = "s", 20, golden_variables()
    else:
        variant, nc = source, 80
        _, v = jax_init(source, seed=51)
    model = build_model(yolov5_cfg(variant, nc=nc), device="cpu")
    load_flax_variables(model, v)  # strict=True inside
    back = flax_from_state_dict(model.state_dict())
    flat_v = jax.tree_util.tree_leaves_with_path(v)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_v) == len(flat_b)
    for path, leaf in flat_v:
        np.testing.assert_array_equal(flat_b[path], leaf)
    sd = state_dict_from_flax(v)
    assert "model.2.m.0.cv1.conv.weight" in sd and "model.24.m.2.bias" in sd
    assert sd["model.0.conv.weight"].shape[1:] == (3, 6, 6)
