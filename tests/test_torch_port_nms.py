"""Decode + NMS: the port against the JAX package on identical f32 inputs
(raw maps of the committed trained checkpoint), exact keep-sets."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_common import golden_variables, images, jax_apply, jax_model

torch.set_num_threads(1)

NMS_TYPES = ["nms", "batched_nms", "fast_nms", "matrix_nms", "merge_nms"]


@pytest.fixture(scope="module")
def golden_outputs():
    """(flat raw maps, decoded predictions, grid constants) as numpy, from
    the golden checkpoint on two 128x128 images."""
    from ayolov2_tpu.models.yolo_head import YOLOHead
    from ayolov2_tpu.ops.nms import flat_grid_meta, flatten_raw_maps

    m = jax_model("s", nc=20)
    x = images((2, 128, 128, 3), seed=21).astype(np.float32) / 255.0
    decoded, raw = jax_apply(m, golden_variables(), x, training=False)
    head = YOLOHead(nc=20, anchors=m.anchors, strides=m.strides)
    meta = flat_grid_meta(m.strides, head.anchor_grid(), (128, 128))
    return np.array(flatten_raw_maps(raw)), np.array(decoded), meta


def _check_same(got, want):
    det, n = (t.numpy() for t in got)
    wdet, wn = (np.asarray(t) for t in want)
    np.testing.assert_array_equal(n, wn)
    assert n.sum() > 0
    np.testing.assert_allclose(det, wdet, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("multi_label", [False, True])
@pytest.mark.parametrize("nms_type", NMS_TYPES)
def test_nms_matches_jax(golden_outputs, nms_type, multi_label):
    from ayolov2_tpu.ops import nms as jnms
    from ayolov2_torch.ops import nms

    flat, decoded, meta = golden_outputs
    kw = dict(conf_thres=0.001, iou_thres=0.65, nms_box=1000, pre_top_k=512,
              keep_top_k=100, multi_label=multi_label, nms_type=nms_type)
    want = jnms.fused_decode_nms(jnp.asarray(flat), *map(jnp.asarray, meta), **kw)
    got = nms.fused_decode_nms(torch.from_numpy(flat), *map(torch.from_numpy, meta), **kw)
    _check_same(got, want)

    want = jnms.batched_nms(jnp.asarray(decoded), **kw)
    got = nms.batched_nms(torch.from_numpy(decoded), **kw)
    _check_same(got, want)


def test_flat_grid_meta_and_flatten_match_jax():
    from ayolov2_tpu.ops import nms as jnms
    from ayolov2_torch.ops import nms

    anchors = np.arange(18, dtype=np.float32).reshape(3, 3, 2) + 1
    for a, b in zip(jnms.flat_grid_meta((8, 16, 32), anchors, (64, 96)),
                    nms.flat_grid_meta((8, 16, 32), anchors, (64, 96))):
        np.testing.assert_array_equal(a, b)
    rng = np.random.default_rng(0)
    raw = [rng.normal(size=(2, 8 // s, 12 // s, 3, 7)).astype(np.float32) for s in (1, 2, 4)]
    np.testing.assert_array_equal(
        nms.flatten_raw_maps([torch.from_numpy(r) for r in raw]).numpy(),
        np.asarray(jnms.flatten_raw_maps([jnp.asarray(r) for r in raw])))


def _sequential_greedy(iou, valid, thr):
    keep = np.zeros_like(valid)
    for j in range(len(valid)):
        keep[j] = valid[j] and not any(keep[i] and iou[i, j] > thr for i in range(j))
    return keep


@pytest.mark.parametrize("thr", [0.3, 0.65])
def test_greedy_suppress_equals_sequential_loop(thr):
    from ayolov2_torch.ops.nms import _box_iou_matrix, _greedy_suppress

    rng = np.random.default_rng(int(thr * 100))
    bs, k = 3, 96
    xy = rng.uniform(0, 100, (bs, k, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(5, 40, (bs, k, 2))], -1).astype(np.float32)
    # a long suppression chain: each box overlaps the next one heavily
    boxes[2, :40] = np.stack([np.arange(40) * 2.0, np.zeros(40), np.arange(40) * 2.0 + 20,
                              np.full(40, 20.0)], -1)
    valid = rng.uniform(size=(bs, k)) > 0.1
    iou = _box_iou_matrix(torch.from_numpy(boxes))
    got = _greedy_suppress(iou, torch.from_numpy(valid), thr).numpy()
    for b in range(bs):
        np.testing.assert_array_equal(got[b], _sequential_greedy(iou[b].numpy(), valid[b], thr))
    assert _greedy_suppress.last_sweeps >= 2


def test_topk_ties_order_like_lax_top_k():
    from ayolov2_tpu.ops import nms as jnms
    from ayolov2_torch.ops import nms

    rng = np.random.default_rng(3)
    # bf16 logits quantised to a few levels: most values tie
    x = np.round(rng.normal(size=(2, 4000)) * 4) / 4
    for k in (7, 512, 1000):
        _, want = jax.lax.top_k(jnp.asarray(x, jnp.bfloat16), k)
        _, got = nms._topk(torch.from_numpy(x).to(torch.bfloat16), k)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    # the same ties through the whole serving tail
    raw = rng.normal(size=(2, 1008, 25)).astype(np.float32)
    raw[..., 4] = np.round(raw[..., 4] * 2) / 2
    raw = np.asarray(jnp.asarray(raw, jnp.bfloat16).astype(jnp.float32))
    strides = (8.0, 16.0, 32.0)
    anchors = np.asarray([[10, 13, 16, 30, 33, 23], [30, 61, 62, 45, 59, 119],
                          [116, 90, 156, 198, 373, 326]], np.float32).reshape(3, 3, 2)
    meta = nms.flat_grid_meta(strides, anchors, (128, 128))
    kw = dict(nms_box=300, pre_top_k=100, keep_top_k=50)
    want = jnms.fused_decode_nms(jnp.asarray(raw, jnp.bfloat16), *map(jnp.asarray, meta), **kw)
    got = nms.fused_decode_nms(torch.from_numpy(raw).to(torch.bfloat16),
                               *map(torch.from_numpy, meta), **kw)
    _check_same(got, want)


def test_detections_to_list():
    from ayolov2_torch.ops.nms import detections_to_list

    det = np.arange(2 * 5 * 6, dtype=np.float32).reshape(2, 5, 6)
    out = detections_to_list(det, np.asarray([3, 0]))
    assert [o.shape for o in out] == [(3, 6), (0, 6)]
    np.testing.assert_array_equal(out[0], det[0, :3])


def test_unknown_nms_type_raises():
    from ayolov2_torch.ops.nms import batched_nms

    with pytest.raises(ValueError, match="Wrong NMS type"):
        batched_nms(torch.zeros(1, 10, 7), nms_type="soft")
