"""ComputeLoss and bbox_iou: the port against the JAX package on the same
seeded numpy inputs (items, and d(loss)/d(raw maps), within 1e-5)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_common import as_np

torch.set_num_threads(1)

NA, BS = 3, 2
GRIDS = ((8, 8), (4, 4), (2, 2))
ANCHORS = np.array([[[1.25, 1.625], [2.0, 3.75], [4.125, 2.875]],
                    [[1.875, 3.8125], [3.875, 2.8125], [3.6875, 7.4375]],
                    [[3.625, 2.8125], [4.875, 6.1875], [11.65625, 10.1875]]], np.float32)
HYP = {"box": 0.05, "cls": 0.3, "obj": 0.7, "cls_pw": 1.0, "obj_pw": 1.0, "anchor_t": 4.0}


def case_inputs(nc: int, seed: int):
    """Raw maps and target rows: real rows, rows that collide in one cell
    (and one anchor), small and large boxes, and zero padding rows."""
    rng = np.random.default_rng(seed)
    preds = [rng.normal(0, 1.5, (BS, ny, nx, NA, 5 + nc)).astype(np.float32) for ny, nx in GRIDS]
    rows = []
    for _ in range(7):
        rows.append([rng.integers(0, BS), rng.integers(0, nc), *rng.uniform(0.05, 0.95, 2),
                     *rng.uniform(0.02, 0.6, 2)])
    base = rows[0]
    rows.append([base[0], (base[1] + 1) % nc, base[2] + 0.01, base[3] - 0.01, base[4] * 1.1,
                 base[5] * 0.9])  # the same cells as row 0
    rows.append(list(base))  # an exact duplicate
    targets = np.zeros((14, 6), np.float32)
    targets[: len(rows)] = np.asarray(rows, np.float32)
    mask = np.zeros(14, bool)
    mask[: len(rows)] = True
    return preds, targets, mask


CASES = {
    "nc1": dict(nc=1),
    "nc4": dict(nc=4),
    "smoothing": dict(nc=4, label_smoothing=0.1),
    "focal": dict(nc=4, fl_gamma=1.5),
    "qfocal": dict(nc=4, fl_gamma=2.0, focal_type="qfocal"),
    "bce_blur": dict(nc=4, focal_type="bce_blur"),
    "obj_pw": dict(nc=4, obj_pw=1.3, cls_pw=0.8),
    "image_weight": dict(nc=4, image_weight=True),
}


@pytest.mark.parametrize("name", list(CASES))
def test_compute_loss_matches_jax(name):
    from ayolov2_tpu.loss.yolo_loss import ComputeLoss as JaxLoss

    from ayolov2_torch.loss.yolo_loss import ComputeLoss

    case = dict(CASES[name])
    nc = case.pop("nc")
    use_weight = case.pop("image_weight", False)
    hyp = dict(HYP, **case)
    preds, targets, mask = case_inputs(nc, seed=len(name))
    weight = np.array([1.0, 0.0], np.float32) if use_weight else None
    if use_weight:  # the caller masks the rows of the images weighted 0
        mask = mask & (targets[:, 0] < 1)

    jl = JaxLoss.from_hyp(ANCHORS, nc, hyp)

    def total(ps):
        return jl(ps, jnp.asarray(targets), jnp.asarray(mask),
                  None if weight is None else jnp.asarray(weight))

    @jax.jit
    def run(ps):
        return total(ps)[1], jax.grad(lambda q: total(q)[0])(ps)

    items_j, grads_j = run([jnp.asarray(p) for p in preds])

    tl = ComputeLoss.from_hyp(ANCHORS, nc, hyp)
    ps = [torch.from_numpy(p).requires_grad_(True) for p in preds]
    loss, items = tl(ps, torch.from_numpy(targets), torch.from_numpy(mask),
                     None if weight is None else torch.from_numpy(weight))
    loss.backward()

    np.testing.assert_allclose(as_np(items), np.asarray(items_j), rtol=1e-5, atol=1e-7)
    assert float(as_np(items)[0]) > 0 and float(as_np(items)[1]) > 0
    for g_t, g_j in zip(ps, grads_j):
        g = as_np(g_t.grad)
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, np.asarray(g_j), rtol=1e-5, atol=1e-7)


def test_padded_rows_give_finite_gradients():
    """Only padding rows: the loss is the objectness term alone, with
    finite gradients everywhere."""
    from ayolov2_torch.loss.yolo_loss import ComputeLoss

    preds, targets, mask = case_inputs(4, seed=3)
    tl = ComputeLoss.from_hyp(ANCHORS, 4, HYP)
    ps = [torch.from_numpy(p).requires_grad_(True) for p in preds]
    loss, items = tl(ps, torch.zeros_like(torch.from_numpy(targets)),
                     torch.zeros(len(mask), dtype=torch.bool))
    loss.backward()
    assert float(items[0]) == 0.0 and float(items[2]) == 0.0 and float(items[1]) > 0
    assert all(torch.isfinite(p.grad).all() for p in ps)


@pytest.mark.parametrize("kind", ["iou", "giou", "diou", "ciou"])
@pytest.mark.parametrize("xyxy", [True, False])
def test_bbox_iou_matches_jax(kind, xyxy):
    from ayolov2_tpu.utils.boxes import bbox_iou as jax_iou

    from ayolov2_torch.utils.boxes import bbox_iou

    rng = np.random.default_rng(7)
    a = rng.uniform(0, 10, (64, 4)).astype(np.float32)
    b = rng.uniform(0, 10, (64, 4)).astype(np.float32)
    if xyxy:
        a[:, 2:] = a[:, :2] + rng.uniform(0.1, 5, (64, 2))
        b[:, 2:] = b[:, :2] + rng.uniform(0.1, 5, (64, 2))
    flags = {"giou": dict(g_iou=True), "diou": dict(d_iou=True), "ciou": dict(c_iou=True)}
    kw = flags.get(kind, {})
    want = np.asarray(jax_iou(jnp.asarray(a), jnp.asarray(b), x1y1x2y2=xyxy, **kw))
    got = bbox_iou(torch.from_numpy(a), torch.from_numpy(b), x1y1x2y2=xyxy, **kw)
    np.testing.assert_allclose(as_np(got), want, rtol=1e-6, atol=1e-6)


def test_wh_iou_matches_jax():
    from ayolov2_tpu.utils.boxes import wh_iou as jax_wh

    from ayolov2_torch.utils.boxes import wh_iou

    rng = np.random.default_rng(8)
    a, b = rng.uniform(1, 50, (9, 2)).astype(np.float32), rng.uniform(1, 50, (5, 2)).astype(np.float32)
    np.testing.assert_allclose(as_np(wh_iou(torch.from_numpy(a), torch.from_numpy(b))),
                               np.asarray(jax_wh(jnp.asarray(a), jnp.asarray(b))), rtol=1e-6)
    np.testing.assert_allclose(wh_iou(a, b), np.asarray(jax_wh(jnp.asarray(a), jnp.asarray(b))),
                               rtol=1e-6)
