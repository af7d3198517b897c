"""Box coordinate transforms and IoU, for numpy arrays and torch tensors.

The counterpart of the numpy half of ``ayolov2_tpu/utils/boxes.py``, with
the same formulas in the same order. Every function takes either a numpy
array (the host data pipeline and the metrics) or a torch tensor (on any
device) and returns the same kind.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch

Array = Union[np.ndarray, torch.Tensor]


def _stack(parts, x: Array) -> Array:
    if isinstance(x, torch.Tensor):
        return torch.stack(parts, dim=-1)
    return np.stack(parts, axis=-1)


def _clip(x: Array, lo=None, hi=None) -> Array:
    if isinstance(x, torch.Tensor):
        return torch.clamp(x, min=lo, max=hi)
    return np.clip(x, lo, hi)


def xywh2xyxy(
    x: Array, ratio: Tuple[float, float] = (1.0, 1.0), wh: Tuple[float, float] = (1.0, 1.0),
    pad: Tuple[float, float] = (0.0, 0.0),
) -> Array:
    """(cx, cy, w, h) -> (x1, y1, x2, y2), optionally scaled from normalised
    to pixels by ``ratio`` and ``wh`` and shifted by the letterbox ``pad``."""
    cx, cy, w, h = x[..., 0], x[..., 1], x[..., 2], x[..., 3]
    x1 = ratio[0] * wh[0] * (cx - w / 2) + pad[0]
    y1 = ratio[1] * wh[1] * (cy - h / 2) + pad[1]
    x2 = ratio[0] * wh[0] * (cx + w / 2) + pad[0]
    y2 = ratio[1] * wh[1] * (cy + h / 2) + pad[1]
    return _stack([x1, y1, x2, y2], x)


def xyxy2xywh(
    x: Array, wh: Tuple[float, float] = (1.0, 1.0), clip_eps: Optional[float] = None,
    check_validity: bool = True,
) -> Array:
    """(x1, y1, x2, y2) -> (cx, cy, w, h), normalised by ``wh``.

    ``clip_eps`` has no effect, as in the reference (its clip is overwritten
    by the unclipped columns). ``check_validity`` shrinks w/h symmetrically
    so the box fits in [0, 1] (centre kept), then clips to [1e-12, 1].
    """
    del clip_eps
    x1 = x[..., 0] / wh[0]
    y1 = x[..., 1] / wh[1]
    x2 = x[..., 2] / wh[0]
    y2 = x[..., 3] / wh[1]
    cx = (x1 + x2) / 2
    cy = (y1 + y2) / 2
    w = x2 - x1
    h = y2 - y1
    if check_validity:
        w = w + _clip(cx - w / 2, hi=0.0) * 2
        w = w - (_clip(cx + w / 2, lo=1.0) - 1.0) * 2
        h = h + _clip(cy - h / 2, hi=0.0) * 2
        h = h - (_clip(cy + h / 2, lo=1.0) - 1.0) * 2
    out = _stack([cx, cy, w, h], x)
    if check_validity:
        out = _clip(out, 1e-12, 1.0)
    return out


def xyn2xy(
    x: Array, ratio: Tuple[float, float] = (1.0, 1.0), wh: Tuple[float, float] = (1.0, 1.0),
    pad: Tuple[float, float] = (0.0, 0.0),
) -> Array:
    """Normalised segment points -> pixel coordinates."""
    px = ratio[0] * wh[0] * x[..., 0] + pad[0]
    py = ratio[1] * wh[1] * x[..., 1] + pad[1]
    return _stack([px, py], x)


def _row(values, like: Array) -> Array:
    if isinstance(like, torch.Tensor):
        return torch.tensor(values, dtype=like.dtype, device=like.device)
    return np.asarray(values, dtype=like.dtype)


def clip_coords(boxes: Array, wh: Tuple[float, float]) -> Array:
    """Clip xyxy boxes to [0, w] x [0, h]."""
    lo = _row([0.0, 0.0, 0.0, 0.0], boxes)
    hi = _row([wh[0], wh[1], wh[0], wh[1]], boxes)
    if isinstance(boxes, torch.Tensor):
        return torch.minimum(torch.maximum(boxes, lo), hi)
    return np.clip(boxes, lo, hi)


def scale_coords(
    img1_shape: Tuple[int, int],
    coords: Array,
    img0_shape: Tuple[int, int],
    ratio_pad: Optional[Tuple[Tuple[float, float], Tuple[float, float]]] = None,
) -> Array:
    """xyxy coords in the letterboxed ``img1_shape`` (h, w) -> the native
    ``img0_shape``: remove the pad, divide by the gain, clip. Without
    ``ratio_pad`` the gain and pad are those of a centred letterbox."""
    if ratio_pad is None:
        gain = min(img1_shape[0] / img0_shape[0], img1_shape[1] / img0_shape[1])
        pad = (
            (img1_shape[1] - img0_shape[1] * gain) / 2,
            (img1_shape[0] - img0_shape[0] * gain) / 2,
        )
    else:
        gain = ratio_pad[0][0]
        pad = ratio_pad[1]
    shift = _row([pad[0], pad[1], pad[0], pad[1]], coords)
    return clip_coords((coords - shift) / gain, (img0_shape[1], img0_shape[0]))


def box_area(box: Array) -> Array:
    """Area of xyxy boxes (..., 4) -> (...)."""
    return (box[..., 2] - box[..., 0]) * (box[..., 3] - box[..., 1])


def _max(a: Array, b: Array) -> Array:
    return torch.maximum(a, b) if isinstance(a, torch.Tensor) else np.maximum(a, b)


def _min(a: Array, b: Array) -> Array:
    return torch.minimum(a, b) if isinstance(a, torch.Tensor) else np.minimum(a, b)


def box_iou(box1: Array, box2: Array, eps: float = 1e-7) -> Array:
    """Pairwise IoU of xyxy boxes: (N, 4), (M, 4) -> (N, M)."""
    area1 = box_area(box1)
    area2 = box_area(box2)
    lt = _max(box1[:, None, :2], box2[None, :, :2])
    rb = _min(box1[:, None, 2:4], box2[None, :, 2:4])
    wh = _clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    return inter / (area1[:, None] + area2[None, :] - inter + eps)


def bbox_ioa(box1: Array, box2: Array, eps: float = 1e-7) -> Array:
    """Intersection over box2's area: (4,), (N, 4) -> (N,); (K, 4) -> (K, N)."""
    b1 = box1.reshape(-1, 4)
    lt = _max(b1[:, None, :2], box2[None, :, :2])
    rb = _min(b1[:, None, 2:4], box2[None, :, 2:4])
    wh = _clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    out = inter / (box_area(box2)[None, :] + eps)
    return out[0] if box1.ndim == 1 else out


def bbox_iou(box1: torch.Tensor, box2: torch.Tensor, x1y1x2y2: bool = True,
             g_iou: bool = False, d_iou: bool = False, c_iou: bool = False,
             eps: float = 1e-7) -> torch.Tensor:
    """Elementwise IoU / GIoU / DIoU / CIoU of aligned boxes (..., 4), as
    torch tensors and differentiable (CIoU's alpha is held constant, as the
    JAX package's ``stop_gradient`` holds it)."""
    if x1y1x2y2:
        b1_x1, b1_y1, b1_x2, b1_y2 = box1.unbind(-1)
        b2_x1, b2_y1, b2_x2, b2_y2 = box2.unbind(-1)
    else:  # xywh -> xyxy
        b1_x1, b1_x2 = box1[..., 0] - box1[..., 2] / 2, box1[..., 0] + box1[..., 2] / 2
        b1_y1, b1_y2 = box1[..., 1] - box1[..., 3] / 2, box1[..., 1] + box1[..., 3] / 2
        b2_x1, b2_x2 = box2[..., 0] - box2[..., 2] / 2, box2[..., 0] + box2[..., 2] / 2
        b2_y1, b2_y2 = box2[..., 1] - box2[..., 3] / 2, box2[..., 1] + box2[..., 3] / 2

    inter = (torch.clamp(torch.minimum(b1_x2, b2_x2) - torch.maximum(b1_x1, b2_x1), min=0)
             * torch.clamp(torch.minimum(b1_y2, b2_y2) - torch.maximum(b1_y1, b2_y1), min=0))
    w1, h1 = b1_x2 - b1_x1, b1_y2 - b1_y1 + eps
    w2, h2 = b2_x2 - b2_x1, b2_y2 - b2_y1 + eps
    union = w1 * h1 + w2 * h2 - inter + eps
    iou = inter / union
    if not (g_iou or d_iou or c_iou):
        return iou

    cw = torch.maximum(b1_x2, b2_x2) - torch.minimum(b1_x1, b2_x1)  # convex width
    ch = torch.maximum(b1_y2, b2_y2) - torch.minimum(b1_y1, b2_y1)  # convex height
    if c_iou or d_iou:
        c2 = cw ** 2 + ch ** 2 + eps  # convex diagonal squared
        rho2 = ((b2_x1 + b2_x2 - b1_x1 - b1_x2) ** 2 + (b2_y1 + b2_y2 - b1_y1 - b1_y2) ** 2) / 4
        if d_iou:
            return iou - rho2 / c2
        v = (4 / np.pi ** 2) * (torch.atan(w2 / h2) - torch.atan(w1 / h1)) ** 2
        with torch.no_grad():
            alpha = v / (v - iou + (1 + eps))
        return iou - (rho2 / c2 + v * alpha)
    c_area = cw * ch + eps
    return iou - (c_area - union) / c_area


def wh_iou(wh1: Array, wh2: Array, eps: float = 1e-7) -> Array:
    """IoU of co-centred width-height pairs: (N, 2), (M, 2) -> (N, M)."""
    inter = _min(wh1[:, None, :], wh2[None, :, :]).prod(-1)
    return inter / (wh1[:, None, :].prod(-1) + wh2[None, :, :].prod(-1) - inter + eps)
