"""Fixed-shape batched decode + NMS, on the device, in plain torch.

The counterpart of ``ayolov2_tpu/ops/nms.py``. Output contract: fixed
``(bs, keep_top_k, 6)`` [x1 y1 x2 y2 conf cls] zero-padded detections plus
per-image valid counts. All five NMS variants are kept: "nms" /
"batched_nms" (greedy, within-class via the +4096*class offset), "fast_nms",
"matrix_nms" and "merge_nms".

Where the JAX package maps a per-image function over the batch, this module
writes the batch dimension out: per-image gathers become ``torch.gather``
and the greedy suppression is a batched matrix product.

Top-k order. ``lax.top_k`` returns the lower index first among equal
values; ``torch.topk`` promises no order on ties, and the objectness
prefilter runs on bf16 logits, where ties are common. So every top-k here is
a stable descending sort, sliced (:func:`_topk`).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from ayolov2_torch.utils.constants import (
    DEFAULT_CONF_THRESHOLD,
    DEFAULT_IOU_THRESHOLD,
    DEFAULT_KEEP_TOP_K,
    DEFAULT_NMS_BOX,
    DEFAULT_TOP_K,
)

MAX_WH = 4096.0  # class-separation coordinate offset
NMS_TYPES = ("nms", "batched_nms", "fast_nms", "matrix_nms", "merge_nms")


def _topk(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last dim; ties keep the lower index first."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def _gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (bs, N, d), idx (bs, k) -> (bs, k, d)."""
    return torch.gather(x, 1, idx.unsqueeze(-1).expand(-1, -1, x.shape[-1]))


def _xywh2xyxy(b: torch.Tensor) -> torch.Tensor:
    xy, wh = b[..., :2], b[..., 2:4]
    return torch.cat([xy - wh / 2, xy + wh / 2], dim=-1)


def _box_iou_matrix(boxes: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """(..., K, 4) xyxy -> (..., K, K) pairwise IoU."""
    area = (boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])
    lt = torch.maximum(boxes[..., :, None, :2], boxes[..., None, :, :2])
    rb = torch.minimum(boxes[..., :, None, 2:4], boxes[..., None, :, 2:4])
    wh = torch.clamp(rb - lt, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    return inter / (area[..., :, None] + area[..., None, :] - inter + eps)


def _greedy_suppress(iou: torch.Tensor, valid: torch.Tensor, iou_thres: float,
                     graph: bool = False) -> torch.Tensor:
    """Greedy NMS keep-mask over score-descending candidates, batched.

    iou (bs, K, K), valid (bs, K) bool. Sequential semantics: candidate j is
    kept iff valid and no kept i < j has iou[i, j] > thr. Solved as a Jacobi
    fixed point from x = valid: each sweep is one (bs, 1, K) @ (bs, K, K)
    product counting the surviving suppressors of every candidate (0/1
    entries summed in f32, so the counts are exact). The strict upper
    triangle makes the dependencies a DAG, so the fixed point is the greedy
    keep-set; it ends when no image changes.

    ``graph=False``: a Python loop, one host sync per sweep; the sweep count
    of the last call is kept in ``_greedy_suppress.last_sweeps``.
    ``graph=True``: the same sweeps as a ``while_loop`` operator, which
    ``torch.export`` records in the graph (its cond and body return fresh
    tensors, as the operator requires).
    """
    k = iou.shape[-1]
    upper = torch.ones(k, k, dtype=torch.bool, device=iou.device).triu(1)
    sup = ((iou > iou_thres) & upper).float()

    def sweep(x):
        hits = torch.bmm(x.float().unsqueeze(1), sup).squeeze(1)
        return valid & (hits < 0.5)

    if graph:
        from torch._higher_order_ops import while_loop

        def body(x, changed):
            x_new = sweep(x)
            return x_new, (x_new != x).any()

        start = torch.ones((), dtype=torch.bool, device=valid.device)
        x, _ = while_loop(lambda x, changed: changed.any(), body, (valid.clone(), start))
        return x
    x = valid
    sweeps = 0
    while True:
        x_new = sweep(x)
        sweeps += 1
        changed = bool((x_new != x).any())
        x = x_new
        if not changed:
            break
    _greedy_suppress.last_sweeps = sweeps
    return x


_greedy_suppress.last_sweeps = 0


def _suppress_and_select(boxes: torch.Tensor, scores: torch.Tensor, cls: torch.Tensor,
                         valid: torch.Tensor, iou_thres: float, keep_top_k: int,
                         agnostic: bool, nms_type: str,
                         graph: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Class-offset suppression + fixed top-k output, batched over dim 0;
    ``graph``: the greedy loop as an operator (:func:`_greedy_suppress`)."""
    off = torch.zeros_like(cls) if agnostic else cls * MAX_WH
    oboxes = boxes + off[..., None]

    if nms_type in ("nms", "batched_nms", "merge_nms"):
        iou = _box_iou_matrix(oboxes)
        keep = _greedy_suppress(iou, valid, iou_thres, graph)
        if nms_type == "merge_nms":
            w = (iou > iou_thres) & valid[:, None, :]
            w = w.to(boxes.dtype) * scores[:, None, :]
            denom = w.sum(dim=-1, keepdim=True)
            merged = torch.bmm(w, boxes) / torch.clamp(denom, min=1e-12)
            boxes = torch.where(keep[..., None] & (denom > 0), merged, boxes)
        out_scores = scores
    elif nms_type == "fast_nms":
        iou = torch.triu(_box_iou_matrix(oboxes), diagonal=1)
        iou = torch.where(valid[:, None, :] & valid[:, :, None], iou, 0.0)
        keep = (iou.amax(dim=1) < iou_thres) & valid
        out_scores = scores
    else:  # matrix_nms: score decay, keep everything above threshold
        iou = torch.triu(_box_iou_matrix(oboxes), diagonal=1)
        iou = torch.where(valid[:, None, :] & valid[:, :, None], iou, 0.0)
        m = iou.amax(dim=1)[:, :, None]
        decay = torch.exp(-(iou ** 2 - m ** 2) / 0.5).amin(dim=1)
        out_scores = scores * decay
        keep = valid

    final = torch.where(keep, out_scores, torch.full_like(out_scores, -1.0))
    kk = min(keep_top_k, final.shape[-1])
    top_scores, tidx = _topk(final, kk)
    n_valid = (top_scores > 0).sum(dim=-1).to(torch.int32)
    det = torch.cat([_gather_rows(boxes, tidx), top_scores[..., None],
                     torch.gather(cls, 1, tidx)[..., None]], dim=-1)
    det = torch.where((top_scores > 0)[..., None], det, torch.zeros_like(det))
    return det, n_valid


def _select_candidates(confs: torch.Tensor, pre_top_k: int, multi_label: bool):
    """confs (bs, k0, nc) -> (scores, box index, class) of the top candidates."""
    nc = confs.shape[-1]
    if multi_label:
        flat = confs.reshape(confs.shape[0], -1)
        scores, fidx = _topk(flat, min(pre_top_k, flat.shape[-1]))
        return scores, fidx // nc, (fidx % nc).float()
    best = confs.amax(dim=-1)
    scores, bidx = _topk(best, min(pre_top_k, best.shape[-1]))
    cls = torch.gather(torch.argmax(confs, dim=-1), 1, bidx).float()
    return scores, bidx, cls


def batched_nms(prediction: torch.Tensor,
                conf_thres: float = DEFAULT_CONF_THRESHOLD,
                iou_thres: float = DEFAULT_IOU_THRESHOLD,
                nms_box: int = DEFAULT_NMS_BOX,
                pre_top_k: int = DEFAULT_TOP_K,
                keep_top_k: int = DEFAULT_KEEP_TOP_K,
                agnostic: bool = False,
                multi_label: bool = True,
                nms_type: str = "nms",
                graph: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched fixed-shape NMS over decoded (bs, N, 5+nc) predictions
    (xywh pixels, obj, class probabilities); ``graph``: the greedy loop as
    an operator that ``torch.export`` records."""
    if nms_type not in NMS_TYPES:
        raise ValueError(f"Wrong NMS type: {nms_type!r}")
    nms_box = min(nms_box, prediction.shape[1])
    _, oidx = _topk(prediction[..., 4], nms_box)
    x = _gather_rows(prediction, oidx)
    confs = x[..., 5:] * x[..., 4:5]
    scores, bidx, cls = _select_candidates(confs, pre_top_k, multi_label)
    boxes = _xywh2xyxy(_gather_rows(x[..., :4], bidx))
    valid = scores > conf_thres
    return _suppress_and_select(boxes, scores, cls, valid, iou_thres, keep_top_k,
                                agnostic, nms_type, graph)


def flat_grid_meta(strides: Sequence[float], anchor_grid: np.ndarray,
                   img_hw: Tuple[int, int]) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Flattened decode constants in the head's (ny, nx, na) order.

    Returns (grid_xy (N, 2), anchor_wh (N, 2), stride (N, 1)) f32 arrays,
    N = sum over levels of ny*nx*na.
    """
    grids, anchors_flat, strides_flat = [], [], []
    for level, s in enumerate(strides):
        ny, nx = int(img_hw[0] / s), int(img_hw[1] / s)
        na = anchor_grid.shape[1]
        yv, xv = np.meshgrid(np.arange(ny), np.arange(nx), indexing="ij")
        g = np.stack([xv, yv], -1).reshape(ny * nx, 1, 2).repeat(na, 1)
        grids.append(g.reshape(-1, 2))
        anchors_flat.append(np.broadcast_to(anchor_grid[level][None], (ny * nx, na, 2)).reshape(-1, 2))
        strides_flat.append(np.full((ny * nx * na, 1), s))
    return (
        np.concatenate(grids).astype(np.float32),
        np.concatenate(anchors_flat).astype(np.float32),
        np.concatenate(strides_flat).astype(np.float32),
    )


def fused_decode_nms(raw_flat: torch.Tensor, grid_xy: torch.Tensor,
                     anchor_wh: torch.Tensor, stride: torch.Tensor,
                     conf_thres: float = DEFAULT_CONF_THRESHOLD,
                     iou_thres: float = DEFAULT_IOU_THRESHOLD,
                     nms_box: int = DEFAULT_NMS_BOX,
                     pre_top_k: int = DEFAULT_TOP_K,
                     keep_top_k: int = DEFAULT_KEEP_TOP_K,
                     agnostic: bool = False,
                     multi_label: bool = False,
                     nms_type: str = "nms",
                     approx_prefilter: bool = False,
                     graph: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Decode + NMS with the full decode only for the top candidates.

    raw_flat: (bs, N, 5+nc) raw head outputs in any float dtype, in the
    head's ny*nx*na level order (:func:`flatten_raw_maps`). The objectness
    prefilter runs on the raw logits (sigmoid is monotonic); only the
    ``nms_box`` survivors are gathered and decoded in f32.

    ``approx_prefilter`` is taken and the prefilter stays the exact top-k:
    the JAX package's flag selects ``lax.approx_max_k``, an approximate
    top-k of the TPU, which off the TPU returns the exact one (the same 512
    indices of 25200 as ``lax.top_k`` on a CPU), and a GPU has no
    counterpart of it. ``graph``: the greedy loop as an operator that
    ``torch.export`` records (:func:`_greedy_suppress`).
    """
    if nms_type not in NMS_TYPES:
        raise ValueError(f"Wrong NMS type: {nms_type!r}")
    k0 = min(nms_box, raw_flat.shape[1])
    _, oidx = _topk(raw_flat[..., 4], k0)
    rows = torch.sigmoid(_gather_rows(raw_flat, oidx).float())
    xy = (rows[..., 0:2] * 2.0 - 0.5 + grid_xy[oidx]) * stride[oidx]
    wh = (rows[..., 2:4] * 2.0) ** 2 * anchor_wh[oidx]
    confs = rows[..., 5:] * rows[..., 4:5]
    scores, bidx, cls = _select_candidates(confs, pre_top_k, multi_label)
    cxy, cwh = _gather_rows(xy, bidx), _gather_rows(wh, bidx)
    boxes = torch.cat([cxy - cwh / 2, cxy + cwh / 2], dim=-1)
    valid = scores > conf_thres
    return _suppress_and_select(boxes, scores, cls, valid, iou_thres, keep_top_k,
                                agnostic, nms_type, graph)


def flatten_raw_maps(raw: Sequence[torch.Tensor]) -> torch.Tensor:
    """nl raw maps (bs, ny, nx, na, no) -> (bs, N, no), level order kept."""
    return torch.cat([r.reshape(r.shape[0], -1, r.shape[-1]) for r in raw], dim=1)


def detections_to_list(detections: np.ndarray, n_valid: np.ndarray) -> List[np.ndarray]:
    """Host-side: fixed (bs, K, 6) + counts -> per-image (n_i, 6) arrays."""
    return [np.asarray(detections[i, : int(n_valid[i])]) for i in range(len(n_valid))]
