"""The YOLOv5 detection loss with static shapes, and its padded targets.

The counterpart of ``ayolov2_tpu/loss/yolo_loss.py``: CIoU box loss, BCE
objectness with the per-level balance (4.0, 1.0, 0.4), BCE classification
with label smoothing, the focal / quality-focal / blur modulations, anchor
matching by ratio (max(r, 1/r) < anchor_t) and the three-cell neighbour
offsets (g = 0.5).

``build_targets`` keeps the JAX package's static slots: every (offset in 5,
anchor in na, target row in M) triple is a slot with a validity mask, so
the loss has one shape per batch shape and no host sync. Means are masked
sums over counts. The objectness target takes the largest IoU a cell gets
(``scatter_reduce(..., "amax")``, the counterpart of ``.at[].max``; an
index assignment would leave duplicates undefined on CUDA). Invalid slots
are given a unit box before the IoU, so that padded target rows, whose
terms ``torch.where`` drops, still have finite gradients.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ayolov2_torch.utils.boxes import bbox_iou

# neighbour-cell offsets, bias g = 0.5
_OFF = np.array([[0, 0], [1, 0], [0, 1], [-1, 0], [0, -1]], dtype=np.float32) * 0.5


@functools.lru_cache(maxsize=64)
def _constants(device: torch.device, anchors: Tuple, grids: Tuple[Tuple[int, int], ...]):
    """(anchors (nl, na, 2), offsets (5, 2), the unit box, per-level gains)
    on ``device``, made once: a host-to-device copy in every call would wait
    for the device each time."""
    gains = tuple(torch.tensor([1.0, 1.0, nx, ny, nx, ny], device=device) for ny, nx in grids)
    return (torch.tensor(anchors, dtype=torch.float32, device=device),
            torch.from_numpy(_OFF).to(device),
            torch.tensor([0.5, 0.5, 1.0, 1.0], device=device), gains)


def pad_targets(labels: Sequence[np.ndarray], batch_size: int, max_targets: int
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Per-image (n_i, 5) [cls, xywh-normalised] labels -> fixed (M, 6)
    [img, cls, xywh] rows + (M,) valid mask, M = ``max_targets``; rows past
    M are dropped."""
    out = np.zeros((max_targets, 6), dtype=np.float32)
    mask = np.zeros((max_targets,), dtype=bool)
    k = 0
    for i, lab in enumerate(labels[:batch_size]):
        for row in np.asarray(lab, dtype=np.float32).reshape(-1, 5):
            if k >= max_targets:
                break
            out[k, 0] = i
            out[k, 1:] = row
            mask[k] = True
            k += 1
    return out, mask


def smooth_bce(eps: float = 0.0) -> Tuple[float, float]:
    """Positive and negative BCE targets under label smoothing ``eps``."""
    return 1.0 - 0.5 * eps, 0.5 * eps


def _bce_with_logits(logits: torch.Tensor, targets: torch.Tensor,
                     pos_weight: float = 1.0) -> torch.Tensor:
    return -(pos_weight * targets * F.logsigmoid(logits) + (1.0 - targets) * F.logsigmoid(-logits))


def _focal_scale(logits, targets, gamma: float, alpha: float = 0.25):
    p = torch.sigmoid(logits)
    p_t = targets * p + (1 - targets) * (1 - p)
    alpha_t = targets * alpha + (1 - targets) * (1 - alpha)
    return alpha_t * (1.0 - p_t) ** gamma


def _qfocal_scale(logits, targets, gamma: float, alpha: float = 0.25):
    p = torch.sigmoid(logits)
    alpha_t = targets * alpha + (1 - targets) * (1 - alpha)
    return alpha_t * torch.abs(targets - p) ** gamma


def _bce_blur_scale(logits, targets, blur_alpha: float = 0.05):
    dx = torch.sigmoid(logits) - targets
    return 1.0 - torch.exp((dx - 1.0) / (blur_alpha + 1e-4))


@dataclasses.dataclass(frozen=True)
class ComputeLoss:
    """Static-shape YOLOv5 loss.

    ``anchors``: stride-normalised (nl, na, 2), the head's
    ``stride_anchors()``; ``hyp``: the loss gains and options (box, cls, obj,
    cls_pw, obj_pw, anchor_t, fl_gamma, label_smoothing) as frozen pairs;
    ``focal_type``: "focal" (the default), "qfocal" or "bce_blur".
    """

    anchors: Tuple[Tuple[Tuple[float, float], ...], ...]
    nc: int
    hyp: Tuple[Tuple[str, float], ...]
    focal_type: str = "focal"

    @staticmethod
    def from_hyp(anchors: np.ndarray, nc: int, hyp: Dict[str, Any]) -> "ComputeLoss":
        keys = ("box", "cls", "obj", "cls_pw", "obj_pw", "anchor_t", "fl_gamma", "label_smoothing")
        default = {"cls_pw": 1.0, "obj_pw": 1.0, "anchor_t": 4.0}
        frozen = tuple((k, float(hyp.get(k, default.get(k, 0.0)))) for k in keys)
        a = tuple(tuple(tuple(float(v) for v in anc) for anc in level)
                  for level in np.asarray(anchors))
        return ComputeLoss(anchors=a, nc=nc, hyp=frozen,
                           focal_type=str(hyp.get("focal_type", "focal")))

    @property
    def nl(self) -> int:
        return len(self.anchors)

    @property
    def na(self) -> int:
        return len(self.anchors[0])

    @property
    def balance(self) -> Tuple[float, ...]:
        return (4.0, 1.0, 0.4) if self.nl == 3 else (4.0, 1.0, 0.25, 0.06, 0.02)

    def _modulate(self, bce, logits, targets, gamma: float):
        if self.focal_type == "bce_blur":
            return bce * _bce_blur_scale(logits, targets)
        if gamma <= 0:
            return bce
        scale = _qfocal_scale if self.focal_type == "qfocal" else _focal_scale
        return bce * scale(logits, targets, gamma)

    def __call__(self, preds: List[torch.Tensor], targets: torch.Tensor,
                 target_mask: torch.Tensor, image_weight: Optional[torch.Tensor] = None,
                 reduce: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Loss of nl raw maps (bs, ny, nx, na, 5+nc) against (M, 6) [img,
        cls, x, y, w, h] normalised target rows with their (M,) validity.

        ``image_weight``: (bs,) 0/1, the objectness mean taken over the
        images weighted 1 only (a padded final validation batch; the caller
        masks those images' target rows too).

        ``reduce``: the sum over the ranks of a data axis (an all-reduce)
        when ``preds`` are one rank's part of a global batch. The counts the
        means divide by (each level's matched slots, the images or their
        weights) are then the global batch's, reduced once and detached, and
        ``bs`` is the global batch size: the rank's loss is its share of the
        global sums over the global counts, and the ranks' shares (and their
        gradients) sum to the loss of the global batch on one device.

        Returns (total * bs, [lbox, lobj, lcls, total]); the items carry no
        gradient.
        """
        hyp = dict(self.hyp)
        cp, cn = smooth_bce(hyp["label_smoothing"])
        gamma = hyp["fl_gamma"]
        dev = preds[0].device
        anchors, off, unit_box, gains = _constants(
            dev, self.anchors, tuple((p.shape[1], p.shape[2]) for p in preds))
        na = self.na
        m_t = targets.shape[0]
        bs = preds[0].shape[0]
        targets = targets.to(device=dev, dtype=torch.float32)
        target_mask = target_mask.to(device=dev, dtype=torch.bool)
        b_row = targets[:, 0].long()
        c_row = targets[:, 1].long()

        w = None if image_weight is None else image_weight.to(device=dev, dtype=torch.float32)
        # per level: the box, objectness and class sums and the matched slots
        sums, slots = [], []
        for li, pred in enumerate(preds):
            pred = pred.float()
            ny, nx = pred.shape[1], pred.shape[2]
            gain = gains[li]
            t = targets * gain  # grid units (M, 6)

            # anchor match by ratio
            r = t[None, :, 4:6] / anchors[li][:, None, :]  # (na, M, 2)
            match = (torch.maximum(r, 1.0 / r).amax(-1) < hyp["anchor_t"]) & target_mask[None]

            # neighbour cells
            gxy = t[:, 2:4]
            gxi = gain[2:4] - gxy
            j_m = (torch.remainder(gxy, 1.0) < 0.5) & (gxy > 1.0)
            l_m = (torch.remainder(gxi, 1.0) < 0.5) & (gxi > 1.0)
            off_mask = torch.stack([torch.ones_like(j_m[:, 0]), j_m[:, 0], j_m[:, 1],
                                    l_m[:, 0], l_m[:, 1]])  # (5, M)
            slot = off_mask[:, None, :] & match[None]  # (5, na, M)

            gij = torch.floor(gxy[None] - off[:, None, :])  # (5, M, 2)
            gi = torch.clamp(gij[..., 0], 0, nx - 1).long()
            gj = torch.clamp(gij[..., 1], 0, ny - 1).long()
            shape = slot.shape
            b_f = b_row[None, None, :].expand(shape).reshape(-1)
            a_f = torch.arange(na, device=dev)[None, :, None].expand(shape).reshape(-1)
            gi_s = gi[:, None, :].expand(shape)
            gj_s = gj[:, None, :].expand(shape)
            txy = gxy[None, None] - torch.stack([gi_s, gj_s], -1).float()
            twh = t[None, None, :, 4:6].expand(shape + (2,))
            slot_f = slot.reshape(-1)
            s_n = slot_f.numel()
            tbox_f = torch.cat([txy, twh], -1).reshape(s_n, 4)
            tbox_f = torch.where(slot_f[:, None], tbox_f, unit_box)
            tcls_f = c_row[None, None, :].expand(shape).reshape(-1)
            anc_f = anchors[li][None, :, None, :].expand(shape + (2,)).reshape(s_n, 2)
            gi_f, gj_f = gi_s.reshape(-1), gj_s.reshape(-1)
            slots.append(slot_f.sum().float())

            ps = pred[b_f, gj_f, gi_f, a_f]  # (S, 5+nc)
            pxy = torch.sigmoid(ps[:, 0:2]) * 2.0 - 0.5
            pwh = (torch.sigmoid(ps[:, 2:4]) * 2.0) ** 2 * anc_f
            iou = bbox_iou(torch.cat([pxy, pwh], -1), tbox_f, x1y1x2y2=False, c_iou=True)
            box_sum = torch.where(slot_f, 1.0 - iou, torch.zeros_like(iou)).sum()

            # objectness target: the largest IoU a cell gets, 0 elsewhere
            score = torch.where(slot_f, iou.detach().clamp(min=0.0), torch.zeros_like(iou))
            flat = ((b_f * ny + gj_f) * nx + gi_f) * na + a_f
            tobj = torch.zeros(bs * ny * nx * na, device=dev).scatter_reduce(
                0, flat, score, reduce="amax", include_self=True).reshape(bs, ny, nx, na)
            logit = pred[..., 4]
            obj_bce = self._modulate(_bce_with_logits(logit, tobj, hyp["obj_pw"]), logit, tobj, gamma)
            obj_sum = (obj_bce if w is None else obj_bce * w[:, None, None, None]).sum()

            cls_sum = torch.zeros((), device=dev)
            if self.nc > 1:
                t_cls = torch.full((s_n, self.nc), cn, device=dev)
                t_cls[torch.arange(s_n, device=dev), tcls_f.clamp(0, self.nc - 1)] = cp
                logits = ps[:, 5:]
                cls_bce = self._modulate(_bce_with_logits(logits, t_cls, hyp["cls_pw"]),
                                         logits, t_cls, gamma)
                cls_sum = torch.where(slot_f[:, None], cls_bce, torch.zeros_like(cls_bce)).sum()
            sums.append((box_sum, obj_sum, cls_sum, ny * nx * na))

        # the counts: matched slots per level, the images, their weights
        n_img = torch.full((), float(bs), device=dev)
        counts = torch.stack(slots + [n_img, n_img if w is None else w.sum()])
        if reduce is not None:
            counts = reduce(counts.detach()).detach()
        nl = len(preds)
        images = counts[nl] if w is None else torch.clamp(counts[nl + 1], min=1.0)
        lbox = torch.zeros((), device=dev)
        lobj = torch.zeros((), device=dev)
        lcls = torch.zeros((), device=dev)
        for li, (box_sum, obj_sum, cls_sum, cells) in enumerate(sums):
            n_slots = torch.clamp(counts[li], min=1)
            lbox = lbox + box_sum / n_slots
            lobj = lobj + obj_sum / (images * cells) * self.balance[li]
            lcls = lcls + cls_sum / (n_slots * self.nc)

        lbox = lbox * hyp["box"]
        lobj = lobj * hyp["obj"]
        lcls = lcls * hyp["cls"]
        total = lbox + lobj + lcls
        if reduce is not None:
            bs = counts[nl]
        return total * bs, torch.stack([lbox, lobj, lcls, total]).detach()
