"""Sizing, segment, label-weight, seeding and device helpers."""

from __future__ import annotations

import logging
import math
from typing import List, Optional, Union

import numpy as np
import torch

from ayolov2_torch.utils.boxes import xyxy2xywh

LOGGER = logging.getLogger(__name__)


def make_divisible(x: float, divisor: int, minimum_check_number: int = 0) -> int:
    """Round ``x`` up to a multiple of ``divisor`` (floor if below threshold)."""
    if x <= minimum_check_number:
        return math.floor(x)
    return math.ceil(x / divisor) * divisor


def check_img_size(img_size: int, s: int = 32) -> int:
    """Snap an image size up to a multiple of the stride ``s``, warning on change."""
    new_size = make_divisible(img_size, int(s))
    if new_size != img_size:
        LOGGER.warning("WARNING --img-size %g must be multiple of max stride %g, updating to %g",
                       img_size, s, new_size)
    return new_size


def segment2box(segment: np.ndarray, width: int = 640, height: int = 640) -> np.ndarray:
    """One (n, 2) polygon -> the xyxy box around its points inside the image."""
    x, y = segment.T
    inside = (x >= 0) & (y >= 0) & (x <= width) & (y <= height)
    x, y = x[inside], y[inside]
    if x.size and x.any():
        return np.array([x.min(), y.min(), x.max(), y.max()])
    return np.zeros((1, 4))


def segments2boxes(segments: List[np.ndarray]) -> np.ndarray:
    """Polygons (each (n, 2)) -> (len, 4) xywh boxes around them."""
    boxes = [[s[:, 0].min(), s[:, 1].min(), s[:, 0].max(), s[:, 1].max()] for s in segments]
    return xyxy2xywh(np.array(boxes), check_validity=False)


def resample_segments(segments: List[np.ndarray], n: int = 1000) -> List[np.ndarray]:
    """Each polygon resampled to exactly ``n`` points by linear interpolation."""
    out = []
    for s in segments:
        x = np.linspace(0, len(s) - 1, n)
        xp = np.arange(len(s))
        out.append(np.stack([np.interp(x, xp, s[:, i]) for i in range(2)], axis=-1))
    return out


def box_candidates(box1: np.ndarray, box2: np.ndarray, wh_thr: float = 2, ar_thr: float = 20,
                   area_thr: float = 0.1, eps: float = 1e-16) -> np.ndarray:
    """Which warped boxes to keep (box1 before, box2 after the warp; both
    (4, n) xyxy): wider and taller than ``wh_thr`` pixels, keeping more than
    ``area_thr`` of the area, aspect ratio under ``ar_thr``."""
    w1, h1 = box1[2] - box1[0], box1[3] - box1[1]
    w2, h2 = box2[2] - box2[0], box2[3] - box2[1]
    ar = np.maximum(w2 / (h2 + eps), h2 / (w2 + eps))
    return (w2 > wh_thr) & (h2 > wh_thr) & (w2 * h2 / (w1 * h1 + eps) > area_thr) & (ar < ar_thr)


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The device an entry point runs on: ``device`` if given, else the card.

    Raises when no device is given and CUDA is absent: the port never falls
    back to the CPU on its own.
    """
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    return torch.device("cuda")


def host_to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on ``device``. To the card through pinned memory without
    blocking the host: the copy queues behind the work already issued."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def labels_to_class_weights(labels: List[np.ndarray], nc: int = 80) -> np.ndarray:
    """Inverse-frequency class weights from a list of (n_i, 5) label arrays."""
    if len(labels) == 0 or labels[0] is None:
        return np.array([])
    classes = np.concatenate(labels, 0)[:, 0].astype(int)
    weights = np.bincount(classes, minlength=nc).astype(np.float64)
    weights[weights == 0] = 1
    weights = 1 / weights
    return weights / weights.sum()


def labels_to_image_weights(labels: List[np.ndarray], nc: int = 80,
                            class_weights: Optional[np.ndarray] = None) -> np.ndarray:
    """Per-image sampling weights: the sum over classes of class weight x count."""
    cw = np.ones(nc) if class_weights is None else class_weights
    counts = np.array([np.bincount(lab[:, 0].astype(int), minlength=nc) for lab in labels])
    return (cw.reshape(1, nc) * counts).sum(1)


def init_seeds(seed: int = 0) -> np.random.Generator:
    """Seed Python's, numpy's and torch's global generators; returns a fresh
    numpy Generator. The port's own draws (weights, data order) take
    explicit generators; this covers anything that reads the global ones."""
    import random

    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return np.random.default_rng(seed)
