"""The geometry half of the training augmentations (numpy, no OpenCV).

The counterpart of the draws and label math of ``ayolov2_tpu/data/
augment.py``: the HSV gains, the random perspective matrix and the warp of
the labels. The on-device planner (``DetectionDataset.plan_item``) consumes
them in the JAX package's seeded order, and ``data/device_augment.py``
renders the pixels on the card. The host pixel path (``augment_hsv``, the
warp of ``random_perspective``, mixup, copy-paste and the pixel policies)
is not ported yet.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ayolov2_torch.utils.general import box_candidates, resample_segments, segment2box

# the named transforms of the policy engine: flips (and Affine) move labels,
# the rest change pixels only
GEOMETRIC_POLICIES = ("HorizontalFlip", "VerticalFlip", "Affine")
PIXEL_POLICIES = ("Blur", "MedianBlur", "ToGray", "CLAHE", "RandomBrightnessContrast",
                  "RandomGamma", "ImageCompression", "Solarize", "Sharpen", "Cutout")


def hsv_gains(rng: np.random.Generator, hgain: float, sgain: float,
              vgain: float) -> Optional[np.ndarray]:
    """The HSV jitter's random gains, or None when HSV is off (no draw)."""
    if not (hgain or sgain or vgain):
        return None
    return rng.uniform(-1, 1, 3) * [hgain, sgain, vgain] + 1


def rotation_matrix_2d(angle: float, center: Tuple[float, float], scale: float) -> np.ndarray:
    """``cv2.getRotationMatrix2D``: (2, 3) rotation by ``angle`` degrees
    (counter-clockwise) and scale about ``center``, with OpenCV's formula
    (the centre a float32 point, as cv2 takes it)."""
    a = angle * (math.pi / 180)
    alpha = math.cos(a) * scale
    beta = math.sin(a) * scale
    cx, cy = (float(np.float32(c)) for c in center)
    return np.array([[alpha, beta, (1 - alpha) * cx - beta * cy],
                     [-beta, alpha, beta * cx + (1 - alpha) * cy]])


def perspective_matrix(
    im_shape: Tuple[int, int],
    rng: np.random.Generator,
    degrees: float = 10,
    translate: float = 0.1,
    scale: float = 0.1,
    shear: float = 10,
    perspective: float = 0.0,
    border: Tuple[int, int] = (0, 0),
) -> Tuple[np.ndarray, float, int, int]:
    """The random perspective warp, drawn without touching pixels.

    Returns (M, s, width, height): M maps input (canvas) to output
    coordinates, s is the scale draw, (width, height) the output size. The
    draw order (P, angle, scale, shear x 2, translate x 2) and the product
    T @ S @ R @ P @ C are the JAX package's, so both consume one stream."""
    height = im_shape[0] + border[0] * 2
    width = im_shape[1] + border[1] * 2

    C = np.eye(3)
    C[0, 2] = -im_shape[1] / 2
    C[1, 2] = -im_shape[0] / 2

    P = np.eye(3)
    P[2, 0] = rng.uniform(-perspective, perspective)
    P[2, 1] = rng.uniform(-perspective, perspective)

    R = np.eye(3)
    a = rng.uniform(-degrees, degrees)
    s = rng.uniform(1 - scale, 1 + scale)
    R[:2] = rotation_matrix_2d(angle=a, center=(0, 0), scale=s)

    S = np.eye(3)
    S[0, 1] = math.tan(rng.uniform(-shear, shear) * math.pi / 180)
    S[1, 0] = math.tan(rng.uniform(-shear, shear) * math.pi / 180)

    T = np.eye(3)
    T[0, 2] = rng.uniform(0.5 - translate, 0.5 + translate) * width
    T[1, 2] = rng.uniform(0.5 - translate, 0.5 + translate) * height

    return T @ S @ R @ P @ C, float(s), width, height


def perspective_targets(
    targets: np.ndarray,
    segments: Sequence[np.ndarray],
    M: np.ndarray,
    s: float,
    width: int,
    height: int,
    perspective: float,
) -> np.ndarray:
    """Targets (n, 5) [cls, xyxy] through the warp ``M``, filtered by
    ``box_candidates``; with segments, each box is the one around its warped
    polygon (resampled to 1000 points)."""
    n = len(targets)
    if n:
        use_segments = any(x.any() for x in segments)
        new = np.zeros((n, 4))
        if use_segments:
            segments = resample_segments(list(segments))
            for i, segment in enumerate(segments):
                xy = np.ones((len(segment), 3))
                xy[:, :2] = segment
                xy = xy @ M.T
                xy = xy[:, :2] / xy[:, 2:3] if perspective else xy[:, :2]
                new[i] = segment2box(xy, width, height)
        else:
            xy = np.ones((n * 4, 3))
            xy[:, :2] = targets[:, [1, 2, 3, 4, 1, 4, 3, 2]].reshape(n * 4, 2)
            xy = xy @ M.T
            xy = (xy[:, :2] / xy[:, 2:3] if perspective else xy[:, :2]).reshape(n, 8)
            x = xy[:, [0, 2, 4, 6]]
            y = xy[:, [1, 3, 5, 7]]
            new = np.concatenate((x.min(1), y.min(1), x.max(1), y.max(1))).reshape(4, n).T
            new[:, [0, 2]] = new[:, [0, 2]].clip(0, width)
            new[:, [1, 3]] = new[:, [1, 3]].clip(0, height)

        i = box_candidates(box1=targets[:, 1:5].T * s, box2=new.T,
                           area_thr=0.01 if use_segments else 0.10)
        targets = targets[i]
        targets[:, 1:5] = new[i]

    return targets


class MultiAugmentationPolicies:
    """Named transform policies with probabilities (the train config's
    ``augmentation``)::

        - policy: {Blur: {p: 0.01}, HorizontalFlip: {p: 0.5}}
          prob: 1.0

    Unknown names raise here. The planner reads ``policies`` and plans the
    flips; applying a policy to pixels on the host is not ported yet.
    """

    def __init__(self, policies: Optional[List[Dict]] = None) -> None:
        self.policies = policies or []
        for pol in self.policies:
            for name in pol.get("policy", {}):
                if name not in PIXEL_POLICIES and name not in GEOMETRIC_POLICIES:
                    raise ValueError(f"Unknown augmentation transform: {name}")

    def __call__(self, img: np.ndarray, labels: np.ndarray, rng: np.random.Generator):
        raise NotImplementedError(
            "applying augmentation policies to pixels on the host is not ported yet; it comes "
            "with the host-augmentation slice of the port (flips are planned and rendered on "
            "the card with train.device_aug)")
