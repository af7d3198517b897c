"""Targets for the YOLOv5 loss.

The counterpart of ``pad_targets`` in ``ayolov2_tpu/loss/yolo_loss.py``;
``ComputeLoss`` comes with the training slice.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np


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
