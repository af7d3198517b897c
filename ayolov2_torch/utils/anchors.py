"""Anchor tools: the best-possible-recall check, the k-means fit with its
genetic refinement, and auto-anchor.

The counterpart of ``ayolov2_tpu/utils/anchors.py``, in numpy with the same
seeded draws (``default_rng(seed)`` and scipy's ``kmeans(..., seed=)``,
imported only when a refit runs), so both packages fit the same anchors.
"""

from __future__ import annotations

import logging
from typing import Optional, Sequence, Tuple

import numpy as np

LOGGER = logging.getLogger(__name__)


def _ratio_metric(k: np.ndarray, wh: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Per label: the ratio metric to each anchor, and the best one."""
    r = wh[:, None] / k[None]
    x = np.minimum(r, 1.0 / r).min(2)  # (n, k)
    return x, x.max(1)


def anchor_fitness(k: np.ndarray, wh: np.ndarray, thr: float) -> float:
    """Mean best-ratio metric over the labels where it exceeds 1/thr."""
    _, best = _ratio_metric(k, wh)
    return float((best * (best > 1.0 / thr)).mean())


def bpr_aat(k: np.ndarray, wh: np.ndarray, thr: float) -> Tuple[float, float]:
    """(best possible recall, anchors above the threshold per label)."""
    x, best = _ratio_metric(k, wh)
    aat = float((x > 1.0 / thr).sum(1).mean())
    bpr = float((best > 1.0 / thr).mean())
    return bpr, aat


def _dataset_wh(dataset, img_size: int, augment_jitter: bool = True, seed: int = 0) -> np.ndarray:
    """Label wh in pixels at the train scale, each jittered by U(0.9, 1.1)."""
    shapes = np.array(dataset.shapes, np.float64)  # (n, 2) native (w, h)
    scaled = img_size * shapes / shapes.max(1, keepdims=True)
    rng = np.random.default_rng(seed)
    whs = []
    for s, lab in zip(scaled, dataset.labels):
        if not len(lab):
            continue
        scale = rng.uniform(0.9, 1.1, size=(len(lab), 1)) if augment_jitter else 1.0
        whs.append(lab[:, 3:5] * s[None] * scale)
    wh = np.concatenate(whs, 0) if whs else np.zeros((0, 2))
    return wh[(wh >= 2.0).any(1)]  # drop tiny degenerate boxes


def kmean_anchors(dataset=None, n: int = 9, img_size: int = 640, thr: float = 4.0,
                  gen: int = 1000, wh: Optional[np.ndarray] = None, seed: int = 0,
                  verbose: bool = False) -> np.ndarray:
    """Whitened k-means, then ``gen`` rounds of multiplicative mutation that
    keep fitness gains; returns (n, 2) anchors sorted by area."""
    from scipy.cluster.vq import kmeans

    if wh is None:
        wh = _dataset_wh(dataset, img_size, seed=seed)
    if len(wh) < n:
        raise ValueError(f"need >= {n} labels to fit {n} anchors, have {len(wh)}")

    std = wh.std(0)
    try:
        k, _ = kmeans(wh / std, n, iter=30, seed=seed)
        if len(k) != n:
            raise ValueError("kmeans returned fewer clusters")
        k *= std
    except Exception:  # k-means can return fewer than n clusters on degenerate data
        rng = np.random.default_rng(seed)
        k = rng.uniform(0.1, 1.0, size=(n, 2)) * img_size

    f = anchor_fitness(k, wh, thr)
    rng = np.random.default_rng(seed)
    npr, sigma, mp = k.size, 0.1, 0.9
    for _ in range(gen):
        v = np.ones(npr)
        while (v == 1).all():
            v = ((rng.random(npr) < mp) * rng.standard_normal(npr) * sigma + 1).clip(0.3, 3.0)
        kg = (k.reshape(-1) * v).reshape(-1, 2).clip(min=2.0)
        fg = anchor_fitness(kg, wh, thr)
        if fg > f:
            f, k = fg, kg.copy()
    k = k[np.argsort(k.prod(1))]
    if verbose:
        bpr, aat = bpr_aat(k, wh, thr)
        LOGGER.info("kmean_anchors: fitness=%.4f bpr=%.4f aat=%.2f", f, bpr, aat)
    return k.astype(np.float32)


def check_anchors(dataset, anchors: np.ndarray, strides: Sequence[float], thr: float = 4.0,
                  img_size: int = 640, seed: int = 0) -> Tuple[np.ndarray, bool]:
    """Auto-anchor: refit when the best possible recall is under 0.98 and
    adopt the refit only if it recalls more. Returns (pixel-space anchors
    (nl, na, 2), changed)."""
    anchors = np.asarray(anchors, np.float32).reshape(len(strides), -1, 2)
    wh = _dataset_wh(dataset, img_size, seed=seed)
    if not len(wh):
        return anchors, False
    flat = anchors.reshape(-1, 2)
    bpr, aat = bpr_aat(flat, wh, thr)
    LOGGER.info("autoanchor: current BPR = %.4f, anchors above thr = %.2f", bpr, aat)
    if bpr > 0.98:
        return anchors, False

    LOGGER.info("autoanchor: BPR < 0.98, refitting %d anchors...", flat.shape[0])
    try:
        new = kmean_anchors(dataset, n=flat.shape[0], img_size=img_size, thr=thr, gen=1000,
                            seed=seed)
    except Exception as e:  # too few labels etc.
        LOGGER.warning("autoanchor failed: %s", e)
        return anchors, False
    new_bpr, _ = bpr_aat(new, wh, thr)
    if new_bpr <= bpr:
        LOGGER.info("autoanchor: refit BPR %.4f did not improve, keeping current anchors", new_bpr)
        return anchors, False
    LOGGER.info("autoanchor: adopting refit anchors (BPR %.4f -> %.4f)", bpr, new_bpr)
    return new.reshape(anchors.shape), True
