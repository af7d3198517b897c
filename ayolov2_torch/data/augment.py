"""The training augmentations on the host (numpy, no OpenCV).

The counterpart of ``ayolov2_tpu/data/augment.py``: the draws and label
math (the HSV gains, the random perspective matrix, the warp of the labels),
which the on-device planner (``DetectionDataset.plan_item``) shares, and the
host pixel path: ``augment_hsv``, ``mixup``, ``cutout``, ``copy_paste``,
``copy_paste2``, ``random_perspective`` and the named policies of
``MultiAugmentationPolicies``. Each function draws from its
``np.random.Generator`` in the JAX package's order, so both packages give
the same labels from the same seed; the pixels come from
``data/image_ops.py``, OpenCV's arithmetic in numpy.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ayolov2_torch.data import image_ops
from ayolov2_torch.utils.boxes import bbox_ioa, xywh2xyxy, xyxy2xywh
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


def augment_hsv(im: np.ndarray, rng: np.random.Generator, hgain: float = 0.5,
                sgain: float = 0.5, vgain: float = 0.5) -> np.ndarray:
    """HSV jitter through one 3-channel LUT, in place on a BGR uint8 image."""
    r = hsv_gains(rng, hgain, sgain, vgain)
    if r is None:
        return im
    x = np.arange(0, 256, dtype=r.dtype)
    table = np.empty((256, 3), im.dtype)
    table[:, 0] = ((x * r[0]) % 180).astype(im.dtype)
    table[:, 1] = np.clip(x * r[1], 0, 255).astype(im.dtype)
    table[:, 2] = np.clip(x * r[2], 0, 255).astype(im.dtype)
    for r in range(0, im.shape[0], 64):  # bands of rows: the temporaries stay in the cache
        band = im[r:r + 64]
        image_ops.hsv2bgr(image_ops.lut(image_ops.bgr2hsv(band), table), dst=band)
    return im


def mixup(im: np.ndarray, labels: np.ndarray, im2: np.ndarray, labels2: np.ndarray,
          rng: np.random.Generator) -> Tuple[np.ndarray, np.ndarray]:
    """Beta(32, 32) blend of two images, their labels concatenated."""
    r = rng.beta(32.0, 32.0)
    im = (im * r + im2 * (1 - r)).astype(np.uint8)
    return im, np.concatenate((labels, labels2), 0)


def cutout(im: np.ndarray, labels: np.ndarray, rng: np.random.Generator,
           p: float = 0.5) -> np.ndarray:
    """Random grey rectangles, in place; drops labels more than 60% hidden."""
    if rng.random() >= p:
        return labels
    h, w = im.shape[:2]
    scales = [0.5] * 1 + [0.25] * 2 + [0.125] * 4 + [0.0625] * 8 + [0.03125] * 16
    for s in scales:
        mask_h = rng.integers(1, max(int(h * s), 2))
        mask_w = rng.integers(1, max(int(w * s), 2))
        xmin = max(0, int(rng.integers(0, w)) - mask_w // 2)
        ymin = max(0, int(rng.integers(0, h)) - mask_h // 2)
        xmax = min(w, xmin + mask_w)
        ymax = min(h, ymin + mask_h)
        im[ymin:ymax, xmin:xmax] = [int(rng.integers(64, 192)) for _ in range(3)]
        if len(labels) and s > 0.03:
            box = np.array([xmin, ymin, xmax, ymax], dtype=np.float32)
            labels = labels[bbox_ioa(box, labels[:, 1:5]) < 0.60]
    return labels


def copy_paste(im: np.ndarray, labels: np.ndarray, segments: List[np.ndarray],
               rng: np.random.Generator, p: float = 0.5):
    """Pastes mirrored copies of a share ``p`` of the segments into the same
    image where they overlap no box by 30% (IoA)."""
    n = len(segments)
    if p and n:
        h, w, _ = im.shape
        im_new = np.zeros(im.shape, np.uint8)
        rows, cols = [h, 0], [w, 0]  # the bounds of what was drawn
        for j in rng.permutation(n)[: round(p * n)]:
            lab, s = labels[j], segments[j]
            box = w - lab[3], lab[2], w - lab[1], lab[4]
            ioa = bbox_ioa(np.asarray(box, np.float32), labels[:, 1:5])
            if (ioa < 0.30).all():
                labels = np.concatenate((labels, [[lab[0], *box]]), 0)
                segments.append(np.concatenate((w - s[:, 0:1], s[:, 1:2]), 1))
                poly = segments[j].astype(np.int32)
                image_ops.fill_polygons(im_new, [poly])
                lo, hi = poly.min(0), poly.max(0)
                rows = [min(rows[0], max(lo[1], 0)), max(rows[1], min(hi[1] + 1, h))]
                cols = [min(cols[0], max(lo[0], 0)), max(cols[1], min(hi[0] + 1, w))]
        if rows[0] < rows[1] and cols[0] < cols[1]:
            # the mirrored AND is zero outside the drawn bounds' mirror image
            r, c = slice(rows[0], rows[1]), slice(cols[0], cols[1])
            result = image_ops.flip(np.bitwise_and(im[r, c], im_new[r, c]), 1)
            target = im[r, w - cols[1]:w - cols[0]]
            i = result > 0
            target[i] = result[i]
    return im, labels, segments


def copy_paste2(im1: np.ndarray, labels1: np.ndarray, seg1: List[np.ndarray], im2: np.ndarray,
                labels2: np.ndarray, seg2: List[np.ndarray], rng: np.random.Generator,
                scale_min: float = 0.35, scale_max: float = 1.0, p: float = 0.5,
                n_trial: int = 5, area_thr: float = 10, ioa_thr: float = 0.3):
    """Pastes objects of ``im2``, scaled, at random free places of ``im1``
    (``n_trial`` tries each)."""
    n = len(seg2)
    if p and n:
        h, w, _ = im1.shape
        im_new = np.zeros(im1.shape, np.uint8)
        for j in rng.permutation(n)[: round(p * n)]:
            label, segment = labels2[j], seg2[j]
            if (int(label[4] - label[2]) * int(label[3] - label[1])) < area_thr:
                continue
            zero_box = label - np.array([0, label[1], label[2], label[1], label[2]])
            zero_seg = segment - label[1:3]
            for _ in range(n_trial):
                sf = rng.uniform(scale_min, scale_max)
                sbox = zero_box[1:] * sf
                max_x = w - (sbox[2] - sbox[0]) - 1
                max_y = h - (sbox[3] - sbox[1]) - 1
                if max_x <= 0 or max_y <= 0:
                    continue
                x = rng.uniform(0, max_x)
                y = rng.uniform(0, max_y)
                new_box = np.concatenate(([label[0]], sbox)) + np.array([0, x, y, x, y])
                ioa = bbox_ioa(new_box[1:5], labels1[:, 1:5]) if len(labels1) else np.zeros(0)
                if (ioa < ioa_thr).all():
                    bw = int(new_box[3]) - int(new_box[1])
                    bh = int(new_box[4]) - int(new_box[2])
                    if bw * bh < area_thr:
                        continue
                    labels1 = np.concatenate((labels1, [new_box]), 0) if len(labels1) else new_box[None]
                    seg1.append(zero_seg * sf + np.array([x, y]))
                    mask = image_ops.fill_polygons(np.zeros(im2.shape, np.uint8),
                                                   [segment.astype(np.int32)])
                    cut = np.bitwise_and(im2, mask)
                    x1, y1, x2, y2 = int(label[1]), int(label[2]), int(label[3]), int(label[4])
                    obj = image_ops.resize_scale(cut[y1:y2, x1:x2, :], sf, sf)
                    px, py = int(x), int(y)
                    im_new[py: py + obj.shape[0], px: px + obj.shape[1], :] = obj
                    break
        i = im_new > 0
        im1[i] = im_new[i]
    return im1, labels1, seg1


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


def random_perspective(im: np.ndarray, targets: np.ndarray, rng: np.random.Generator,
                       segments: Sequence[np.ndarray] = (), degrees: float = 10,
                       translate: float = 0.1, scale: float = 0.1, shear: float = 10,
                       perspective: float = 0.0, border: Tuple[int, int] = (0, 0)):
    """The random centre, perspective, rotation, scale, shear and translation
    warp of the image (border 114) and of its (n, 5) [cls, xyxy] targets."""
    M, s, width, height = perspective_matrix(im.shape[:2], rng, degrees, translate, scale, shear,
                                             perspective, border)
    if (border[0] != 0) or (border[1] != 0) or (M != np.eye(3)).any():
        if perspective:
            im = image_ops.warp_perspective(im, M, (width, height), border=114)
        else:
            im = image_ops.warp_affine(im, M[:2], (width, height), border=114)
    targets = perspective_targets(targets, segments, M, s, width, height, perspective)
    return im, targets


# ---- the named policies: name -> fn(img, rng, **params) -> img ------------------------


def _blur(im, rng, blur_limit=7):
    return image_ops.box_blur(im, int(rng.integers(3, blur_limit + 1)) | 1)


def _median_blur(im, rng, blur_limit=7):
    return image_ops.median_blur(im, int(rng.integers(3, blur_limit + 1)) | 1)


def _to_gray(im, rng):
    return image_ops.gray2bgr(image_ops.bgr2gray(im))


def _clahe(im, rng, clip_limit=4.0, tile_grid_size=(8, 8)):
    lab = image_ops.bgr2lab(im)
    lab[..., 0] = image_ops.clahe(lab[..., 0], clip_limit, tuple(tile_grid_size))
    return image_ops.lab2bgr(lab)


def _brightness_contrast(im, rng, brightness_limit=0.2, contrast_limit=0.2):
    alpha = 1.0 + rng.uniform(-contrast_limit, contrast_limit)
    beta = rng.uniform(-brightness_limit, brightness_limit) * 255
    return image_ops.convert_scale_abs(im, alpha, beta)


def _random_gamma(im, rng, gamma_limit=(80, 120)):
    gamma = rng.uniform(gamma_limit[0], gamma_limit[1]) / 100.0
    table = np.clip(((np.arange(256) / 255.0) ** gamma) * 255.0, 0, 255).astype(np.uint8)
    return image_ops.lut(im, table)


def _image_compression(im, rng, quality_lower=75, quality_upper=100):
    return image_ops.jpeg_roundtrip(im, int(rng.integers(quality_lower, quality_upper + 1)))


def _affine(img, labels, rng, scale=None, translate_percent=None, rotate=None, shear=None):
    """Albumentations-style Affine ranges through ``random_perspective``;
    ``labels`` are (n, 5) [cls, xywh-normalised]."""
    h, w = img.shape[:2]
    lab = labels.copy()
    if len(lab):
        lab[:, 1:] = xywh2xyxy(lab[:, 1:], wh=(w, h))
    degrees = max(abs(rotate[0]), abs(rotate[1])) if rotate else 0.0
    shear_deg = max(abs(shear[0]), abs(shear[1])) if shear else 0.0
    scale_amp = max(abs(1 - scale[0]), abs(scale[1] - 1)) if scale else 0.0
    translate = 0.0
    if translate_percent:
        tx = translate_percent.get("x", [0, 0])
        ty = translate_percent.get("y", [0, 0])
        translate = max(abs(tx[0]), abs(tx[1]), abs(ty[0]), abs(ty[1]))
    img, lab = random_perspective(img, lab, rng, degrees=degrees, translate=translate,
                                  scale=scale_amp, shear=shear_deg, perspective=0.0)
    if len(lab):
        lab[:, 1:] = xyxy2xywh(lab[:, 1:], wh=(w, h), clip_eps=1e-3)
    return img, lab


def _solarize(im, rng, threshold=128):
    table = np.arange(256, dtype=np.uint8)
    table[int(threshold):] = 255 - table[int(threshold):]
    return image_ops.lut(im, table)


def _sharpen(im, rng, alpha=(0.2, 0.5), lightness=(0.5, 1.0)):
    a = rng.uniform(*alpha)
    li = rng.uniform(*lightness)
    kernel = np.array([[-1, -1, -1], [-1, 8 + li, -1], [-1, -1, -1]], np.float32)
    sharp = image_ops.filter2d(im, kernel / max(kernel.sum(), 1e-6))
    return image_ops.add_weighted(im, 1 - a, sharp, a, 0)


def _cutout_holes(im, rng, num_holes=1, max_h_size=128, max_w_size=128, fill_value=0):
    h, w = im.shape[:2]
    out = im.copy()
    for _ in range(int(num_holes)):
        ch = int(rng.integers(1, max_h_size + 1))
        cw = int(rng.integers(1, max_w_size + 1))
        y = int(rng.integers(0, max(h - ch, 1)))
        x = int(rng.integers(0, max(w - cw, 1)))
        out[y: y + ch, x: x + cw] = fill_value
    return out


PIXEL_TRANSFORMS = {
    "Blur": _blur,
    "MedianBlur": _median_blur,
    "ToGray": _to_gray,
    "CLAHE": _clahe,
    "RandomBrightnessContrast": _brightness_contrast,
    "RandomGamma": _random_gamma,
    "ImageCompression": _image_compression,
    "Solarize": _solarize,
    "Sharpen": _sharpen,
    "Cutout": _cutout_holes,
}
assert tuple(PIXEL_TRANSFORMS) == PIXEL_POLICIES


class MultiAugmentationPolicies:
    """Named transform policies with probabilities (the train config's
    ``augmentation``)::

        - policy: {Blur: {p: 0.01}, HorizontalFlip: {p: 0.5}}
          prob: 1.0

    Unknown names raise here. The planner reads ``policies`` and plans the
    flips; ``__call__`` applies them on the host.
    """

    def __init__(self, policies: Optional[List[Dict]] = None) -> None:
        self.policies = policies or []
        for pol in self.policies:
            for name in pol.get("policy", {}):
                if name not in PIXEL_POLICIES and name not in GEOMETRIC_POLICIES:
                    raise ValueError(f"Unknown augmentation transform: {name}")

    def __call__(self, img: np.ndarray, labels: np.ndarray,
                 rng: np.random.Generator) -> Tuple[np.ndarray, np.ndarray]:
        """Applies the policies in order; ``labels`` are (n, 5) [cls,
        xywh-normalised]. Each policy draws its ``prob``, then each of its
        transforms its ``p``, then its own parameters."""
        for pol in self.policies:
            if rng.random() >= pol.get("prob", 1.0):
                continue
            for name, params in pol.get("policy", {}).items():
                params = dict(params or {})
                p = params.pop("p", 0.5)
                if rng.random() >= p:
                    continue
                if name == "HorizontalFlip":
                    img = image_ops.flip(img, 1)
                    if len(labels):
                        labels[:, 1] = 1.0 - labels[:, 1]
                elif name == "VerticalFlip":
                    img = image_ops.flip(img, 0)
                    if len(labels):
                        labels[:, 2] = 1.0 - labels[:, 2]
                elif name == "Affine":
                    img, labels = _affine(img, labels, rng, **params)
                else:
                    img = PIXEL_TRANSFORMS[name](img, rng, **params)
        return img, labels
