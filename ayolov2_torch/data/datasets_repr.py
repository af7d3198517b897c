"""Datasets for representation learning: n augmented views of each image.

The counterpart of ``ayolov2_tpu/data/datasets_repr.py``. An item is
``n_trans`` views of one letterboxed image, each drawn from the dataset's
``np.random.Generator`` with the JAX package's calls in its order, so the
views are equal to JAX's for the same seed: cv2's resize is
``image_io.resize_linear`` and its gray conversions are
``image_ops.bgr2gray`` / ``gray2bgr``, each equal to OpenCV's output.
:class:`RLDataLoader` lays a batch out image-major, the layout the losses
of ``loss/losses_repr.py`` pair on. :func:`crop_and_save_bboxes` makes the
box-crop image set.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import List, Optional, Sequence, Union

import numpy as np

from ayolov2_torch.data import image_ops
from ayolov2_torch.data.augment import MultiAugmentationPolicies, augment_hsv
from ayolov2_torch.data.datasets import ImageFolderDataset, letterbox
from ayolov2_torch.data.image_io import imread, imwrite, resize_linear

LOGGER = logging.getLogger(__name__)


class RLImageDataset(ImageFolderDataset):
    """``n_trans`` views per image: the named policies, the HSV jitter and a
    horizontal flip with p 0.5, each view in turn."""

    def __init__(
        self,
        path: Union[str, Sequence[str]],
        img_size: int = 320,
        batch_size: int = 16,
        n_skip: int = 0,
        stride: int = 32,
        n_trans: int = 2,
        augmentation: Optional[List[dict]] = None,
        seed: int = 0,
    ) -> None:
        super().__init__(path, img_size, batch_size, rect=False, stride=stride, n_skip=n_skip)
        self.n_trans = n_trans
        self.policies = MultiAugmentationPolicies(augmentation) if augmentation else None
        self.rng = np.random.default_rng(seed)

    def _augment_view(self, img: np.ndarray) -> np.ndarray:
        view = img.copy()
        if self.policies is not None:
            view, _ = self.policies(view, np.zeros((0, 5), np.float32), self.rng)
        augment_hsv(view, self.rng)
        if self.rng.random() < 0.5:
            view = np.fliplr(view)
        return np.ascontiguousarray(view)

    def __getitem__(self, index: int):
        """(views (n_trans, H, W, 3) uint8, path, ((h0, w0), (ratio, pad)))."""
        im, (h0, w0), _ = self.load_image(index)
        im, ratio, pad = letterbox(im, self.target_shape(index), stride=self.stride, auto=False)
        views = np.stack([self._augment_view(im) for _ in range(self.n_trans)])
        return views, self.img_files[index], ((h0, w0), (ratio, pad))


class SimCLRDataset(RLImageDataset):
    """SimCLR's views: a random resized crop (scale 0.2-1, aspect 3/4-4/3),
    a horizontal flip with p 0.5, the HSV jitter (gains 0.1, 0.4, 0.4) and
    gray with p 0.2."""

    def _augment_view(self, img: np.ndarray) -> np.ndarray:
        h, w = img.shape[:2]
        rng = self.rng
        scale = rng.uniform(0.2, 1.0)
        ar = rng.uniform(3 / 4, 4 / 3)
        cw = int(min(w, np.sqrt(w * h * scale * ar)))
        ch = int(min(h, np.sqrt(w * h * scale / ar)))
        x0 = int(rng.integers(0, max(w - cw, 1)))
        y0 = int(rng.integers(0, max(h - ch, 1)))
        view = resize_linear(np.ascontiguousarray(img[y0: y0 + ch, x0: x0 + cw]), (w, h))
        if rng.random() < 0.5:
            view = np.fliplr(view).copy()
        augment_hsv(view, rng, hgain=0.1, sgain=0.4, vgain=0.4)
        if rng.random() < 0.2:
            view = image_ops.gray2bgr(image_ops.bgr2gray(view))
        return np.ascontiguousarray(view)


class RLDataLoader:
    """Batches of view items, image-major: (bs * n_trans, H, W, 3) with rows
    [img0_v0, img0_v1, img1_v0, ...], and the items' paths. Drops the last
    partial batch; ``shuffle`` permutes with ``seed + epoch``."""

    def __init__(self, dataset, batch_size: int = 16, shuffle: bool = False, seed: int = 0) -> None:
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0

    def __len__(self) -> int:
        return len(self.dataset) // self.batch_size

    def __iter__(self):
        order = np.arange(len(self.dataset))
        if self.shuffle:
            order = np.random.default_rng(self.seed + self.epoch).permutation(order)
        for i in range(0, len(order) - self.batch_size + 1, self.batch_size):
            items = [self.dataset[int(j)] for j in order[i: i + self.batch_size]]
            views = np.stack([it[0] for it in items])  # (bs, n_trans, H, W, 3)
            yield views.reshape(-1, *views.shape[2:]), [it[1] for it in items]
        self.epoch += 1


def _source_image(label_path: Path) -> Optional[Path]:
    """The image of a label file: ``.jpg`` (the JAX package's only source),
    else a ``.bmp``."""
    base = Path(str(label_path).replace("labels", "images"))
    for suffix in (".jpg", ".bmp"):
        if base.with_suffix(suffix).exists():
            return base.with_suffix(suffix)
    return None


def crop_and_save_bboxes(img_dir: str, save_dir: str, min_size: int = 32) -> int:
    """Crop every labelled box of at least ``min_size`` pixels a side into
    ``save_dir/{stem}_{index:03d}{suffix}``; returns the number of crops.

    The labels are read from ``img_dir`` with ``images`` replaced by
    ``labels``. Box corners are truncated to pixels as the JAX package does.
    A ``.jpg`` source gives a ``.jpg`` crop, read and written by the port's
    JPEG codec (the bytes ``cv2.imwrite`` writes); a ``.bmp`` source, which
    the JAX package does not take, gives a ``.bmp`` crop."""
    save = Path(save_dir)
    save.mkdir(parents=True, exist_ok=True)
    label_dir = Path(str(img_dir).replace("images", "labels"))
    n = 0
    for label_path in sorted(label_dir.glob("*.txt")):
        img_path = _source_image(label_path)
        if img_path is None:
            continue
        try:
            img = imread(str(img_path))
        except OSError:  # unreadable: skipped, as cv2.imread's None is
            continue
        h, w = img.shape[:2]
        for idx, line in enumerate(label_path.read_text().splitlines()):
            parts = line.split()
            if len(parts) < 5:
                continue
            _, cx, cy, bw, bh = map(float, parts[:5])
            x0, bw_px = int((cx - bw / 2) * w), int(bw * w)
            y0, bh_px = int((cy - bh / 2) * h), int(bh * h)
            if bw_px >= min_size and bh_px >= min_size:
                crop = img[max(y0, 0): y0 + bh_px, max(x0, 0): x0 + bw_px]
                imwrite(str(save / f"{img_path.stem}_{idx:03d}{img_path.suffix}"),
                        np.ascontiguousarray(crop))
                n += 1
    LOGGER.info("wrote %d box crops to %s", n, save_dir)
    return n
