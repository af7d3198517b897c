"""Datasets: image folders, and images with YOLO labels.

The counterpart of ``ayolov2_tpu/data/datasets.py`` without augmentation:
recursive glob over ``IMG_EXTS``, the shape scan cached beside the images,
rect batches (aspect-ratio buckets rounded up to stride multiples),
``letterbox`` with the same padding split and fill, label files (boxes or
segment polygons) and the ``mem`` image cache. Items are HWC BGR uint8 and
(n, 5) [cls, xywh-normalised] labels, as in the JAX package.

Images are read and resized by ``data/image_io.py`` (no OpenCV for .bmp).
Training without augmentation (``yolo_augmentation.augment: false``, mosaic
0, no policies, as the memorisation configs train) uses the same items:
``get_item(index, salt)`` is the loader's entry, ``labels`` / ``segments``
feed auto-anchor and the class weights. Training-time augmentation (mosaic,
mixup, copy-paste, perspective, policies, HSV, on-device plans) is not
ported yet and raises, naming the later slice.
"""

from __future__ import annotations

import hashlib
import logging
import pickle
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from ayolov2_torch.data.image_io import image_size, imread, resize_area, resize_linear
from ayolov2_torch.utils.boxes import xywh2xyxy, xyxy2xywh
from ayolov2_torch.utils.constants import IMG_EXTS
from ayolov2_torch.utils.general import segments2boxes

LOGGER = logging.getLogger(__name__)
# the JAX package's key: both packages scan the same files to the same
# shapes and labels, so they share the cache files beside the images
CACHE_VERSION = "ayolo-tpu-v1"


def letterbox(
    im: np.ndarray,
    new_shape: Tuple[int, int],
    stride: int = 32,
    color: Tuple[int, int, int] = (114, 114, 114),
    auto: bool = True,
    scale_fill: bool = False,
    scale_up: bool = True,
) -> Tuple[np.ndarray, Tuple[float, float], Tuple[float, float]]:
    """Resize + pad keeping the aspect ratio.

    Returns (image, (rw, rh) resize ratio, (dw, dh) padding of one side).
    """
    shape = im.shape[:2]  # (h, w)
    r = min(new_shape[0] / shape[0], new_shape[1] / shape[1])
    if not scale_up:
        r = min(r, 1.0)

    ratio = (r, r)
    new_unpad = int(round(shape[1] * r)), int(round(shape[0] * r))
    dw: float = new_shape[1] - new_unpad[0]
    dh: float = new_shape[0] - new_unpad[1]

    if auto:
        dw, dh = dw % stride, dh % stride
    elif scale_fill:
        dw, dh = 0.0, 0.0
        new_unpad = (new_shape[1], new_shape[0])
        ratio = (new_shape[1] / shape[1], new_shape[0] / shape[0])

    dw /= 2
    dh /= 2

    if shape[::-1] != new_unpad:
        im = resize_linear(im, new_unpad)
    top, bottom = int(round(dh - 0.1)), int(round(dh + 0.1))
    left, right = int(round(dw - 0.1)), int(round(dw + 0.1))
    fill = np.asarray(color, np.uint8)
    out = np.empty((im.shape[0] + top + bottom, im.shape[1] + left + right, 3), np.uint8)
    out[...] = fill
    out[top:top + im.shape[0], left:left + im.shape[1]] = im
    return out, ratio, (dw, dh)


def _glob_images(path: Union[str, Path, Sequence[str]]) -> List[str]:
    paths = [path] if isinstance(path, (str, Path)) else list(path)
    files: List[str] = []
    for p in paths:
        p = Path(p)
        if p.is_dir():
            files += [str(f) for f in sorted(p.rglob("*")) if f.suffix.lower() in IMG_EXTS]
        elif p.is_file() and p.suffix.lower() in IMG_EXTS:
            files.append(str(p))
    return files


def _files_hash(files: Sequence[str]) -> str:
    h = hashlib.sha1()
    for f in files:
        h.update(f.encode())
        try:
            h.update(str(Path(f).stat().st_size).encode())
        except OSError:
            pass
    return h.hexdigest()


def _read_cache(path: Path, key: str) -> Optional[Dict[str, Any]]:
    """The cache dict written by this package or the JAX package, if its key
    matches (the files are pickles that either package wrote itself)."""
    if not path.exists():
        return None
    try:
        with open(path, "rb") as f:
            data = pickle.load(f)
    except (OSError, pickle.UnpicklingError, EOFError, AttributeError, ImportError):
        return None
    return data if isinstance(data, dict) and data.get("key") == key else None


def _write_cache(path: Path, data: Dict[str, Any]) -> None:
    try:
        with open(path, "wb") as f:
            pickle.dump(data, f)
    except OSError:
        pass


class ImageFolderDataset:
    """Images only, with the shape scan and rect batches."""

    def __init__(
        self,
        path: Union[str, Path, Sequence[str]],
        img_size: int = 640,
        batch_size: int = 16,
        rect: bool = False,
        pad: float = 0.0,
        stride: int = 32,
        n_skip: int = 0,
        cache_images: Optional[str] = None,
    ) -> None:
        if cache_images not in (None, "mem"):
            raise NotImplementedError(
                f"cache_images={cache_images!r}: only the 'mem' cache is ported so far")
        self.img_size = img_size
        self.stride = stride
        self.rect = rect
        self.pad = pad
        self.batch_size = batch_size

        self.img_files = _glob_images(path)
        if n_skip > 0:
            self.img_files = self.img_files[:: n_skip + 1]
        if not self.img_files:
            raise FileNotFoundError(f"No images found in {path}")

        self.shapes = self._scan_shapes()  # (n, 2) wh
        self.indices = np.arange(len(self.img_files))
        self.batch_idx = np.floor(np.arange(len(self.img_files)) / batch_size).astype(int)
        if rect:
            self._setup_rect_batches()

        self._img_cache: Dict[int, Tuple[np.ndarray, Tuple[int, int], Tuple[int, int]]] = {}
        self.cache_images = cache_images
        if cache_images == "mem":
            for i in range(len(self.img_files)):
                self._img_cache[i] = self._load_image_nocache(i)

    def _cache_path(self) -> Path:
        root = Path(self.img_files[0]).parent
        return root / f".{root.name}_shapes.cache"

    def _scan_shapes(self) -> np.ndarray:
        cache_file = self._cache_path()
        key = _files_hash(self.img_files) + CACHE_VERSION
        cached = _read_cache(cache_file, key)
        if cached is not None:
            return cached["shapes"]
        shapes = []
        for f in self.img_files:
            try:
                shapes.append(image_size(f))
            except (OSError, ValueError) as e:
                LOGGER.warning("Corrupt image %s: %s", f, e)
                shapes.append((self.img_size, self.img_size))
        arr = np.array(shapes, dtype=np.int64)
        _write_cache(cache_file, {"key": key, "shapes": arr})
        return arr

    def _setup_rect_batches(self) -> None:
        ar = self.shapes[:, 1] / self.shapes[:, 0]  # h / w
        irect = ar.argsort()
        self.img_files = [self.img_files[i] for i in irect]
        self.shapes = self.shapes[irect]
        ar = ar[irect]

        nb = self.batch_idx[-1] + 1
        shapes = [[1.0, 1.0]] * nb
        for i in range(nb):
            ari = ar[self.batch_idx == i]
            mini, maxi = ari.min(), ari.max()
            if maxi < 1:
                shapes[i] = [maxi, 1.0]
            elif mini > 1:
                shapes[i] = [1.0, 1.0 / mini]
        self.batch_shapes = (
            np.ceil(np.array(shapes) * self.img_size / self.stride + self.pad).astype(int) * self.stride
        )  # (nb, 2) as (h, w)

    def _load_image_nocache(self, index: int):
        path = self.img_files[index]
        im = imread(path)  # BGR
        h0, w0 = im.shape[:2]
        r = self.img_size / max(h0, w0)
        if r != 1:
            size = (int(w0 * r), int(h0 * r))
            im = resize_area(im, size) if r < 1 else resize_linear(im, size)
        return im, (h0, w0), im.shape[:2]

    def load_image(self, index: int):
        """(image, (h0, w0) native, (h1, w1) after the resize to img_size)."""
        if index in self._img_cache:
            im, orig, resized = self._img_cache[index]
            return im.copy(), orig, resized
        return self._load_image_nocache(index)

    def __len__(self) -> int:
        return len(self.img_files)

    def target_shape(self, index: int) -> Tuple[int, int]:
        return (
            tuple(self.batch_shapes[self.batch_idx[index]])
            if self.rect
            else (self.img_size, self.img_size)
        )

    def __getitem__(self, index: int):
        """(img HWC BGR uint8, (h0, w0), ((h1/h0, w1/w0), pad)).

        The ratio is the whole scale from native to letterboxed content, the
        resize of ``load_image`` and the letterbox's together: what
        ``scale_coords`` takes as ``ratio_pad``.
        """
        im, (h0, w0), (h1, w1) = self.load_image(index)
        shape = self.target_shape(index)
        im, _, pad_wh = letterbox(im, shape, stride=self.stride, auto=False, scale_up=False)
        return im, (h0, w0), ((h1 / h0, w1 / w0), pad_wh)


def _parse_label_file(path: Path) -> Tuple[np.ndarray, List[np.ndarray]]:
    """One label txt -> ((n, 5) [cls, xywh-norm], segments list)."""
    if not path.exists():
        return np.zeros((0, 5), np.float32), []
    with open(path, encoding="utf-8") as f:
        rows = [ln.split() for ln in f.read().strip().splitlines() if len(ln)]
    if not rows:
        return np.zeros((0, 5), np.float32), []
    if any(len(r) > 6 for r in rows):  # segment polygons
        classes = np.array([r[0] for r in rows], np.float32)
        segments = [np.array(r[1:], np.float32).reshape(-1, 2) for r in rows]
        boxes = segments2boxes(segments)
        labels = np.concatenate([classes.reshape(-1, 1), boxes], 1).astype(np.float32)
        return labels, segments
    labels = np.array(rows, dtype=np.float32).reshape(-1, 5)
    if not (labels[:, 1:] <= 1.001).all():
        raise ValueError(f"non-normalized coordinates in {path}")
    return labels, []


def _img2label_path(img_path: str, label_type: str) -> Path:
    p = Path(img_path)
    parts = list(p.parts)
    for i in range(len(parts) - 1, -1, -1):
        if parts[i] == "images":
            parts[i] = label_type
            break
    return Path(*parts).with_suffix(".txt")


_AUGMENTATIONS = ("augment", "mosaic", "mixup", "copy_paste")


class DetectionDataset(ImageFolderDataset):
    """Images + YOLO labels, letterboxed without augmentation (validation,
    and training with augmentation off)."""

    def __init__(
        self,
        path: Union[str, Path, Sequence[str]],
        img_size: int = 640,
        batch_size: int = 16,
        rect: bool = False,
        pad: float = 0.0,
        stride: int = 32,
        n_skip: int = 0,
        cache_images: Optional[str] = None,
        label_type: str = "labels",  # "labels" | "segments"
        yolo_augmentation: Optional[Dict[str, Any]] = None,
        augmentation: Optional[List[Dict]] = None,
        single_cls: bool = False,
        seed: int = 0,
    ) -> None:
        ya = yolo_augmentation or {}
        used = [k for k in _AUGMENTATIONS if ya.get(k)]
        if used or (ya.get("copy_paste2") or {}).get("p") or augmentation:
            raise NotImplementedError(
                f"training-time augmentation ({used or 'policies / copy_paste2'}) is not "
                "ported yet (data/augment.py and data/device_augment.py come with later "
                "slices of the port); train with yolo_augmentation.augment false, mosaic, "
                "mixup and copy_paste 0 and no augmentation policies")
        self.seed = seed
        self.epoch = 0  # published by the DataLoader each epoch
        super().__init__(path, img_size, batch_size, rect, pad, stride, n_skip, cache_images)
        self.label_type = label_type
        self.single_cls = single_cls
        self.labels, self.segments = self._load_labels()
        if single_cls:
            for lab in self.labels:
                lab[:, 0] = 0

    def _load_labels(self) -> Tuple[List[np.ndarray], List[List[np.ndarray]]]:
        cache_file = self._cache_path().with_suffix(".labels")
        key = _files_hash(self.img_files) + CACHE_VERSION + self.label_type
        cached = _read_cache(cache_file, key)
        if cached is not None:
            return cached["labels"], cached["segments"]
        labels, segments = [], []
        n_missing = 0
        for f in self.img_files:
            lab, seg = _parse_label_file(_img2label_path(f, self.label_type))
            if not len(lab):
                n_missing += 1
            labels.append(lab)
            segments.append(seg)
        if n_missing:
            LOGGER.warning("%d / %d images have no labels", n_missing, len(self.img_files))
        _write_cache(cache_file, {"key": key, "labels": labels, "segments": segments})
        return labels, segments

    def enable_device_aug(self, resident: bool = True) -> None:
        raise NotImplementedError("on-device augmentation is not ported yet (a later slice "
                                  "of the port)")

    def __getitem__(self, index: int):
        """(img HWC BGR uint8, (n, 5) [cls, xywh-norm], path, shapes)."""
        return self.get_item(index, 0)

    def get_item(self, index: int, salt: int = 0):
        """``__getitem__`` with the loader's epoch-position salt. Without
        augmentation an item draws nothing, so the salt (which keeps
        repeated indices of weighted sampling apart) changes nothing."""
        index = int(self.indices[index])
        img, (h0, w0), (h1, w1) = self.load_image(index)
        img, ratio, pad = letterbox(img, self.target_shape(index), stride=self.stride,
                                    auto=False, scale_up=False)
        shapes = ((h0, w0), ((h1 / h0, w1 / w0), pad))

        labels = self.labels[index].copy() if self.labels[index].size else np.zeros((0, 5), np.float32)
        if labels.size:
            labels[:, 1:] = xywh2xyxy(labels[:, 1:], ratio=ratio, wh=(w1, h1), pad=pad)
            labels[:, 1:] = xyxy2xywh(labels[:, 1:], wh=img.shape[:2][::-1], clip_eps=1e-3)
        return np.ascontiguousarray(img), labels.astype(np.float32), self.img_files[index], shapes

