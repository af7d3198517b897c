"""Datasets: image folders, and images with YOLO labels.

The counterpart of ``ayolov2_tpu/data/datasets.py``: recursive glob over
``IMG_EXTS``, the shape scan cached beside the images, rect batches
(aspect-ratio buckets rounded up to stride multiples), ``letterbox`` with
the same padding split and fill, label files (boxes or segment polygons)
and the image caches (``mem``, ``dynamic_mem``, and ``disk`` /
``dynamic_disk`` in the JAX package's ``.ayolo.npy`` files). Items are HWC
BGR uint8 and (n, 5) [cls, xywh-normalised] labels, as in the JAX package.

Images are read and resized by ``data/image_io.py`` (no OpenCV for .bmp).
``get_item(index, salt)`` is the loader's entry, ``labels`` / ``segments``
feed auto-anchor and the class weights. By default ``get_item`` augments on
the host as the JAX package does: mosaic (with ``copy_paste`` and
``copy_paste2``) and mixup, or the letterbox with ``copy_paste2`` and the
random perspective (rect batches included), then the named policies, then
the HSV jitter; every draw comes from the item's seeded generator in the JAX
package's order and the pixels from ``data/image_ops.py``. In plan mode
(``enable_device_aug``) ``plan_item`` draws the same geometry, computes the
labels on the host and leaves the pixels to ``data/device_augment.py`` on
the card.
"""

from __future__ import annotations

import hashlib
import logging
import pickle
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from ayolov2_torch.data.augment import (
    MultiAugmentationPolicies,
    augment_hsv,
    copy_paste,
    copy_paste2,
    hsv_gains,
    mixup,
    perspective_matrix,
    perspective_targets,
    random_perspective,
)
from ayolov2_torch.data.image_io import image_size, imread, resize_area, resize_linear
from ayolov2_torch.utils.boxes import xyn2xy, xywh2xyxy, xyxy2xywh
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
        scale_up: bool = False,
    ) -> None:
        self.img_size = img_size
        self.stride = stride
        self.rect = rect
        self.pad = pad
        self.batch_size = batch_size
        self.scale_up = scale_up

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
            im = resize_area(im, size) if (r < 1 and not self.scale_up) else resize_linear(im, size)
        return im, (h0, w0), im.shape[:2]

    def _npy_path(self, index: int) -> Path:
        return Path(self.img_files[index]).with_suffix(".ayolo.npy")

    def load_image(self, index: int, copy: bool = True):
        """(image, (h0, w0) native, (h1, w1) after the resize to img_size).
        ``copy=False`` hands out the cached array itself: only for readers
        that never write to it.

        ``cache_images``: ``mem`` loads every image at construction,
        ``dynamic_mem`` keeps each one once loaded; ``disk`` and
        ``dynamic_disk`` write ``<image>.ayolo.npy`` (``np.save`` of
        ``{"im", "orig", "resized"}``, the JAX package's file, so either
        package reads the other's) and read it on later loads; a file that
        does not load is deleted and written anew."""
        if index in self._img_cache:
            im, orig, resized = self._img_cache[index]
            return (im.copy() if copy else im), orig, resized
        if self.cache_images in ("disk", "dynamic_disk"):
            npy = self._npy_path(index)
            if npy.exists():
                try:
                    data = np.load(npy, allow_pickle=True).item()
                    return data["im"], tuple(data["orig"]), tuple(data["resized"])
                except Exception:  # stale or corrupt: rebuilt below
                    npy.unlink(missing_ok=True)
        item = self._load_image_nocache(index)
        if self.cache_images == "dynamic_mem":
            self._img_cache[index] = item
        elif self.cache_images in ("disk", "dynamic_disk"):
            try:
                np.save(self._npy_path(index), {"im": item[0], "orig": item[1],
                                                "resized": item[2]})
            except OSError:
                pass
        return item

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
        im, _, pad_wh = letterbox(im, shape, stride=self.stride, auto=False,
                                  scale_up=self.scale_up)
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


class DetectionDataset(ImageFolderDataset):
    """Images + YOLO labels, augmented on the host (or, with
    ``enable_device_aug``, planned for the card's renderer)."""

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
        self.yolo_augmentation = yolo_augmentation or {}
        self.augment = bool(self.yolo_augmentation.get("augment", False))
        super().__init__(path, img_size, batch_size, rect, pad, stride, n_skip, cache_images,
                         scale_up=self.augment)
        self.label_type = label_type
        self.single_cls = single_cls
        self.policies = MultiAugmentationPolicies(augmentation) if augmentation else None
        self.seed = seed
        self.epoch = 0  # published by the DataLoader each epoch
        # plan mode (enable_device_aug)
        self.device_aug = False
        self.device_aug_resident = True
        self.resident_frames: Optional[np.ndarray] = None
        self.frame_hw: Optional[np.ndarray] = None

        self.labels, self.segments = self._load_labels()
        if single_cls:
            for lab in self.labels:
                lab[:, 0] = 0

    def _item_rng(self, index: int, salt: int = 0) -> np.random.Generator:
        """The generator of one item's draws, from (seed, epoch, index,
        salt): the same whatever thread builds it, new each epoch, and new
        for each position (``salt``) at which weighted sampling repeats an
        index. The JAX package's stream."""
        return np.random.default_rng(np.random.SeedSequence([self.seed, self.epoch, index, salt]))

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

    def _image_labels(self, idx: int, **to_pixels):
        """(labels (n, 5) [cls, xyxy in pixels], segments in pixels) of one
        image, copies; ``to_pixels`` are ``xywh2xyxy``'s ratio, wh and pad."""
        labels = self.labels[idx].copy() if self.labels[idx].size else np.zeros((0, 5), np.float32)
        segments = [seg.copy() for seg in self.segments[idx]]
        if labels.size:
            labels[:, 1:] = xywh2xyxy(labels[:, 1:], **to_pixels)
            segments = [xyn2xy(x, **to_pixels) for x in segments]
        return labels, segments

    @staticmethod
    def _mosaic_slot(i: int, mc_w: int, mc_h: int, w: int, h: int, s2: int):
        """Slot ``i`` (top left, top right, bottom left, bottom right) of the
        mosaic around (mc_w, mc_h) for a w x h image: its rectangle on the
        2s canvas and the image's top-left corner there."""
        if i == 0:
            x1a, y1a, x2a, y2a = max(mc_w - w, 0), max(mc_h - h, 0), mc_w, mc_h
            x1b, y1b = w - (x2a - x1a), h - (y2a - y1a)
        elif i == 1:
            x1a, y1a, x2a, y2a = mc_w, max(mc_h - h, 0), min(mc_w + w, s2), mc_h
            x1b, y1b = 0, h - (y2a - y1a)
        elif i == 2:
            x1a, y1a, x2a, y2a = max(mc_w - w, 0), mc_h, mc_w, min(s2, mc_h + h)
            x1b, y1b = w - (x2a - x1a), 0
        else:
            x1a, y1a, x2a, y2a = mc_w, mc_h, min(mc_w + w, s2), min(s2, mc_h + h)
            x1b, y1b = 0, 0
        return (x1a, y1a, x2a, y2a), (x1b, y1b)

    def _warp_args(self) -> Dict[str, float]:
        ya = self.yolo_augmentation
        return dict(degrees=ya.get("degrees", 0.0), translate=ya.get("translate", 0.1),
                    scale=ya.get("scale", 0.5), shear=ya.get("shear", 0.0),
                    perspective=ya.get("perspective", 0.0))

    # -- the host path --------------------------------------------------------------

    def load_mosaic(self, index: int, rng: np.random.Generator):
        """The 4-image mosaic on a 2s canvas (fill 114), copy-paste within it
        and from other images, then the random perspective down to s x s.
        Returns (image, labels (n, 5) [cls, xyxy])."""
        s = self.img_size
        half = s // 2
        mc_h, mc_w = (int(rng.uniform(half, 2 * s - half)) for _ in range(2))
        indices = [index] + list(rng.choice(self.indices, 3))
        rng.shuffle(indices)

        mosaic_img = np.full((s * 2, s * 2, 3), 114, dtype=np.uint8)
        mosaic_labels, mosaic_segments = [], []
        for i, idx in enumerate(indices):
            img, _, (h, w) = self.load_image(idx, copy=False)
            (x1a, y1a, x2a, y2a), (x1b, y1b) = self._mosaic_slot(i, mc_w, mc_h, w, h, s * 2)
            mosaic_img[y1a:y2a, x1a:x2a] = img[y1b:y1b + y2a - y1a, x1b:x1b + x2a - x1a]
            labels, segs = self._image_labels(idx, wh=(w, h), pad=(x1a - x1b, y1a - y1b))
            mosaic_labels.append(labels)
            mosaic_segments.extend(segs)

        labels4 = np.concatenate(mosaic_labels, 0)
        for x in (labels4[:, 1:], *mosaic_segments):
            np.clip(x, 1e-3, 2 * s, out=x)

        ya = self.yolo_augmentation
        mosaic_img, labels4, mosaic_segments = copy_paste(
            mosaic_img, labels4, mosaic_segments, rng, p=ya.get("copy_paste", 0.0))
        cp2 = ya.get("copy_paste2") or {}
        if cp2.get("p", 0.0) > 0.0:
            for _ in range(cp2.get("n_img", 3)):
                mosaic_img, labels4, mosaic_segments = self._cross_copy_paste(
                    mosaic_img, labels4, mosaic_segments, rng)
        return random_perspective(mosaic_img, labels4, rng, segments=mosaic_segments,
                                  border=(-half, -half), **self._warp_args())

    def _cross_copy_paste(self, img, labels, segs, rng: np.random.Generator):
        """``copy_paste2`` from a random donor image."""
        cp2 = self.yolo_augmentation.get("copy_paste2") or {}
        j = int(rng.integers(0, len(self.img_files)))
        img2, _, (h2, w2) = self.load_image(j)
        labels2, segs2 = self._image_labels(j, wh=(w2, h2))
        return copy_paste2(
            img, labels, segs, img2, labels2, segs2, rng,
            scale_min=cp2.get("scale_min", 0.35), scale_max=cp2.get("scale_max", 1.0),
            p=cp2.get("p", 0.0), n_trial=cp2.get("n_trial", 5),
            area_thr=cp2.get("area_thr", 10), ioa_thr=cp2.get("ioa_thr", 0.3))

    # -- plan mode: geometry and labels on the host, pixels on the card -------
    #
    # plan_item / plan_mosaic draw in the order of the JAX package's host path
    # (get_item / load_mosaic) and compute the same labels, but leave every
    # pixel to the renderer. Features whose draws interleave with pixel reads
    # (copy_paste, copy_paste2) and pixel-only policies cannot be planned.

    def device_aug_ineligible(self) -> Optional[str]:
        """None when this config can be rendered on the card, else why not."""
        ya = self.yolo_augmentation
        if self.rect:
            return "rect batching (device aug is square-letterbox only)"
        if ya.get("copy_paste", 0.0):
            return "copy_paste > 0 (interleaves RNG with pixel reads; host-only)"
        if (ya.get("copy_paste2") or {}).get("p", 0.0):
            return "copy_paste2 > 0 (interleaves RNG with pixel reads; host-only)"
        if self.policies is not None:
            for pol in self.policies.policies:
                for name in pol.get("policy", {}):
                    if name not in ("HorizontalFlip", "VerticalFlip"):
                        return f"pixel policy {name} (host-only)"
        return None

    def enable_device_aug(self, resident: bool = True) -> None:
        """Switch ``get_item`` to plan mode: items become (plan, labels, path,
        shapes), which the DataLoader collates into ``PlanBatch``es for the
        card's renderer. ``resident=True`` also assembles every source frame
        into one (N, s, s, 3) uint8 array, moved to the card once; otherwise
        each plan carries its own frames."""
        reason = self.device_aug_ineligible()
        if reason:
            raise ValueError(f"device augmentation unsupported: {reason}")
        self.device_aug = True
        self.device_aug_resident = resident
        if resident and self.resident_frames is None:
            self._build_resident_frames()

    def _build_resident_frames(self) -> None:
        s = self.img_size
        n = len(self.img_files)
        LOGGER.info("building resident frame store: %d frames, %.1f MB", n, n * s * s * 3 / 1e6)
        self.resident_frames = np.full((n, s, s, 3), 114, np.uint8)
        self.frame_hw = np.zeros((n, 2), np.int32)
        for i in range(n):
            im, _, (h, w) = self.load_image(i, copy=False)
            self.resident_frames[i, :h, :w] = im
            self.frame_hw[i] = (h, w)

    def _src_hw(self, idx: int) -> Tuple[int, int]:
        """(h1, w1) of a source frame after the resize, without its pixels
        where the resident store knows it."""
        if self.frame_hw is not None:
            return int(self.frame_hw[idx, 0]), int(self.frame_hw[idx, 1])
        return self.load_image(idx, copy=False)[2]

    def plan_mosaic(self, index: int, rng: np.random.Generator, plan: Dict[str, np.ndarray],
                    pair: int) -> np.ndarray:
        """The 4-image mosaic and its warp, planned: fills ``plan``'s slots of
        ``pair`` and returns the warped labels. Draws the centre, the three
        other images, their order, then the perspective warp."""
        s = self.img_size
        half = s // 2
        mc_h, mc_w = (int(rng.uniform(half, 2 * s - half)) for _ in range(2))
        indices = [index] + list(rng.choice(self.indices, 3))
        rng.shuffle(indices)

        mosaic_labels, mosaic_segments = [], []
        for i, idx in enumerate(indices):
            idx = int(idx)
            h, w = self._src_hw(idx)
            (x1a, y1a, x2a, y2a), (x1b, y1b) = self._mosaic_slot(i, mc_w, mc_h, w, h, s * 2)
            plan["src_idx"][pair, i] = idx
            plan["rects"][pair, i] = (x1a, y1a, x2a, y2a)
            plan["offs"][pair, i] = (x1a - x1b, y1a - y1b)
            labels, segs = self._image_labels(idx, wh=(w, h), pad=(x1a - x1b, y1a - y1b))
            mosaic_labels.append(labels)
            mosaic_segments.extend(segs)

        labels4 = np.concatenate(mosaic_labels, 0)
        for x in (labels4[:, 1:], *mosaic_segments):
            np.clip(x, 1e-3, 2 * s, out=x)
        # copy_paste and copy_paste2 are 0 here (device_aug_ineligible): at 0
        # the host path draws nothing for them

        warp = self._warp_args()
        M, sc, width, height = perspective_matrix((s * 2, s * 2), rng, border=(-half, -half), **warp)
        labels4 = perspective_targets(labels4, mosaic_segments, M, sc, width, height,
                                      warp["perspective"])
        plan["minv"][pair] = np.linalg.inv(M).astype(np.float32)
        return labels4

    def plan_item(self, index: int, salt: int = 0):
        """``get_item`` with the pixels left to the card: (plan, labels, path,
        shapes). The plan holds, for P pairs (2 when mixup is configured):
        ``src_idx`` (P, 4), ``rects`` (P, 4, 4) and ``offs`` (P, 4, 2) of the
        four paste slots, ``minv`` (P, 3, 3) from output to canvas
        coordinates, ``blend``, ``hsv`` (3,), ``flips`` (2,) and, when the
        frames are not resident, ``src`` (P, 4, s, s, 3) uint8."""
        index = int(self.indices[index])
        rng = self._item_rng(index, salt)
        s = self.img_size
        ya = self.yolo_augmentation
        pairs = 2 if ya.get("mixup", 0.0) > 0 else 1
        plan: Dict[str, np.ndarray] = {
            "src_idx": np.zeros((pairs, 4), np.int32),
            "rects": np.zeros((pairs, 4, 4), np.int32),
            "offs": np.zeros((pairs, 4, 2), np.int32),
            "minv": np.tile(np.eye(3, dtype=np.float32)[None], (pairs, 1, 1)),
            "blend": np.float32(1.0),
            "hsv": np.ones(3, np.float32),
            "flips": np.zeros(2, np.int32),
        }

        if rng.random() < ya.get("mosaic", 0.0):
            labels = self.plan_mosaic(index, rng, plan, 0)
            shapes = ((0, 0), ((0.0, 0.0), (0.0, 0.0)))
            if rng.random() < ya.get("mixup", 0.0):
                j = int(rng.integers(0, len(self.img_files)))
                labels2 = self.plan_mosaic(j, rng, plan, 1)
                plan["blend"] = np.float32(rng.beta(32.0, 32.0))
                labels = np.concatenate((labels, labels2), 0)
            elif pairs == 2:
                # mixup configured but not drawn: pair 1 repeats pair 0 at
                # blend 1, so every batch has the same shapes
                for k in ("src_idx", "rects", "offs", "minv"):
                    plan[k][1] = plan[k][0]
        else:
            h1, w1 = self._src_hw(index)
            w0, h0 = (int(v) for v in self.shapes[index])
            # letterbox() with auto=False to the square, scale_up=augment
            r = min(s / h1, s / w1)
            if not self.augment:
                r = min(r, 1.0)
            new_w, new_h = int(round(w1 * r)), int(round(h1 * r))
            dw, dh = (s - new_w) / 2, (s - new_h) / 2
            top, left = int(round(dh - 0.1)), int(round(dw - 0.1))
            shapes = ((h0, w0), ((h1 / h0, w1 / w0), (dw, dh)))

            labels, segments = self._image_labels(index, ratio=(r, r), wh=(w1, h1), pad=(dw, dh))

            # source -> letterboxed frame, cv2.resize's half-pixel convention:
            # x_dst = (x_src + 0.5) * (new_w / w1) - 0.5 + left
            L = np.eye(3)
            sx, sy = new_w / w1, new_h / h1
            L[0, 0], L[0, 2] = sx, 0.5 * sx - 0.5 + left
            L[1, 1], L[1, 2] = sy, 0.5 * sy - 0.5 + top

            if self.augment:
                warp = self._warp_args()
                M2, sc, w_, h_ = perspective_matrix((s, s), rng, **warp)
                labels = perspective_targets(labels, segments, M2, sc, w_, h_, warp["perspective"])
                F = M2 @ L
            else:
                F = L
            plan["minv"][0] = np.linalg.inv(F).astype(np.float32)
            plan["src_idx"][0, 0] = index
            plan["rects"][0, 0] = (0, 0, w1, h1)
            if pairs == 2:
                for k in ("src_idx", "rects", "offs", "minv"):
                    plan[k][1] = plan[k][0]

        if labels.size:
            labels[:, 1:] = xyxy2xywh(labels[:, 1:], wh=(s, s), clip_eps=1e-3)

        if self.policies is not None:  # flips only (device_aug_ineligible)
            for pol in self.policies.policies:
                if rng.random() >= pol.get("prob", 1.0):
                    continue
                for name, params in pol.get("policy", {}).items():
                    params = dict(params or {})
                    p = params.pop("p", 0.5)
                    if rng.random() >= p:
                        continue
                    if name == "HorizontalFlip":
                        plan["flips"][0] ^= 1
                        if len(labels):
                            labels[:, 1] = 1.0 - labels[:, 1]
                    else:  # VerticalFlip
                        plan["flips"][1] ^= 1
                        if len(labels):
                            labels[:, 2] = 1.0 - labels[:, 2]
        if self.augment:
            g = hsv_gains(rng, ya.get("hsv_h", 0.015), ya.get("hsv_s", 0.7), ya.get("hsv_v", 0.4))
            if g is not None:
                plan["hsv"] = g.astype(np.float32)

        if not self.device_aug_resident:
            # streaming: the plan carries its (padded) source frames
            src = np.full((pairs, 4, s, s, 3), 114, np.uint8)
            for pair in range(pairs):
                for slot in range(4):
                    x1a, y1a, x2a, y2a = plan["rects"][pair, slot]
                    if x2a > x1a and y2a > y1a:
                        im, _, (h, w) = self.load_image(int(plan["src_idx"][pair, slot]), copy=False)
                        src[pair, slot, :h, :w] = im
            plan["src"] = src

        return plan, labels.astype(np.float32), self.img_files[index], shapes

    def __getitem__(self, index: int):
        """(img HWC BGR uint8, (n, 5) [cls, xywh-norm], path, shapes)."""
        return self.get_item(index, 0)

    def get_item(self, index: int, salt: int = 0):
        """``__getitem__`` with the loader's epoch-position salt, which keeps
        the draws of repeated indices (weighted sampling) apart; in plan mode
        ``plan_item``."""
        if self.device_aug:
            return self.plan_item(index, salt)
        index = int(self.indices[index])
        rng = self._item_rng(index, salt)
        ya = self.yolo_augmentation

        if rng.random() < ya.get("mosaic", 0.0):
            img, labels = self.load_mosaic(index, rng)
            shapes = ((0, 0), ((0.0, 0.0), (0.0, 0.0)))
            if rng.random() < ya.get("mixup", 0.0):
                img, labels = mixup(
                    img, labels, *self.load_mosaic(int(rng.integers(0, len(self.img_files))), rng),
                    rng)
        else:
            img, (h0, w0), (h1, w1) = self.load_image(index)
            img, ratio, pad = letterbox(img, self.target_shape(index), stride=self.stride,
                                        auto=False, scale_up=self.augment)
            shapes = ((h0, w0), ((h1 / h0, w1 / w0), pad))
            labels, segments = self._image_labels(index, ratio=ratio, wh=(w1, h1), pad=pad)

            cp2 = ya.get("copy_paste2") or {}
            if cp2.get("p", 0.0) > 0.0:
                for _ in range(cp2.get("n_img", 3)):
                    img, labels, segments = self._cross_copy_paste(img, labels, segments, rng)
            if self.augment:
                img, labels = random_perspective(img, labels, rng, **self._warp_args())

        if labels.size:
            labels[:, 1:] = xyxy2xywh(labels[:, 1:], wh=img.shape[:2][::-1], clip_eps=1e-3)
        if self.policies is not None:
            img, labels = self.policies(img, labels, rng)
        if self.augment:
            img = np.ascontiguousarray(img)
            augment_hsv(img, rng, ya.get("hsv_h", 0.015), ya.get("hsv_s", 0.7),
                        ya.get("hsv_v", 0.4))
        return np.ascontiguousarray(img), labels.astype(np.float32), self.img_files[index], shapes
