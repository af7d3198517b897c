"""The validation loop: mAP of a detection model over a labelled data set.

The counterpart of ``ayolov2_tpu/eval/validator.py``. Per batch: the uint8
images go to the device, the model's forward and decode + NMS run there,
and only the fixed-shape detections and counts come back; on the host each
image's TP matrix is computed in native coordinates (the letterbox undone
by ``scale_coords``), and at the end ``ap_per_class`` rolls them up into
(mp, mr, mAP50, mAP50-95) with the speed report (pre / inference / NMS ms
per image).

Two device paths, both through ``make_serving_fn``'s forward:

- fused (the default for BN-folded models): the early-network kernel on the
  raw uint8 batch, the model from layer 4, then ``fused_decode_nms``, which
  decodes only the objectness-prefiltered candidates; grid constants are
  cached per letterbox shape;
- plain: every anchor decoded, then ``batched_nms`` with any ``nms_type``;
  hybrid-label NMS (the ground truth injected as perfect candidates) runs
  on this path.

With ``compute_loss`` (the trainer's validation) the loop also returns the
validation loss (lbox, lobj, lcls averaged over batches) of the raw maps in
f32, on the plain path with the forward from the image (no kernel): a
padded final batch weights its padding images 0 and masks their target
rows, as the JAX validator does.

With ``tta`` the plain path decodes each batch by ``ops/tta.tta_decode``
(scales and flips from ``tta_scales`` / ``tta_flips``): its unscaled,
unflipped branch is the serving forward, so the early-network kernel runs
there when the model takes it, and the scaled and flipped branches run the
model from layer 0 on the normalised images. (JAX's TTA path, like its
fused path, never calls its Pallas kernel.) No loss is computed under TTA,
as in JAX. With ``plot_dir`` the confusion matrix is gathered and, with the
PR, F1, P and R curves, written there as PNGs. The loop runs inside
``maybe_trace("val")`` (a ``torch.profiler`` trace under
``AYOLO_TRACE_DIR/val`` when that is set).
"""

from __future__ import annotations

import logging
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ayolov2_torch.export.exporter import make_serving_fn
from ayolov2_torch.ops.nms import batched_nms, detections_to_list
from ayolov2_torch.ops.tta import tta_decode
from ayolov2_torch.utils.boxes import scale_coords, xywh2xyxy
from ayolov2_torch.utils.general import resolve_device
from ayolov2_torch.utils.metrics import IOUV, ConfusionMatrix, ap_per_class, process_batch
from ayolov2_torch.utils.profiling import maybe_trace

LOGGER = logging.getLogger(__name__)


def inject_labels(pred: torch.Tensor, targets: torch.Tensor, mask: torch.Tensor,
                  wh: Tuple[int, int]) -> torch.Tensor:
    """Hybrid-label NMS input: each image's label rows (img, cls, xywh-norm)
    appended to its (N, 5+nc) predictions as candidates with objectness 1
    and class score 1. Padding rows go to a scratch image and are dropped."""
    bs, _, no = pred.shape
    m = targets.shape[0]
    per_img = m // bs
    rows = torch.zeros((m, no), dtype=torch.float32, device=pred.device)
    scale = torch.tensor([wh[0], wh[1], wh[0], wh[1]], dtype=torch.float32, device=pred.device)
    rows[:, :4] = targets[:, 2:6] * scale
    rows[:, 4] = 1.0
    cls_idx = torch.clamp(targets[:, 1].long(), 0, no - 6)
    rows[torch.arange(m, device=pred.device), 5 + cls_idx] = 1.0
    rows = torch.where(mask[:, None], rows, torch.zeros_like(rows))
    img_idx = torch.where(mask, targets[:, 0].long(), torch.full_like(cls_idx, bs))
    order = torch.sort(img_idx, stable=True).indices
    img_sorted = img_idx[order]
    pos = torch.arange(m, device=pred.device) - torch.searchsorted(img_sorted, img_sorted)
    extra = torch.zeros((bs + 1, per_img, no), dtype=torch.float32, device=pred.device)
    extra[img_sorted, torch.clamp(pos, 0, per_img - 1)] = rows[order]
    return torch.cat([pred, extra[:bs]], dim=1)


class YoloValidator:
    """Runs mAP validation of a detection model over a DataLoader.

    Args:
        model: a ``YOLOModel`` on any device (copied to ``device`` in the
            compute dtype; the caller's model is left as it is), or None
            with ``detection_fn``.
        loader: a ``DataLoader`` over a ``DetectionDataset``.
        class_names: names for the per-class report.
        cfg: conf_t, iou_t, nms_type, single_cls, max_det, pre_top_k,
            nms_box, hybrid_label, half (bf16, the default, else f32),
            fused (the fused path where the model allows it), early_pipeline
            (the early-network kernel where the model allows it), tta,
            tta_scales and tta_flips (NHWC axes; None: ``ops/tta.py``'s
            defaults), plot_dir (curves and confusion matrix written there),
            verbose, nc (without a model).
        compute_loss: a ``ComputeLoss``: also compute the validation loss
            (the plain path then, without the kernel).
        detection_fn: images -> (detections, counts), used instead of the
            model (e.g. another serving function).
        device: where the model runs; default the card, raising without
            CUDA (pass "cpu" to run on the CPU).
    """

    def __init__(
        self,
        model,
        loader,
        class_names: Optional[Sequence[str]] = None,
        cfg: Optional[Dict[str, Any]] = None,
        compute_loss=None,
        detection_fn: Optional[Callable] = None,
        device: Optional[Union[str, torch.device]] = None,
    ) -> None:
        cfg = dict(cfg or {})
        if compute_loss is not None:  # the loss needs the raw maps: the plain path
            cfg["fused"] = False
            cfg["early_pipeline"] = False
        self.compute_loss = compute_loss
        self.device = resolve_device(device)
        self.loader = loader
        self.detection_fn = detection_fn
        nc_src = model.nc if model is not None else int(cfg.get("nc", 80))
        self.nc = 1 if cfg.get("single_cls") else nc_src
        self.names = list(class_names) if class_names else [str(i) for i in range(self.nc)]

        self.conf_t = float(cfg.get("conf_t", 0.001))
        self.iou_t = float(cfg.get("iou_t", 0.65))
        self.nms_type = cfg.get("nms_type", "nms")
        self.single_cls = bool(cfg.get("single_cls", False))
        self.max_det = int(cfg.get("max_det", 300))
        self.pre_top_k = int(cfg.get("pre_top_k", 512))
        self.nms_box = int(cfg.get("nms_box", 1000))
        self.hybrid_label = bool(cfg.get("hybrid_label", False))
        self.tta = bool(cfg.get("tta", False))
        self.tta_scales = cfg.get("tta_scales")
        self.tta_flips = cfg.get("tta_flips")
        self.image_dtype = torch.bfloat16 if cfg.get("half", True) else torch.float32
        self.verbose = bool(cfg.get("verbose", False))
        self.plot_dir = cfg.get("plot_dir")
        self.confusion = ConfusionMatrix(self.nc) if self.plot_dir else None

        self.use_fused = (
            bool(cfg.get("fused", True))
            and model is not None
            and getattr(model, "fused", False)
            and not self.tta
            and not self.hybrid_label
            and self.nms_type in ("nms", "batched_nms")
        )
        self.serve = None
        if model is not None:
            self.serve = make_serving_fn(
                model, conf_thres=self.conf_t, iou_thres=self.iou_t, top_k=self.pre_top_k,
                keep_top_k=self.max_det, nms_box=self.nms_box, image_dtype=self.image_dtype,
                fused_decode=True, early_pipeline=bool(cfg.get("early_pipeline", True)),
                multi_label=self.nc > 1, agnostic=self.single_cls, device=self.device,
            )

    def update_weights(self, model) -> None:
        """Take ``model``'s weights (same graph; e.g. this epoch's EMA) into
        the validator's copy, cast to its compute dtype."""
        if self.serve.early:
            raise ValueError("the kernel path holds packed weights; build a new validator")
        self.serve.model.load_state_dict(model.state_dict())

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _run_nms(self, pred: torch.Tensor):
        n = pred.shape[1]
        return batched_nms(
            pred, conf_thres=self.conf_t, iou_thres=self.iou_t,
            nms_box=min(self.nms_box, n), pre_top_k=min(self.pre_top_k, n),
            keep_top_k=self.max_det, agnostic=self.single_cls, multi_label=self.nc > 1,
            nms_type=self.nms_type if self.nms_type != "batched_nms" else "nms",
        )

    @torch.inference_mode()
    def _detect(self, images: torch.Tensor, batch=None):
        """(detections, counts, time the forward ended or None) of one batch
        of uint8 images on the device; ``batch`` gives hybrid-label NMS its
        targets."""
        if self.detection_fn is not None:
            det, n_valid = self.detection_fn(images)
            return det, n_valid, None
        if self.use_fused:
            det, n_valid = self.serve(images)
            return det, n_valid, None
        if self.tta:
            pred = tta_decode(self.serve, images, self.image_dtype, self.tta_scales,
                              self.tta_flips)
        else:
            raw = self.serve.raw_maps(images)
            if self.compute_loss is not None and batch is not None:
                self._loss(raw, batch)
            pred = self.serve.model.head.decode(raw)
        self._sync()
        t_forward = time.perf_counter()
        if self.hybrid_label:
            h, w = images.shape[1:3]
            pred = inject_labels(pred, torch.from_numpy(batch.targets).to(self.device),
                                 torch.from_numpy(batch.target_mask).to(self.device), (w, h))
        det, n_valid = self._run_nms(pred)
        return det, n_valid, t_forward

    def _loss(self, raw, batch) -> None:
        """Add this batch's loss items; a padded final batch's padding
        images weigh 0 and their target rows are masked."""
        bs = raw[0].shape[0]
        nr = getattr(batch, "n_real", bs)
        mask = batch.target_mask & (batch.targets[:, 0] < nr)
        weight = (np.arange(bs) < nr).astype(np.float32)
        _, items = self.compute_loss(
            [r.float() for r in raw], torch.from_numpy(batch.targets).to(self.device),
            torch.from_numpy(mask).to(self.device), torch.from_numpy(weight).to(self.device))
        self._loss_sum += items[:3].double().cpu().numpy()

    def detect(self, images: np.ndarray, batch=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """Fixed (bs, max_det, 6) letterbox-space detections and (bs,) counts
        of a (bs, H, W, 3) uint8 batch, on the device."""
        det, n_valid, _ = self._detect(torch.from_numpy(images).to(self.device), batch)
        return det, n_valid

    def statistics_per_image(self, dets: List[np.ndarray], batch, img_hw: Tuple[int, int],
                             stats: List, confusion: Optional[ConfusionMatrix] = None) -> None:
        """Per-image TP accumulation in native coordinates: labels from
        normalised xywh to letterbox pixels, then labels and predictions
        through the same ``scale_coords`` to the native image (and into
        ``confusion`` where given)."""
        targets = batch.targets
        mask = batch.target_mask
        h, w = img_hw
        for si, det in enumerate(dets):
            rows = targets[(targets[:, 0] == si) & mask]
            tcls = rows[:, 1].astype(int).tolist() if len(rows) else []
            shape0, ratio_pad = batch.shapes[si]
            native = shape0 if shape0 != (0, 0) else (h, w)

            if det.shape[0] == 0:
                if len(rows):
                    stats.append((np.zeros((0, len(IOUV)), bool), np.zeros(0), np.zeros(0), tcls))
                continue

            if self.single_cls:
                det = det.copy()
                det[:, 5] = 0
            pred_native = det.copy()
            pred_native[:, :4] = scale_coords(
                (h, w), det[:, :4], native, ratio_pad if shape0 != (0, 0) else None)

            if len(rows):
                tbox = xywh2xyxy(rows[:, 2:6] * np.array([w, h, w, h], np.float32))
                tbox = scale_coords((h, w), tbox, native, ratio_pad if shape0 != (0, 0) else None)
                labels_native = np.concatenate([rows[:, 1:2], tbox], 1)
                correct = process_batch(pred_native, labels_native)
                if confusion is not None:
                    confusion.process_batch(pred_native, labels_native)
            else:
                correct = np.zeros((det.shape[0], len(IOUV)), bool)
            stats.append((correct, det[:, 4], det[:, 5], tcls))

    def validation(self, verbose: Optional[bool] = None) -> Dict[str, Any]:
        """Run the loop; returns mp, mr, map50, map50_95, loss (lbox, lobj,
        lcls averaged over batches; zeros without ``compute_loss``), maps
        (per-class mAP50-95), t (pre, inference, NMS ms per image), seen and
        n_labels (the labels of the images seen)."""
        verbose = self.verbose if verbose is None else verbose
        self._loss_sum = np.zeros(3, np.float64)
        with maybe_trace("val", self.device):
            return self._validation_loop(verbose)

    def _validation_loop(self, verbose: bool) -> Dict[str, Any]:
        stats: List = []
        dt = np.zeros(3, np.float64)
        seen = 0
        n_batches = 0
        for batch in self.loader:
            bs, h, w = batch.images.shape[:3]
            t0 = time.perf_counter()
            images = torch.from_numpy(batch.images).to(self.device)
            self._sync()
            t1 = time.perf_counter()
            det, n_valid, t2 = self._detect(images, batch)
            det, n_valid = det.cpu().numpy(), n_valid.cpu().numpy()  # waits for the device
            t3 = time.perf_counter()
            dt += (t1 - t0, (t2 or t3) - t1, t3 - (t2 or t3))
            # only the real items of a padded final batch count
            n_real = getattr(batch, "n_real", bs)
            seen += n_real
            n_batches += 1
            dets = detections_to_list(det, n_valid)[:n_real]
            self.statistics_per_image(dets, batch, (h, w), stats, confusion=self.confusion)
        result = self.compute_statistics(stats, dt, seen, verbose)
        result["loss"] = (self._loss_sum / max(n_batches, 1)).tolist()
        return result

    def compute_statistics(self, stats: List, dt, seen: int, verbose: bool) -> Dict[str, Any]:
        """The ap_per_class rollup and the report."""
        maps = np.zeros(self.nc)
        mp = mr = map50 = map5095 = 0.0
        nt = np.zeros(1)
        if stats:
            arrs = [
                np.concatenate(
                    [np.asarray(x[i]).reshape(-1, len(IOUV)) if i == 0 else np.asarray(x[i]).reshape(-1)
                     for x in stats], 0)
                for i in range(3)
            ]
            tcls = (np.concatenate([np.asarray(x[3]) for x in stats])
                    if any(len(x[3]) for x in stats) else np.zeros(0))
            if len(tcls):
                nt = np.bincount(tcls.astype(np.int64), minlength=self.nc)
            if len(arrs[0]):
                p, r, ap, f1, ap_class = ap_per_class(
                    arrs[0].astype(bool), arrs[1], arrs[2], tcls,
                    plot=self.plot_dir is not None, save_dir=self.plot_dir, names=self.names)
                ap50, ap_mean = ap[:, 0], ap.mean(1)
                mp, mr, map50, map5095 = p.mean(), r.mean(), ap50.mean(), ap_mean.mean()
                for i, c in enumerate(ap_class):
                    maps[c] = ap_mean[i]
                if verbose and self.nc > 1:
                    for i, c in enumerate(ap_class):
                        LOGGER.info("%20s %11d %11d %11.3g %11.3g %11.3g %11.3g",
                                    self.names[c], seen, int(nt[c]), p[i], r[i], ap50[i], ap_mean[i])
        if self.confusion is not None:
            from ayolov2_torch.utils.plots import plot_confusion_matrix

            Path(self.plot_dir).mkdir(parents=True, exist_ok=True)
            plot_confusion_matrix(self.confusion.matrix, Path(self.plot_dir) / "confusion_matrix.png",
                                  self.names)
        t = tuple(x / max(seen, 1) * 1e3 for x in dt)  # ms per image
        LOGGER.info("%20s %11s %11s %11s %11s %11s %11s",
                    "Class", "Images", "Labels", "P", "R", "mAP@.5", "mAP@.5:.95")
        LOGGER.info("%20s %11d %11d %11.3g %11.3g %11.3g %11.3g",
                    "all", seen, int(nt.sum()), mp, mr, map50, map5095)
        LOGGER.info("Speed: %.1f/%.1f/%.1f ms per image (pre/inference/NMS)", t[0], t[1], t[2])
        return {
            "mp": float(mp),
            "mr": float(mr),
            "map50": float(map50),
            "map50_95": float(map5095),
            "loss": [0.0, 0.0, 0.0],
            "maps": maps,
            "t": t,
            "seen": seen,
            "n_labels": int(nt.sum()),
        }
