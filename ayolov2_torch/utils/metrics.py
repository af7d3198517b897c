"""Detection metrics: AP, TP matrices, confusion matrix, COCO evaluator.

The counterpart of ``ayolov2_tpu/utils/metrics.py``, host-side numpy with
the same operations in the same order, so every number is bit-equal to the
JAX package's: ``compute_ap`` (101-point interpolation), ``ap_per_class``
(the max-F1 operating point), ``process_batch`` (TP matrix at IoU 0.5:0.95,
unique per detection and per label), ``check_correct_prediction_by_iou``,
``ConfusionMatrix`` and ``COCOmAPEvaluator`` (the COCOeval bbox protocol
without pycocotools, and the per-class report). With ``plot=True``
``ap_per_class`` writes the PR, F1, P and R curves, and an evaluator with
``export_root`` writes them and its confusion matrix there
(``utils/plots.py``). With ``img_root`` too, ``evaluate_per_class(debug=
True)`` renders each image's predictions beside its labels
(``{img_id:012d}.jpg`` of ``img_root``; reading and writing a ``.jpg``
needs cv2, as ``image_io.imread`` says) into ``export_root``, never over a
source image.
"""

from __future__ import annotations

import json
import logging
from collections import defaultdict
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from ayolov2_torch.utils.boxes import box_iou
from ayolov2_torch.utils.constants import COCO_CATEGORY_IDS

LOGGER = logging.getLogger(__name__)
# numpy 2 renamed trapz; both are the same function
_trapezoid = getattr(np, "trapezoid", None) or np.trapz

IOUV = np.linspace(0.5, 0.95, 10)


def compute_ap(recall: np.ndarray, precision: np.ndarray) -> Tuple[float, np.ndarray, np.ndarray]:
    """101-point interpolated AP from recall/precision curves."""
    mrec = np.concatenate(([0.0], recall, [1.0]))
    mpre = np.concatenate(([1.0], precision, [0.0]))
    mpre = np.flip(np.maximum.accumulate(np.flip(mpre)))
    x = np.linspace(0, 1, 101)
    ap = float(_trapezoid(np.interp(x, mrec, mpre), x))
    return ap, mpre, mrec


def ap_per_class(
    tp: np.ndarray,
    conf: np.ndarray,
    pred_cls: np.ndarray,
    target_cls: np.ndarray,
    plot: bool = False,
    save_dir: Optional[Union[str, Path]] = None,
    names: Sequence[str] = (),
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Per-class P/R/AP/F1 at the max-F1 operating point.

    Returns (p, r, ap (nc, n_iou), f1, unique_classes). With ``plot=True``
    writes PR_curve.png, F1_curve.png, P_curve.png and R_curve.png to
    ``save_dir``.
    """
    order = np.argsort(-conf)
    tp, conf, pred_cls = tp[order], conf[order], pred_cls[order]

    unique_classes = np.unique(target_cls)
    nc = unique_classes.shape[0]

    px = np.linspace(0, 1, 1000)
    py = []  # PR curves at IoU 0.5 per class
    ap = np.zeros((nc, tp.shape[1]))
    p = np.zeros((nc, 1000))
    r = np.zeros((nc, 1000))
    for ci, c in enumerate(unique_classes):
        i = pred_cls == c
        n_l = (target_cls == c).sum()
        n_p = int(i.sum())
        if n_p == 0 or n_l == 0:
            if plot:
                py.append(np.zeros_like(px))
            continue
        fpc = (1 - tp[i]).cumsum(0)
        tpc = tp[i].cumsum(0)
        recall = tpc / (n_l + 1e-16)
        precision = tpc / (tpc + fpc)
        r[ci] = np.interp(-px, -conf[i], recall[:, 0], left=0)
        p[ci] = np.interp(-px, -conf[i], precision[:, 0], left=1)
        for j in range(tp.shape[1]):
            ap[ci, j], mpre, mrec = compute_ap(recall[:, j], precision[:, j])
            if plot and j == 0:
                py.append(np.interp(px, mrec, mpre))

    f1 = 2 * p * r / (p + r + 1e-16)
    if plot and save_dir is not None:
        from ayolov2_torch.utils.plots import plot_mc_curve, plot_pr_curve

        save_dir = Path(save_dir)
        save_dir.mkdir(parents=True, exist_ok=True)
        cls_names = [names[int(c)] if int(c) < len(names) else str(int(c)) for c in unique_classes]
        plot_pr_curve(px, np.stack(py, 1) if py else np.zeros((1000, 1)), ap,
                      save_dir / "PR_curve.png", cls_names)
        plot_mc_curve(px, f1, save_dir / "F1_curve.png", cls_names, ylabel="F1")
        plot_mc_curve(px, p, save_dir / "P_curve.png", cls_names, ylabel="Precision")
        plot_mc_curve(px, r, save_dir / "R_curve.png", cls_names, ylabel="Recall")
    i = f1.mean(0).argmax()
    return p[:, i], r[:, i], ap, f1[:, i], unique_classes.astype(np.int32)


def process_batch(detections: np.ndarray, labels: np.ndarray, iouv: np.ndarray = IOUV) -> np.ndarray:
    """TP matrix (n_det, n_iou) — greedy IoU matching, unique det AND label."""
    correct = np.zeros((detections.shape[0], iouv.shape[0]), dtype=bool)
    if len(labels) == 0 or len(detections) == 0:
        return correct
    iou = box_iou(labels[:, 1:], detections[:, :4])
    li, di = np.where((iou >= iouv[0]) & (labels[:, 0:1] == detections[:, 5][None]))
    if len(li):
        matches = np.stack([li, di, iou[li, di]], 1)
        if len(li) > 1:
            matches = matches[matches[:, 2].argsort()[::-1]]
            matches = matches[np.unique(matches[:, 1], return_index=True)[1]]
            matches = matches[np.unique(matches[:, 0], return_index=True)[1]]
        correct[matches[:, 1].astype(int)] = matches[:, 2:3] >= iouv[None]
    return correct


def check_correct_prediction_by_iou(
    detections: np.ndarray,
    labels: np.ndarray,
    iou_s: float = 0.5,
    iou_e: float = 0.95,
    iou_step: float = 0.05,
) -> np.ndarray:
    """Correct-prediction matrix over an IoU threshold range.

    Parity: scripts/utils/metrics.py:551-600 — NOTE it dedups matches by
    detection only (each detection keeps its best label), unlike
    process_batch which also dedups by label.

    Args:
        detections: (N, 6) [x1, y1, x2, y2, conf, cls].
        labels: (M, 5) [cls, x1, y1, x2, y2].

    Returns:
        (N, T) bool — T = len(arange(iou_s, iou_e + iou_step, iou_step)).
    """
    iouv = np.arange(iou_s, iou_e + iou_step, iou_step)
    correct = np.zeros((detections.shape[0], iouv.shape[0]), dtype=bool)
    if len(labels) == 0 or len(detections) == 0:
        return correct
    iou = box_iou(labels[:, 1:], detections[:, :4])
    li, di = np.where((iou >= iouv[0]) & (labels[:, 0:1] == detections[:, 5][None]))
    if len(li):
        matches = np.stack([li, di, iou[li, di]], 1)
        matches = matches[matches[:, 2].argsort()[::-1]]
        matches = matches[np.unique(matches[:, 1], return_index=True)[1]]
        # strict > like the reference (:598 `matches[:, 2:3] > iouv`)
        correct[matches[:, 1].astype(int)] = matches[:, 2:3] > iouv[None]
    return correct


class ConfusionMatrix:
    """(nc+1, nc+1) confusion matrix with a background row/col."""

    def __init__(self, nc: int, conf: float = 0.25, iou_thres: float = 0.45) -> None:
        self.matrix = np.zeros((nc + 1, nc + 1))
        self.nc = nc
        self.conf = conf
        self.iou_thres = iou_thres

    def process_batch(self, detections: np.ndarray, labels: np.ndarray) -> None:
        detections = detections[detections[:, 4] > self.conf]
        gt_classes = labels[:, 0].astype(int)
        det_classes = detections[:, 5].astype(int)
        if len(labels) and len(detections):
            iou = box_iou(labels[:, 1:], detections[:, :4])
            li, di = np.where(iou > self.iou_thres)
        else:
            li, di = np.array([], int), np.array([], int)
        if len(li):
            matches = np.stack([li, di, iou[li, di]], 1)
            if len(li) > 1:
                matches = matches[matches[:, 2].argsort()[::-1]]
                matches = matches[np.unique(matches[:, 1], return_index=True)[1]]
                matches = matches[np.unique(matches[:, 0], return_index=True)[1]]
        else:
            matches = np.zeros((0, 3))

        n = len(matches) > 0
        m0, m1 = matches[:, 0].astype(int), matches[:, 1].astype(int)
        for i, gc in enumerate(gt_classes):
            j = m0 == i
            if n and j.sum() == 1:
                self.matrix[det_classes[m1[j][0]], gc] += 1  # correct/confused
            else:
                self.matrix[self.nc, gc] += 1  # background FN
        if n:
            for i, dc in enumerate(det_classes):
                if not (m1 == i).any():
                    self.matrix[dc, self.nc] += 1  # background FP


class COCOmAPEvaluator:
    """Evaluate COCO-format prediction JSON against GT JSON.

    Implements the COCOeval bbox protocol (101-pt precision interpolation,
    IoU 0.5:0.95, maxDets 100, area ranges) in plain numpy — the reference's
    COCOmAPEvaluator (metrics.py:603-880) is likewise pycocotools-free at its
    core. Prediction category ids may be either YOLO indices (0-79) or real
    COCO ids; set ``cat_from_yolo`` accordingly (the id fixmap of
    multi_queue.py:78-159).
    """

    AREA_RNG = {
        "all": (0.0, 1e10),
        "small": (0.0, 32.0 ** 2),
        "medium": (32.0 ** 2, 96.0 ** 2),
        "large": (96.0 ** 2, 1e10),
    }

    def __init__(self, gt_path: Union[str, Path, Dict], cat_from_yolo: bool = False,
                 img_root: Optional[str] = None, export_root: Optional[str] = None) -> None:
        gt = gt_path if isinstance(gt_path, dict) else json.loads(Path(gt_path).read_text())
        self.cat_ids = [c["id"] for c in gt.get("categories", [])] or COCO_CATEGORY_IDS
        self.names = [c.get("name", str(c["id"])) for c in gt.get("categories", [])] or [
            str(c) for c in self.cat_ids
        ]
        self.fix_label = {cid: i for i, cid in enumerate(self.cat_ids)}
        self.img_ids = sorted({im["id"] for im in gt["images"]})
        self.cat_from_yolo = cat_from_yolo
        self.img_root = img_root  # the source images of the debug renders
        self.export_root = export_root  # where evaluate_per_class writes its plots
        if export_root is not None:
            Path(export_root).mkdir(parents=True, exist_ok=True)
        self.gt_by_key: Dict[Tuple[int, int], List[dict]] = defaultdict(list)
        self.gt_by_img: Dict[int, List[dict]] = defaultdict(list)
        for ann in gt["annotations"]:
            if ann.get("iscrowd", 0):
                ann = dict(ann, _crowd=True)
            self.gt_by_key[(ann["image_id"], ann["category_id"])].append(ann)
            self.gt_by_img[ann["image_id"]].append(ann)

    def _fix_cat(self, cid: int) -> int:
        return COCO_CATEGORY_IDS[int(cid)] if self.cat_from_yolo else int(cid)

    def _lookup_label(self, cid: int) -> int:
        """Strict category_id -> contiguous class index (KeyError on ids
        outside the GT categories, like the reference's fix_label[...])."""
        try:
            return self.fix_label[int(cid)]
        except KeyError:
            raise KeyError(
                f"category_id {cid} not in the GT categories "
                f"({sorted(self.fix_label)[:5]}...); check cat_from_yolo / the "
                "prediction JSON id-space"
            ) from None

    def evaluate(self, pred_path: Union[str, Path, List[dict]], max_det: int = 100) -> Dict[str, float]:
        preds = (
            pred_path
            if isinstance(pred_path, list)
            else json.loads(Path(pred_path).read_text())
        )
        pred_by_key: Dict[Tuple[int, int], List[dict]] = defaultdict(list)
        for p in preds:
            pred_by_key[(p["image_id"], self._fix_cat(p["category_id"]))].append(p)

        iouv = IOUV
        t = len(iouv)
        # COCO protocol: AP is computed per class then averaged over classes
        # that have ground truth; per class, detections pool across images.
        results: Dict[str, Optional[np.ndarray]] = {}
        for area_name, area_rng in self.AREA_RNG.items():
            per_class_ap = []
            for cat in self.cat_ids:
                scores_cls, match_cls, ignore_cls = [], [], []
                n_gt = 0
                for img in self.img_ids:
                    gts = self.gt_by_key.get((img, cat), [])
                    dts = sorted(pred_by_key.get((img, cat), []), key=lambda d: -d["score"])[:max_det]
                    if not gts and not dts:
                        continue
                    g_boxes = np.array([g["bbox"] for g in gts], np.float64).reshape(-1, 4)
                    g_area = np.array(
                        [g.get("area", b[2] * b[3]) for g, b in zip(gts, g_boxes)], dtype=np.float64
                    )
                    g_crowd = np.array([bool(g.get("iscrowd", 0)) for g in gts], dtype=bool)
                    g_ignore = g_crowd | (g_area < area_rng[0]) | (g_area >= area_rng[1])
                    n_gt += int((~g_ignore).sum())
                    if not dts:
                        continue
                    d_boxes = np.array([d["bbox"] for d in dts], np.float64).reshape(-1, 4)
                    d_scores = np.array([d["score"] for d in dts], np.float64)
                    d_area = d_boxes[:, 2] * d_boxes[:, 3]
                    d_out_of_rng = (d_area < area_rng[0]) | (d_area >= area_rng[1])
                    iou = _iou_xywh(d_boxes, g_boxes, g_crowd) if len(gts) else np.zeros((len(dts), 0))

                    dt_m = np.full((t, len(dts)), -1, dtype=np.int64)
                    gt_m = np.full((t, len(gts)), -1, dtype=np.int64)
                    for ti, thr in enumerate(iouv):
                        for di in range(len(dts)):
                            best, best_g = min(thr, 1 - 1e-10), -1
                            for gi in range(len(gts)):
                                if gt_m[ti, gi] >= 0 and not g_crowd[gi]:
                                    continue
                                if best_g >= 0 and not g_ignore[best_g] and g_ignore[gi]:
                                    break  # gts sorted ignored-last below
                                if iou[di, gi] < best:
                                    continue
                                best, best_g = iou[di, gi], gi
                            if best_g >= 0:
                                dt_m[ti, di] = best_g
                                gt_m[ti, best_g] = di
                    if len(gts):
                        d_ignore = np.where(
                            dt_m >= 0,
                            g_ignore[np.clip(dt_m, 0, None)],
                            d_out_of_rng[None, :],
                        )
                    else:
                        d_ignore = np.broadcast_to(d_out_of_rng[None, :], dt_m.shape).copy()
                    scores_cls.append(d_scores)
                    match_cls.append(dt_m >= 0)
                    ignore_cls.append(d_ignore)

                if n_gt == 0:
                    continue  # class absent from GT: excluded from the mean
                per_class_ap.append(_accumulate_ap(scores_cls, match_cls, ignore_cls, n_gt, t))
            results[area_name] = np.mean(per_class_ap, axis=0) if per_class_ap else None

        def _m(name: str) -> float:
            return float(np.mean(results[name])) if results[name] is not None else 0.0

        all_ap = results["all"]
        return {
            "map50_95": _m("all"),
            "map50": float(all_ap[0]) if all_ap is not None else 0.0,
            "map75": float(all_ap[5]) if all_ap is not None else 0.0,
            "map_small": _m("small"),
            "map_medium": _m("medium"),
            "map_large": _m("large"),
        }


    # -- reference-style per-class report path (metrics.py:649-880) ---------

    def evaluate_per_class(self, pred_path: Union[str, Path, List[dict]],
                           debug: bool = False) -> Dict[str, object]:
        """The reference evaluator's per-class report: per-image
        check_correct_prediction_by_iou, then the ap_per_class rollup.
        Complements :meth:`evaluate`, which is the COCOeval protocol. With
        ``export_root`` the curves and the confusion matrix are written
        there. ``debug`` draws each image's pred-vs-GT render
        (:meth:`_draw_result`; nothing without ``img_root``)."""
        preds = (
            pred_path if isinstance(pred_path, list)
            else json.loads(Path(pred_path).read_text())
        )
        pred_by_img: Dict[int, List[dict]] = defaultdict(list)
        for p in preds:
            pred_by_img[p["image_id"]].append(p)

        confusion = ConfusionMatrix(nc=len(self.names)) if self.export_root else None
        corrects = []
        for img_id in sorted(set(self.img_ids) | set(pred_by_img)):
            dts = pred_by_img.get(img_id, [])
            label_pred = np.zeros((0, 6), np.float64)
            if dts:
                # a category outside the GT's means the two disagree on the id
                # space: raise, as the reference's fix_label[...] does
                label_pred = np.array(
                    [[*d["bbox"], d["score"], self._lookup_label(self._fix_cat(d["category_id"]))]
                     for d in dts], np.float64,
                )
                label_pred[:, 2:4] += label_pred[:, 0:2]  # xywh -> xyxy
            gts = self.gt_by_img.get(img_id, [])
            label_gt = np.zeros((0, 5), np.float64)
            if gts:
                label_gt = np.array(
                    [[self._lookup_label(g["category_id"]), *g["bbox"]] for g in gts],
                    np.float64,
                )
                label_gt[:, 3:5] += label_gt[:, 1:3]
            correct = check_correct_prediction_by_iou(label_pred, label_gt)
            corrects.append((correct, label_pred[:, 4], label_pred[:, 5], label_gt[:, 0]))
            if confusion is not None:
                confusion.process_batch(label_pred, label_gt)
            if debug:
                self._draw_result(img_id, label_pred, label_gt)

        c = [np.concatenate(x, 0) for x in zip(*corrects)]
        precision, recall, ap, f1, ap_class = ap_per_class(
            c[0], c[1], c[2], c[3], plot=self.export_root is not None,
            save_dir=self.export_root, names=self.names)
        if confusion is not None:
            try:
                from ayolov2_torch.utils.plots import plot_confusion_matrix

                plot_confusion_matrix(confusion.matrix,
                                      Path(self.export_root) / "confusion_matrix.png", self.names)
            except Exception as e:  # plotting must not stop the evaluation
                LOGGER.warning("confusion matrix plot failed: %s", e)
        ap50, ap_mean = ap[:, 0], ap.mean(1)
        result = {
            "p": precision,
            "r": recall,
            "ap": ap_mean,
            "ap50": ap50,
            "f1": f1,
            "mp": float(precision.mean()),
            "mr": float(recall.mean()),
            "map50": float(ap50.mean()),
            "map50_95": float(ap_mean.mean()),
            "target_histogram": np.bincount(c[3].astype(np.int64), minlength=len(self.names)),
            "names": self.names,
            # the classes the per-class rows belong to (classes absent from
            # the GT have no row); print_result scatters by them
            "ap_class": ap_class,
        }
        self.print_result(result)
        return result

    def _draw_result(self, img_id: int, label_pred: np.ndarray, label_gt: np.ndarray) -> None:
        """The image ``img_root/{img_id:012d}.jpg`` with its predictions drawn,
        a grey divider 3% of its width, and the image with its labels, side
        by side, written under the same name into ``export_root``; nothing
        without ``img_root`` or the file, and never into ``img_root``."""
        if self.img_root is None:
            return
        from ayolov2_torch.data.image_io import imread, imwrite
        from ayolov2_torch.utils.plots import draw_labels

        img_path = Path(self.img_root) / f"{img_id:012d}.jpg"
        if not img_path.is_file():
            return
        try:
            img = imread(str(img_path))
        except OSError:  # unreadable: as cv2.imread's None
            return
        img_pred = draw_labels(img, np.concatenate((label_pred[:, 5:6], label_pred[:, :4]), 1),
                               self.names, norm_xywh=False)
        img_gt = draw_labels(img, label_gt, self.names, norm_xywh=False)
        divider = np.full((img_gt.shape[0], int(img_gt.shape[1] * 0.03), 3), 127, np.uint8)
        img_merge = np.concatenate((img_pred, divider, img_gt), 1)
        if self.export_root is not None:
            if Path(self.export_root).resolve() == Path(self.img_root).resolve():
                return  # never overwrite source images
            imwrite(str(Path(self.export_root) / f"{img_id:012d}.jpg"), img_merge)

    @staticmethod
    def print_result(result: Dict) -> None:
        """The per-class result dict as a table (logged, and returned as rows).

        Pads the per-class arrays to the full name list: ap_per_class only
        emits rows for classes present in GT."""
        names = list(result["names"])
        n = len(names)
        # ap_per_class emits rows only for classes present in GT; scatter by
        # the class ids so sparse-class runs don't misattribute rows
        ap_class = np.asarray(
            result.get("ap_class", np.arange(n)), np.int64
        )

        def full(key):
            arr = np.asarray(result[key], np.float64)
            out = np.zeros(n)
            ids = ap_class[: arr.shape[0]]
            keep = ids < n
            out[ids[keep]] = arr[: len(ids)][keep]
            return out

        by_class = np.stack(
            (np.asarray(result["target_histogram"], np.float64),
             full("p"), full("r"), full("f1"), full("ap50"), full("ap")), 1,
        )
        by_all = np.array(
            [float(np.asarray(result["target_histogram"]).sum()), result["mp"],
             result["mr"], float(np.asarray(result["f1"]).mean()),
             result["map50"], result["map50_95"]]
        )
        contents = np.concatenate(
            (np.array(names + ["all"])[:, None], np.vstack((by_class, by_all))), 1
        )
        LOGGER.info("\n%s", _github_table(
            ["name", "n_targets", "P", "R", "F1", "mAP50", "mAP50:95"], contents))
        return contents


def _iou_xywh(d: np.ndarray, g: np.ndarray, g_crowd: np.ndarray) -> np.ndarray:
    """COCO bbox IoU ([x, y, w, h]); crowd GT uses IoA over detection."""
    d_xyxy = np.concatenate([d[:, :2], d[:, :2] + d[:, 2:]], 1)
    g_xyxy = np.concatenate([g[:, :2], g[:, :2] + g[:, 2:]], 1)
    lt = np.maximum(d_xyxy[:, None, :2], g_xyxy[None, :, :2])
    rb = np.minimum(d_xyxy[:, None, 2:], g_xyxy[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    d_area = (d[:, 2] * d[:, 3])[:, None]
    g_area = (g[:, 2] * g[:, 3])[None, :]
    union = np.where(g_crowd[None, :], d_area, d_area + g_area - inter)
    return inter / np.maximum(union, 1e-12)


def _accumulate_ap(scores_cls, match_cls, ignore_cls, n_gt, t) -> np.ndarray:
    """COCOeval accumulate for one class: 101-pt interpolated AP per threshold."""
    if not scores_cls:
        return np.zeros(t)
    scores = np.concatenate(scores_cls)
    order = np.argsort(-scores, kind="mergesort")
    matched = np.concatenate(match_cls, axis=1)[:, order]
    ignored = np.concatenate(ignore_cls, axis=1)[:, order]
    rec_thrs = np.linspace(0, 1, 101)
    ap = np.zeros(t)
    for ti in range(t):
        keep = ~ignored[ti]
        tps = (matched[ti] & keep).astype(np.float64).cumsum()
        fps = (~matched[ti] & keep).astype(np.float64).cumsum()
        rc = tps / n_gt
        pr = tps / np.maximum(tps + fps, np.finfo(np.float64).eps)
        pr = np.maximum.accumulate(pr[::-1])[::-1]  # precision envelope
        inds = np.searchsorted(rc, rec_thrs, side="left")
        q = np.zeros(101)
        valid = inds < len(pr)
        q[valid] = pr[inds[valid]]
        ap[ti] = q.mean()
    return ap


def _github_table(headers: Sequence[str], rows: np.ndarray) -> str:
    """Rows of strings as a GitHub-style table (what ``tabulate`` prints
    with ``tablefmt="github"``, without the dependency)."""
    def cell(v: str) -> str:
        try:
            return f"{float(v):g}"
        except ValueError:
            return v

    table = [[cell(str(v)) for v in row] for row in rows]
    widths = [max([len(h)] + [len(r[i]) for r in table]) for i, h in enumerate(headers)]
    lines = ["| " + " | ".join(h.ljust(w) for h, w in zip(headers, widths)) + " |",
             "|" + "|".join("-" * (w + 2) for w in widths) + "|"]
    lines += ["| " + " | ".join(v.ljust(w) for v, w in zip(r, widths)) + " |" for r in table]
    return "\n".join(lines)
