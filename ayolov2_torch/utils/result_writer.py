"""COCO-JSON result writer, and COCO GT built from YOLO labels.

The counterpart of ``ayolov2_tpu/utils/result_writer.py``: a consumer
thread takes each batch's fixed-shape detections, scales the boxes back to
the native image, converts xyxy to COCO [x, y, w, h], maps YOLO class
indices to COCO category ids, collects the predictions and writes them as
JSON on ``close``.
"""

from __future__ import annotations

import json
import queue
import threading
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from ayolov2_torch.utils.boxes import scale_coords
from ayolov2_torch.utils.constants import COCO_CATEGORY_IDS


def image_id_from_path(path: str) -> int:
    """COCO image id from a file's stem: the number it is, else a hash of it
    (Python's ``hash``, salted per process: such ids agree within one
    process only, as in the JAX package)."""
    stem = Path(path).stem
    try:
        return int(stem)
    except ValueError:
        return abs(hash(stem)) % (10 ** 12)


class ResultWriter:
    """Asynchronously converts device detections to COCO prediction dicts.

    Usage::

        writer = ResultWriter("answersheet.json")
        writer.start()
        for batch ...:
            writer.add_outputs(paths, det, n_valid, img_hw, metas)
        writer.close()  # joins + dumps JSON
    """

    def __init__(self, path: Union[str, Path, None], cat_from_yolo: bool = True) -> None:
        self.path = Path(path) if path else None
        self.cat_from_yolo = cat_from_yolo
        self.results: List[Dict[str, Any]] = []
        self._q: "queue.Queue" = queue.Queue(maxsize=64)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None

    def start(self) -> None:
        self._thread = threading.Thread(target=self._consume, daemon=True)
        self._thread.start()

    def _consume(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            if self._error is None:  # after a failure, drain so add_outputs never blocks
                try:
                    self._process(*item)
                except Exception as e:  # raised again by close()
                    self._error = e

    def add_outputs(
        self,
        paths: Sequence[str],
        detections: np.ndarray,
        n_valid: np.ndarray,
        img_hw: Tuple[int, int],
        metas: Sequence[Tuple[Tuple[int, int], Any]],
    ) -> None:
        """Enqueue one batch.

        Args:
            paths: per-image file paths (image ids derive from stems).
            detections: (bs, k, 6) [x1 y1 x2 y2 conf cls] in letterbox space.
            n_valid: (bs,) valid counts.
            img_hw: letterboxed (h, w).
            metas: per-image ((h0, w0), ratio_pad) native shape + transform.
        """
        self._q.put((list(paths), np.asarray(detections), np.asarray(n_valid), img_hw, list(metas)))

    def _process(self, paths, detections, n_valid, img_hw, metas) -> None:
        for i, path in enumerate(paths):
            n = int(n_valid[i])
            if n == 0:
                continue
            det = detections[i, :n].astype(np.float64)
            (h0, w0), ratio_pad = metas[i]
            boxes = scale_coords(img_hw, det[:, :4], (h0, w0), ratio_pad)
            # xyxy -> coco xywh (top-left + size)
            wh = boxes[:, 2:4] - boxes[:, 0:2]
            img_id = image_id_from_path(path)
            for b in range(n):
                cat = int(det[b, 5])
                if self.cat_from_yolo:
                    cat = COCO_CATEGORY_IDS[cat]
                self.results.append(
                    {
                        "image_id": img_id,
                        "category_id": cat,
                        "bbox": [round(float(x), 3) for x in (boxes[b, 0], boxes[b, 1], wh[b, 0], wh[b, 1])],
                        "score": round(float(det[b, 4]), 5),
                    }
                )

    def close(self) -> List[Dict[str, Any]]:
        """Flush the queue, join the consumer, write JSON, return results;
        raises what the consumer raised."""
        self._q.put(None)
        if self._thread is not None:
            self._thread.join()
        if self._error is not None:
            raise self._error
        if self.path is not None:
            self.path.parent.mkdir(parents=True, exist_ok=True)
            self.path.write_text(json.dumps(self.results))
        return self.results


def yolo_labels_to_coco_json(
    dataset,
    categories_from_yolo: bool = True,
    out_path: Optional[Union[str, Path]] = None,
) -> Dict[str, Any]:
    """Build a COCO GT dict from a DetectionDataset's YOLO label files.

    Lets COCO evaluation run on datasets that have YOLO txt labels only.
    """
    images, annotations = [], []
    ann_id = 1
    for i, (path, labels) in enumerate(zip(dataset.img_files, dataset.labels)):
        w, h = (int(x) for x in dataset.shapes[i])
        img_id = image_id_from_path(path)
        images.append({"id": img_id, "file_name": Path(path).name, "width": w, "height": h})
        for lab in np.asarray(labels).reshape(-1, 5):
            cat = int(lab[0])
            if categories_from_yolo:
                cat = COCO_CATEGORY_IDS[cat]
            cx, cy, bw, bh = lab[1] * w, lab[2] * h, lab[3] * w, lab[4] * h
            annotations.append(
                {
                    "id": ann_id,
                    "image_id": img_id,
                    "category_id": cat,
                    "bbox": [cx - bw / 2, cy - bh / 2, bw, bh],
                    "area": float(bw * bh),
                    "iscrowd": 0,
                }
            )
            ann_id += 1
    cats = COCO_CATEGORY_IDS if categories_from_yolo else sorted({a["category_id"] for a in annotations})
    gt = {
        "images": images,
        "annotations": annotations,
        "categories": [{"id": c} for c in cats],
    }
    if out_path is not None:
        Path(out_path).write_text(json.dumps(gt))
    return gt
