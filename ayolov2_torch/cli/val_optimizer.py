"""Search validation parameters (image size, confidence and IoU thresholds)
for the best parameter/time/mAP trade-off.

The counterpart of ``cli/val_optimizer.py``: a study (``ayolov2_torch.search``,
the same TPE draws as the JAX package's) maximising

    score = alpha * (base_params / params)
          + beta  * (base_time / time)
          + gamma * (map50 / base_map50)

times 0.1 when mAP50 drops below the floor (``--base-map50``, else the
baseline's). The baseline is the model's own validation at 640, conf 0.001,
IoU 0.65 unless both ``--base-map50`` and ``--base-time`` are given. Each
(width, conf, IoU) is validated once untimed (cuDNN picks its algorithms
per shape) and then timed, the card synchronised at both ends. Trials
validate through ``YoloValidator`` on the card unless ``--device cpu``, with
the early-network kernel where the model allows it; ``--run-json`` scores
them through ``cli.val2``'s path instead (image folder -> serving with
every class of a box -> ``ResultWriter`` -> ``COCOmAPEvaluator``).

Usage:
    python -m ayolov2_torch.cli.val_optimizer --weights best.ckpt --data-cfg ... \\
        --n-trials 100 [--storage build/val_optimizer_study.json] [--load-if-exists]
"""

from __future__ import annotations

import argparse
import logging
import sys
import time
from typing import Optional, Sequence

import torch

from ayolov2_torch.cli.val import device_of
from ayolov2_torch.data import DataLoader, DetectionDataset, ImageFolderDataset
from ayolov2_torch.eval import YoloValidator
from ayolov2_torch.export import make_serving_fn
from ayolov2_torch.models import count_params
from ayolov2_torch.search import create_study
from ayolov2_torch.utils.checkpoint import load_model
from ayolov2_torch.utils.config import load_yaml
from ayolov2_torch.utils.general import check_img_size

LOGGER = logging.getLogger("val_optimizer")


def get_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Optimize validation parameters.")
    parser.add_argument("--weights", type=str, required=True)
    parser.add_argument("--model-cfg", type=str, default="")
    parser.add_argument("--data-cfg", type=str, default="res/configs/data/coco.yaml")
    parser.add_argument("--optim-cfg", type=str, default="res/configs/cfg/val_optimizer.yaml")
    parser.add_argument("--n-trials", type=int, default=100)
    parser.add_argument("--batch-size", type=int, default=16)
    parser.add_argument("--n-skip", type=int, default=0)
    parser.add_argument("--alpha", type=float, default=0.5, help="param-count weight")
    parser.add_argument("--beta", type=float, default=0.1, help="speed weight")
    parser.add_argument("--gamma", type=float, default=4.0, help="mAP50 weight")
    parser.add_argument("--base-map50", type=float, default=-1.0,
                        help="punishment floor (default: baseline run's mAP50)")
    parser.add_argument("--base-time", type=float, default=-1.0,
                        help="baseline val wall time; with --base-map50 skips the baseline run")
    parser.add_argument("--storage", type=str, default="val_optimizer_study.json")
    parser.add_argument("--study-name", type=str, default="val_optimizer")
    parser.add_argument("--load-if-exists", action="store_true")
    parser.add_argument("--load-study", action="store_true",
                        help="an alias of --load-if-exists")
    parser.add_argument("--device", type=str, default="",
                        help="cuda, cuda:N, N (a card's index) or cpu; default the card")
    parser.add_argument("--half", action="store_true", help="bf16 is already the default")
    parser.add_argument("--rect", action="store_true", dest="rect", default=True)
    parser.add_argument("--no-rect", action="store_false", dest="rect")
    parser.add_argument("--single-cls", action="store_true")
    parser.add_argument("--plot", action="store_true",
                        help="accepted; trial validations draw no plots")
    parser.add_argument("--verbose", type=int, nargs="?", const=1, default=1)
    parser.add_argument("--run-json", action="store_true",
                        help="score trials through the COCO-json path (val2's)")
    parser.add_argument("--json-path", type=str, default="",
                        help="prediction JSON written by --run-json trials")
    return parser


class ObjectiveValidator:
    """The trial objective: validate at the suggested (img_width, conf, iou).

    ``model``: the fused model (any device; each validation copies it to
    ``device`` in bf16)."""

    PUNISHMENT = 0.1

    def __init__(self, model, data_cfg, space, args, device) -> None:
        self.model = model
        self.data_cfg = data_cfg
        self.space = space
        self.args = args
        self.device = device
        self.model_params = count_params(model)
        self._warmed: set = set()
        self._gt_json = None
        # the trial model is the baseline model, so the alpha term is 1;
        # it differs only when comparing checkpoints offline
        if args.base_map50 >= 0 and args.base_time >= 0:
            self.baseline_map50 = max(args.base_map50, 1e-9)
            self.baseline_t = args.base_time
        else:
            base, self.baseline_t = self._timed_validate(640, 0.001, 0.65)
            self.baseline_map50 = max(base["map50"], 1e-9)
        self.baseline_params = self.model_params
        self.base_map50_floor = args.base_map50 if args.base_map50 >= 0 else self.baseline_map50
        LOGGER.info("baseline: mAP50 %.4f in %.3fs (warm)", self.baseline_map50, self.baseline_t)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _timed_validate(self, img_width: int, conf_t: float, iou_t: float):
        """(result, seconds): the first run of a (width, conf, iou) is an
        untimed warm-up, the second is timed."""
        key = (img_width, round(conf_t, 6), round(iou_t, 6))
        if key not in self._warmed:
            self._validate(img_width, conf_t, iou_t)
            self._warmed.add(key)
        self._sync()
        t0 = time.monotonic()
        result = self._validate(img_width, conf_t, iou_t)
        self._sync()
        return result, time.monotonic() - t0

    def _label_type(self) -> str:
        return "segments" if str(self.data_cfg.get("dataset", "")).lower() == "coco" else "labels"

    def _validate(self, img_width: int, conf_t: float, iou_t: float) -> dict:
        if getattr(self.args, "run_json", False):
            return self._validate_json(img_width, conf_t, iou_t)
        stride = int(max(self.model.strides))
        w = check_img_size(img_width, stride)
        dataset = DetectionDataset(
            self.data_cfg["val_path"], img_size=w, batch_size=self.args.batch_size,
            rect=getattr(self.args, "rect", True), pad=0.5, stride=stride,
            n_skip=self.args.n_skip, label_type=self._label_type(),
            single_cls=getattr(self.args, "single_cls", False),
        )
        v = YoloValidator(
            self.model, DataLoader(dataset, batch_size=self.args.batch_size),
            cfg={"conf_t": conf_t, "iou_t": iou_t,
                 "single_cls": getattr(self.args, "single_cls", False)},
            device=self.device)
        return v.validation()

    def _validate_json(self, img_width: int, conf_t: float, iou_t: float) -> dict:
        """--run-json: image folder -> serving (every class of a box, all
        anchors decoded) -> answersheet -> COCO mAP."""
        from ayolov2_torch.utils.metrics import COCOmAPEvaluator
        from ayolov2_torch.utils.result_writer import ResultWriter, yolo_labels_to_coco_json

        stride = int(max(self.model.strides))
        w = check_img_size(img_width, stride)
        dataset = ImageFolderDataset(
            self.data_cfg["val_path"], img_size=w, batch_size=self.args.batch_size,
            rect=getattr(self.args, "rect", True), pad=0.5, stride=stride,
            n_skip=self.args.n_skip)
        loader = DataLoader(dataset, batch_size=self.args.batch_size, detection=False)
        serve = make_serving_fn(self.model, conf_thres=conf_t, iou_thres=iou_t, top_k=512,
                                keep_top_k=100, fused_decode=False, multi_label=True,
                                device=self.device)
        writer = ResultWriter(self.args.json_path or "val_optimizer_trial.json")
        writer.start()
        for images, metas, indices, n_real in loader:
            h, wi = images.shape[1:3]
            det, n_valid = serve(torch.from_numpy(images).to(self.device))
            paths = [dataset.img_files[i] for i in indices]
            writer.add_outputs(paths, det.cpu().numpy()[:n_real],
                               n_valid.cpu().numpy()[:n_real], (h, wi), metas)
        results = writer.close()
        if self._gt_json is None:
            label_ds = DetectionDataset(
                self.data_cfg["val_path"], img_size=w, batch_size=self.args.batch_size,
                stride=stride, n_skip=self.args.n_skip, label_type=self._label_type())
            self._gt_json = yolo_labels_to_coco_json(label_ds)
        metrics = COCOmAPEvaluator(self._gt_json, cat_from_yolo=False).evaluate(results)
        return {"map50": metrics["map50"], "map50_95": metrics["map50_95"]}

    def calc_objective_fn(self, t: float, map50: float) -> float:
        param_score = self.args.alpha * (self.baseline_params / self.model_params)
        time_score = self.args.beta * (self.baseline_t / max(t, 1e-9))
        map50_score = self.args.gamma * (map50 / self.baseline_map50)
        return param_score + time_score + map50_score

    def __call__(self, trial) -> float:
        iw = self.space["img_width"]
        img_width = trial.suggest_int("img_width", iw["low"], iw["high"], step=iw.get("step", 32))
        conf = trial.suggest_float("conf_thr", self.space["conf_thr"]["low"],
                                   self.space["conf_thr"]["high"])
        iou = trial.suggest_float("iou_thr", self.space["iou_thr"]["low"],
                                  self.space["iou_thr"]["high"])
        result, dt = self._timed_validate(img_width, conf, iou)
        map50 = result["map50"]
        trial.set_user_attr("map50", map50)
        trial.set_user_attr("time_s", dt)
        score = self.calc_objective_fn(dt, map50)
        if map50 < self.base_map50_floor:
            score *= self.PUNISHMENT
        return score


def main(argv: Optional[Sequence[str]] = None):
    """Returns the study."""
    args = get_parser().parse_args(argv)
    device = device_of(args.device)
    if args.run_json:
        LOGGER.info("--run-json: trials score the COCO-json path; --json-path=%s",
                    args.json_path or "<auto>")
    data_cfg = load_yaml(args.data_cfg)
    space = load_yaml(args.optim_cfg)
    model = load_model(args.weights, args.model_cfg or None, nc=int(data_cfg["nc"]),
                       device=device)
    objective = ObjectiveValidator(model, data_cfg, space, args, device)
    study = create_study(direction="maximize", storage=args.storage,
                         study_name=args.study_name,
                         load_if_exists=args.load_if_exists or args.load_study)
    study.optimize(objective, n_trials=args.n_trials)
    LOGGER.info("best value %.5f with params %s", study.best_value, study.best_params)
    return study


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, format="%(message)s", stream=sys.stdout)
    main()
