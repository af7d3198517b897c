"""COCO-JSON inference + evaluation.

The counterpart of ``cli/val2.py``: image folder -> rect batches -> the
serving function (decode + NMS on the device) -> ``ResultWriter`` (a COCO
answersheet JSON) -> ``COCOmAPEvaluator`` against the GT JSON, which is
built from the YOLO labels when ``--gt-json`` is not given. Runs on the
card unless ``--device cpu`` is given. ``--tta`` decodes each batch with
test-time augmentation (``--tta-cfg``; the unscaled branch is the serving
forward, with the early-network kernel) before the NMS; ``--plot`` writes
the per-class report's curves and confusion matrix to
``{dst}/val2/{DATE}_runs`` (or to ``--export``); ``--trace-dir`` writes a
``torch.profiler`` trace of the serve loop there.

Usage:
    python -m ayolov2_torch.cli.val2 --weights best.ckpt --data-cfg res/configs/data/coco.yaml \\
        [--gt-json instances_val2017.json] --json-path answersheet.json

``--export`` writes the plots, but not the JAX package's pred-vs-GT renders
of the source images (which its entry point never asks for). The
pycocotools cross-check is left out (``--no-coco`` is accepted and changes
nothing). As in the JAX entry point, ``--weights`` is read as a checkpoint
whatever its suffix: an exported artifact is validated by ``cli.val``.
"""

from __future__ import annotations

import argparse
import json
import logging
import sys
import time
from typing import Optional, Sequence

import torch

from ayolov2_torch.cli.val import build_val_model, device_of, load_tta_cfg
from ayolov2_torch.data import DataLoader, DetectionDataset, ImageFolderDataset
from ayolov2_torch.export import make_serving_fn
from ayolov2_torch.ops.nms import batched_nms
from ayolov2_torch.ops.tta import tta_decode
from ayolov2_torch.utils.config import load_yaml, make_run_dir
from ayolov2_torch.utils.general import check_img_size
from ayolov2_torch.utils.metrics import COCOmAPEvaluator
from ayolov2_torch.utils.profiling import trace_to
from ayolov2_torch.utils.result_writer import ResultWriter, yolo_labels_to_coco_json

LOGGER = logging.getLogger("val2")


def get_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="COCO-json inference + mAP.")
    parser.add_argument("--weights", type=str, default="")
    parser.add_argument("--model-cfg", type=str, default="")
    parser.add_argument("--data-cfg", type=str, default="res/configs/data/coco.yaml")
    parser.add_argument("--gt-json", type=str, default="", help="COCO GT json (else from labels)")
    parser.add_argument("--json-path", type=str, default="answersheet.json")
    parser.add_argument("-iw", "--img-width", type=int, default=640)
    parser.add_argument("--batch-size", type=int, default=32)
    parser.add_argument("-ct", "--conf-t", type=float, default=0.001)
    parser.add_argument("-it", "--iou-t", type=float, default=0.65)
    parser.add_argument("--nms-type", "--nms_type", type=str, default="nms")
    parser.add_argument("--top-k", type=int, default=512)
    parser.add_argument("--keep-top-k", type=int, default=100)
    parser.add_argument("--nms-box", type=int, default=1000)
    parser.add_argument("--tta", action="store_true", help="test-time augmentation")
    parser.add_argument("--tta-cfg", type=str, default="res/configs/cfg/tta.yaml",
                        help="TTA scales and flips (YAML; flips as torch NCHW dims)")
    parser.add_argument("--no-half", action="store_true")
    parser.add_argument("--half", action="store_true", help="bf16 is already the default")
    parser.add_argument("--rect", action="store_true", dest="rect", default=True,
                        help="rectangular batches (default)")
    parser.add_argument("--no-rect", action="store_false", dest="rect")
    parser.add_argument("--n-skip", type=int, default=0)
    parser.add_argument("--data", type=str, default="",
                        help="validation image root (overrides data-cfg val_path)")
    parser.add_argument("--device", type=str, default="",
                        help="cuda, cuda:N, N (a card's index) or cpu; default the card")
    parser.add_argument("--dst", type=str, default="exp",
                        help="export dir root: {dst}/val2/{DATE}_runs")
    parser.add_argument("-ih", "--img-height", type=int, default=-1)
    parser.add_argument("--agnostic", action="store_true",
                        help="class-agnostic NMS (no class coordinate offset)")
    parser.add_argument("--single-cls", action="store_true", help="validate as a single class")
    parser.add_argument("--plot", action="store_true",
                        help="per-class report and plots under the dst run dir")
    parser.add_argument("--export", type=str, default="",
                        help="write the per-class report's plots to this dir")
    parser.add_argument("--no-coco", "--no_coco", action="store_true",
                        help="accepted; the pycocotools cross-check is not ported")
    parser.add_argument("--verbose", type=int, nargs="?", const=1, default=1)
    parser.add_argument("--check-map", type=float, default=-1.0,
                        help="fail unless mAP50 >= this value")
    parser.add_argument("--trace-dir", type=str, default="",
                        help="write a torch.profiler trace of the serve loop here")
    return parser


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = get_parser().parse_args(argv)
    device = device_of(args.device)

    data_cfg = load_yaml(args.data_cfg)
    if args.data:
        data_cfg["val_path"] = args.data
    # single_cls folds labels and NMS to one class; the net keeps its nc
    nc = int(data_cfg["nc"])
    model = build_val_model(args, nc, True, device)

    stride = int(max(model.strides))
    if args.img_height < 0:
        args.img_height = args.img_width
    img_size = check_img_size(max(args.img_width, args.img_height), stride)
    dataset = ImageFolderDataset(
        data_cfg["val_path"], img_size=img_size, batch_size=args.batch_size,
        rect=args.rect, pad=0.5, stride=stride, n_skip=args.n_skip,
    )
    loader = DataLoader(dataset, batch_size=args.batch_size, detection=False)
    image_dtype = torch.float32 if args.no_half else torch.bfloat16
    serve = make_serving_fn(
        model, conf_thres=args.conf_t, iou_thres=args.iou_t, top_k=args.top_k,
        keep_top_k=args.keep_top_k, nms_box=args.nms_box, image_dtype=image_dtype,
        fused_decode=False, multi_label=not args.single_cls,
        agnostic=args.agnostic or args.single_cls, nms_type=args.nms_type, device=device,
    )
    if args.tta:
        scales, flips = load_tta_cfg(args.tta_cfg)

        def detect(images: torch.Tensor):
            pred = tta_decode(serve, images, image_dtype, scales, flips)
            return batched_nms(
                pred, conf_thres=args.conf_t, iou_thres=args.iou_t,
                nms_box=min(args.nms_box, pred.shape[1]), pre_top_k=args.top_k,
                keep_top_k=args.keep_top_k, multi_label=not args.single_cls,
                agnostic=args.agnostic or args.single_cls, nms_type=args.nms_type)
    else:
        detect = serve

    writer = ResultWriter(args.json_path)
    writer.start()
    seen = 0
    t_infer = 0.0
    with trace_to(args.trace_dir or None, device):
        for images, metas, indices, n_real in loader:
            h, w = images.shape[1:3]
            t0 = time.perf_counter()
            det, n_valid = detect(torch.from_numpy(images).to(device))
            det, n_valid = det.cpu().numpy(), n_valid.cpu().numpy()  # waits for the device
            t_infer += time.perf_counter() - t0
            # metas and indices are cut to the real (unpadded) items already
            paths = [dataset.img_files[i] for i in indices]
            writer.add_outputs(paths, det[:n_real], n_valid[:n_real], (h, w), metas)
            seen += n_real
    results = writer.close()
    LOGGER.info("%d images, %.1f ms/img inference+NMS, %d predictions",
                seen, t_infer / max(seen, 1) * 1e3, len(results))

    if args.gt_json:
        gt = args.gt_json
    else:
        LOGGER.info("no GT json given: building one from YOLO labels")
        label_ds = DetectionDataset(
            data_cfg["val_path"], img_size=img_size, batch_size=args.batch_size,
            stride=stride, n_skip=args.n_skip,
            label_type="segments" if str(data_cfg.get("dataset", "")).lower() == "coco" else "labels",
            single_cls=args.single_cls,
        )
        gt = yolo_labels_to_coco_json(label_ds)

    export_root = args.export
    if args.plot and not export_root:
        export_root = str(make_run_dir(args.dst, "val2"))
    evaluator = COCOmAPEvaluator(gt, cat_from_yolo=False, export_root=export_root or None)
    metrics = evaluator.evaluate(results, max_det=args.keep_top_k)
    if args.plot or args.export or args.verbose >= 2:
        evaluator.evaluate_per_class(results, debug=bool(args.export))
        if export_root:
            LOGGER.info("per-class plots -> %s", export_root)
    LOGGER.info("COCO eval: %s", json.dumps({k: round(v, 4) for k, v in metrics.items()}))
    if args.check_map >= 0 and metrics["map50"] < args.check_map:
        raise SystemExit(f"mAP50 {metrics['map50']:.4f} < required {args.check_map}")
    return metrics


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, format="%(message)s", stream=sys.stdout)
    main()
