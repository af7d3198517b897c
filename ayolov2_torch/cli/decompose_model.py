"""Decompose a model's convolutions (Tucker-2 + EVBMF), validating before and after.

The counterpart of ``cli/decompose_model.py``: the checkpoint's EMA
weights -> mAP of the model as it is -> ``compress.decompose_model`` on the
host (f64 numpy) -> mAP of the decomposed model -> the decomposed
checkpoint (meta ``decompose_map``, the weights in f32 under ``model`` and
``ema``, in the JAX package's format, which that package reads too) and
``{out}.args.yaml`` (JSON text, which YAML readers read) with the parameter
counts, both mAP50s and the per-layer report. Validation runs on the card
unless ``--device cpu`` is given, through the early-network kernel where
the decomposed model allows it (none of layers 0-3 decomposed).

Usage:
    python -m ayolov2_torch.cli.decompose_model --weights best.ckpt \\
        --data-cfg res/configs/data/coco.yaml --loss-thr 0.1 --prune-step 0.1
"""

from __future__ import annotations

import argparse
import json
import logging
import sys
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from ayolov2_torch.cli.val import device_of
from ayolov2_torch.compress import decompose_model
from ayolov2_torch.data import DataLoader, DetectionDataset
from ayolov2_torch.eval import YoloValidator
from ayolov2_torch.models import build_model
from ayolov2_torch.models.builder import parse_model_config
from ayolov2_torch.utils.checkpoint import load_variables, write_checkpoint
from ayolov2_torch.utils.config import load_yaml, make_run_dir
from ayolov2_torch.utils.general import check_img_size
from ayolov2_torch.utils.weights import load_flax_variables

LOGGER = logging.getLogger("decompose")


def get_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Tucker/EVBMF model decomposition.")
    parser.add_argument("--weights", type=str, default="", help="checkpoint (.ckpt)")
    parser.add_argument("--model-cfg", type=str, default="")
    parser.add_argument("--data-cfg", type=str, default="res/configs/data/coco.yaml")
    parser.add_argument("--loss-thr", type=float, default=0.1,
                        help="per-layer forward-diff threshold")
    parser.add_argument("--prune-step", type=float, default=0.01,
                        help="binary-search granularity for prune ratio (0 = no prune)")
    parser.add_argument("-iw", "--img-width", type=int, default=640)
    parser.add_argument("--batch-size", type=int, default=16)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--skip-validation", action="store_true")
    parser.add_argument("--out", type=str, default="", help="output ckpt path")
    parser.add_argument("-ih", "--img-height", type=int, default=-1)
    parser.add_argument("-ct", "--conf-t", type=float, default=0.001)
    parser.add_argument("-it", "--iou-t", type=float, default=0.65)
    parser.add_argument("--device", type=str, default="",
                        help="cuda, cuda:N, N (a card's index) or cpu; default the card")
    parser.add_argument("--dst", type=str, default="",
                        help="export dir: {dst}/decompose/{DATE}_runs (else next to ckpt)")
    parser.add_argument("--rect", action="store_true", dest="rect", default=True)
    parser.add_argument("--no-rect", action="store_false", dest="rect")
    parser.add_argument("--single-cls", action="store_true")
    parser.add_argument("--plot", action="store_true",
                        help="save before/after validation plots under dst")
    return parser


def count_tree(tree) -> int:
    """Leaves' elements of a nested dict of arrays."""
    if isinstance(tree, dict):
        return sum(count_tree(v) for v in tree.values())
    return int(np.asarray(tree).size)


def run_validation(model_cfg, variables, data_cfg, img_size: int, batch_size: int, device,
                   decompose_map=(), args=None) -> dict:
    """mAP of ``variables`` (unfused) in the graph of ``model_cfg`` and
    ``decompose_map``, BN folded, bf16, over the data config's val set."""
    model = build_model(model_cfg, nc=int(data_cfg["nc"]), device=device,
                        decompose_map=decompose_map)
    model = load_flax_variables(model, variables).fuse()
    stride = int(max(model.strides))
    single_cls = getattr(args, "single_cls", False)
    dataset = DetectionDataset(
        data_cfg["val_path"], img_size=img_size, batch_size=batch_size,
        rect=getattr(args, "rect", True), pad=0.5, stride=stride, single_cls=single_cls,
        label_type="segments" if str(data_cfg.get("dataset", "")).lower() == "coco" else "labels",
    )
    cfg = {"single_cls": single_cls}
    if args is not None:
        cfg.update(conf_t=args.conf_t, iou_t=args.iou_t)
        if getattr(args, "plot", False) and getattr(args, "_plot_dir", None):
            cfg["plot_dir"] = args._plot_dir
    return YoloValidator(model, DataLoader(dataset, batch_size=batch_size), cfg=cfg,
                         device=device).validation()


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Returns {"map50_before", "map50_after", "decompose_map", "out"}."""
    args = get_parser().parse_args(argv)
    device = device_of(args.device)
    if args.img_height < 0:
        args.img_height = args.img_width
    data_cfg = load_yaml(args.data_cfg)
    img_size = check_img_size(max(args.img_width, args.img_height), 32)
    args._plot_dir = str(make_run_dir(args.dst, "decompose")) if args.dst else None

    variables, meta = load_variables(args.weights, prefer_ema=True)
    model_cfg = args.model_cfg or (json.loads(meta["model_cfg"]) if meta.get("model_cfg")
                                   else None)
    if not model_cfg:
        raise SystemExit("need --model-cfg or a checkpoint with an embedded model config")
    if isinstance(model_cfg, str):
        model_cfg = parse_model_config(model_cfg)

    n_before = count_tree(variables["params"])
    result_before = None
    if not args.skip_validation:
        result_before = run_validation(model_cfg, variables, data_cfg, img_size,
                                       args.batch_size, device, args=args)

    decompose_map, new_params, report = decompose_model(
        variables["params"], loss_thr=args.loss_thr, prune_step=args.prune_step,
        seed=args.seed)
    new_vars = {"params": new_params, "batch_stats": variables.get("batch_stats", {})}
    n_after = count_tree(new_params)
    LOGGER.info("params: %s -> %s (%.1f%%), %d convs decomposed", f"{n_before:,}",
                f"{n_after:,}", 100 * n_after / n_before, len(decompose_map))

    result_after = None
    if not args.skip_validation:
        result_after = run_validation(model_cfg, new_vars, data_cfg, img_size, args.batch_size,
                                      device, decompose_map, args=args)

    stem = Path(args.weights).stem + f"_decomposed_seed_{args.seed}.ckpt"
    if args.out:
        out = args.out
    elif args._plot_dir:
        out = str(Path(args._plot_dir) / stem)
    else:
        out = str(Path(args.weights).with_name(stem))
    payload = {
        "meta": {
            **{k: meta.get(k, 0) for k in ("version", "epoch", "best_score", "map50",
                                           "ema_updates", "step")},
            "model_cfg": json.dumps(model_cfg),
            "decompose_map": json.dumps(decompose_map),
        },
        "model": {"params": new_params, "batch_stats": new_vars["batch_stats"]},
        "ema": {"params": new_params, "batch_stats": new_vars["batch_stats"]},
    }
    write_checkpoint(out, payload)
    args_yaml = Path(out).with_suffix(".args.yaml")
    args_yaml.write_text(json.dumps({
        "params_before": int(n_before),
        "params_after": int(n_after),
        "loss_thr": args.loss_thr,
        "prune_step": args.prune_step,
        "map50_before": result_before["map50"] if result_before else None,
        "map50_after": result_after["map50"] if result_after else None,
        "report": report,
    }, indent=2) + "\n")
    LOGGER.info("decomposed ckpt: %s (+ %s)", out, args_yaml)
    return {"map50_before": result_before["map50"] if result_before else None,
            "map50_after": result_after["map50"] if result_after else None,
            "decompose_map": decompose_map, "out": out}


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, format="%(message)s", stream=sys.stdout)
    main()
