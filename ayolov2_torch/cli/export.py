"""Export a trained model's serving graph to a ``.pt2`` artifact.

The counterpart of ``cli/export.py``: checkpoint (EMA weights) -> the model
rebuilt from its embedded config (or ``--model-cfg``) -> BN folded ->
``export_serving`` -> ``{out}.pt2`` (``torch.export``) and the sidecar
``{out}.yaml`` that ``cli.val`` reads with the artifact. Without
``--no-dry-run`` the artifact is read back and called on a zero batch.

Usage:
    python -m ayolov2_torch.cli.export --weights best.ckpt --type tpu_nms -iw 640 \\
        --batch-size 32 [--platforms cpu]

The artifact is made for the card unless ``--platforms cpu``; on the card
the early-network kernel is in the graph (the operator
``ayolov2::early_pipeline``) where the model allows it. ``--type tpu_nms``
keeps the NMS in the graph (boxes out); any other type gives the decoded
predictions. ``--raw-hw H W``: native H x W frames in, letterboxed in the
graph, boxes in the frames' coordinates. ``--opset`` and ``--gpu-mem`` are
logged and ignored, as the JAX entry point does. ``--dtype int8
--calib-dir DIR``: the int8 artifact, calibrated on the first
``--calib-batches`` batches of DIR's images (``ImageFolderDataset``,
letterboxed square, /255 in f32, then the compute dtype) by
``--calib-method``; without ``--calib-dir`` int8 falls back to float, as in
the JAX entry point. A decomposed checkpoint (meta ``decompose_map``) is
exported decomposed.
"""

from __future__ import annotations

import argparse
import json
import logging
import sys
from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np

from ayolov2_torch.export import export_serving, load_exported
from ayolov2_torch.export.exporter import export_device
from ayolov2_torch.models.builder import parse_model_config
from ayolov2_torch.utils.checkpoint import decompose_map_of_meta, load_variables

LOGGER = logging.getLogger("export")


def get_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Export a model's serving graph (.pt2).")
    parser.add_argument("--weights", type=str, required=True)
    parser.add_argument("--model-cfg", type=str, default="",
                        help="rebuild under this config (else the checkpoint's)")
    parser.add_argument("--type", type=str, default="tpu_nms", choices=["tpu_nms", "tpu_raw"],
                        help="tpu_nms = boxes out (NMS in the graph); tpu_raw = decoded "
                             "predictions")
    parser.add_argument("--nc", type=int, default=80)
    parser.add_argument("-iw", "--img-width", type=int, default=640)
    parser.add_argument("-ih", "--img-height", type=int, default=-1)
    parser.add_argument("--batch-size", type=int, default=32)
    parser.add_argument("-ct", "--conf-t", type=float, default=0.001)
    parser.add_argument("-it", "--iou-t", type=float, default=0.65)
    parser.add_argument("--top-k", type=int, default=512)
    parser.add_argument("-ktk", "--keep-top-k", type=int, default=100)
    parser.add_argument("--no-half", action="store_true", help="f32 instead of bf16")
    parser.add_argument("--platforms", type=str, default="",
                        help="the device the artifact is made for: cuda (default) or cpu")
    parser.add_argument("--no-dry-run", action="store_true")
    parser.add_argument("--out", type=str, default="")
    parser.add_argument("--dst", type=str, default="",
                        help="export directory; default next to the checkpoint")
    parser.add_argument("--dtype", type=str, default="fp16", choices=["fp16", "int8", "fp32"],
                        help="fp16 is bf16 here; fp32 = --no-half; int8 needs --calib-dir")
    parser.add_argument("--calib-dir", type=str, default="",
                        help="image folder for int8 calibration")
    parser.add_argument("--calib-batches", type=int, default=8,
                        help="calibration batches (int8 only)")
    parser.add_argument("--calib-method", type=str, default="absmax",
                        choices=["absmax", "p999"], help="int8 input-range calibration")
    parser.add_argument("--rect", action="store_true", dest="rect", default=True,
                        help="accepted: the artifact has one fixed shape")
    parser.add_argument("--no-rect", action="store_false", dest="rect")
    parser.add_argument("--opset", type=int, default=11, help="ONNX opset: logged only")
    parser.add_argument("--gpu-mem", type=int, default=6,
                        help="TensorRT workspace GiB: logged only")
    parser.add_argument("--raw-hw", "--raw_hw", type=int, nargs=2, default=None,
                        metavar=("H", "W"),
                        help="native H x W uint8 frames in, letterboxed in the graph, "
                             "boxes in the frames' coordinates")
    parser.add_argument("--verbose", type=int, nargs="?", const=1, default=1)
    return parser


def calibrated_int8(args: argparse.Namespace, model_cfg, variables, decompose_map,
                    device) -> dict:
    """The int8 tree of ``variables``, calibrated on ``--calib-dir``."""
    import torch

    from ayolov2_torch.compress.quantize import quantize_model
    from ayolov2_torch.data.datasets import ImageFolderDataset

    dtype = torch.float32 if args.no_half else torch.bfloat16
    ds = ImageFolderDataset(args.calib_dir, img_size=args.img_width, batch_size=args.batch_size)
    n_img = min(len(ds), args.calib_batches * args.batch_size)
    imgs = np.stack([ds[i][0] for i in range(n_img)])
    batches = [torch.from_numpy(imgs[i:i + args.batch_size].astype(np.float32) / 255.0)
               .to(device).permute(0, 3, 1, 2).to(dtype)
               for i in range(0, n_img, args.batch_size)]
    LOGGER.info("int8 calibration on %d images from %s", n_img, args.calib_dir)
    _, qvars = quantize_model(model_cfg, variables, batches, dtype=dtype, nc=args.nc,
                              decompose_map=decompose_map, method=args.calib_method,
                              device=device)
    return qvars


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, str]:
    args = get_parser().parse_args(argv)
    if args.img_height < 0:
        args.img_height = args.img_width
    platforms = tuple(p for p in args.platforms.split(",") if p)
    if "tpu" in platforms:
        raise SystemExit("--platforms tpu: the port exports for one NVIDIA GPU (cuda) or the "
                         "CPU; a TPU artifact is made by the JAX package's cli/export.py")
    if args.dtype == "fp32":
        args.no_half = True
    elif args.dtype == "int8" and not args.calib_dir:
        # as the JAX entry point: int8 without a calibrator falls back to float
        LOGGER.warning("INT8 calibrator must be provided. Switching to float precision.")
        args.dtype = "fp16"
    LOGGER.info("--opset %d and --gpu-mem %d are not used by a torch.export artifact",
                args.opset, args.gpu_mem)

    variables, meta = load_variables(args.weights, prefer_ema=True,
                                     model_cfg=args.model_cfg or None, nc=args.nc)
    model_cfg = json.loads(meta["model_cfg"]) if meta.get("model_cfg") else None
    if args.model_cfg:
        model_cfg = parse_model_config(args.model_cfg)
    if not model_cfg:
        raise SystemExit("need --model-cfg or a checkpoint with an embedded model config")
    decompose_map = decompose_map_of_meta(meta)
    quant = args.dtype == "int8"
    if quant:
        variables = calibrated_int8(args, model_cfg, variables, decompose_map,
                                    export_device(platforms or None))

    if args.out:
        out = args.out
    elif args.dst:
        Path(args.dst).mkdir(parents=True, exist_ok=True)
        out = str(Path(args.dst) / (Path(args.weights).stem + f"_{args.type}"))
    else:
        out = str(Path(args.weights).with_name(Path(args.weights).stem + f"_{args.type}"))
    paths = export_serving(
        model_cfg,
        variables,
        out,
        batch_size=args.batch_size,
        img_size=(args.img_height, args.img_width),
        nc=args.nc,
        conf_thres=args.conf_t,
        iou_thres=args.iou_t,
        top_k=args.top_k,
        keep_top_k=args.keep_top_k,
        include_nms=args.type == "tpu_nms",
        half=not args.no_half,
        platforms=platforms or None,
        decompose_map=decompose_map,
        quant=quant,
        raw_hw=tuple(args.raw_hw) if args.raw_hw else None,
    )

    if not args.no_dry_run:
        call = load_exported(paths["pt2"])
        in_h, in_w = args.raw_hw if args.raw_hw else (args.img_height, args.img_width)
        outs = call(np.zeros((args.batch_size, in_h, in_w, 3), np.uint8))
        outs = outs if isinstance(outs, tuple) else (outs,)
        LOGGER.info("dry run OK: %s", [tuple(o.shape) for o in outs])
    LOGGER.info("artifacts: %s", paths)
    return paths


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, format="%(message)s", stream=sys.stdout)
    main()
