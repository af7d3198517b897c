"""Validate a trained model: mAP over a labelled val set.

The counterpart of ``cli/val.py``: checkpoint -> the model rebuilt from its
embedded config -> BN folded -> rect val loader -> ``YoloValidator``.
Runs on the card unless ``--device cpu`` is given. ``--tta`` validates with
test-time augmentation (the schedule from ``--tta-cfg``, whose flips are
torch's NCHW dims, mapped to NHWC axes); ``--plot`` writes the PR, F1, P
and R curves and the confusion matrix to ``{dst}/val/{DATE}_runs``;
``--profile`` (``--n-profile`` runs, or ``--profile-step`` N) logs the
validator's forward (with the early-network kernel where it uses it) in
ms per image before validating; ``AYOLO_TRACE_DIR`` traces the loop.
``--int8`` validates the int8 model (``compress/quantize.quantize_model``)
calibrated on the first ``--calib-batches`` val batches (/255 in the
compute dtype) by ``--calib-method``; its layers 1-3 are int8, so it runs
without the early-network kernel. A decomposed checkpoint (meta
``decompose_map``, from ``cli.decompose_model`` or the JAX package's) is
rebuilt decomposed.

Usage:
    python -m ayolov2_torch.cli.val --weights runs/train/xxx/best.ckpt \\
        --data-cfg res/configs/data/coco.yaml [--device cpu] [--json-path out.json]

An exported artifact (``--weights model.pt2``, from ``cli.export``) is
validated through ``load_exported`` with its sidecar's batch size and image
size, square batches (``rect=False``) and the final batch padded; a
sidecar ``{weights}.yaml`` next to any weights overrides the matching
flags. A JAX artifact (``.jaxexp``) is read by the JAX package's
``cli/val.py``, not here.
"""

from __future__ import annotations

import argparse
import json
import logging
import sys
import time
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import torch

from ayolov2_torch.data import DataLoader, DetectionDataset
from ayolov2_torch.eval import YoloValidator
from ayolov2_torch.export import load_exported
from ayolov2_torch.models import build_model, count_params
from ayolov2_torch.models.builder import parse_model_config
from ayolov2_torch.utils.checkpoint import load_model
from ayolov2_torch.utils.config import load_yaml, make_run_dir
from ayolov2_torch.utils.general import check_img_size, resolve_device

LOGGER = logging.getLogger("val")


def get_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Validate a model (mAP over a val set).")
    parser.add_argument("--weights", type=str, default="",
                        help="checkpoint (.ckpt) or exported artifact (.pt2)")
    parser.add_argument("--model-cfg", type=str, default="", help="model config (else the ckpt's)")
    parser.add_argument("--data-cfg", type=str, default="res/configs/data/coco.yaml")
    parser.add_argument("-iw", "--img-width", type=int, default=640)
    parser.add_argument("-ih", "--img-height", type=int, default=-1)
    parser.add_argument("--batch-size", type=int, default=16)
    parser.add_argument("-ct", "--conf-t", type=float, default=0.001)
    parser.add_argument("-it", "--iou-t", type=float, default=0.65)
    parser.add_argument("--device", type=str, default="",
                        help="cuda, cuda:N, N (a card's index) or cpu; default the card")
    parser.add_argument("--dst", type=str, default="exp",
                        help="run dir root: plots go to {dst}/val/{DATE}_runs")
    parser.add_argument("--top-k", type=int, default=512, help="NMS confidence pre-filter top-k")
    parser.add_argument("-ktk", "--keep-top-k", type=int, default=0,
                        help="detections kept after NMS; 0 = --max-det")
    parser.add_argument("--rect", action="store_true", dest="rect", default=True,
                        help="rectangular val batches (default)")
    parser.add_argument("--plot", action="store_true",
                        help="write the PR/F1/P/R curves and the confusion matrix to the run dir")
    parser.add_argument("--profile", action="store_true",
                        help="time the forward before validating (ms per image)")
    parser.add_argument("--n-profile", type=int, default=100, help="runs for --profile")
    parser.add_argument("--half", action="store_true", help="bf16 is already the default")
    parser.add_argument("--tta-cfg", type=str, default="res/configs/cfg/tta.yaml",
                        help="TTA scales and flips (YAML; flips as torch NCHW dims)")
    parser.add_argument("--nms-type", "--nms_type", type=str, default="nms",
                        choices=["nms", "batched_nms", "fast_nms", "matrix_nms", "merge_nms"])
    parser.add_argument("--max-det", type=int, default=300)
    parser.add_argument("--single-cls", action="store_true")
    parser.add_argument("--tta", action="store_true", help="test-time augmentation")
    parser.add_argument("--hybrid-label", action="store_true", help="inject GT into NMS candidates")
    parser.add_argument("--no-half", action="store_true", help="f32 compute instead of bf16")
    parser.add_argument("--no-rect", action="store_false", dest="rect", help="square batches")
    parser.add_argument("--no-fuse", action="store_true", help="skip conv+BN folding")
    parser.add_argument("--int8", action="store_true",
                        help="int8 post-training quantization, calibrated on val batches")
    parser.add_argument("--calib-batches", type=int, default=4,
                        help="calibration batches for --int8")
    parser.add_argument("--calib-method", type=str, default="absmax", choices=["absmax", "p999"],
                        help="int8 input-range calibration for --int8")
    parser.add_argument("--profile-step", type=int, default=0,
                        help="time the forward N times (as --profile)")
    parser.add_argument("-v", "--verbose", type=int, nargs="?", const=1, default=1,
                        help="verbosity (>= 2: per-class metrics)")
    parser.add_argument("--n-skip", type=int, default=0, help="skip every n images")
    parser.add_argument("--json-path", type=str, default="", help="write result metrics JSON here")
    return parser


def device_of(arg: str) -> torch.device:
    """``--device``: '' = the card (raises without CUDA), 'N' = card N."""
    if arg.isdigit():
        arg = f"cuda:{arg}"
    return resolve_device(arg or None)


def refuse_unported(args: argparse.Namespace) -> None:
    if args.weights.endswith(".jaxexp"):
        raise SystemExit(f"{args.weights}: a JAX artifact is read by the JAX package "
                         "(cli/val.py); the port reads the .pt2 artifacts of "
                         "ayolov2_torch.cli.export")


def load_sidecar(weights: str, args: argparse.Namespace) -> None:
    """The sidecar ``{weights}.yaml`` an export writes overrides the flags
    it names (batch size, image size, thresholds, top-k)."""
    sidecar = Path(weights).with_suffix(".yaml")
    if not sidecar.exists():
        return
    for k, v in (load_yaml(str(sidecar)) or {}).items():
        k = k.replace("-", "_")
        if hasattr(args, k):
            setattr(args, k, v)
            LOGGER.info("sidecar override: %s = %s", k, v)


def validate_exported(args: argparse.Namespace, data_cfg: dict, nc: int, names,
                      device: torch.device) -> dict:
    """Validate a ``.pt2`` serving artifact: its fixed (bs, k, 6) detections
    and counts, on square batches of its own size."""
    call = load_exported(args.weights)
    if call.device.type != device.type:
        raise SystemExit(f"{args.weights} was exported for {call.device.type}; pass "
                         f"--device {call.device.type}")
    sidecar = Path(args.weights).with_suffix(".yaml")
    meta = load_yaml(str(sidecar)) if sidecar.exists() else {}
    shape = meta.get("input", {}).get("shape") or [args.batch_size, args.img_height,
                                                   args.img_width, 3]
    bs, h, w = shape[:3]
    dataset = DetectionDataset(
        data_cfg["val_path"], img_size=max(h, w), batch_size=bs, rect=False, stride=32,
        n_skip=args.n_skip,
        label_type="segments" if str(data_cfg.get("dataset", "")).lower() == "coco" else "labels",
        single_cls=args.single_cls,
    )
    loader = DataLoader(dataset, batch_size=bs, pad_final_batch=True)
    validator = YoloValidator(
        None, loader, class_names=names,
        cfg={"nc": nc, "single_cls": args.single_cls, "verbose": args.verbose},
        detection_fn=call, device=call.device,
    )
    result = validator.validation()
    if args.json_path:
        Path(args.json_path).write_text(json.dumps({k: v for k, v in result.items()
                                                    if k != "maps"}, indent=2))
    return result


def load_tta_cfg(path: str) -> Tuple[Optional[List[float]], Optional[List[Optional[int]]]]:
    """(scales, flips) of a TTA YAML, None where it sets none or the file is
    missing; its flips are torch's NCHW dims (2 up-down, 3 left-right),
    returned as NHWC axes (1, 2)."""
    if not path or not Path(path).exists():
        LOGGER.info("TTA: %s not found, the default scales and flips", path)
        return None, None
    cfg = load_yaml(path) or {}
    flips = cfg.get("flips")
    if flips is not None:
        flips = [None if f is None else {2: 1, 3: 2}[int(f)] for f in flips]
    return cfg.get("scales"), flips


def profile_model(serve, img_hw: Tuple[int, int], batch_size: int, n_run: int,
                  device: torch.device) -> float:
    """The forward of ``serve`` (raw maps and decode; the early-network
    kernel where it uses it) on a zero uint8 batch, in ms per image over
    ``n_run`` runs after one warm-up, the card synchronised at both ends."""
    images = torch.zeros((batch_size, img_hw[0], img_hw[1], 3), dtype=torch.uint8, device=device)

    def forward():
        return serve.model.head.decode(serve.raw_maps(images))

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    forward()
    sync()
    t0 = time.perf_counter()
    for _ in range(n_run):
        forward()
    sync()
    dt = (time.perf_counter() - t0) / n_run / batch_size * 1e3
    LOGGER.info("Profile: %.3f ms/image (batch %d, %d runs%s)", dt, batch_size, n_run,
                ", early-network kernel" if serve.early else "")
    return dt


def quantize_on_val(model, loader, n_batches: int, method: str, dtype: torch.dtype,
                    device: torch.device):
    """The fused ``model`` quantized to int8, calibrated on the first
    ``n_batches`` batches of ``loader`` (uint8 -> ``dtype`` -> /255)."""
    from ayolov2_torch.compress.quantize import quantize_model
    from ayolov2_torch.utils.weights import flax_from_state_dict

    batches = []
    for batch in loader:
        images = torch.from_numpy(batch.images).to(device).permute(0, 3, 1, 2)
        batches.append(images.to(dtype) / 255.0)
        if len(batches) >= n_batches:
            break
    LOGGER.info("int8 PTQ: calibrating on %d val batches (%s)", len(batches), method)
    qmodel, _ = quantize_model(model.cfg, flax_from_state_dict(model.state_dict()), batches,
                               dtype=dtype, nc=model.nc, decompose_map=model.decompose_map,
                               method=method, device=device)
    return qmodel


def build_val_model(args: argparse.Namespace, nc: Optional[int], fuse: bool,
                    device: torch.device):
    """The model ``--weights`` holds (or ``--model-cfg``'s with its default
    initialisation), BN folded when ``fuse``, on ``device``."""
    if args.weights:
        return load_model(args.weights, args.model_cfg or None, nc=nc, fuse=fuse, device=device)
    if not args.model_cfg:
        raise SystemExit("need --model-cfg or a checkpoint with an embedded model config")
    LOGGER.warning("no weights given: validating a model with its default initialisation")
    model = build_model(parse_model_config(args.model_cfg), nc=nc, device=device)
    return model.fuse() if fuse else model


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = get_parser().parse_args(argv)
    refuse_unported(args)
    device = device_of(args.device)
    if args.weights:
        load_sidecar(args.weights, args)
    if args.img_height < 0:
        args.img_height = args.img_width

    data_cfg = load_yaml(args.data_cfg)
    nc = 1 if args.single_cls else int(data_cfg["nc"])
    names = data_cfg.get("names") or [str(i) for i in range(nc)]
    if args.weights.endswith(".pt2"):
        return validate_exported(args, data_cfg, nc, names, device)

    model = build_val_model(args, None if args.single_cls else nc, not args.no_fuse, device)
    LOGGER.info("Model: %s params", f"{count_params(model):,}")

    stride = int(max(model.strides))
    h = check_img_size(args.img_height, stride)
    w = check_img_size(args.img_width, stride)
    dataset = DetectionDataset(
        data_cfg["val_path"],
        img_size=max(h, w),
        batch_size=args.batch_size,
        rect=args.rect,
        pad=0.5,
        stride=stride,
        n_skip=args.n_skip,
        label_type="segments" if str(data_cfg.get("dataset", "")).lower() == "coco" else "labels",
        single_cls=args.single_cls,
    )
    loader = DataLoader(dataset, batch_size=args.batch_size)
    if args.int8:
        if args.no_fuse:
            raise SystemExit("--int8 requires the fused serving path (drop --no-fuse)")
        model = quantize_on_val(model, loader, args.calib_batches, args.calib_method,
                                torch.float32 if args.no_half else torch.bfloat16, device)

    tta_scales = tta_flips = None
    if args.tta:
        tta_scales, tta_flips = load_tta_cfg(args.tta_cfg)
    plot_dir = None
    if args.plot:
        plot_dir = str(make_run_dir(args.dst, "val"))
        LOGGER.info("plots -> %s", plot_dir)
    validator = YoloValidator(
        model,
        loader,
        class_names=names,
        cfg={
            "conf_t": args.conf_t,
            "iou_t": args.iou_t,
            "nms_type": args.nms_type,
            "single_cls": args.single_cls,
            "max_det": args.keep_top_k or args.max_det,
            "pre_top_k": args.top_k,
            "hybrid_label": args.hybrid_label,
            "half": not args.no_half,
            "verbose": args.verbose,
            "tta": args.tta,
            "tta_scales": tta_scales,
            "tta_flips": tta_flips,
            "plot_dir": plot_dir,
        },
        device=device,
    )
    if args.profile_step > 0 or args.profile:
        profile_model(validator.serve, (h, w), args.batch_size,
                      args.profile_step or args.n_profile, device)
    result = validator.validation()
    if args.json_path:
        out = {k: v for k, v in result.items() if k != "maps"}
        Path(args.json_path).write_text(json.dumps(out, indent=2))
    return result


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, format="%(message)s", stream=sys.stdout)
    main()
