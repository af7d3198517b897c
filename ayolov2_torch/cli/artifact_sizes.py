"""The sizes of the exported serving artifact in f32, bf16 and int8.

The counterpart of ``cli/artifact_sizes.py``: the golden checkpoint's
yolov5s (nc 20) exported by ``export_serving`` at 320 px, bs 1 with f32
weights, with bf16 weights (``half``) and as the int8 artifact (calibrated
on one seeded random batch: the calibration's content does not change the
size), and the ``.pt2`` sizes in bytes with their ratios. The artifacts are
made for the card unless ``--device cpu``. The JSON goes to ``--out``
(default ``build/artifact_sizes.json``).

Usage: python -m ayolov2_torch.cli.artifact_sizes [--ckpt best.ckpt] [--out build/sizes.json]
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch

from ayolov2_torch.cli.val import device_of

ROOT = Path(__file__).resolve().parents[2]
DEFAULT_CKPT = str(ROOT / "runs/golden_r4_mem/train/2026_0818_runs/weights/best.ckpt")
MODEL_CFG = str(ROOT / "res/configs/model/yolov5s.yaml")


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--ckpt", default=DEFAULT_CKPT)
    p.add_argument("--model-cfg", default=MODEL_CFG)
    p.add_argument("--img-size", type=int, default=320)
    p.add_argument("--nc", type=int, default=20)
    p.add_argument("--out", default="build/artifact_sizes.json")
    p.add_argument("--device", type=str, default="",
                   help="the device the artifacts are made for: the card (default) or cpu")
    return p


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = get_parser().parse_args(argv)

    from ayolov2_torch.compress.quantize import fuse_variables, quantize_model
    from ayolov2_torch.export.exporter import export_serving
    from ayolov2_torch.utils.checkpoint import load_variables

    device = device_of(args.device)
    variables, _ = load_variables(args.ckpt)
    fused = fuse_variables(variables)
    hw = (args.img_size, args.img_size)
    common = dict(batch_size=1, img_size=hw, nc=args.nc, platforms=(device.type,))
    sizes = {}
    with tempfile.TemporaryDirectory() as td:
        for key, half in (("fp32", False), ("bf16", True)):
            paths = export_serving(args.model_cfg, fused, str(Path(td) / key), half=half,
                                   fused_input=True, **common)
            sizes[key] = Path(paths["pt2"]).stat().st_size
            print(f"{key}: {sizes[key]} bytes", flush=True)
        rng = np.random.default_rng(0)
        calib = [torch.from_numpy(rng.integers(0, 255, (1, *hw, 3), np.uint8).astype(np.float32)
                                  / 255.0).to(device).permute(0, 3, 1, 2).to(torch.bfloat16)]
        _, qvars = quantize_model(args.model_cfg, fused, calib, nc=args.nc, device=device)
        paths = export_serving(args.model_cfg, qvars, str(Path(td) / "int8"), quant=True,
                               half=True, **common)
        sizes["int8"] = Path(paths["pt2"]).stat().st_size
        print(f"int8: {sizes['int8']} bytes", flush=True)
    out = {
        "note": (f"Sizes in bytes of the .pt2 serving artifact of {args.ckpt} (yolov5s, "
                 f"nc {args.nc}, {args.img_size} px, bs 1, made for {device.type}) by "
                 f"ayolov2_torch.cli.artifact_sizes on {time.strftime('%Y-%m-%d')}: f32 "
                 "weights, bf16 weights, and the int8 artifact (int8 conv weights, f32 "
                 "scales)."),
        "pt2": sizes,
        "ratios": {"int8_vs_fp32": sizes["int8"] / sizes["fp32"],
                   "int8_vs_bf16": sizes["int8"] / sizes["bf16"],
                   "bf16_vs_fp32": sizes["bf16"] / sizes["fp32"]},
    }
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1))
    print(f"wrote {args.out}", flush=True)
    return out


if __name__ == "__main__":
    main()
    sys.exit(0)
