"""int8 against bf16 for one conv: the yardstick of the int8 serving route.

The counterpart of ``cli/probe_int8_conv.py``. A mid-network conv (3x3,
cin = cout = 256 at 80x80, bs 32 by default) in three forms, each timed
with CUDA events after warm-up (a host timer with ``--device cpu``):

  1. bf16 x bf16 on cuDNN (``F.conv2d``, channels_last), the serving default;
  2. s8 x s8 -> s32: the int8 route of ``ops/int8_conv.py`` (NHWC im2col,
     then ``torch._int_mm``); and its product alone on a ready im2col;
  3. the whole int8 layer: f32 -> round/clip to s8 -> the s8 conv ->
     dequantize (``layers.QuantConv``), what an int8 serving graph pays.

Each row is printed as one JSON line with the card's name and power limit;
``--out`` also writes them to a file (default none; e.g. under ``build/``).

Usage: python -m ayolov2_torch.cli.probe_int8_conv [--out build/int8_probe.json]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path
from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ayolov2_torch.cli.val import device_of
from ayolov2_torch.models.layers import QuantConv
from ayolov2_torch.ops.int8_conv import im2col, int8_conv, int8_matmul, weight_matrix


def card_name() -> str:
    """``nvidia-smi``'s name and power limit of the cards, or why not."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30).stdout.strip()
        return out.splitlines()[0] if out else "nvidia-smi: no output"
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable: {e}"


def time_ms(fn: Callable, device: torch.device, iters: int, warmup: int = 3) -> float:
    """Mean ms of fn() over ``iters`` calls: CUDA events on the card."""
    for _ in range(warmup):
        fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) / iters * 1e3
    torch.cuda.synchronize(device)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / iters


def probe(batch: int = 32, hw: int = 80, channels: int = 256, kernel: int = 3,
          iters: int = 20, device=None) -> list:
    """The rows: [{"metric", "ms", "shape"}, ...]."""
    device = device_of(device or "")
    rng = np.random.default_rng(0)
    b, c, k = batch, channels, kernel
    x_f = torch.from_numpy(rng.normal(size=(b, hw, hw, c)).astype(np.float32)).to(device)
    x_f = x_f.permute(0, 3, 1, 2)  # NCHW view, channels_last
    w_f = torch.from_numpy(rng.normal(size=(c, c, k, k)).astype(np.float32) * 0.05).to(device)
    x_s8 = torch.from_numpy(rng.integers(-127, 127, (b, hw, hw, c), dtype=np.int8)).to(device)
    w_s8 = torch.from_numpy(rng.integers(-127, 127, (c, c, k, k), dtype=np.int8)).to(device)
    x_bf = x_f.to(torch.bfloat16)
    w_bf = w_f.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    layer = QuantConv(c, c, k, 1, k // 2).to(device)
    layer.q_kernel.copy_(w_s8)
    layer.w_scale.fill_(0.01)
    layer.in_scale.fill_(0.05 * 127)
    cols, _ = im2col(x_s8, k, 1, k // 2)
    wm = weight_matrix(w_s8)
    shape = f"{k}x{k} cin=cout={c} @ {hw}x{hw} bs{b}"
    forms = {
        "conv_bf16xbf16_cudnn": lambda: F.conv2d(x_bf, w_bf, padding=k // 2),
        "conv_s8xs8_s32acc_im2col_int_mm": lambda: int8_conv(x_s8, w_s8, 1, k // 2),
        "int_mm_s8xs8_s32acc_product_only": lambda: int8_matmul(cols, wm),
        "conv_ptq_chain_quant_conv_dequant": lambda: layer(x_f),
    }
    rows = []
    with torch.no_grad():
        for name, fn in forms.items():
            rows.append({"metric": name, "ms": time_ms(fn, device, iters), "shape": shape})
    return rows


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="int8 vs bf16 conv micro-probe")
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--hw", type=int, default=80)
    p.add_argument("--channels", type=int, default=256)
    p.add_argument("--kernel", type=int, default=3)
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--out", type=str, default="")
    p.add_argument("--device", type=str, default="",
                   help="cuda, cuda:N, N (a card's index) or cpu; default the card")
    return p


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = get_parser().parse_args(argv)
    device = device_of(args.device)
    card = card_name() if device.type == "cuda" else "cpu"
    rows = probe(args.batch, args.hw, args.channels, args.kernel, args.iters, args.device)
    for row in rows:
        row["device"] = card
        print(json.dumps(row), flush=True)
    if args.out:
        out = Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps({"device": card, "rows": rows}, indent=1))
        print(f"wrote {out}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
