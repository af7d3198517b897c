"""Train-step stage breakdown, batch-size sweep and remat cost on one device.

The counterpart of ``cli/profile_train.py``, with its flags, row names, JSON
keys and ``--out`` file. The stages of ``train/train_state.make_train_step``
(bf16 autocast, channels_last on the card), each timed alone with
``utils/profiling.time_call``:

  fwd         forward in train mode (BatchNorm statistics advance), no tape
  loss        ComputeLoss with build_targets            (= fwd_loss - fwd)
  bwd         backward                                  (= grad - fwd_loss)
  opt_ema     optimizer update + EMA                    (= full - grad; also
              measured directly on fixed gradients as a cross-check)

plus a batch-size sweep of the full step, the cost of each remat mode
(``true`` and ``save_convs``) with the step's activation memory, and the
donation row. MFU: the FLOPs of one step from
``torch.utils.flop_counter.FlopCounterMode`` (``flops_source``), else 49e9
per image as the JAX package assumes, over the card's bf16 dense peak chosen
by its name (H100 SXM 989e12, H100 PCIe 756e12; another card or the CPU has
no MFU).

PyTorch has nothing to donate: the optimizer and the EMA update the state in
place (``_foreach_lerp_``), which is what donation buys XLA. The
``train_step_donated`` row reports the step and its peak allocated memory
with a ``note`` that says so.

Usage:
    python -m ayolov2_torch.cli.profile_train [--bs-sweep 8 16 32 64] \\
        [--out runs/bench_matrix/train_breakdown.json] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ayolov2_torch.utils.general import resolve_device
from ayolov2_torch.utils.profiling import device_record, synchronize, time_call

SIZE = 640
MODEL_CFG = "res/configs/model/yolov5s.yaml"
# ~49 GFLOP/img fwd+bwd for yolov5s@640: used only where the FLOP counter fails
FLOP_PER_IMG_FALLBACK = 49e9
BF16_DENSE_PEAK = {"H100 PCIe": 756e12, "H100": 989e12}  # by the card's name, first match

HYP = {"optimizer_params": {"lr": 0.01}, "box": 0.05, "cls": 0.5, "obj": 1.0,
       "cls_pw": 1.0, "obj_pw": 1.0, "anchor_t": 4.0, "fl_gamma": 0.0,
       "label_smoothing": 0.0, "weight_decay": 5e-4, "lrf": 0.1,
       "momentum": 0.937, "warmup_epochs": 3.0, "warmup_momentum": 0.8,
       "warmup_bias_lr": 0.1}
DONATE_NOTE = ("nothing to donate in PyTorch: the optimizer and the EMA update the state in "
               "place (_foreach_lerp_); the row is the step itself and its peak allocated "
               "memory")


def bf16_peak(device: torch.device) -> Optional[float]:
    """The card's bf16 dense tensor-core peak by its name, or None."""
    if device.type != "cuda":
        return None
    name = torch.cuda.get_device_name(device)
    return next((v for k, v in BF16_DENSE_PEAK.items() if k in name), None)


def _make_batch(bs: int, nc: int, size: int = 0, device="cpu"):
    """The JAX package's synthetic batch: uint8 images from default_rng(0),
    one centred box per image, as tensors on ``device``."""
    size = size or SIZE
    rng = np.random.default_rng(0)
    images = rng.integers(0, 255, (bs, size, size, 3), dtype=np.uint8)
    targets = np.zeros((bs * 64, 6), np.float32)
    mask = np.zeros((bs * 64,), bool)
    for i in range(bs):
        targets[i] = [i, i % nc, 0.5, 0.5, 0.25, 0.25]
        mask[i] = True
    return tuple(torch.from_numpy(a).to(device) for a in (images, targets, mask))


def build(bs: int, device: torch.device, remat=False):
    """(train state, loss, step) of yolov5s (``init_model``, seed 0) as the
    trainer builds them, on ``device``."""
    from ayolov2_torch.loss.yolo_loss import ComputeLoss
    from ayolov2_torch.models import build_model, init_model
    from ayolov2_torch.train.optimizer import build_optimizer
    from ayolov2_torch.train.train_state import create_train_state, make_train_step

    model = init_model(build_model(MODEL_CFG, device="cpu", remat=remat), seed=0).to(device)
    if device.type == "cuda":
        model = model.to(memory_format=torch.channels_last)
    loss_fn = ComputeLoss.from_hyp(model.head.stride_anchors(), model.nc, HYP)
    opt = build_optimizer(model, HYP, epochs=300, steps_per_epoch=100, batch_size=bs)
    return create_train_state(model, opt), loss_fn, make_train_step(loss_fn)


def step_flops(state, loss_fn, batch) -> Optional[float]:
    """FLOPs of one forward + loss + backward (FlopCounterMode), or None."""
    from torch.utils.flop_counter import FlopCounterMode

    from ayolov2_torch.train.train_state import train_forward

    try:
        with FlopCounterMode(display=False) as counter:
            total, _ = train_forward(state.model, loss_fn, *batch)
            total.backward()
        state.model.zero_grad(set_to_none=True)
        return float(counter.get_total_flops()) or None
    except Exception:  # a counter that fails leaves the analytic fallback
        return None


def activation_mb(step, state, batch, device: torch.device) -> Optional[float]:
    """Peak memory one step allocates above what was allocated before it
    (activations and temporaries), in MB; None off the card."""
    if device.type != "cuda":
        return None
    synchronize(device)
    before = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    step(state, *batch)
    synchronize(device)
    return round((torch.cuda.max_memory_allocated(device) - before) / 1e6, 1)


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="train step stage breakdown")
    p.add_argument("--batch-size", type=int, default=32, help="breakdown batch size")
    p.add_argument("--bs-sweep", type=int, nargs="*", default=[8, 16, 32, 64],
                   help="full-step batch sizes to sweep (empty to skip)")
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--img-size", type=int, default=SIZE,
                   help="lower for CPU smoke runs (e.g. 64)")
    p.add_argument("--skip-remat", action="store_true")
    p.add_argument("--skip-donate", action="store_true")
    p.add_argument("--skip-breakdown", action="store_true",
                   help="skip the stage-isolated fwd/loss/bwd/opt timings; still measures the "
                        "full step (the remat/donate baseline)")
    p.add_argument("--out", type=str, default="")
    p.add_argument("--device", type=str, default="",
                   help="cuda (default; exits without CUDA) or cpu")
    return p


def main(argv: Optional[Sequence[str]] = None) -> int:
    global SIZE
    args = get_parser().parse_args(argv)
    SIZE = args.img_size
    device = resolve_device(args.device or None)
    peak = bf16_peak(device)

    from ayolov2_torch.train.train_state import EMA, finish_step, to_input, train_forward

    rows = []

    def emit(**row) -> None:
        rows.append(row)
        print(json.dumps(row), flush=True)

    def mfu(flops: float, t: float) -> Optional[float]:
        return round(100 * flops / t / peak, 1) if peak else None

    bs = args.batch_size
    state, loss_fn, step = build(bs, device)
    batch = _make_batch(bs, state.model.nc, device=device)
    images, targets, mask = batch
    t_full = time_call(lambda: step(state, *batch), device, args.iters)

    if not args.skip_breakdown:
        model = state.model

        @torch.no_grad()
        def fwd_only():
            model.train()
            with torch.autocast(device_type=device.type, dtype=torch.bfloat16):
                raw = model(to_input(images, torch.bfloat16), training=True)
            return sum(r.float().sum() for r in raw)

        @torch.no_grad()
        def fwd_loss():
            return train_forward(model, loss_fn, *batch)[0]

        def grad():
            model.zero_grad(set_to_none=True)
            train_forward(model, loss_fn, *batch)[0].backward()

        t_fwd = time_call(fwd_only, device, args.iters)
        t_fwd_loss = time_call(fwd_loss, device, args.iters)
        t_grad = time_call(grad, device, args.iters)
        model.zero_grad(set_to_none=True)

        # optimizer + EMA alone, on fixed gradients (a cross-check of full - grad)
        params = list(model.parameters())
        fixed = [torch.full_like(p, 1e-4) for p in params]
        ema = EMA()

        def opt_ema():
            for p, g in zip(params, fixed):
                p.grad = g
            finish_step(state, ema)

        t_opt_direct = time_call(opt_ema, device, args.iters)
        flops = step_flops(state, loss_fn, batch)
        step_total = flops if flops else FLOP_PER_IMG_FALLBACK * bs
        emit(metric="train_stage_breakdown", batch_size=bs,
             fwd_ms=round(t_fwd * 1e3, 2),
             loss_ms=round((t_fwd_loss - t_fwd) * 1e3, 2),
             bwd_ms=round((t_grad - t_fwd_loss) * 1e3, 2),
             opt_ema_ms=round((t_full - t_grad) * 1e3, 2),
             opt_ema_direct_ms=round(t_opt_direct * 1e3, 2),
             full_ms=round(t_full * 1e3, 2),
             img_per_s=round(bs / t_full, 1),
             mfu_pct=mfu(step_total, t_full),
             flops_per_step=step_total,
             flops_source="flop_counter" if flops else "analytic_49gf_per_img")
        per_img = step_total / bs
    else:
        per_img = FLOP_PER_IMG_FALLBACK
        emit(metric="train_step_full", batch_size=bs,
             ms_per_step=round(t_full * 1e3, 2), img_per_s=round(bs / t_full, 1),
             mfu_pct=mfu(per_img * bs, t_full))

    # --- batch-size sweep of the full step ---
    for b in args.bs_sweep:
        try:
            st2, _, step2 = build(b, device)
            batch2 = _make_batch(b, st2.model.nc, device=device)
            t = time_call(lambda: step2(st2, *batch2), device, args.iters)
            emit(metric=f"train_step_bs{b}", batch_size=b,
                 ms_per_step=round(t * 1e3, 2), img_per_s=round(b / t, 1),
                 mfu_pct=mfu(per_img * b, t))
            del st2, batch2
        except (RuntimeError, MemoryError) as e:  # e.g. out of memory at a large bs
            emit(metric=f"train_step_bs{b}", batch_size=b, error=repr(e)[:200])
        if device.type == "cuda":
            torch.cuda.empty_cache()

    # --- remat cost at the breakdown batch size ---
    if not args.skip_remat:
        base_temp = activation_mb(step, state, batch, device)
        for mode in (True, "save_convs"):
            str_, _, stepr = build(bs, device, remat=mode)
            t_remat = time_call(lambda: stepr(str_, *batch), device, args.iters)
            emit(metric="train_step_remat", remat_mode=str(mode), batch_size=bs,
                 ms_per_step=round(t_remat * 1e3, 2),
                 baseline_ms=round(t_full * 1e3, 2),
                 overhead_pct=round(100 * (t_remat - t_full) / t_full, 1),
                 temp_mb=activation_mb(stepr, str_, batch, device),
                 baseline_temp_mb=base_temp)
            del str_

    # --- donation: nothing to donate, the state updates in place ---
    if not args.skip_donate:
        row: Dict = dict(metric="train_step_donated", batch_size=bs,
                         ms_per_step=round(t_full * 1e3, 2), baseline_ms=round(t_full * 1e3, 2),
                         delta_pct=0.0, note=DONATE_NOTE)
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
            step(state, *batch)
            synchronize(device)
            row["max_memory_allocated_mb"] = round(torch.cuda.max_memory_allocated(device) / 1e6,
                                                   1)
        emit(**row)

    if args.out:
        out = Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps({"device": device_record(device), "img_size": SIZE,
                                   "rows": rows}, indent=1))
        print(f"wrote {out}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
