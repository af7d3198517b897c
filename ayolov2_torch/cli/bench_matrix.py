"""Benchmark matrix: serving, its variants and the train step on one device.

The counterpart of ``cli/bench_matrix.py``, with its flags, row names, JSON
keys and ``--out`` file. Prints one JSON line per row:

    {"metric": ..., "value": ..., "unit": "images/sec/chip", "ms_per_batch": ...}

Rows (``--configs``):
  serve       ``make_serving_fn`` of the model, the early-network kernel on
              (``k1_launches_per_call`` counts its launches per call)
  int8        ``compress/quantize.quantize_model`` (calibrated on the batch)
  tta         ``ops/tta.tta_decode`` (the kernel in the unscaled branch)
  decomposed  ``compress/decomposition.decompose_model`` (Tucker-2)
  train       ``train/train_state.make_train_step`` on a fixed batch
  latency     bs 1 p50 with the round trip of a one-element read beside it
  sweep       serve at ``--sweep-batch-sizes`` x ``--sweep-prefilters``; the
              port's approximate prefilter is the exact top-k, so each batch
              size is timed once and its approx row repeats the exact row's
              time (a ``note`` says so)
  h2d         host batches through ``parallel/serve.serve_stream``
              (double-buffered) against copy, synchronise, serve
  train_e2e   the loader feeding the step on ``--data``'s train images,
              with host and with device augmentation, the step alone and
              the renderer alone

Every time is ``utils/profiling.time_call``: chained calls between two
synchronisations of the device, after warm-up. Runs on the card unless
``--device cpu``; without CUDA it exits.

Usage: python -m ayolov2_torch.cli.bench_matrix [--configs serve tta decomposed train]
    [--iters 20] [--out runs/bench_matrix/NAME.json] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np
import torch

from ayolov2_torch.utils.general import resolve_device
from ayolov2_torch.utils.profiling import device_record, synchronize, time_call

BATCH, SIZE = 32, 640
H2D_BATCHES = (32, 128)
MODEL_CFG = "res/configs/model/yolov5s.yaml"
HYP = {"optimizer_params": {"lr": 0.01}, "box": 0.05, "cls": 0.5, "obj": 1.0,
       "cls_pw": 1.0, "obj_pw": 1.0, "anchor_t": 4.0, "fl_gamma": 0.0,
       "label_smoothing": 0.0, "weight_decay": 5e-4, "lrf": 0.1,
       "momentum": 0.937, "warmup_epochs": 3.0, "warmup_momentum": 0.8,
       "warmup_bias_lr": 0.1}
NMS_KW = dict(conf_thres=0.001, iou_thres=0.65, nms_box=512, top_k=512, keep_top_k=100,
              multi_label=False)
APPROX_NOTE = ("the port's approx prefilter is the exact top-k: lax.approx_max_k is a TPU "
               "approximation with no GPU counterpart (ops/nms.fused_decode_nms); the "
               "value is the exact row's timing at this batch size")

ROWS: list = []  # every emitted row, for the --out artifact


def _emit(name: str, t: float, batch: Optional[int] = None, **extra) -> dict:
    batch = BATCH if batch is None else batch
    row = {"metric": name, "value": round(batch / t, 2), "unit": "images/sec/chip",
           "ms_per_batch": round(t * 1e3, 2), **extra}
    ROWS.append(row)
    print(json.dumps(row), flush=True)
    return row


def _row(row: dict) -> dict:
    ROWS.append(row)
    print(json.dumps(row), flush=True)
    return row


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="benchmark matrix of the serving and train paths")
    p.add_argument("--configs", nargs="+",
                   default=["serve", "tta", "decomposed", "train", "latency"],
                   choices=["serve", "int8", "tta", "decomposed", "train", "latency",
                            "sweep", "h2d", "train_e2e"])
    p.add_argument("--model-cfg", type=str, default=MODEL_CFG,
                   help="model YAML for every config (family sweeps: yolov5m/l/x)")
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--sweep-batch-sizes", type=int, nargs="+", default=[32, 64, 128],
                   help="batch sizes for the serve operating-point sweep")
    p.add_argument("--sweep-prefilters", nargs="+", default=["exact", "approx"],
                   choices=["exact", "approx"],
                   help="objectness-prefilter variants to sweep (approx is the exact top-k "
                        "here: the row's note says so)")
    p.add_argument("--out", type=str, default="",
                   help="also write every row to this JSON file")
    p.add_argument("--data", type=str, default="res/configs/data/voc_fixture.yaml",
                   help="train_e2e: the data config whose train_path it reads")
    p.add_argument("--device", type=str, default="",
                   help="cuda (default; exits without CUDA) or cpu")
    return p


def _serve_model(model_cfg):
    """The unfused model (init_model, seed 0, on the CPU) and its JAX-layout
    variables."""
    from ayolov2_torch.models import build_model, init_model
    from ayolov2_torch.utils.weights import flax_from_state_dict

    model = init_model(build_model(model_cfg, device="cpu"), seed=0)
    return model, flax_from_state_dict(model.state_dict())


def _serving_fn(fused_model, device: torch.device):
    from ayolov2_torch.export import make_serving_fn

    return make_serving_fn(fused_model, device=device, **NMS_KW)


def train_e2e_images(data_cfg_path: str) -> Path:
    """The train image directory of ``--data``; exits naming the path where
    the config or its images are missing (no row is skipped silently)."""
    from ayolov2_torch.utils.config import load_yaml

    if not Path(data_cfg_path).exists():
        raise SystemExit(f"train_e2e: data config {data_cfg_path} not found")
    path = Path(str(load_yaml(data_cfg_path)["train_path"]))
    if not path.is_dir() or not any(path.iterdir()):
        raise SystemExit(f"train_e2e: no train images at {path} (train_path of "
                         f"{data_cfg_path}); pass --data with a data config whose images exist")
    return path


def train_e2e_rows(name: str, model_cfg, data_cfg_path: str, iters: int,
                   device: torch.device) -> None:
    """The loader feeding the step, host- and device-augmented; the step on a
    resident batch; the renderer alone. AYOLO_TRAIN_E2E_SIZE, _BS, _MODES and
    _EPOCHS as in the JAX package."""
    from ayolov2_torch.data import DataLoader, DetectionDataset
    from ayolov2_torch.data.device_augment import DeviceAugmenter
    from ayolov2_torch.loss.yolo_loss import ComputeLoss
    from ayolov2_torch.models import build_model, init_model
    from ayolov2_torch.train.optimizer import build_optimizer
    from ayolov2_torch.train.train_state import create_train_state, make_train_step
    from ayolov2_torch.utils.config import load_yaml
    from ayolov2_torch.utils.general import host_to_device

    images = train_e2e_images(data_cfg_path)
    tr_size = int(os.environ.get("AYOLO_TRAIN_E2E_SIZE", 320))
    tr_bs = int(os.environ.get("AYOLO_TRAIN_E2E_BS", 16))
    cfg_all = load_yaml("res/configs/cfg/train_config.yaml")
    ya = dict(cfg_all.get("yolo_augmentation") or {})
    ya.update(augment=True, mosaic=1.0, mixup=0.0, copy_paste=0.0)
    ya["copy_paste2"] = {"p": 0.0}

    def fresh_state():
        model = init_model(build_model(model_cfg, device="cpu"), seed=0).to(device)
        if device.type == "cuda":
            model = model.to(memory_format=torch.channels_last)
        opt = build_optimizer(model, HYP, epochs=300, steps_per_epoch=100, batch_size=tr_bs)
        loss_fn = ComputeLoss.from_hyp(model.head.stride_anchors(), model.nc, HYP)
        return create_train_state(model, opt), make_train_step(loss_fn)

    modes = tuple(os.environ.get("AYOLO_TRAIN_E2E_MODES", "host,device").split(","))
    n_epochs = int(os.environ.get("AYOLO_TRAIN_E2E_EPOCHS", 3))
    last_batch, augmenter = None, None
    for mode in modes:
        ds = DetectionDataset(str(images), img_size=tr_size, batch_size=tr_bs, rect=False,
                              stride=32, cache_images="mem", yolo_augmentation=ya)
        if mode == "device":
            ds.enable_device_aug(resident=True)
            augmenter = DeviceAugmenter(tr_size, tr_size, 1, resident_frames=ds.resident_frames,
                                        device=device)
        loader = DataLoader(ds, batch_size=tr_bs, shuffle=True, drop_last=True, workers=2)
        state, step = fresh_state()
        n_img, t0, items = 0, None, None
        for epoch in range(n_epochs):
            for batch in loader:
                imgs = (augmenter(batch) if mode == "device"
                        else host_to_device(batch.images, device))
                items = step(state, imgs, host_to_device(batch.targets, device),
                             host_to_device(batch.target_mask, device))
                last_batch = batch
                if t0 is not None:
                    n_img += tr_bs
            if epoch == 0:  # timing starts after the first epoch (caches, cuDNN's choices)
                synchronize(device)
                t0 = time.perf_counter()
        synchronize(device)
        dt = time.perf_counter() - t0
        _row({"metric": f"{name}_{tr_size}_bs{tr_bs}_train_e2e_{mode}_aug",
              "value": round(n_img / dt, 2) if dt > 0 else float("nan"),
              "unit": "images/sec/chip", "epochs_timed": n_epochs - 1,
              "finite": bool(items is not None and torch.isfinite(items).all()),
              "note": f"real loader + real step, overlapped (2 workers); {mode}-side "
                      "augmentation"})

    if last_batch is None:
        return
    rng = np.random.default_rng(0)
    imgs_r = torch.from_numpy(rng.integers(0, 255, (tr_bs, tr_size, tr_size, 3),
                                           dtype=np.uint8)).to(device)
    tgts_r = host_to_device(last_batch.targets, device)
    mask_r = host_to_device(last_batch.target_mask, device)
    state, step = fresh_state()
    t = time_call(lambda: step(state, imgs_r, tgts_r, mask_r), device, iters)
    _emit(f"{name}_{tr_size}_bs{tr_bs}_train_step_only", t, batch=tr_bs,
          note="device-resident inputs, chained iters — the e2e ceiling")
    if "device" in modes and last_batch.images is None:
        pb = last_batch
        t = time_call(lambda: augmenter(pb), device, iters)
        dt_name = str(augmenter.dtype).replace("torch.", "")
        _emit(f"{name}_{tr_size}_bs{tr_bs}_render_only_{dt_name}", t, batch=tr_bs,
              render_mode=augmenter.mode,
              note="device-aug renderer alone (chained iters, resident frames)")


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = get_parser().parse_args(argv)
    device = resolve_device(args.device or None)
    ROWS.clear()
    if "train_e2e" in args.configs:
        train_e2e_images(args.data)  # exits naming the path before any row is timed

    from ayolov2_torch.ops import early_pipeline as early
    from ayolov2_torch.parallel import serve_stream

    rng = np.random.default_rng(0)
    images = torch.from_numpy(rng.integers(0, 255, (BATCH, SIZE, SIZE, 3),
                                           dtype=np.uint8)).to(device)
    name = Path(args.model_cfg).stem
    unfused, variables = _serve_model(args.model_cfg)
    fused = unfused.fuse()
    shape = dict(batch_size=BATCH, img_size=SIZE)

    if "serve" in args.configs:
        serve = _serving_fn(fused, device)
        before = early.early_pipeline.launches
        serve(images)
        launches = early.early_pipeline.launches - before
        t = time_call(lambda: serve(images), device, args.iters)
        _emit(f"{name}_640_bs32_serve", t, early=serve.early, k1_launches_per_call=launches,
              **shape)

    if "int8" in args.configs:
        from ayolov2_torch.compress.quantize import quantize_model

        calib = [images.permute(0, 3, 1, 2).to(torch.bfloat16) / 255.0]
        qmodel, _ = quantize_model(args.model_cfg, variables, calib, dtype=torch.bfloat16,
                                   device=device)
        serve_q = _serving_fn(qmodel, device)
        _emit(f"{name}_640_bs32_serve_int8", time_call(lambda: serve_q(images), device,
                                                       args.iters), early=serve_q.early, **shape)

    if "sweep" in args.configs:
        # both prefilters run one function here, so each batch size is timed once
        serve_s = _serving_fn(fused, device)
        times = {}
        for bs in args.sweep_batch_sizes:
            imgs_b = torch.from_numpy(rng.integers(0, 255, (bs, SIZE, SIZE, 3),
                                                   dtype=np.uint8)).to(device)
            times[bs] = time_call(lambda: serve_s(imgs_b), device, args.iters)
            del imgs_b
        for prefilter in args.sweep_prefilters:
            for bs in args.sweep_batch_sizes:
                extra = {"note": APPROX_NOTE} if prefilter == "approx" else {}
                _emit(f"{name}_640_bs{bs}_serve_{prefilter}", times[bs], batch=bs,
                      batch_size=bs, prefilter=prefilter, img_size=SIZE, **extra)

    if "latency" in args.configs:
        serve1 = _serving_fn(fused, device)
        img1 = images[:1]
        one = torch.zeros((1,), device=device)
        for _ in range(3):
            serve1(img1)[0].sum().item()
        samples, rtts = [], []
        for _ in range(30):
            t0 = time.perf_counter()
            serve1(img1)[0].sum().item()
            samples.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            one.sum().item()
            rtts.append(time.perf_counter() - t0)
        p50, rtt = float(np.median(samples)), float(np.median(rtts))
        _row({"metric": f"{name}_640_bs1_p50_latency_ms", "value": round(p50 * 1e3, 2),
              "unit": "ms", "sync_rtt_ms": round(rtt * 1e3, 2),
              "p50_minus_rtt_ms": round((p50 - rtt) * 1e3, 2), "img_size": SIZE})

    if "h2d" in args.configs:
        serve_h = _serving_fn(fused, device)
        for bs in H2D_BATCHES:
            hosts = [np.ascontiguousarray(rng.integers(0, 255, (bs, SIZE, SIZE, 3),
                                                       dtype=np.uint8)) for _ in range(2)]
            serve_h(torch.from_numpy(hosts[0]).to(device))
            synchronize(device)

            def run_overlap(n=args.iters):
                t0, det = time.perf_counter(), None
                for det, _ in serve_stream(serve_h, (hosts[i % 2] for i in range(n)), depth=2,
                                           device=device):
                    pass
                det.sum().item()
                return (time.perf_counter() - t0) / n

            def run_serial(n=args.iters):
                t0 = time.perf_counter()
                for i in range(n):
                    cur = torch.from_numpy(hosts[i % 2]).to(device)
                    synchronize(device)
                    det, _ = serve_h(cur)
                    det.sum().item()
                return (time.perf_counter() - t0) / n

            run_overlap(3)
            t_ov = run_overlap()
            run_serial(3)
            t_se = run_serial()
            for tag, t in (("overlap", t_ov), ("serial", t_se)):
                _emit(f"{name}_640_bs{bs}_e2e_h2d_{tag}", t, batch=bs, batch_size=bs,
                      img_size=SIZE,
                      h2d="double-buffered" if tag == "overlap" else "per-iter sync",
                      caveat="host numpy batches: serve_stream pins each batch and copies on "
                             "a side stream; the serial row copies pageable memory")

    if "train_e2e" in args.configs:
        train_e2e_rows(name, args.model_cfg, args.data, args.iters, device)

    if "tta" in args.configs:
        from ayolov2_torch.ops.tta import tta_decode

        serve_t = _serving_fn(fused, device)
        _emit(f"{name}_640_bs32_tta_serve",
              time_call(lambda: tta_decode(serve_t, images, torch.bfloat16), device,
                        args.iters), early=serve_t.early, **shape)

    if "decomposed" in args.configs:
        from ayolov2_torch.compress.decomposition import decompose_model
        from ayolov2_torch.models import build_model
        from ayolov2_torch.utils.weights import load_flax_variables

        dmap, dparams, _ = decompose_model(variables["params"], loss_thr=0.1, n_test=64)
        dmodel = build_model(args.model_cfg, device="cpu",
                             decompose_map=tuple((k, tuple(v)) for k, v in dmap.items()))
        dmodel = load_flax_variables(dmodel, {"params": dparams,
                                              "batch_stats": variables.get("batch_stats", {})})
        serve_d = _serving_fn(dmodel.fuse(), device)
        _emit(f"{name}_640_bs32_decomposed_serve",
              time_call(lambda: serve_d(images), device, args.iters),
              decomposed_layers=len(dmap), early=serve_d.early, **shape)

    if "train" in args.configs:
        from ayolov2_torch.loss.yolo_loss import ComputeLoss
        from ayolov2_torch.train.optimizer import build_optimizer
        from ayolov2_torch.train.train_state import create_train_state, make_train_step

        model, _ = _serve_model(args.model_cfg)
        model = model.to(device)
        if device.type == "cuda":
            model = model.to(memory_format=torch.channels_last)
        opt = build_optimizer(model, HYP, epochs=300, steps_per_epoch=100, batch_size=BATCH)
        state = create_train_state(model, opt)
        step = make_train_step(ComputeLoss.from_hyp(model.head.stride_anchors(), model.nc, HYP))
        targets = np.zeros((BATCH * 64, 6), np.float32)
        mask = np.zeros((BATCH * 64,), bool)
        for i in range(BATCH):
            targets[i] = [i, i % model.nc, 0.5, 0.5, 0.25, 0.25]
            mask[i] = True
        targets, mask = torch.from_numpy(targets).to(device), torch.from_numpy(mask).to(device)
        _emit(f"{name}_640_bs32_train_step",
              time_call(lambda: step(state, images, targets, mask), device, args.iters),
              **shape)

    if args.out:
        out = Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps({"device": device_record(device), "rows": ROWS}, indent=1))
        print(f"wrote {len(ROWS)} rows to {out}", file=sys.stderr)
    return 0


def rows_finite(rows: List[dict]) -> bool:
    """Every number of every row is finite."""
    return all(np.isfinite(v) for row in rows for v in row.values()
               if isinstance(v, (int, float)) and not isinstance(v, bool))


if __name__ == "__main__":
    sys.exit(main())
