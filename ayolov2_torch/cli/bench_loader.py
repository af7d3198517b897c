"""Input pipeline against the train step: which one paces training.

The counterpart of ``cli/bench_loader.py``, with its flags and its JSON line.
Measures, separately:
  - loader img/s: ``DetectionDataset`` under the train config's augmentation
    through the ``DataLoader``'s workers, in thread and in process mode
    (``--workers-mode``), cold (the first pass fills the image cache) and in
    steady state;
  - step img/s: the trainer's step on a synthetic batch already on the
    device (no input pipeline), timed with ``utils/profiling.time_call``;

and prints one JSON line: ``{"loader_img_s", "step_img_s", "bottleneck",
...}``. The step runs on the card unless ``--device cpu``; without CUDA it
exits.

Usage:
    python -m ayolov2_torch.cli.bench_loader --data DATA.yaml \\
        --cfg res/configs/cfg/train_config.yaml --batches 20 [--no-step]
"""

from __future__ import annotations

import argparse
import json
import logging
import sys
import tempfile
import time
from typing import Optional, Sequence

import numpy as np
import torch

from ayolov2_torch.utils.general import resolve_device
from ayolov2_torch.utils.profiling import device_record, time_call

LOGGER = logging.getLogger("bench_loader")


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Loader vs train-step throughput")
    p.add_argument("--data", type=str, default="res/configs/data/voc_fixture.yaml")
    p.add_argument("--cfg", type=str, default="res/configs/cfg/train_config.yaml")
    p.add_argument("--model", type=str, default="res/configs/model/yolov5s.yaml")
    p.add_argument("--batch-size", type=int, default=0, help="0 = train cfg value")
    p.add_argument("--img-size", type=int, default=0, help="0 = train cfg value")
    p.add_argument("--workers", type=int, default=-1, help="-1 = train cfg value")
    p.add_argument("--batches", type=int, default=20, help="timed batches per phase")
    p.add_argument("--no-step", action="store_true", help="skip the device step phase")
    p.add_argument("--workers-mode", "--workers_mode", type=str, default="both",
                   choices=["thread", "process", "both"],
                   help="worker pool kind to measure; 'both' measures thread and process "
                        "mode one after the other")
    p.add_argument("--device-aug", "--device_aug", action="store_true",
                   help="measure the plan-mode loader (on-device augmentation): workers emit "
                        "geometry and labels only; copy_paste is zeroed and only the flip "
                        "policies are kept")
    p.add_argument("--cache", type=str, default="dynamic_mem",
                   choices=["cfg", "none", "mem", "dynamic_mem", "disk", "dynamic_disk"],
                   help="image cache for the steady-state measurement; 'cfg' = the train "
                        "cfg's")
    p.add_argument("--device", type=str, default="",
                   help="where the step runs: cuda (default; exits without CUDA) or cpu")
    return p


def bench_loader(loader, n_batches: int) -> float:
    """Images per second the loader yields over ``n_batches`` (the first
    batch, which starts the workers, is not timed)."""
    it = iter(loader)
    next(it)
    t0 = time.perf_counter()
    n = 0
    for _ in range(n_batches):
        try:
            batch = next(it)
        except StopIteration:
            it.close()
            it = iter(loader)
            batch = next(it)
        # plan-mode batches carry no pixels (images is None): count n_real
        n += batch.images.shape[0] if batch.images is not None else batch.n_real
    dt = time.perf_counter() - t0
    it.close()  # join the workers
    return n / dt


def bench_step(model_cfg: str, nc: int, train_cfg: dict, batch_size: int, img_size: int,
               max_labels: int, n_iters: int, device: torch.device) -> float:
    """The trainer's step on a synthetic batch on the device: images/s."""
    from ayolov2_torch.models import build_model, init_model
    from ayolov2_torch.train.trainer import YoloTrainer

    class _SyntheticDataset:
        labels = [np.zeros((0, 5), np.float32)]

    class _SyntheticLoader:
        """What the trainer reads of its loader at construction."""

        dataset = _SyntheticDataset()

        def __len__(self):
            return n_iters

    cfg = dict(train_cfg)
    cfg["train"] = dict(train_cfg["train"], image_size=img_size, batch_size=batch_size,
                        epochs=1, plot=False)
    model = init_model(build_model(model_cfg, nc=nc, device="cpu"), seed=0)
    with tempfile.TemporaryDirectory() as log_dir:
        trainer = YoloTrainer(model, cfg, _SyntheticLoader(), val_loader=None, log_dir=log_dir,
                              device=device)
    rng = np.random.default_rng(0)
    images = torch.from_numpy(rng.integers(0, 255, (batch_size, img_size, img_size, 3),
                                           dtype=np.uint8)).to(device)
    targets = torch.zeros((batch_size * max_labels, 6), device=device)
    mask = torch.zeros((batch_size * max_labels,), dtype=torch.bool, device=device)
    t = time_call(lambda: trainer._train_step(trainer.state, images, targets, mask), device,
                  n_iters)
    return batch_size / t


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = get_parser().parse_args(argv)
    device = None if args.no_step else resolve_device(args.device or None)

    from ayolov2_torch.data import DataLoader, DetectionDataset
    from ayolov2_torch.utils.config import load_yaml

    data_cfg = load_yaml(args.data)
    train_cfg = load_yaml(args.cfg)
    tcfg = train_cfg["train"]
    batch_size = args.batch_size or int(tcfg["batch_size"])
    img_size = args.img_size or int(tcfg["image_size"])
    workers = int(tcfg.get("workers", 4)) if args.workers < 0 else args.workers

    dataset = DetectionDataset(
        data_cfg["train_path"],
        img_size=img_size,
        batch_size=batch_size,
        cache_images=(tcfg.get("cache_image") if args.cache == "cfg"
                      else None if args.cache == "none" else args.cache),
        # a VOC data cfg reads its labels/ dir whatever the train cfg's
        # COCO-oriented label_type says (cli.val's rule)
        label_type=("segments" if str(data_cfg.get("dataset", "")).lower() == "coco"
                    else "labels") if str(data_cfg.get("dataset", ""))
        else str(tcfg.get("label_type", "labels")),
        yolo_augmentation={**train_cfg["hyper_params"], **train_cfg["yolo_augmentation"]},
        augmentation=train_cfg.get("augmentation"),
    )
    if args.device_aug:
        # zero the host-only features so that the config can be planned:
        # copy_paste reads pixels, and of the policies only the flips are plans
        dataset.yolo_augmentation["copy_paste"] = 0.0
        if isinstance(dataset.yolo_augmentation.get("copy_paste2"), dict):
            dataset.yolo_augmentation["copy_paste2"]["p"] = 0.0
        if dataset.policies is not None:
            kept = []
            for pol in dataset.policies.policies:
                names = {k: v for k, v in pol.get("policy", {}).items()
                         if k in ("HorizontalFlip", "VerticalFlip")}
                if names:
                    kept.append({**pol, "policy": names})
            dataset.policies.policies = kept
        dataset.enable_device_aug(resident=True)
    modes = ["thread", "process"] if args.workers_mode == "both" else [args.workers_mode]
    loader = DataLoader(dataset, batch_size=batch_size, shuffle=True, drop_last=True,
                        workers=workers, workers_mode=modes[0])
    if len(loader) == 0:
        raise SystemExit(f"dataset too small for batch_size={batch_size}")

    # the cold pass is the first epoch's cost (decode and resize, filling the
    # cache); the steady state every later epoch's
    cold_img_s = bench_loader(loader, args.batches)
    per_mode = {}
    for mode in modes:
        mode_loader = DataLoader(dataset, batch_size=batch_size, shuffle=True, drop_last=True,
                                 workers=workers, workers_mode=mode)
        per_mode[mode] = (bench_loader(mode_loader, args.batches) if args.cache != "none"
                          else cold_img_s)
        LOGGER.info("loader[%s]: %.1f img/s steady-state (workers=%d, cache=%s)", mode,
                    per_mode[mode], workers, args.cache)
    best_mode = max(per_mode, key=per_mode.get)
    loader_img_s = per_mode[best_mode]

    report = {
        "loader_img_s": round(loader_img_s, 1),
        "loader_cold_img_s": round(cold_img_s, 1),
        "loader_by_mode_img_s": {m: round(v, 1) for m, v in per_mode.items()},
        "best_workers_mode": best_mode,
        "cache": args.cache,
        "device_aug": bool(args.device_aug),
        "workers": workers,
        "batch_size": batch_size,
        "img_size": img_size,
    }
    if not args.no_step:
        step_img_s = bench_step(args.model, int(data_cfg["nc"]), train_cfg, batch_size,
                                img_size, int(tcfg.get("max_labels_per_image", 64)),
                                args.batches, device)
        LOGGER.info("train step: %.1f img/s (synthetic batch on the device)", step_img_s)
        report["step_img_s"] = round(step_img_s, 1)
        report["bottleneck"] = "loader" if loader_img_s < step_img_s else "device"
        report["device"] = device_record(device)
    print(json.dumps(report), flush=True)
    return report


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, format="%(message)s", stream=sys.stderr)
    main()
    sys.exit(0)
