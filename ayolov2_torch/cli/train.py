"""Train a model from the config triple (model / data / train cfg).

The counterpart of ``cli/train.py``: the model from
``--model`` (a YAML, or a ``.ckpt`` whose embedded config rebuilds the
graph and whose EMA weights are transferred where names and shapes match,
or the reference's ``.pt`` with its model YAML saved beside it as
``x.yaml``; ``train.weights`` may be a ``.pt`` too, read into ``--model``'s
graph),
the shuffled train loader and the validation loaders of
``train.val_geometry`` (``rect``, ``train`` or ``both``), weights from
``init_model`` (seed 0), ``YoloTrainer``, and ``metrics.json`` in the run
dir. Runs on the card unless ``--device cpu`` is given. Configs are read by
the port's own YAML reader (or as JSON). With ``train.device_aug: true``
the training augmentation is planned on the host and rendered on the
device (``train.device_aug_resident``: true, false or auto, resident up to
2 GiB of frames; ``train.device_aug_dtype``: bfloat16 or float32);
otherwise it runs on the host, in ``train.workers`` threads or, with
``train.workers_mode: process``, forked processes (the setting for host
augmentation, which holds the GIL). With ``train.plot`` (the default)
``labels.png`` and ``train_batch0-2.png`` go to the run dir; with
``AYOLO_TRACE_DIR`` set, a ``torch.profiler`` trace of train steps 2 to 1 +
``AYOLO_TRACE_STEPS`` (default 4) goes to ``AYOLO_TRACE_DIR/train``.

Usage:
    python -m ayolov2_torch.cli.train --model res/configs/model/yolov5s.yaml \\
        --data res/configs/data/voc_fixture_memorize.yaml \\
        --cfg res/configs/cfg/train_golden_memorize.yaml [--device cpu]

On several ranks: ``--n-devices N`` starts N local ranks (``--device cpu``:
on the CPU over gloo; else one card each over NCCL), or the caller starts
them under JAX's env contract (``AYOLO_NUM_PROCS``, ``AYOLO_PROC_ID``,
``AYOLO_COORDINATOR``) or torchrun's; ``--local_rank`` names the rank's card
where ``LOCAL_RANK`` does not. ``train.batch_size`` is the global batch; each
rank loads its shard of every batch, rank 0 makes the run dir, writes the
checkpoints and ``metrics.json`` and validates; ``train.fsdp`` and
``train.tp`` split the state (``train/trainer.py``). wandb is not used
(``--wlog`` only warns, as the JAX entry point does without wandb).
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
from ayolov2_torch.data import DataLoader, DetectionDataset
from ayolov2_torch.models import build_model, init_model
from ayolov2_torch.models.builder import parse_model_config
from ayolov2_torch.parallel.launch import join_or_launch, leave
from ayolov2_torch.parallel.mesh import broadcast_object, is_main_process, rank, world_size
from ayolov2_torch.train.trainer import YoloTrainer
from ayolov2_torch.utils.checkpoint import intersect_trees, load_variables
from ayolov2_torch.utils.config import load_yaml, make_run_dir, snapshot_configs
from ayolov2_torch.utils.general import check_img_size
from ayolov2_torch.utils.weights import flax_from_state_dict, state_dict_from_flax

LOGGER = logging.getLogger("train")


def get_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Train a model.")
    parser.add_argument("--model", type=str, default="res/configs/model/yolov5s.yaml",
                        help="model YAML or checkpoint (.ckpt)")
    parser.add_argument("--data", type=str, default="res/configs/data/coco.yaml")
    parser.add_argument("--cfg", type=str, default="res/configs/cfg/train_config.yaml")
    parser.add_argument("--wlog", action="store_true", help="(wandb is not used by the port)")
    parser.add_argument("--wlog-name", "--wlog_name", type=str, default="", help="wandb run name")
    parser.add_argument("--log-dir", "--log_dir", type=str, default="runs", help="log root directory")
    parser.add_argument("--use-swa", "--use_swa", action="store_true", help="save per-epoch ckpts for SWA")
    parser.add_argument("--resume", type=str, default="", help="checkpoint to resume from")
    parser.add_argument("--n-devices", type=int, default=0,
                        help="ranks: N > 1 starts N local ranks (0 = the ranks the env names)")
    parser.add_argument("--local_rank", type=int, default=-1,
                        help="the rank's card, where LOCAL_RANK is not set (torch's launcher)")
    parser.add_argument("--device", type=str, default="",
                        help="cuda, cuda:N, N (a card's index) or cpu; default the card")
    return parser


def transfer(model, variables, source: str) -> None:
    """Load the leaves of ``variables`` (flax names) whose names and shapes
    match ``model``'s; the rest keep their initial values."""
    mine = flax_from_state_dict(model.state_dict())
    params, n_match, n_total = intersect_trees(variables["params"], mine["params"])
    stats = mine.get("batch_stats", {})
    if variables.get("batch_stats"):
        stats, _, _ = intersect_trees(variables["batch_stats"], stats)
    model.load_state_dict(state_dict_from_flax({"params": params, "batch_stats": stats}),
                          strict=True)
    LOGGER.info("Transferred %d/%d param tensors from %s", n_match, n_total, source)


def main(argv: Optional[Sequence[str]] = None) -> YoloTrainer:
    args = get_parser().parse_args(argv)
    rank_device = join_or_launch("ayolov2_torch.cli.train", argv, args.n_devices, args.device,
                                 args.local_rank)
    try:
        return _main(args, rank_device)
    finally:
        leave()


def _main(args, rank_device) -> YoloTrainer:
    cfg = load_yaml(args.cfg)
    data_cfg = load_yaml(args.data)
    tcfg = cfg["train"]
    device = rank_device or device_of(args.device)
    if args.wlog:
        LOGGER.warning("wandb logging is not used by the port; metrics go to metrics.json")
    # the data axis: ranks on one model-axis row load the same shard
    tp = max(int(tcfg.get("tp", 0) or 0), 1)
    shard = (rank() // tp, world_size() // tp) if world_size() % tp == 0 else (0, 1)

    log_dir = make_run_dir(args.log_dir, "train") if is_main_process() else None
    log_dir = Path(broadcast_object(str(log_dir) if log_dir else None))
    if is_main_process():
        snapshot_configs(log_dir, merged={"cfg": cfg, "data": data_cfg},
                         files={"model": args.model, "data": args.data, "cfg": args.cfg})
    LOGGER.info("Run dir: %s (rank %d of %d)", log_dir, rank(), world_size())

    nc = 1 if tcfg.get("single_cls") else int(data_cfg["nc"])
    names = data_cfg.get("names") or [str(i) for i in range(nc)]

    init_weights = None
    if args.model.endswith((".ckpt", ".pt")):
        pt_cfg = None
        if args.model.endswith(".pt"):
            # a torch pickle holds no model config: the graph is the config
            # saved beside it (x.yaml next to x.pt)
            pt_cfg = Path(args.model).with_suffix(".yaml")
            if not pt_cfg.exists():
                raise SystemExit(
                    f"--model {args.model}: reference .pt weights can't define the graph; put "
                    f"its model YAML beside it as {pt_cfg.name}, or pass --model <model yaml> "
                    f"and set `weights: {args.model}` in the train config (or convert once "
                    "with ayolov2_torch.cli.import_torch_weights)")
        init_weights, meta = load_variables(args.model, prefer_ema=True,
                                            model_cfg=pt_cfg and str(pt_cfg), nc=nc)
        model_cfg = json.loads(meta["model_cfg"]) if meta.get("model_cfg") else None
        if not model_cfg:
            raise SystemExit(f"{args.model} holds no model config; pass a model YAML")
    else:
        model_cfg = parse_model_config(args.model)
    # train.remat: each layer an activation checkpoint (true), or one that keeps
    # the convs' outputs and recomputes BN, activations and concat ("save_convs")
    remat = tcfg.get("remat", False)
    model = init_model(build_model(model_cfg, nc=nc, device="cpu",
                                   remat=remat if isinstance(remat, str) else bool(remat)),
                       seed=0)

    stride = int(max(model.strides))
    img_size = check_img_size(int(tcfg["image_size"]), stride)
    common = dict(
        img_size=img_size,
        batch_size=int(tcfg["batch_size"]),
        stride=stride,
        n_skip=int(tcfg.get("n_skip", 0)),
        label_type=tcfg.get("label_type", "labels"),
        single_cls=bool(tcfg.get("single_cls", False)),
        cache_images=tcfg.get("cache_image"),
    )
    train_dataset = DetectionDataset(
        data_cfg["train_path"], rect=bool(tcfg.get("rect", False)),
        yolo_augmentation=cfg.get("yolo_augmentation"), augmentation=cfg.get("augmentation"),
        **common)
    if tcfg.get("device_aug", False):
        # the loader's threads plan geometry and labels; mosaic, warp, mixup,
        # HSV and flips are rendered on the trainer's device. "auto" keeps
        # the source frames there when they take at most 2 GiB
        resident = tcfg.get("device_aug_resident", "auto")
        if resident == "auto":
            resident = len(train_dataset) * img_size * img_size * 3 <= 2 * 1024**3
        train_dataset.enable_device_aug(resident=bool(resident))
        LOGGER.info("device augmentation on (%s source frames)",
                    "resident" if resident else "streamed")
    max_labels = int(tcfg.get("max_labels_per_image", 64))
    workers_mode = str(tcfg.get("workers_mode", "thread"))
    if workers_mode not in ("thread", "process"):
        raise SystemExit(f"train.workers_mode {workers_mode!r} is not a loader mode: use 'thread' "
                         "or 'process'")
    # each rank loads its shard of every batch (the order padded, so every
    # rank runs as many batches)
    train_loader = DataLoader(train_dataset, batch_size=int(tcfg["batch_size"]),
                              shuffle=not tcfg.get("rect", False), drop_last=True,
                              workers=int(tcfg.get("workers", 4)), workers_mode=workers_mode,
                              max_labels_per_image=max_labels, shard=shard)

    # the validation protocol: rect (pad 0.5, the default), train (the train
    # geometry) or both (rect primary, train geometry logged as mAP50_aux)
    val_geometry = str(tcfg.get("val_geometry", "rect"))
    val_loader = val_loader_aux = None
    if data_cfg.get("val_path") and is_main_process():

        def _val_loader(rect: bool, pad: float):
            ds = DetectionDataset(data_cfg["val_path"], rect=rect, pad=pad, **common)
            return DataLoader(ds, batch_size=int(tcfg["batch_size"]),
                              max_labels_per_image=max_labels)

        train_geom = dict(rect=bool(tcfg.get("rect", False)), pad=0.0)
        if val_geometry == "train":
            val_loader = _val_loader(**train_geom)
        else:
            val_loader = _val_loader(rect=True, pad=0.5)
            if val_geometry == "both":
                val_loader_aux = _val_loader(**train_geom)

    if init_weights is not None:
        transfer(model, init_weights, args.model)
    elif tcfg.get("weights"):
        # a .pt goes into the graph being trained; its own counts tell a wrong
        # pairing of weights and config (the transfer from the template is full)
        w, w_meta = load_variables(tcfg["weights"], prefer_ema=True, model_cfg=model_cfg, nc=nc)
        t_matched, t_unmatched = w_meta.get("torch_matched"), w_meta.get("torch_unmatched", 0)
        if t_matched is not None:
            LOGGER.info("Torch import %s: %d tensors matched, %d unmatched", tcfg["weights"],
                        t_matched, t_unmatched)
            if t_unmatched > t_matched:
                raise SystemExit(
                    f"weights {tcfg['weights']}: {t_unmatched} of {t_matched + t_unmatched} "
                    "tensors did not match the --model graph: wrong weights/model-cfg pairing? "
                    "(pass the YAML the .pt was trained with)")
        transfer(model, w, tcfg["weights"])

    trainer = YoloTrainer(
        model, cfg, train_loader, val_loader=val_loader, val_loader_aux=val_loader_aux,
        log_dir=str(log_dir), class_names=names, use_swa=args.use_swa,
        n_devices=args.n_devices or None,
        model_cfg_dict=model_cfg if isinstance(model_cfg, dict) else parse_model_config(model_cfg),
        device=device)
    if args.resume:
        trainer.resume(args.resume)
    trainer.train()

    if is_main_process():
        metrics_path = Path(log_dir) / "metrics.json"
        metrics_path.write_text(json.dumps(
            {k: v for k, v in trainer.state_dict.items() if not isinstance(v, np.ndarray)},
            indent=2, default=float))
        LOGGER.info("Metrics written to %s", metrics_path)
    return trainer


if __name__ == "__main__":
    from ayolov2_torch.utils.logger import rank_level

    logging.basicConfig(level=rank_level(logging.INFO), format="%(message)s", stream=sys.stdout)
    main()
