"""Soft-teacher knowledge distillation.

The counterpart of ``cli/distillation.py``: the teacher from
``--teacher`` (a ``.ckpt``, or the reference's ``.pt`` read into
``--teacher-cfg``'s graph, else ``--model``'s; a ``.pt`` of which more than a
quarter of the tensors do not match that graph stops the run), its graph
from ``--teacher-cfg``, else its checkpoint's config, else ``--model``, BN
folded and served in bf16 (with the early-network kernel where the model
allows it); the student from ``--model`` with ``init_model`` weights (seed
0), or ``--resume``'s EMA params where names and shapes match; the
labelled ``train_path``, the unlabeled ``--unlabeled-path`` (default the
same images) and the ``val_path`` validation; ``SoftTeacherTrainer``.
``--device`` and ``--teacher-device`` are the reference's GPU ids; as in the
JAX entry point they are logged only, and teacher and student share one
device: the card, or the CPU when ``--device cpu`` is given. On several
ranks (``--n-devices N``, or either env contract: ``parallel/launch.py``)
each rank has a teacher on its device and loads its shard of both loaders;
rank 0 makes the run dir, validates and writes the checkpoints.

Usage:
    python -m ayolov2_torch.cli.distillation --model res/configs/model/yolov5s.yaml \\
        --teacher teacher.ckpt --data res/configs/data/coco.yaml \\
        --cfg res/configs/cfg/distillation.yaml
"""

from __future__ import annotations

import argparse
import json
import logging
import sys
from typing import Optional, Sequence

from ayolov2_torch.data import DataLoader, DetectionDataset
from ayolov2_torch.models import build_model, init_model
from ayolov2_torch.models.builder import parse_model_config
from ayolov2_torch.parallel.launch import join_or_launch, leave
from ayolov2_torch.parallel.mesh import broadcast_object, is_main_process, rank, world_size
from ayolov2_torch.train.kd_trainer import SoftTeacherTrainer
from ayolov2_torch.utils.checkpoint import intersect_trees, load_variables
from ayolov2_torch.utils.config import load_yaml, make_run_dir
from ayolov2_torch.utils.general import check_img_size, resolve_device
from ayolov2_torch.utils.weights import (
    flax_from_state_dict,
    load_flax_variables,
    state_dict_from_flax,
)

LOGGER = logging.getLogger("distillation")


def get_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Soft-teacher distillation.")
    parser.add_argument("--model", type=str, default="res/configs/model/yolov5s.yaml")
    parser.add_argument("--teacher", type=str, required=True, help="teacher checkpoint (.ckpt)")
    parser.add_argument("--data", type=str, default="res/configs/data/coco.yaml")
    parser.add_argument("--unlabeled-path", type=str, default="",
                        help="unlabeled image dir (default: train_path without labels)")
    parser.add_argument("--cfg", type=str, default="res/configs/cfg/distillation.yaml")
    parser.add_argument("--log-dir", "--log_dir", type=str, default="runs")
    parser.add_argument("--teacher-cfg", "--teacher_cfg", type=str, default="",
                        help="teacher model YAML (else from the teacher ckpt meta)")
    parser.add_argument("--resume", type=str, default="",
                        help="student checkpoint to resume/transfer from")
    parser.add_argument("--device", type=str, default="",
                        help="the reference's student GPU id, logged only; 'cpu' runs on the CPU")
    parser.add_argument("--teacher-device", "--teacher_device", type=str, default="",
                        help="the reference's teacher GPU id; logged only: teacher and student "
                             "share one device")
    parser.add_argument("--wlog", action="store_true", help="(wandb is not used by the port)")
    parser.add_argument("--wlog-name", "--wlog_name", type=str, default="", help="wandb run name")
    parser.add_argument("--n-devices", type=int, default=0,
                        help="ranks: N > 1 starts N local ranks (0 = the ranks the env names)")
    return parser


def main(argv: Optional[Sequence[str]] = None) -> SoftTeacherTrainer:
    args = get_parser().parse_args(argv)
    rank_device = join_or_launch("ayolov2_torch.cli.distillation", argv, args.n_devices,
                                 "cpu" if args.device == "cpu" else "")
    try:
        return _main(args, rank_device)
    finally:
        leave()


def _main(args, rank_device) -> SoftTeacherTrainer:
    device = rank_device or resolve_device("cpu" if args.device == "cpu" else None)
    if (args.device and args.device != "cpu") or args.teacher_device:
        LOGGER.info("--device/--teacher-device accepted as the reference's GPU ids and logged "
                    "only: teacher and student run on %s", device)
    if args.wlog:
        LOGGER.warning("wandb logging is not used by the port")
    cfg = load_yaml(args.cfg)
    data_cfg = load_yaml(args.data)
    tcfg = cfg["train"]
    nc = int(data_cfg["nc"])

    # the teacher: its weights, checked, then its graph BN folded
    t_vars, t_meta = load_variables(args.teacher, prefer_ema=True,
                                    model_cfg=args.teacher_cfg or args.model, nc=nc)
    t_unmatched = int(t_meta.get("torch_unmatched", 0))
    t_matched = int(t_meta.get("torch_matched", 0)) or 1
    if t_unmatched > 0.25 * (t_matched + t_unmatched):
        raise SystemExit(
            f"teacher {args.teacher}: {t_unmatched} of {t_matched + t_unmatched} tensors did not "
            f"match the graph template ({args.teacher_cfg or args.model}); pass --teacher-cfg "
            "with the YAML the teacher was trained with")
    if args.teacher_cfg:
        t_cfg = parse_model_config(args.teacher_cfg)
    else:
        t_cfg = json.loads(t_meta["model_cfg"]) if t_meta.get("model_cfg") else args.model
    teacher = load_flax_variables(build_model(t_cfg, nc=nc, device="cpu"), t_vars).fuse()

    # the student
    model_cfg = parse_model_config(args.model)
    student = init_model(build_model(model_cfg, nc=nc, device="cpu"), seed=0)
    img_size = check_img_size(int(tcfg["image_size"]), int(max(student.strides)))
    if args.resume:
        r_vars, _ = load_variables(args.resume, prefer_ema=True)
        mine = flax_from_state_dict(student.state_dict())
        merged, n_match, n_total = intersect_trees(r_vars["params"], mine["params"])
        student.load_state_dict(state_dict_from_flax(
            {"params": merged, "batch_stats": mine.get("batch_stats", {})}), strict=True)
        LOGGER.info("resumed %d/%d student tensors from %s", n_match, n_total, args.resume)

    stride = int(max(student.strides))
    common = dict(img_size=img_size, batch_size=int(tcfg["batch_size"]), stride=stride,
                  n_skip=int(tcfg.get("n_skip", 0)), label_type=tcfg.get("label_type", "labels"))
    workers = int(tcfg.get("workers", 4))
    max_labels = int(tcfg.get("max_labels_per_image", 64))
    labeled = DetectionDataset(data_cfg["train_path"], yolo_augmentation=cfg.get("yolo_augmentation"),
                               augmentation=cfg.get("augmentation"), **common)
    unlabeled = DetectionDataset(args.unlabeled_path or data_cfg["train_path"], **common)
    shard = (rank(), world_size())  # each rank's rows of every batch
    labeled_loader = DataLoader(labeled, batch_size=int(tcfg["batch_size"]), shuffle=True,
                                drop_last=True, workers=workers, max_labels_per_image=max_labels,
                                shard=shard)
    unlabeled_loader = DataLoader(unlabeled, batch_size=int(tcfg["batch_size"]), shuffle=True,
                                  drop_last=True, workers=workers,
                                  max_labels_per_image=max_labels, shard=shard)
    val_loader = None
    if data_cfg.get("val_path") and is_main_process():
        val_ds = DetectionDataset(data_cfg["val_path"], **common)
        val_loader = DataLoader(val_ds, batch_size=int(tcfg["batch_size"]), workers=workers,
                                max_labels_per_image=max_labels)

    log_dir = make_run_dir(args.log_dir, "distill") if is_main_process() else None
    log_dir = broadcast_object(str(log_dir) if log_dir else None)
    LOGGER.info("Run dir: %s (rank %d of %d)", log_dir, rank(), world_size())
    trainer = SoftTeacherTrainer(
        student, teacher, cfg, labeled_loader, unlabeled_loader, val_loader=val_loader,
        log_dir=str(log_dir), model_cfg_dict=model_cfg, class_names=data_cfg.get("names"),
        n_devices=args.n_devices or None, device=device)
    trainer.train()
    return trainer


if __name__ == "__main__":
    from ayolov2_torch.utils.logger import rank_level

    logging.basicConfig(level=rank_level(logging.INFO), format="%(message)s", stream=sys.stdout)
    main()
