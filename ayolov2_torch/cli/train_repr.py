"""Train a representation-learning model (SimpleRL or SimCLR).

The counterpart of ``cli/train_repr.py``: the model from
``--model`` (``simclr.yaml`` or ``yolov5s_repr.yaml``, ``init_model``
weights, seed 0), ``RLImageDataset`` (``base``) or ``SimCLRDataset``
(``simclr``; ``--rl-type`` overrides the config's ``train.rl_type``) over
the data config's ``train_path`` (and ``val_path`` for the validation loss),
``RLDataLoader``, ``RepresentationLearningTrainer``. Checkpoints go to
``{log-dir}/train_repr/{DATE}_runs{N}/weights``. Runs on the card unless
``--device cpu`` is given. On several ranks (``--n-devices N``, or either
env contract: ``parallel/launch.py``) the step is data parallel over the view
batch; rank 0 makes the run dir, validates and writes the checkpoints.

Usage:
    python -m ayolov2_torch.cli.train_repr --model res/configs/model/simclr.yaml \\
        --data res/configs/data/coco.yaml --cfg res/configs/cfg/train_config_repr.yaml
"""

from __future__ import annotations

import argparse
import logging
import sys
from typing import Optional, Sequence

from ayolov2_torch.cli.val import device_of
from ayolov2_torch.data.datasets_repr import RLDataLoader, RLImageDataset, SimCLRDataset
from ayolov2_torch.models import build_model, init_model
from ayolov2_torch.models.builder import parse_model_config
from ayolov2_torch.parallel.launch import join_or_launch, leave
from ayolov2_torch.parallel.mesh import broadcast_object, is_main_process
from ayolov2_torch.train.repr_trainer import RepresentationLearningTrainer
from ayolov2_torch.utils.config import load_yaml, make_run_dir
from ayolov2_torch.utils.general import check_img_size

LOGGER = logging.getLogger("train_repr")


def get_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Representation learning.")
    parser.add_argument("--model", type=str, default="res/configs/model/simclr.yaml")
    parser.add_argument("--data", type=str, default="res/configs/data/coco.yaml")
    parser.add_argument("--cfg", type=str, default="res/configs/cfg/train_config_repr.yaml")
    parser.add_argument("--log-dir", type=str, default="runs")
    parser.add_argument("--rl-type", type=str, default="", choices=["", "base", "simclr"],
                        help="representation-learning type (overrides the cfg)")
    parser.add_argument("--device", type=str, default="",
                        help="cuda, cuda:N, N (a card's index) or cpu; default the card")
    parser.add_argument("--n-devices", type=int, default=0,
                        help="ranks: N > 1 starts N local ranks (0 = the ranks the env names)")
    return parser


def main(argv: Optional[Sequence[str]] = None) -> RepresentationLearningTrainer:
    args = get_parser().parse_args(argv)
    rank_device = join_or_launch("ayolov2_torch.cli.train_repr", argv, args.n_devices,
                                 args.device)
    try:
        return _main(args, rank_device)
    finally:
        leave()


def _main(args, rank_device) -> RepresentationLearningTrainer:
    device = rank_device or device_of(args.device)
    cfg = load_yaml(args.cfg)
    data_cfg = load_yaml(args.data)
    tcfg = cfg["train"]
    rl_type = args.rl_type or tcfg.get("rl_type", "base")

    model_cfg = parse_model_config(args.model)
    model = init_model(build_model(model_cfg, device="cpu"), seed=0)
    img_size = check_img_size(int(tcfg["image_size"]), 32)

    ds_cls = SimCLRDataset if rl_type == "simclr" else RLImageDataset
    common = dict(img_size=img_size, batch_size=int(tcfg["batch_size"]),
                  n_skip=int(tcfg.get("n_skip", 0)), n_trans=int(tcfg.get("n_trans", 2)),
                  augmentation=cfg.get("augmentation"))
    train_loader = RLDataLoader(ds_cls(data_cfg["train_path"], **common),
                                batch_size=int(tcfg["batch_size"]), shuffle=True)
    val_loader = None
    if data_cfg.get("val_path") and is_main_process():
        val_loader = RLDataLoader(ds_cls(data_cfg["val_path"], **common),
                                  batch_size=int(tcfg["batch_size"]))

    log_dir = make_run_dir(args.log_dir, "train_repr") if is_main_process() else None
    log_dir = broadcast_object(str(log_dir) if log_dir else None)
    LOGGER.info("Run dir: %s (%s, %d train batches of %d images x %d views, device %s)",
                log_dir, rl_type, len(train_loader), int(tcfg["batch_size"]),
                int(tcfg.get("n_trans", 2)), device)
    trainer = RepresentationLearningTrainer(
        model, cfg, train_loader, val_loader, rl_type=rl_type, log_dir=str(log_dir),
        model_cfg_dict=model_cfg, n_devices=args.n_devices or None, device=device)
    trainer.train()
    return trainer


if __name__ == "__main__":
    from ayolov2_torch.utils.logger import rank_level

    logging.basicConfig(level=rank_level(logging.INFO), format="%(message)s", stream=sys.stdout)
    main()
