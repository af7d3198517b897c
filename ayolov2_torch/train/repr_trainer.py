"""The representation-learning trainer (SimpleRL's L1 or SimCLR's InfoNCE).

The counterpart of ``ayolov2_tpu/train/repr_trainer.py`` on one device: the
view batches of ``data/datasets_repr.RLDataLoader`` through a headless
graph (``simclr.yaml``, ``yolov5s_repr.yaml``) in f32 and train mode, the
loss of ``loss/losses_repr.py``, one optimizer update a batch:

- ``base``: SGD with momentum and Nesterov (optax's ``trace(nesterov=True)``
  takes the same first step as torch's), the config's lr;
- ``simclr``: AdamW (weight decay 1e-4, betas 0.9/0.999, eps 1e-8) with
  optax's ``cosine_decay_schedule(lr, len(loader) * epochs)``, indexed as
  optax counts updates: update k uses lr(k), update 0 lr(0).

Each epoch the validation loss (eval mode) picks ``best_eNNN.ckpt`` (meta
``best_score`` = -best loss) and ``last.ckpt`` is written, in the JAX
package's checkpoint format; the model is also its own EMA branch there, as
in the JAX package. One device only.
"""

from __future__ import annotations

import dataclasses
import logging
import math
import time
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch

from ayolov2_torch.loss.losses_repr import InfoNCELoss, RLLoss
from ayolov2_torch.train.train_state import to_input
from ayolov2_torch.train.trainer import AbstractTrainer
from ayolov2_torch.utils.checkpoint import save_checkpoint
from ayolov2_torch.utils.general import resolve_device

LOGGER = logging.getLogger(__name__)


def cosine_decay(lr: float, decay_steps: int, count: int) -> float:
    """optax's ``cosine_decay_schedule(lr, decay_steps)`` at ``count``, in f32."""
    f = np.float32
    t = f(min(count, decay_steps)) / f(decay_steps)
    return float(f(lr) * (f(0.5) * (f(1.0) + np.cos(f(math.pi) * t))))


class ReprOptimizer:
    """The repr trainer's optimizer: SGD (``base``) or AdamW on the cosine
    schedule (``simclr``), with the checkpoint layout of
    ``train/optimizer.Optimizer`` (kind, updates, per-parameter slots)."""

    def __init__(self, model: torch.nn.Module, rl_type: str, lr: float, momentum: float = 0.937,
                 nesterov: bool = True, decay_steps: int = 1) -> None:
        self.names = [n for n, _ in model.named_parameters()]
        self.params = [p for _, p in model.named_parameters()]
        self.kind = "adamw" if rl_type == "simclr" else "sgd"
        self.lr, self.decay_steps = float(lr), max(int(decay_steps), 1)
        self.updates = 0
        if self.kind == "adamw":
            self.opt = torch.optim.AdamW(self.params, lr=self.lr, betas=(0.9, 0.999), eps=1e-8,
                                         weight_decay=1e-4)
        else:
            self.opt = torch.optim.SGD(self.params, lr=self.lr, momentum=momentum,
                                       nesterov=nesterov)

    def current_lr(self) -> float:
        if self.kind == "adamw":
            return cosine_decay(self.lr, self.decay_steps, self.updates)
        return self.lr

    def step(self) -> None:
        for group in self.opt.param_groups:
            group["lr"] = self.current_lr()
        self.opt.step()
        self.opt.zero_grad(set_to_none=True)
        self.updates += 1

    def state_dict(self) -> Dict[str, Any]:
        state = {}
        for name, p in zip(self.names, self.params):
            st = self.opt.state.get(p, {})
            state[name] = {k: v.detach().cpu().numpy().copy() if torch.is_tensor(v) else v
                           for k, v in st.items()}
        return {"kind": self.kind, "updates": self.updates, "mini_step": 0, "state": state}


@dataclasses.dataclass
class ReprState:
    """What ``save_checkpoint`` reads: the model is its own EMA branch and the
    counters stay 0, as the JAX package's repr state."""

    model: torch.nn.Module
    optimizer: ReprOptimizer
    ema_updates: int = 0
    step: int = 0

    @property
    def ema_model(self) -> torch.nn.Module:
        return self.model


class RepresentationLearningTrainer(AbstractTrainer):
    """Train a headless graph with a representation-learning loss.

    Args:
        model: the port's model of a repr config (features out), trained in
            place on ``device``.
        cfg: the train config (``train``: epochs, batch_size, n_trans,
            temperature; ``hyper_params.optimizer_params``: lr, momentum,
            nesterov).
        train_loader / val_loader: ``RLDataLoader``s.
        rl_type: ``base`` (SimpleRL) or ``simclr``.
        device: default the card (raises without CUDA); "cpu" explicitly.
    """

    def __init__(self, model, cfg: Dict[str, Any], train_loader, val_loader=None,
                 rl_type: str = "base", log_dir: str = "runs/repr/exp",
                 model_cfg_dict: Optional[Dict[str, Any]] = None,
                 n_devices: Optional[int] = None, device=None) -> None:
        if n_devices is not None and n_devices > 1:
            raise NotImplementedError("training on more than one device is not ported yet; it "
                                      "comes with the parallelism slice of the port")
        if rl_type not in ("base", "simclr"):
            raise ValueError(f"rl_type must be 'base' or 'simclr', got {rl_type!r}")
        tcfg = cfg["train"]
        super().__init__(epochs=int(tcfg["epochs"]))
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.cfg, self.tcfg = cfg, tcfg
        self.train_loader, self.val_loader = train_loader, val_loader
        self.rl_type = rl_type
        self.log_dir = Path(log_dir)
        self.wdir = self.log_dir / "weights"
        self.wdir.mkdir(parents=True, exist_ok=True)
        self.model_cfg_dict = model_cfg_dict
        self.best_loss = float("inf")

        n_trans = int(tcfg.get("n_trans", 2))
        bs = int(tcfg["batch_size"])
        opt = cfg["hyper_params"].get("optimizer_params", {})
        if rl_type == "simclr":
            self.loss_fn = InfoNCELoss(batch_size=bs, n_trans=n_trans,
                                       temperature=float(tcfg.get("temperature", 0.07)))
            optimizer = ReprOptimizer(self.model, rl_type, float(opt.get("lr", 3e-4)),
                                      decay_steps=max(len(train_loader), 1) * self.epochs)
        else:
            self.loss_fn = RLLoss()
            optimizer = ReprOptimizer(self.model, rl_type, float(opt.get("lr", 0.01)),
                                      momentum=float(opt.get("momentum", 0.937)),
                                      nesterov=bool(opt.get("nesterov", True)))
        self.state = ReprState(self.model, optimizer)
        self.last_items = np.zeros(1)
        self.n_images = 0
        self.views_per_s = 0.0  # the last epoch's
        self._t_epoch = 0.0

    def train_step(self, images: torch.Tensor) -> torch.Tensor:
        """One update on a uint8 view batch on the device; returns [loss]."""
        self.model.train()
        feats = self.model(to_input(images, torch.float32), training=True)
        total, items = self.loss_fn(feats)
        total.backward()
        self.state.optimizer.step()
        return items.detach()

    @torch.no_grad()
    def eval_items(self, images: torch.Tensor) -> torch.Tensor:
        self.model.eval()
        return self.loss_fn(self.model(to_input(images, torch.float32), training=False))[1]

    def epoch_iterator(self):
        return self.train_loader

    def on_epoch_start(self, epoch: int) -> None:
        self.n_images = 0
        self._t_epoch = time.perf_counter()

    def training_step(self, batch, batch_idx: int) -> Dict[str, float]:
        images, _ = batch
        items = self.train_step(torch.from_numpy(images).to(self.device, non_blocking=True))
        self.n_images += images.shape[0]
        if batch_idx % 20 == 0:
            self.last_items = items.cpu().numpy()
            LOGGER.info("epoch %3d step %4d  %s loss %.5f", self.current_epoch, batch_idx,
                        self.rl_type, float(self.last_items[0]))
        return {}

    def on_epoch_end(self, epoch: int) -> None:
        dt = time.perf_counter() - self._t_epoch
        self.views_per_s = self.n_images / max(dt, 1e-9)
        LOGGER.info("epoch %3d done in %.1fs (%.1f views/s)", epoch, dt, self.views_per_s)

    def on_preempt(self) -> None:
        self._save("last.ckpt")

    def validation(self) -> None:
        if self.val_loader is None:
            self._save("last.ckpt")
            return
        losses = [float(self.eval_items(torch.from_numpy(images).to(self.device))[0])
                  for images, _ in self.val_loader]
        val_loss = float(np.mean(losses)) if losses else math.inf
        self.log_dict({"val_loss": val_loss})
        LOGGER.info("epoch %3d val %s loss %.5f", self.current_epoch, self.rl_type, val_loss)
        if val_loss < self.best_loss:
            self.best_loss = val_loss
            self._save(f"best_e{self.current_epoch:03d}.ckpt")
        self._save("last.ckpt")

    def _save(self, name: str) -> None:
        save_checkpoint(self.wdir / name, self.state, epoch=self.current_epoch,
                        best_score=-self.best_loss, model_cfg=self.model_cfg_dict)
