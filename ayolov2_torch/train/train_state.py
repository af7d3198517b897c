"""Train state, EMA, and the train and eval steps.

The counterpart of ``ayolov2_tpu/train/train_state.py``. One micro-step:

    uint8 (B, H, W, 3) -> bf16 -> /255 in bf16 -> the unfused model in
    train mode (convs in bf16 under ``torch.autocast``; parameters f32;
    BatchNorm statistics reduced in f32) -> raw maps as f32 -> ComputeLoss
    -> backward of total * bs -> optimizer micro-step -> EMA

With ``image_dtype=torch.float32`` everything is f32. As in the JAX
package, the EMA and the BatchNorm statistics advance on every micro-step,
also on those where accumulation applies no update; the EMA covers the
parameters and the BatchNorm running statistics.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Callable, List, Tuple

import numpy as np
import torch

from ayolov2_torch.loss.yolo_loss import ComputeLoss
from ayolov2_torch.train.optimizer import Optimizer


def ema_tensors(model: torch.nn.Module) -> List[torch.Tensor]:
    """The tensors the EMA averages: the float entries of the state dict
    (parameters and the BatchNorm running statistics), in its order."""
    return [t for t in model.state_dict(keep_vars=True).values() if t.is_floating_point()]


@dataclasses.dataclass(frozen=True)
class EMA:
    """Exponential moving average: rate ``decay * (1 - exp(-n / tau))``
    after n updates."""

    decay: float = 0.9999
    tau: float = 2000.0

    def rate(self, updates: int) -> np.float32:
        return np.float32(self.decay) * (np.float32(1.0) - np.exp(
            -np.float32(updates) / np.float32(self.tau)))

    @torch.no_grad()
    def update(self, ema: List[torch.Tensor], new: List[torch.Tensor], updates: int) -> None:
        """``ema = d * ema + (1 - d) * new`` over two lists of tensors
        (``ema_tensors`` of the EMA copy and of the model)."""
        torch._foreach_lerp_(ema, new, float(np.float32(1.0) - self.rate(updates)))


@dataclasses.dataclass
class TrainState:
    """The model (f32, trained in place), its optimizer, the EMA copy, the
    EMA's update count and the micro-step count."""

    model: torch.nn.Module
    optimizer: Optimizer
    ema_model: torch.nn.Module
    ema_updates: int = 0
    step: int = 0


def create_train_state(model: torch.nn.Module, optimizer: Optimizer) -> TrainState:
    ema_model = copy.deepcopy(model).eval()
    for p in ema_model.parameters():
        p.requires_grad_(False)
    return TrainState(model=model, optimizer=optimizer, ema_model=ema_model)


def to_input(images: torch.Tensor, image_dtype: torch.dtype) -> torch.Tensor:
    """uint8 NHWC -> ``image_dtype`` NCHW (a channels_last view) / 255,
    rounded as XLA rounds the JAX package's steps: in f32 (and f64) it
    computes ``x / 255`` as ``x * (1 / 255)``, a product with the rounded
    reciprocal (one ulp from the quotient on 126 of the 256 values); in bf16
    it rounds the quotient, as this division does."""
    x = images.permute(0, 3, 1, 2).to(image_dtype)
    return x / 255.0 if image_dtype == torch.bfloat16 else x * (1.0 / 255)


def train_forward(model: torch.nn.Module, loss_fn: ComputeLoss, images: torch.Tensor,
                  targets: torch.Tensor, target_mask: torch.Tensor,
                  image_dtype: torch.dtype = torch.bfloat16
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward in train mode and the loss: (total * bs, items)."""
    model.train()
    x = to_input(images, image_dtype)
    with torch.autocast(device_type=images.device.type, dtype=torch.bfloat16,
                        enabled=image_dtype == torch.bfloat16):
        raw = model(x, training=True)
    return loss_fn([r.float() for r in raw], targets, target_mask)


def finish_step(state: TrainState, ema: EMA = EMA()) -> bool:
    """After the backward: the optimizer's micro-step, then the EMA and the
    counters. Returns whether the optimizer updated."""
    updated = state.optimizer.step()
    state.ema_updates += 1
    ema.update(ema_tensors(state.ema_model), ema_tensors(state.model), state.ema_updates)
    state.step += 1
    return updated


def make_train_step(loss_fn: ComputeLoss, ema: EMA = EMA(),
                    image_dtype: torch.dtype = torch.bfloat16
                    ) -> Callable[[TrainState, torch.Tensor, torch.Tensor, torch.Tensor],
                                  torch.Tensor]:
    """``step(state, images uint8 (B, H, W, 3), targets (M, 6), target_mask
    (M,)) -> loss items [lbox, lobj, lcls, total]``; the state advances in
    place. Inputs live on the model's device."""

    def step_fn(state: TrainState, images, targets, target_mask) -> torch.Tensor:
        total, items = train_forward(state.model, loss_fn, images, targets, target_mask,
                                     image_dtype)
        total.backward()
        finish_step(state, ema)
        return items

    return step_fn


def make_eval_step(image_dtype: torch.dtype = torch.bfloat16, use_ema: bool = True):
    """``eval(state, images uint8) -> decoded predictions`` (f32), from the
    EMA model (or the trained one) in eval mode."""

    @torch.no_grad()
    def eval_fn(state: TrainState, images: torch.Tensor) -> torch.Tensor:
        model = state.ema_model if use_ema else state.model
        was = model.training
        model.eval()
        with torch.autocast(device_type=images.device.type, dtype=torch.bfloat16,
                            enabled=image_dtype == torch.bfloat16):
            decoded, _ = model(to_input(images, image_dtype), training=False)
        model.train(was)
        return decoded.float()

    return eval_fn
