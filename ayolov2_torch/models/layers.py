"""YOLOv5 v6 building blocks as torch modules (NCHW tensors, channels_last).

The counterpart of ``ayolov2_tpu/models/layers.py`` for the modules the v6
graph uses: Conv (``ConvBnAct``), Bottleneck, C3, SPPF, UpSample. Attribute
names follow the kindle/torch convention (``conv``, ``bn``, ``cv1``, ``m.0``)
so a state_dict bridged from the JAX package loads with ``strict=True``.

BatchNorm carries eps=1e-3 and follows flax's ``nn.BatchNorm`` in training
(:class:`BatchNorm2d`). Conv kernels start from flax's default,
``lecun_normal`` (:func:`lecun_normal_`). ``fused=True`` builds the
BN-folded form: a conv with bias and no BN.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

ACTIVATIONS = {
    "SiLU": F.silu,
    "Swish": F.silu,
    "ReLU": F.relu,
    "ReLU6": lambda x: torch.clamp(x, 0.0, 6.0),
    "LeakyReLU": lambda x: F.leaky_relu(x, 0.1),
    "Hardswish": F.hardswish,
    "Mish": lambda x: x * torch.tanh(F.softplus(x)),
    "Sigmoid": torch.sigmoid,
    "Tanh": torch.tanh,
    "Identity": lambda x: x,
    None: lambda x: x,
}


def get_activation(name: Optional[str]) -> Callable[[torch.Tensor], torch.Tensor]:
    if callable(name):
        return name
    return ACTIVATIONS[name]


def lecun_normal_(weight: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """flax's ``lecun_normal``: a normal truncated at two standard deviations,
    variance 1 / fan_in (fan_in = input channels x kernel area), drawn on
    the CPU from ``generator`` and copied in, so every device gets the same
    values."""
    fan_in = weight.shape[1] * weight[0, 0].numel()
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978  # the truncation's std
    draw = torch.empty(weight.shape, dtype=torch.float32)
    nn.init.trunc_normal_(draw, 0.0, 1.0, -2.0, 2.0, generator=generator)
    with torch.no_grad():
        weight.copy_(draw * std)
    return weight


class BatchNorm2d(nn.BatchNorm2d):
    """BatchNorm with flax's semantics (eps 1e-3, decay 0.97).

    In ``train()`` mode the batch is normalised by its mean and *biased*
    variance, and the running statistics move as ``0.97 * old + 0.03 *
    batch`` with the biased variance, in f32 (torch's own update uses the
    unbiased one). Under bf16 autocast the input stays bf16 and the
    statistics are reduced in f32. ``eval()`` uses the running statistics.
    ``num_batches_tracked`` is not counted: the momentum is fixed.
    """

    def __init__(self, num_features: int) -> None:
        super().__init__(num_features, eps=1e-3, momentum=0.03)
        # this batch's mean and unbiased variance, overwritten in every
        # training forward (momentum 1), not saved
        self.register_buffer("batch_mean", torch.zeros(num_features), persistent=False)
        self.register_buffer("batch_var", torch.ones(num_features), persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                                False, 0.0, self.eps)
        out = F.batch_norm(x, self.batch_mean, self.batch_var, self.weight, self.bias, True, 1.0,
                           self.eps)
        n = x.numel() // x.shape[1]
        with torch.no_grad():  # the biased variance averaged in, as flax does
            self.running_mean.lerp_(self.batch_mean, self.momentum)
            self.running_var.lerp_(self.batch_var * ((n - 1) / n), self.momentum)
        return out


def autopad(k: int, p: Optional[int] = None) -> int:
    """'same'-style padding for odd kernels (YOLOv5 autopad convention)."""
    return k // 2 if p is None else p


class ConvBnAct(nn.Module):
    """Conv2d + BatchNorm + activation: the YOLOv5 'Conv' block."""

    def __init__(self, c_in: int, c_out: int, k: int = 1, s: int = 1,
                 p: Optional[int] = None, act: Optional[str] = "SiLU",
                 fused: bool = False):
        super().__init__()
        self.conv = nn.Conv2d(c_in, c_out, k, s, autopad(k, p), bias=fused)
        self.bn = None if fused else BatchNorm2d(c_out)
        self.act = get_activation(act)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(x)
        if self.bn is not None:
            x = self.bn(x)
        return self.act(x)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 with an optional residual."""

    def __init__(self, c_in: int, c_out: int, shortcut: bool = True,
                 expansion: float = 0.5, act: Optional[str] = "SiLU",
                 fused: bool = False):
        super().__init__()
        c_ = int(c_out * expansion)
        self.cv1 = ConvBnAct(c_in, c_, 1, 1, act=act, fused=fused)
        self.cv2 = ConvBnAct(c_, c_out, 3, 1, act=act, fused=fused)
        self.add = shortcut and c_in == c_out

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.cv2(self.cv1(x))
        return x + y if self.add else y


class C3(nn.Module):
    """CSP bottleneck with 3 convolutions."""

    def __init__(self, c_in: int, c_out: int, n: int = 1, shortcut: bool = True,
                 expansion: float = 0.5, act: Optional[str] = "SiLU",
                 fused: bool = False):
        super().__init__()
        c_ = int(c_out * expansion)
        self.cv1 = ConvBnAct(c_in, c_, 1, 1, act=act, fused=fused)
        self.m = nn.Sequential(*(
            Bottleneck(c_, c_, shortcut, 1.0, act=act, fused=fused) for _ in range(n)
        ))
        self.cv2 = ConvBnAct(c_in, c_, 1, 1, act=act, fused=fused)
        self.cv3 = ConvBnAct(2 * c_, c_out, 1, 1, act=act, fused=fused)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.cv3(torch.cat([self.m(self.cv1(x)), self.cv2(x)], dim=1))


class SPPF(nn.Module):
    """Fast SPP: 3 cascaded max pools equivalent to SPP(5, 9, 13)."""

    def __init__(self, c_in: int, c_out: int, k: int = 5,
                 act: Optional[str] = "SiLU", fused: bool = False):
        super().__init__()
        c_ = c_in // 2
        self.cv1 = ConvBnAct(c_in, c_, 1, 1, act=act, fused=fused)
        self.cv2 = ConvBnAct(c_ * 4, c_out, 1, 1, act=act, fused=fused)
        self.k = k

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.cv1(x)
        y1 = F.max_pool2d(x, self.k, 1, self.k // 2)
        y2 = F.max_pool2d(y1, self.k, 1, self.k // 2)
        y3 = F.max_pool2d(y2, self.k, 1, self.k // 2)
        return self.cv2(torch.cat([x, y1, y2, y3], dim=1))


class UpSample(nn.Module):
    """Nearest-neighbour upsample by an integer factor."""

    def __init__(self, scale: int = 2):
        super().__init__()
        self.scale = scale

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.interpolate(x, scale_factor=self.scale, mode="nearest")


class Concat(nn.Module):
    """Channel concat (dim 1); holds no parameters."""

    def forward(self, xs) -> torch.Tensor:
        return torch.cat(list(xs), dim=1)
