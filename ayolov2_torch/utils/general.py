"""Sizing and device helpers."""

from __future__ import annotations

import math
from typing import Optional, Union

import torch


def make_divisible(x: float, divisor: int, minimum_check_number: int = 0) -> int:
    """Round ``x`` up to a multiple of ``divisor`` (floor if below threshold)."""
    if x <= minimum_check_number:
        return math.floor(x)
    return math.ceil(x / divisor) * divisor


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The device an entry point runs on: ``device`` if given, else the card.

    Raises when no device is given and CUDA is absent: the port never falls
    back to the CPU on its own.
    """
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    return torch.device("cuda")
