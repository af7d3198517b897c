"""Rank-gated, colored logging.

The counterpart of ``ayolov2_tpu/utils/logger.py``: rank 0 (or a process
without ranks) logs at the level asked for; every other rank at WARNING, so
N ranks print one log. The rank is read from the environment of either
contract (``AYOLO_PROC_ID``, torchrun's ``RANK``) before
``torch.distributed`` starts, and from ``torch.distributed`` after.
"""

from __future__ import annotations

import logging
import os
import sys
from typing import Any

_COLORS = {
    "black": "\033[30m", "red": "\033[31m", "green": "\033[32m", "yellow": "\033[33m",
    "blue": "\033[34m", "magenta": "\033[35m", "cyan": "\033[36m", "white": "\033[37m",
    "bright_black": "\033[90m", "bright_red": "\033[91m", "bright_green": "\033[92m",
    "bright_yellow": "\033[93m", "bright_blue": "\033[94m", "bright_magenta": "\033[95m",
    "bright_cyan": "\033[96m", "bright_white": "\033[97m", "bold": "\033[1m",
    "underline": "\033[4m", "end": "\033[0m",
}


def colorstr(*inputs: Any) -> str:
    """colorstr('blue', 'bold', 'hello') -> ANSI-wrapped string."""
    *args, string = inputs if len(inputs) > 1 else ("blue", "bold", inputs[0])
    return "".join(_COLORS[x] for x in args) + str(string) + _COLORS["end"]


def process_index() -> int:
    """This process's rank: ``torch.distributed``'s when it has started,
    else the environment's (``AYOLO_PROC_ID`` with ``AYOLO_NUM_PROCS`` > 1,
    or ``RANK``), else 0."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    if int(os.environ.get("AYOLO_NUM_PROCS", "0") or 0) > 1:
        return int(os.environ.get("AYOLO_PROC_ID", "0") or 0)
    for key in ("RANK", "JAX_PROCESS_INDEX"):
        if os.environ.get(key, "") != "":
            try:
                return int(os.environ[key])
            except ValueError:
                pass
    return 0


def rank_level(log_level: int = logging.INFO) -> int:
    """``log_level`` on rank 0, WARNING elsewhere."""
    return log_level if process_index() in (-1, 0) else max(log_level, logging.WARNING)


def get_logger(name: str, log_level: int = logging.INFO) -> logging.Logger:
    """A logger to stderr whose level is gated to WARNING off rank 0."""
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter(
            colorstr("bright_black", "%(asctime)s ") + "%(levelname)s %(name)s: %(message)s",
            datefmt="%H:%M:%S"))
        logger.addHandler(handler)
        logger.propagate = False
    logger.setLevel(rank_level(log_level))
    return logger
