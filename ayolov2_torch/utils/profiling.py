"""Traces of the hot loops on ``torch.profiler``, written as Chrome traces.

The counterpart of ``ayolov2_tpu/utils/profiling.py``. Off unless asked for:

    AYOLO_TRACE_DIR=/tmp/trace python -m ayolov2_torch.cli.val ...    # the val loop
    AYOLO_TRACE_DIR=/tmp/trace AYOLO_TRACE_STEPS=4 python -m ayolov2_torch.cli.train ...
        # train steps 2..5 of the run (a bounded window: a whole epoch's
        # trace would be gigabytes)

Each phase writes ``<host>_<pid>.<ms>.pt.trace.json`` under its own
subdirectory of ``AYOLO_TRACE_DIR`` (``val/``, ``train/``); ``cli.val2
--trace-dir DIR`` writes its serve loop's there. The files open in Perfetto
(ui.perfetto.dev) or ``chrome://tracing``. The activities are the CPU's, and
the card's kernels (CUPTI) where the traced work runs on the card. The
train window marks each step as a ``ProfilerStep#N`` range. One profiler
runs at a time: a validation inside the train window is part of the train
trace and writes none of its own.

A profiler that cannot start or stop is logged once and the run goes on:
tracing is diagnostics and never kills a run.
"""

from __future__ import annotations

import contextlib
import logging
import os
import socket
import time
from pathlib import Path
from typing import Iterator, Optional, Union

import torch

LOGGER = logging.getLogger(__name__)

Device = Optional[Union[str, torch.device]]


def trace_dir(sub: str = "") -> Optional[str]:
    """The AYOLO_TRACE_DIR target for a phase, or None when tracing is off."""
    root = os.environ.get("AYOLO_TRACE_DIR", "")
    if not root:
        return None
    path = Path(root) / sub if sub else Path(root)
    path.mkdir(parents=True, exist_ok=True)
    return str(path)


_warned = False


def _warn_once(msg: str) -> None:
    global _warned
    if not _warned:
        LOGGER.warning(msg)
        _warned = True


def _on_card(device: Device) -> bool:
    return device is not None and torch.device(device).type == "cuda"


def _start(device: Device) -> Optional[torch.profiler.profile]:
    """A started profiler of the CPU, and of the card where ``device`` is
    the card; None (warned once) where it cannot start, and None where a
    profiler runs already (the train window around a validation: one
    profiler at a time, the outer one's trace holds the inner work)."""
    if torch.autograd._profiler_enabled():
        LOGGER.info("torch.profiler is tracing already; this phase is in that trace")
        return None
    activities = [torch.profiler.ProfilerActivity.CPU]
    if _on_card(device):
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    try:
        prof = torch.profiler.profile(activities=activities)
        prof.start()
    except Exception as e:  # diagnostics never kill a run
        _warn_once(f"torch.profiler unavailable ({e!r}); tracing skipped")
        return None
    return prof


def _stop(prof: torch.profiler.profile, target: str, device: Device) -> Optional[str]:
    """Stop ``prof`` once the card has run what was traced, and write its
    Chrome trace under ``target``; the file's path, or None (warned once)."""
    t0 = time.perf_counter()
    try:
        if _on_card(device):
            torch.cuda.synchronize(device)
        prof.stop()
        path = Path(target) / f"{socket.gethostname()}_{os.getpid()}.{time.time_ns() // 10**6}" \
                              f".pt.trace.json"
        prof.export_chrome_trace(str(path))
    except Exception as e:
        _warn_once(f"writing the torch.profiler trace failed ({e!r})")
        return None
    LOGGER.info("profiler trace written to %s in %.3f s", path, time.perf_counter() - t0)
    return str(path)


@contextlib.contextmanager
def trace_to(target: Optional[str], device: Device = None) -> Iterator[bool]:
    """Trace the block into ``target`` (made if missing); yields whether the
    profiler runs. ``target`` None traces nothing."""
    prof = None
    if target is not None:
        Path(target).mkdir(parents=True, exist_ok=True)
        prof = _start(device)
    try:
        yield prof is not None
    finally:
        if prof is not None:
            _stop(prof, target, device)


def maybe_trace(sub: str = "", device: Device = None):
    """Trace the block under ``AYOLO_TRACE_DIR/sub`` when the variable is
    set (a context manager yielding whether it traces)."""
    return trace_to(trace_dir(sub), device)


class StepWindowTracer:
    """Trace a bounded window of training steps (AYOLO_TRACE_STEPS, default 4).

    Call :meth:`step` once per training step, before it, with the step's
    index; the trace starts at step 2 (past the first steps' allocations
    and cuDNN's autotuning, which would fill the timeline) and stops after
    the window, each step inside a ``ProfilerStep#N`` range. Safe to call
    every step forever: a no-op once the window closed or when
    AYOLO_TRACE_DIR is unset. :meth:`close` ends a window the run cut short.
    """

    START_STEP = 2

    def __init__(self, sub: str = "train", device: Device = None) -> None:
        self.target = trace_dir(sub)
        self.steps = int(os.environ.get("AYOLO_TRACE_STEPS", 4))
        self._device = device
        self._prof: Optional[torch.profiler.profile] = None
        self._mark = None
        self._stop_at = 0
        self._done = self.target is None or self.steps <= 0
        self.path: Optional[str] = None

    def step(self, step_idx: int) -> None:
        if self._done:
            return
        if self._prof is None:
            if step_idx < self.START_STEP:
                return
            self._prof = _start(self._device)
            if self._prof is None:
                self._done = True
                return
            self._stop_at = step_idx + self.steps
        elif step_idx >= self._stop_at:
            self.close()
            return
        self._end_mark()
        self._mark = torch.profiler.record_function(f"ProfilerStep#{step_idx}")
        self._mark.__enter__()

    def _end_mark(self) -> None:
        if self._mark is not None:
            self._mark.__exit__(None, None, None)
            self._mark = None

    def close(self) -> None:
        """Stop an open window and write its trace."""
        if self._prof is not None:
            self._end_mark()
            self.path = _stop(self._prof, self.target, self._device)
            self._prof = None
        self._done = True
