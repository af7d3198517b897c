"""Ranks for the entry points: start N local ranks, or join the ones the
caller started.

``cli.train``, ``cli.distillation`` and ``cli.train_repr`` call
:func:`join_or_launch` first. Under JAX's env contract (``AYOLO_NUM_PROCS``,
``AYOLO_PROC_ID``, ``AYOLO_COORDINATOR``) or torchrun's (``WORLD_SIZE``,
``RANK``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``) the process joins
its ranks. Otherwise ``--n-devices N`` (N > 1) starts N copies of the entry
point, one rank each, under JAX's contract on a free localhost port, and
waits for them: the first that fails stops the others.
"""

from __future__ import annotations

import os
import signal
import socket
import subprocess
import sys
import time
from typing import Optional, Sequence

import torch

from ayolov2_torch.parallel.mesh import initialize_distributed


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return int(s.getsockname()[1])


def ranks_in_env() -> bool:
    """Whether the environment names ranks (either contract)."""
    return int(os.environ.get("AYOLO_NUM_PROCS", "0") or 0) > 1 or \
        os.environ.get("WORLD_SIZE", "") != ""


def launch(module: str, argv: Sequence[str], n: int) -> int:
    """Run ``python -m module *argv`` as ``n`` ranks on this host; the worst
    exit code (0 when every rank succeeded)."""
    env = dict(os.environ, AYOLO_NUM_PROCS=str(n), AYOLO_COORDINATOR=f"localhost:{free_port()}")
    procs = [subprocess.Popen([sys.executable, "-m", module, *argv],
                              env=dict(env, AYOLO_PROC_ID=str(i))) for i in range(n)]
    rcs = [None] * n
    try:
        while any(rc is None for rc in rcs):
            for i, p in enumerate(procs):
                if rcs[i] is None:
                    rcs[i] = p.poll()
            if any(rc not in (None, 0) for rc in rcs):
                for p in procs:
                    if p.poll() is None:
                        p.send_signal(signal.SIGTERM)
                deadline = time.monotonic() + 30
                for i, p in enumerate(procs):
                    try:
                        rcs[i] = p.wait(timeout=max(deadline - time.monotonic(), 0.1))
                    except subprocess.TimeoutExpired:
                        p.kill()
                        rcs[i] = p.wait()
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return next((rc for rc in rcs if rc), 0)


def join_or_launch(module: str, argv: Optional[Sequence[str]], n_devices: int, device: str,
                   local_rank: int = -1):
    """Join the ranks the environment names (returns the rank's device, or
    None for one process without ranks), or start ``n_devices`` ranks and
    leave with their exit code (``SystemExit``). ``device``: "cpu" runs the
    ranks on the CPU over gloo; else each rank takes its card over NCCL.
    ``local_rank`` (the ``--local_rank`` of ``torch.distributed.launch``) is
    the rank's card where ``LOCAL_RANK`` is not set."""
    if local_rank >= 0 and "LOCAL_RANK" not in os.environ:
        os.environ["LOCAL_RANK"] = str(local_rank)
    if not ranks_in_env():
        if n_devices > 1:
            raise SystemExit(launch(module, list(sys.argv[1:] if argv is None else argv),
                                    n_devices))
        return None
    return initialize_distributed(device="cpu" if device == "cpu" else None)


def leave() -> None:
    """Leave the ranks (the end of an entry point that joined them)."""
    if torch.distributed.is_available() and torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
