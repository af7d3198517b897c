"""Pipelined host -> device serving on one card.

The counterpart of ``serve_stream`` in ``ayolov2_tpu/parallel/serve.py``:
overlap each batch's host-to-device copy with the compute of the batch
before it.
"""

from __future__ import annotations

from collections import deque
from typing import Callable, Iterable, Iterator, Optional, Union

import torch

from ayolov2_torch.utils.general import resolve_device


def serve_stream(
    serve_fn: Callable,
    batches: Iterable,
    depth: int = 2,
    device: Optional[Union[str, torch.device]] = None,
) -> Iterator:
    """Yield ``serve_fn(batch)`` for each host batch, in order.

    On the card, each host batch (numpy array or CPU tensor) is copied into
    pinned memory and sent to the device on a side stream; the compute
    stream waits for that batch's copy only (a per-batch event rather than
    ``wait_stream``, which would also wait for the copy of the batch after
    it), and ``record_stream`` keeps the input's memory from being reused
    before the compute that reads it has run. At most ``depth`` input
    batches are in flight: ``depth=2`` is double buffering, ``depth=1`` the
    serial schedule. Batches are pulled from ``batches`` lazily.

    On the CPU (``device="cpu"``) the same schedule runs without streams.
    Results are device tensors; the consumer decides when to read them.
    """
    if depth < 1:
        raise ValueError(f"depth must be >= 1, got {depth}")
    device = resolve_device(device)
    cuda = device.type == "cuda"
    copy_stream = torch.cuda.Stream(device) if cuda else None
    q: deque = deque()

    def put(host) -> None:
        t = torch.as_tensor(host)
        if not cuda:
            q.append((t.to(device), None))
            return
        pinned = t.pin_memory()
        with torch.cuda.stream(copy_stream):
            dev = pinned.to(device, non_blocking=True)
            done = torch.cuda.Event()
            done.record(copy_stream)
        q.append((dev, done))

    def take():
        dev, done = q.popleft()
        if done is not None:
            compute = torch.cuda.current_stream(device)
            compute.wait_event(done)
            dev.record_stream(compute)
        return serve_fn(dev)

    for host in batches:
        put(host)
        if len(q) >= depth:
            yield take()
    while q:
        yield take()
