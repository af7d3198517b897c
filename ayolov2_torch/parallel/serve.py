"""Serving over ranks, and the pipelined host -> device stream.

The counterparts of ``make_sharded_serving_fn`` and ``serve_stream`` in
``ayolov2_tpu/parallel/serve.py``: data-parallel serving, each rank serving
its rows of the batch through ``make_serving_fn`` (so K1 runs on every
rank), and the overlap of each batch's host-to-device copy with the
compute of the batch before it.
"""

from __future__ import annotations

from collections import deque
from typing import Callable, Iterable, Iterator, Optional, Tuple, Union

import torch

from ayolov2_torch.parallel.mesh import axis_index, axis_size, shard_batch
from ayolov2_torch.utils.general import resolve_device


def make_sharded_serving_fn(
    mesh,
    model,
    conf_thres: float = 0.001,
    iou_thres: float = 0.65,
    top_k: int = 512,
    keep_top_k: int = 100,
    nms_box: int = 1000,
    image_dtype: Optional[torch.dtype] = None,
    img_hw: Optional[Tuple[int, int]] = None,
    gather: bool = False,
    device: Optional[Union[str, torch.device]] = None,
) -> Callable:
    """Build ``images -> (detections, counts)`` over ``mesh``'s data axis.

    ``images`` is the global batch (bs, H, W, 3) uint8, the same on every
    rank; its batch must divide by the data axis's size (else ValueError,
    as the JAX package's assert). Each rank serves its rows through
    ``make_serving_fn`` on its ``device`` (K1 where the model allows it;
    ``img_hw`` given selects the fused obj-prefilter decode, as in JAX) and returns its rows' (bs / n, keep_top_k, 6)
    detections and counts; ``gather=True`` all-gathers them, and rank 0
    returns the whole batch's. ``serve.core`` is the rank's serving module.
    The model may be int8 (``compress.quantize.quantize_model``).
    """
    from ayolov2_torch.export.exporter import make_serving_fn

    core = make_serving_fn(
        model, conf_thres=conf_thres, iou_thres=iou_thres, top_k=top_k, keep_top_k=keep_top_k,
        nms_box=nms_box, image_dtype=image_dtype if image_dtype is not None else torch.bfloat16,
        fused_decode=img_hw is not None, include_nms=True,
        device=device)
    n = axis_size(mesh, "data")

    def serve(images):
        if images.shape[0] % n:
            raise ValueError(f"batch {images.shape[0]} not divisible by data-axis size {n}")
        dets, counts = core(torch.as_tensor(shard_batch(mesh, images)))
        if not gather:
            return dets, counts
        from ayolov2_torch.parallel.collectives import gather as all_gather

        group = mesh.get_group("data")
        dets, counts = all_gather(dets, 0, group), all_gather(counts, 0, group)
        if axis_index(mesh, "data") == 0:
            return dets, counts
        return shard_batch(mesh, (dets, counts))

    serve.core = core
    return serve


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
