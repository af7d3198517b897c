"""Serving over ranks, and the pipelined host -> device stream.

The counterparts of ``make_sharded_serving_fn``, ``make_latency_serving_fn``
and ``serve_stream`` in ``ayolov2_tpu/parallel/serve.py``: data-parallel
serving, each rank serving its rows of the batch through ``make_serving_fn``
(so K1 runs on every rank); spatially split serving, each rank computing its
rows of every layer of the whole batch (``spatial``), K1 on its rows of the
image; and the overlap of each batch's host-to-device copy with the compute
of the batch before it.
"""

from __future__ import annotations

import functools
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


def make_latency_serving_fn(
    mesh,
    model,
    conf_thres: float = 0.001,
    iou_thres: float = 0.65,
    top_k: int = 512,
    keep_top_k: int = 100,
    nms_box: int = 1000,
    image_dtype: Optional[torch.dtype] = None,
    img_hw: Optional[Tuple[int, int]] = None,
    axis: str = "data",
    device: Optional[Union[str, torch.device]] = None,
    early_pipeline: bool = True,
) -> Callable:
    """Spatially split serving: one image's rows, and so its FLOPs, spread
    over ``mesh``'s ``axis``; the latency lever that data-parallel serving
    (:func:`make_sharded_serving_fn`) cannot move at bs 1.

    ``serve(images)`` takes the whole (bs, H, W, 3) uint8 batch, the same on
    every rank, for any bs (the split is over H), and every rank returns the
    whole answer: the (bs, keep_top_k, 6) detections and (bs,) counts of
    ``make_serving_fn`` on one device. Each rank computes its rows of every
    layer from its rows of the layer's input and their halo
    (``spatial.row_plan``, ``spatial.run_rows``), receiving the rows it lacks
    in one all-gather of edge rows a layer (``collectives.halo_exchange``);
    K1 (``early_pipeline`` and a model it takes, as in ``make_serving_fn``)
    runs once per rank per call on the rank's image rows and their halo.
    The head's raw maps are then gathered whole on every rank (one
    all-gather) and decoded and suppressed as ``make_serving_fn`` does
    (``img_hw`` given: the fused obj-prefilter decode, as in JAX), on the
    whole image's grid. ``serve.plan(h, w)`` is the row plan at that size
    (computed once per size); ``serve.raw_maps(images)`` the gathered raw
    maps (images on the rank's device); ``serve.core`` the rank's serving
    module; ``serve.received`` the rows the last call took from other
    ranks, by (layer, source).
    """
    from ayolov2_torch.export.exporter import make_serving_fn
    from ayolov2_torch.parallel.collectives import gather_rows
    from ayolov2_torch.parallel.spatial import row_plan, run_rows

    core = make_serving_fn(
        model, conf_thres=conf_thres, iou_thres=iou_thres, top_k=top_k, keep_top_k=keep_top_k,
        nms_box=nms_box, image_dtype=image_dtype if image_dtype is not None else torch.bfloat16,
        fused_decode=img_hw is not None, include_nms=True, early_pipeline=early_pipeline,
        device=device)
    n, rank = axis_size(mesh, axis), axis_index(mesh, axis)
    group = mesh.get_group(axis) if n > 1 else None
    early_n = core.ep.n if core.early else None

    @functools.lru_cache(maxsize=None)
    def plan(h: int, w: int):
        return row_plan(core.model, (h, w), n, early_n)

    @torch.no_grad()
    def raw_maps(images: torch.Tensor):
        if images.dim() != 4 or images.shape[-1] != 3:
            raise ValueError(f"expected (bs, H, W, 3) uint8 images, got {tuple(images.shape)}")
        p = plan(int(images.shape[1]), int(images.shape[2]))
        serve.received = {}
        raw = run_rows(core, p, images, rank, group, serve.received)
        return gather_rows(raw, [p.level_split(k) for k in range(len(raw))], 1, group)

    def serve(images):
        images = torch.as_tensor(images).to(core.device, non_blocking=True)
        with torch.no_grad():
            return core.detect(raw_maps(images), (int(images.shape[1]), int(images.shape[2])))

    serve.plan = plan
    serve.raw_maps = raw_maps
    serve.core = core
    serve.received = {}
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
