"""The serving function: uint8 NHWC batch -> fixed-shape detections.

The counterpart of ``make_serving_fn`` in ``ayolov2_tpu/export/exporter.py``
with ``fused_decode=True``, the graph the JAX bench times:

    uint8 (bs, H, W, 3) -> /255 -> BN-folded forward -> flatten_raw_maps
    -> fused_decode_nms -> ((bs, keep_top_k, 6) detections, (bs,) counts)

With ``early_pipeline=True`` (the default) and a model whose layers 0..3
match the YOLOv5 v6 pattern, those layers run as the fused early-network
kernel on the raw uint8 pixels, and the model continues from
``start_layer=4``. Every other conv goes to cuDNN through ``F.conv2d``.
"""

from __future__ import annotations

import copy
from typing import Callable, Dict, Optional, Tuple, Union

import torch

from ayolov2_torch.models.builder import fuse_params
from ayolov2_torch.ops import early_pipeline as early
from ayolov2_torch.ops.nms import (
    batched_nms,
    flat_grid_meta,
    flatten_raw_maps,
    fused_decode_nms,
)
from ayolov2_torch.utils.constants import (
    DEFAULT_CONF_THRESHOLD,
    DEFAULT_IOU_THRESHOLD,
    DEFAULT_KEEP_TOP_K,
    DEFAULT_NMS_BOX,
    DEFAULT_TOP_K,
)
from ayolov2_torch.utils.general import resolve_device


def make_serving_fn(
    model,
    conf_thres: float = DEFAULT_CONF_THRESHOLD,
    iou_thres: float = DEFAULT_IOU_THRESHOLD,
    top_k: int = DEFAULT_TOP_K,
    keep_top_k: int = DEFAULT_KEEP_TOP_K,
    nms_box: int = DEFAULT_NMS_BOX,
    image_dtype: torch.dtype = torch.bfloat16,
    fused_decode: bool = True,
    early_pipeline: bool = True,
    multi_label: bool = False,
    agnostic: bool = False,
    nms_type: str = "nms",
    device: Optional[Union[str, torch.device]] = None,
) -> Callable:
    """Build ``serve(images) -> (detections, counts)`` for a YOLOModel.

    ``images``: (bs, H, W, 3) uint8 on ``device`` (moved there if not).
    The model is copied to ``device`` in ``image_dtype`` and channels_last;
    the caller's model is left as it is. ``device`` defaults to the card and
    raises without CUDA.

    ``fused_decode``: decode only the objectness-prefiltered candidates
    (``ops/nms.fused_decode_nms``); False decodes every anchor and runs
    ``batched_nms``.
    ``early_pipeline``: run layers 0..3 through the fused kernel where the
    model allows it (``serve.early`` says whether it does).
    ``multi_label``, ``agnostic``, ``nms_type``: as in ``ops/nms`` (the
    validator takes every class of a box and, with one class, suppresses
    across classes).

    ``serve.raw_maps(images)`` returns the head's raw maps of the same
    forward, for comparisons.
    """
    device = resolve_device(device)
    use_early = bool(early_pipeline) and early.can_fuse_early(model.specs)
    ep = None
    if use_early:
        ep = early.extract_early_params(fuse_params(
            {k: v.float() for k, v in model.state_dict().items()})).to(device)
    net = copy.deepcopy(model).to(device=device, dtype=image_dtype,
                                  memory_format=torch.channels_last).eval()
    head = net.head
    metas: Dict[Tuple[int, int], Tuple[torch.Tensor, ...]] = {}

    def grid_meta(hw: Tuple[int, int]):
        if hw not in metas:
            metas[hw] = tuple(torch.from_numpy(v).to(device)
                              for v in flat_grid_meta(net.strides, head.anchor_grid(), hw))
        return metas[hw]

    @torch.inference_mode()
    def raw_maps(images: torch.Tensor):
        images = images.to(device, non_blocking=True)
        if use_early:
            act = early.early_pipeline(images.contiguous(), ep)
            # a contiguous NHWC tensor viewed as NCHW is channels_last already
            return net(act.permute(0, 3, 1, 2), training=True, start_layer=4)
        x = images.permute(0, 3, 1, 2).to(image_dtype) / 255.0
        return net(x, training=True)

    @torch.inference_mode()
    def serve(images: torch.Tensor):
        raw = raw_maps(images)
        if fused_decode:
            grid_xy, anchor_wh, stride = grid_meta(tuple(images.shape[1:3]))
            return fused_decode_nms(
                flatten_raw_maps(raw), grid_xy, anchor_wh, stride,
                conf_thres=conf_thres, iou_thres=iou_thres, nms_box=nms_box,
                pre_top_k=top_k, keep_top_k=keep_top_k, multi_label=multi_label,
                agnostic=agnostic, nms_type=nms_type,
            )
        decoded = head.decode(raw)
        return batched_nms(
            decoded, conf_thres=conf_thres, iou_thres=iou_thres,
            nms_box=min(nms_box, decoded.shape[1]), pre_top_k=top_k,
            keep_top_k=keep_top_k, multi_label=multi_label, agnostic=agnostic,
            nms_type=nms_type,
        )

    serve.raw_maps = raw_maps
    serve.early = use_early
    serve.ep = ep
    serve.model = net
    return serve
