"""The serving graph: uint8 NHWC batch -> fixed-shape detections, and its export.

The counterpart of ``ayolov2_tpu/export/exporter.py``. The graph:

    uint8 (bs, H, W, 3) -> /255 -> BN-folded forward -> flatten_raw_maps
    -> fused_decode_nms -> ((bs, keep_top_k, 6) detections, (bs,) counts)

(``include_nms=False``: the decoded (bs, N, 5+nc) predictions instead.)
With ``early_pipeline=True`` (the default) and a model whose layers 0..3
match the YOLOv5 v6 pattern and hold plain float convs
(``early_pipeline.can_fuse_early_model``: not int8, not decomposed), those
layers run as the fused early-network kernel on the raw uint8 pixels (the
operator ``ayolov2::early_pipeline``, its packed weights a buffer of the
module), and the model continues from ``start_layer=4``. Every other float
conv goes to cuDNN through ``F.conv2d``; an int8 model's quantized convs
go to ``ops/int8_conv.py`` (``torch._int_mm`` on the card).

:func:`make_serving_fn` and :func:`make_raw_serving_fn` build the graph as
a :class:`ServingModule`; :func:`export_serving` records the same module
with ``torch.export`` (the greedy NMS loop as a ``while_loop`` operator) and
writes ``{name}.pt2`` and a sidecar ``{name}.yaml``; :func:`load_exported`
reads the artifact back in any interpreter that can import this package.
"""

from __future__ import annotations

import copy
import json
import logging
from pathlib import Path
from typing import Any, Callable, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ayolov2_torch.models.builder import build_model, fuse_params
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

LOGGER = logging.getLogger(__name__)


def letterbox_geometry(
    raw_hw: Tuple[int, int],
    img_hw: Tuple[int, int],
    scale_up: bool = True,
) -> Tuple[float, Tuple[int, int], Tuple[int, int, int, int], Tuple[float, float]]:
    """Static letterbox geometry of a raw frame into ``img_hw`` (the host
    letterbox with ``auto=False``): ``(r, new_unpad_hw, (top, bottom, left,
    right), (dw, dh))`` with ``r`` the content scale, ``new_unpad_hw`` the
    resized content's shape, the pad widths (the bottom and right ones the
    complement, so the padded shape is exactly ``img_hw``) and the half-pad
    floats that ``scale_coords`` takes off."""
    r = min(img_hw[0] / raw_hw[0], img_hw[1] / raw_hw[1])
    if not scale_up:
        r = min(r, 1.0)
    new_unpad_hw = (int(round(raw_hw[0] * r)), int(round(raw_hw[1] * r)))
    dw = (img_hw[1] - new_unpad_hw[1]) / 2
    dh = (img_hw[0] - new_unpad_hw[0]) / 2
    top, left = int(round(dh - 0.1)), int(round(dw - 0.1))
    bottom = img_hw[0] - new_unpad_hw[0] - top
    right = img_hw[1] - new_unpad_hw[1] - left
    return r, new_unpad_hw, (top, bottom, left, right), (dw, dh)


def device_letterbox(
    images: torch.Tensor,
    raw_hw: Tuple[int, int],
    img_hw: Tuple[int, int],
    scale_up: bool = True,
    color: float = 114.0,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """In-graph letterbox: uint8 (bs, *raw_hw, 3) -> (bs, 3, *img_hw) in
    ``dtype``, values in [0, 255]: a bilinear resize with half-pixel
    centres and no antialiasing (``jax.image.resize``'s "linear") to the
    content shape, then a constant ``color`` border."""
    _, new_unpad_hw, (top, bottom, left, right), _ = letterbox_geometry(raw_hw, img_hw, scale_up)
    x = images.permute(0, 3, 1, 2).to(dtype)
    if new_unpad_hw != tuple(raw_hw):
        x = F.interpolate(x, size=new_unpad_hw, mode="bilinear", align_corners=False,
                          antialias=False)
    return F.pad(x, (left, right, top, bottom), value=color)


class ServingModule(nn.Module):
    """The serving graph as one module: ``serve(images)`` -> (detections,
    counts), or the decoded predictions without NMS.

    ``serve.raw_maps(images)`` returns the head's raw maps of the same
    forward; ``serve.model`` is the BN-folded network it runs (in
    ``image_dtype``, channels_last, gradients off; an int8 conv's scales and
    bias stay f32, ``layers.QuantConv``); ``serve.early`` says
    whether layers 0..3 run as the early-network kernel (``serve.ep`` its
    weights, ``k1_weights`` their packed buffer). ``raw_hw``: the input is
    native (bs, *raw_hw, 3) frames, letterboxed to ``img_hw`` in the graph,
    and the boxes come back in the frame's coordinates. ``graph_nms``: the
    greedy NMS loop as a ``while_loop`` operator (for ``torch.export``).
    """

    def __init__(self, model, device: torch.device, image_dtype: torch.dtype,
                 conf_thres: float, iou_thres: float, top_k: int, keep_top_k: int,
                 nms_box: int, include_nms: bool, fused_decode: bool, use_early: bool,
                 multi_label: bool, agnostic: bool, nms_type: str,
                 img_hw: Optional[Tuple[int, int]] = None,
                 raw_hw: Optional[Tuple[int, int]] = None, scale_up: bool = True,
                 graph_nms: bool = False):
        super().__init__()
        self.device = device
        self.image_dtype = image_dtype
        self.nms_kw = dict(conf_thres=conf_thres, iou_thres=iou_thres, keep_top_k=keep_top_k,
                           multi_label=multi_label, agnostic=agnostic, nms_type=nms_type)
        self.top_k, self.nms_box = top_k, nms_box
        self.include_nms, self.fused_decode = include_nms, fused_decode
        self.graph_nms = graph_nms
        self.raw_hw, self.img_hw, self.scale_up = raw_hw, img_hw, scale_up
        self.early = use_early
        self.ep = None
        if use_early:
            self.ep = early.extract_early_params(fuse_params(
                {k: v.float() for k, v in model.state_dict().items()})).to(device)
            if device.type == "cuda":
                early.tile_for(self.ep)  # raises on widths the kernel does not take
            self.register_buffer("k1_weights", early.pack_weights(self.ep))
            self.ep._packed[str(device)] = self.k1_weights
        self.model = copy.deepcopy(model).to(device=device, dtype=image_dtype,
                                             memory_format=torch.channels_last).eval()
        self.model.requires_grad_(False)
        self._metas: Dict[Tuple[int, int], Tuple[torch.Tensor, ...]] = {}
        if img_hw is not None:  # the fixed size's decode constants, saved with the module
            for name, v in zip(("grid_xy", "anchor_wh", "grid_stride"), self._meta_np(img_hw)):
                self.register_buffer(name, torch.from_numpy(v).to(device))

    def _meta_np(self, hw):
        return flat_grid_meta(self.model.strides, self.model.head.anchor_grid(), hw)

    def grid_meta(self, hw: Tuple[int, int]) -> Tuple[torch.Tensor, ...]:
        """(grid_xy, anchor_wh, stride) of the flattened maps at ``hw``."""
        if hw == self.img_hw:
            return self.grid_xy, self.anchor_wh, self.grid_stride
        if hw not in self._metas:
            self._metas[hw] = tuple(torch.from_numpy(v).to(self.device)
                                    for v in self._meta_np(hw))
        return self._metas[hw]

    def raw_maps(self, images: torch.Tensor):
        images = images.to(self.device, non_blocking=True)
        if self.raw_hw is not None:
            x = device_letterbox(images, self.raw_hw, self.img_hw, self.scale_up,
                                 dtype=self.image_dtype)
            return self.model(x / 255.0, training=True)
        if self.early:
            c0, c1, ch, c2, n = self.ep.widths
            act = early.early_pipeline_op(images.contiguous(), self.k1_weights, c0, n, c1,
                                          ch, c2)
            # a contiguous NHWC tensor viewed as NCHW is channels_last already
            return self.model(act.permute(0, 3, 1, 2), training=True, start_layer=4)
        x = images.permute(0, 3, 1, 2).to(self.image_dtype) / 255.0
        return self.model(x, training=True)

    def forward(self, images: torch.Tensor):
        raw = self.raw_maps(images)
        if not self.include_nms:
            return self.model.head.decode(raw)
        if self.fused_decode:
            hw = tuple(self.img_hw) if self.raw_hw is not None else tuple(images.shape[1:3])
            det, n = fused_decode_nms(flatten_raw_maps(raw), *self.grid_meta(hw),
                                      nms_box=self.nms_box, pre_top_k=self.top_k,
                                      graph=self.graph_nms, **self.nms_kw)
        else:
            decoded = self.model.head.decode(raw)
            det, n = batched_nms(decoded, nms_box=min(self.nms_box, decoded.shape[1]),
                                 pre_top_k=self.top_k, graph=self.graph_nms, **self.nms_kw)
        if self.raw_hw is None:
            return det, n
        # scale_coords: off the pad, back to the frame's scale, clipped to it
        r, _, _, (dw, dh) = letterbox_geometry(self.raw_hw, self.img_hw, self.scale_up)
        rh, rw = self.raw_hw
        shift = torch.tensor([dw, dh, dw, dh], dtype=det.dtype, device=det.device)
        upper = torch.tensor([rw, rh, rw, rh], dtype=det.dtype, device=det.device)
        boxes = torch.minimum(torch.clamp((det[..., :4] - shift) / r, min=0.0), upper)
        return torch.cat([boxes, det[..., 4:]], dim=-1), n


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
    include_nms: bool = True,
    device: Optional[Union[str, torch.device]] = None,
) -> ServingModule:
    """Build ``serve(images) -> (detections, counts)`` for a YOLOModel.

    ``images``: (bs, H, W, 3) uint8 on ``device`` (moved there if not).
    The model is copied to ``device`` in ``image_dtype`` and channels_last;
    the caller's model is left as it is. ``device`` defaults to the card and
    raises without CUDA.

    ``fused_decode``: decode only the objectness-prefiltered candidates
    (``ops/nms.fused_decode_nms``); False decodes every anchor and runs
    ``batched_nms``. ``include_nms=False``: ``serve`` returns the decoded
    (bs, N, 5+nc) f32 predictions.
    ``early_pipeline``: run layers 0..3 through the fused kernel where the
    model allows it (``early_pipeline.can_fuse_early_model``; ``serve.early``
    says whether it does).
    ``multi_label``, ``agnostic``, ``nms_type``: as in ``ops/nms`` (the
    validator takes every class of a box and, with one class, suppresses
    across classes).
    """
    device = resolve_device(device)
    use_early = bool(early_pipeline) and early.can_fuse_early_model(model)
    return ServingModule(model, device, image_dtype, conf_thres, iou_thres, top_k, keep_top_k,
                         nms_box, include_nms, fused_decode, use_early, multi_label, agnostic,
                         nms_type)


def make_raw_serving_fn(
    model,
    raw_hw: Tuple[int, int],
    img_hw: Tuple[int, int],
    conf_thres: float = DEFAULT_CONF_THRESHOLD,
    iou_thres: float = DEFAULT_IOU_THRESHOLD,
    top_k: int = DEFAULT_TOP_K,
    keep_top_k: int = DEFAULT_KEEP_TOP_K,
    nms_box: int = DEFAULT_NMS_BOX,
    image_dtype: torch.dtype = torch.bfloat16,
    scale_up: bool = True,
    device: Optional[Union[str, torch.device]] = None,
) -> ServingModule:
    """Raw uint8 frames (bs, *raw_hw, 3) in -> detections in the frames'
    coordinates: :func:`device_letterbox` to ``img_hw``, /255, the forward,
    fused decode + NMS (best class per box), then ``scale_coords`` with the
    static (r, dw, dh). The early-network kernel reads uint8 pixels and the
    letterboxed input is float, so this graph runs every conv on cuDNN."""
    device = resolve_device(device)
    return ServingModule(model, device, image_dtype, conf_thres, iou_thres, top_k, keep_top_k,
                         nms_box, True, True, False, False, False, "nms",
                         img_hw=tuple(img_hw), raw_hw=tuple(raw_hw), scale_up=scale_up)


def export_device(platforms: Optional[Sequence[str]]) -> torch.device:
    """The one device an artifact is made for: ``platforms`` is None (the
    card), ("cuda",) or ("cpu",)."""
    if not platforms:
        return resolve_device(None)
    if len(platforms) != 1 or platforms[0] not in ("cuda", "cpu"):
        raise ValueError(f"platforms {tuple(platforms)}: an artifact of the port is made for "
                         "one device, 'cuda' or 'cpu'")
    return resolve_device(platforms[0])


def export_serving(
    model_cfg: Any,
    variables: Dict[str, Any],
    out_path: str,
    batch_size: int = 32,
    img_size: Tuple[int, int] = (640, 640),
    nc: Optional[int] = None,
    conf_thres: float = 0.001,
    iou_thres: float = 0.65,
    top_k: int = 512,
    keep_top_k: int = 100,
    include_nms: bool = True,
    half: bool = True,
    fused_input: bool = False,
    platforms: Optional[Sequence[str]] = None,
    decompose_map: Any = (),
    quant: bool = False,
    raw_hw: Optional[Tuple[int, int]] = None,
    early_pipeline: Optional[bool] = None,
) -> Dict[str, str]:
    """Export the serving graph; returns the written files' paths.

    ``variables``: the JAX package's {'params', 'batch_stats'} tree (a
    checkpoint's, ``utils/checkpoint.load_variables``), unfused, or fused
    params with ``fused_input=True``, or with ``quant`` the int8 tree of
    ``compress/quantize.quantize_params`` (fused). ``decompose_map``: a
    decomposed checkpoint's (its meta's ``decompose_map``). The artifact ``{out}.pt2``
    (``torch.export.save``) holds /255, the BN-folded forward in bf16
    (``half``, the weights stored in bf16) or f32, decode and NMS (the
    greedy loop as a ``while_loop`` operator), for one batch size and image
    size, on one device (``platforms``: None = the card, or ("cpu",)).
    On the card with a model that allows it, layers 0..3 are the operator
    ``ayolov2::early_pipeline`` with its packed weights in the artifact
    (``early_pipeline``: None = so on the card and not on the CPU; True puts
    the operator in a CPU artifact too, where it runs its plain version). With
    ``quant`` the int8 weights are in the artifact as int8 and the scales as
    f32 under either ``half``; the sidecar's ``quant`` is true.
    ``raw_hw``: the raw-frame graph of :func:`make_raw_serving_fn` (requires
    ``include_nms``). The sidecar ``{out}.yaml`` is JSON (which YAML
    readers read too): the val-time overrides, the input and outputs, and
    ``early_pipeline`` (whether the artifact needs the operator registered:
    :func:`load_exported` does that).
    """
    if raw_hw is not None and not include_nms:
        raise ValueError("raw_hw export requires include_nms")
    device = export_device(platforms)
    dtype = torch.bfloat16 if half else torch.float32
    from ayolov2_torch.utils.weights import state_dict_from_flax

    model = build_model(model_cfg, nc=nc, fused=fused_input or bool(quant), device="cpu",
                        quant=bool(quant), decompose_map=decompose_map)
    model.load_state_dict(state_dict_from_flax(variables), strict=True)
    model = model.fuse()
    img_hw = (int(img_size[0]), int(img_size[1]))
    if raw_hw is not None:
        serve = make_raw_serving_fn(model, tuple(raw_hw), img_hw, conf_thres, iou_thres, top_k,
                                    keep_top_k, image_dtype=dtype, device=device)
        in_hw = (int(raw_hw[0]), int(raw_hw[1]))
    else:
        wanted = device.type == "cuda" if early_pipeline is None else early_pipeline
        use_early = wanted and early.can_fuse_early_model(model)
        serve = ServingModule(model, device, dtype, conf_thres, iou_thres, top_k, keep_top_k,
                              DEFAULT_NMS_BOX, include_nms, include_nms, use_early, False,
                              False, "nms", img_hw=img_hw)
        in_hw = img_hw
    serve.graph_nms = True
    example = torch.zeros((batch_size, *in_hw, 3), dtype=torch.uint8, device=device)
    with torch.no_grad():
        program = torch.export.export(serve, (example,))
    program.example_inputs = None  # else the zero batch is saved too (39 MB at bs 32, 640)

    out = Path(out_path)
    out.parent.mkdir(parents=True, exist_ok=True)
    paths = {"pt2": str(out.with_suffix(".pt2")), "yaml": str(out.with_suffix(".yaml"))}
    torch.export.save(program, paths["pt2"])
    sidecar = {
        "batch_size": batch_size,
        "img_width": img_hw[1],
        "img_height": img_hw[0],
        "conf_t": conf_thres,
        "iou_t": iou_thres,
        "keep_top_k": keep_top_k,
        "top_k": top_k,
        "include_nms": include_nms,
        "half": half,
        "quant": bool(quant),
        "platforms": [device.type],
        "early_pipeline": bool(serve.early),
        "on_device_letterbox": raw_hw is not None,
        **({"raw_height": in_hw[0], "raw_width": in_hw[1]} if raw_hw is not None else {}),
        "input": {"shape": [batch_size, in_hw[0], in_hw[1], 3], "dtype": "uint8"},
        "outputs": (
            [{"shape": [batch_size, keep_top_k, 6], "dtype": "float32"},
             {"shape": [batch_size], "dtype": "int32"}]
            if include_nms else [{"shape": "decoded", "dtype": "float32"}]
        ),
    }
    Path(paths["yaml"]).write_text(json.dumps(sidecar, indent=2) + "\n")
    LOGGER.info("exported %s (%s, early-network kernel %s)", paths["pt2"], device.type,
                "in the graph" if serve.early else "not used")
    return paths


def load_exported(path: str) -> Callable:
    """Read a ``.pt2`` artifact; returns ``call(images)`` (numpy or a
    tensor; moved to the artifact's device) -> its outputs. The operator
    ``ayolov2::early_pipeline`` is registered by this module's import."""
    program = torch.export.load(str(path))
    module = program.module()
    device = next(iter(program.state_dict.values())).device

    def call(images):
        if isinstance(images, np.ndarray):
            images = torch.from_numpy(np.ascontiguousarray(images))
        with torch.no_grad():
            return module(images.to(device))

    call.device = device
    return call
