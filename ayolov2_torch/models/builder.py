"""Config -> torch model graph builder (the kindle re-creation).

Consumes the model config schema of ``res/configs/model/*.yaml``:
``depth_multiple`` / ``width_multiple`` scaling and ``backbone`` + ``head``
lists of ``[from, repeat, module, args, {kwargs}]`` rows. A config is a dict
(``models/configs.yolov5_cfg``) or a YAML path (``utils/config.load_yaml``:
PyYAML is imported only for a file that is not JSON).

The result is one ``nn.Module`` whose layers sit in ``self.model`` under the
kindle names (``model.{i}...``). Raw head maps are (bs, ny, nx, na, no), as
in the JAX package; activations inside are NCHW tensors, and serving keeps
them in ``torch.channels_last``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.utils.checkpoint
from torch import nn

from ayolov2_torch.models import layers as L
from ayolov2_torch.models.yolo_head import YOLOHead
from ayolov2_torch.utils.config import load_yaml
from ayolov2_torch.utils.general import make_divisible, resolve_device
from ayolov2_torch.utils.weights import module_name


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """One node of the model graph (one config row, after scaling)."""

    index: int
    from_idx: Tuple[int, ...]  # absolute or -1-relative source indices
    module: str
    args: Tuple[Any, ...]
    kwargs: Tuple[Tuple[str, Any], ...]
    repeat: int
    out_channels: int

    def kw(self) -> Dict[str, Any]:
        return dict(self.kwargs)


def _freeze(obj: Any) -> Any:
    """Recursively convert lists to tuples so specs are hashable."""
    if isinstance(obj, (list, tuple)):
        return tuple(_freeze(o) for o in obj)
    return obj


_KNOWN_MODULES = {
    "Conv", "Bottleneck", "C3", "SPP", "SPPF", "Focus", "UpSample", "Concat",
    "YOLOHead", "MV2Block", "MobileViTBlock", "GlobalAvgPool", "Flatten", "Linear",
}
_WIDTH_SCALED = {"Conv", "C3", "SPP", "SPPF", "Focus", "MV2Block"}
_DEPTH_SCALED = {"C3", "Bottleneck", "MV2Block", "MobileViTBlock"}


def parse_model_config(cfg: Union[str, Dict[str, Any]]) -> Dict[str, Any]:
    """A config dict, or the dict a YAML (or JSON) path holds."""
    if isinstance(cfg, str):
        cfg = load_yaml(cfg)
    return cfg


def _build_specs(cfg: Dict[str, Any]) -> Tuple[List[LayerSpec], List[int], Optional[int]]:
    """Parse config rows into LayerSpecs with channel bookkeeping.

    Returns (specs, save_indices, head_index).
    """
    gd = float(cfg.get("depth_multiple", 1.0))
    gw = float(cfg.get("width_multiple", 1.0))
    in_ch = int(cfg.get("input_channel", 3))

    rows = list(cfg["backbone"]) + list(cfg.get("head", []))
    channels: List[int] = [in_ch]  # channels[i+1] = out channels of layer i
    specs: List[LayerSpec] = []
    save: set = set()
    head_index: Optional[int] = None

    for i, row in enumerate(rows):
        frm, rep, mod = row[0], row[1], row[2]
        args = list(row[3]) if len(row) > 3 else []
        kwargs = dict(row[4]) if len(row) > 4 else {}
        frm_list = frm if isinstance(frm, list) else [frm]
        if mod not in _KNOWN_MODULES:
            raise ValueError(f"Unknown module type in model config (row {i}): {mod!r}")

        n = max(round(rep * gd), 1) if (rep > 1 and mod in _DEPTH_SCALED) else rep

        def src_ch(f: int) -> int:
            return channels[i + f + 1] if f < 0 else channels[f + 1]

        if mod in _WIDTH_SCALED:
            c_out = make_divisible(args[0] * gw, 8)
            args[0] = c_out
        elif mod == "Concat":
            c_out = sum(src_ch(f) for f in frm_list)
        elif mod == "YOLOHead":
            head_index = i
            c_out = 0
        elif mod == "Linear":
            c_out = int(args[0])
        else:  # UpSample, GlobalAvgPool, Flatten, MobileViTBlock
            c_out = src_ch(frm_list[0])

        for f in frm_list:
            if f != -1:
                save.add(f if f >= 0 else i + f)

        specs.append(LayerSpec(
            index=i,
            from_idx=tuple(frm_list),
            module=mod,
            args=_freeze(tuple(args)),
            kwargs=tuple(sorted((k, _freeze(v)) for k, v in kwargs.items())),
            repeat=n,
            out_channels=c_out,
        ))
        channels.append(c_out)

    return specs, sorted(save), head_index


def _source(spec: LayerSpec, f: int) -> int:
    """Absolute index of a spec's source (-1 = the previous layer)."""
    return spec.index - 1 if f == -1 else (f if f >= 0 else spec.index + f)


def _make_module(spec: LayerSpec, c_in: int, fused: bool, s2d=False, quant=False) -> nn.Module:
    """The torch module of one (non-head) layer spec, repeat not applied."""
    a, kw = spec.args, spec.kw()
    q = dict(fused=fused, quant=quant)
    act = kw.get("activation", "SiLU" if spec.module in _WIDTH_SCALED else None)
    m = spec.module
    if m == "Conv":
        k = a[1] if len(a) > 1 else 1
        s = a[2] if len(a) > 2 else 1
        p = a[3] if len(a) > 3 else None
        return L.ConvBnAct(c_in, a[0], k, s, p, act=act, s2d=s2d, **q)
    if m == "Bottleneck":
        return L.Bottleneck(c_in, a[0], a[1] if len(a) > 1 else True, act=act, **q)
    if m == "C3":
        return L.C3(c_in, a[0], n=spec.repeat, shortcut=a[1] if len(a) > 1 else True,
                    act=act, **q)
    if m == "SPP":
        return L.SPP(c_in, a[0], tuple(a[1]) if len(a) > 1 else (5, 9, 13), act=act, **q)
    if m == "SPPF":
        return L.SPPF(c_in, a[0], a[1] if len(a) > 1 else 5, act=act, **q)
    if m == "Focus":
        return L.Focus(c_in, a[0], a[1] if len(a) > 1 else 1, a[2] if len(a) > 2 else 1,
                       act=act, **q)
    if m == "UpSample":
        return L.UpSample(int(a[1]) if len(a) > 1 and a[1] else 2)
    if m == "Concat":
        return L.Concat()
    if m == "MV2Block":
        return L.MV2Block(c_in, a[0], a[1] if len(a) > 1 else 1, a[2] if len(a) > 2 else 4,
                          act=act, **q)
    if m == "MobileViTBlock":
        return L.MobileViTBlock(c_in, a[0], a[1], a[2], act=act, **q)
    if m == "GlobalAvgPool":
        return L.GlobalAvgPool()
    if m == "Flatten":
        return L.Flatten()
    if m == "Linear":
        return L.Linear(c_in, a[0], act=act)
    raise ValueError(f"Unknown module type: {m}")


REMAT_MODES = (False, True, "save_convs")
QUANT_MODES = (False, True, "calib")


def decompose_map_of(mapping) -> Dict[str, Tuple[int, int]]:
    """A decompose map as {JAX module path: (rank_in, rank_out)}, sorted;
    from a dict (a checkpoint's JSON gives lists) or (path, ranks) pairs."""
    items = mapping.items() if isinstance(mapping, dict) else (mapping or ())
    return {str(k): (int(v[0]), int(v[1])) for k, v in sorted(items)}


@contextlib.contextmanager
def _frozen_batch_stats(mod: nn.Module):
    """BatchNorm layers of ``mod`` leave their running statistics alone."""
    bns = [m for m in mod.modules() if isinstance(m, L.BatchNorm2d)]
    for bn in bns:
        bn.update_stats = False
    try:
        yield
    finally:
        for bn in bns:
            bn.update_stats = True


def remat_call(mod: nn.Module, x, remat) -> torch.Tensor:
    """``mod(x)`` as an activation checkpoint: the backward pass runs the
    forward again instead of keeping its activations. ``remat=True`` keeps
    only the input; ``"save_convs"`` also keeps the output of every conv
    (``aten.convolution``) and recomputes the rest (BatchNorm, activations,
    concat). The recomputation leaves BatchNorm's running statistics alone,
    so they move once per step, as without remat."""
    calls = [0]

    def fn(z):
        calls[0] += 1
        if calls[0] == 1:
            return mod(z)
        with _frozen_batch_stats(mod):
            return mod(z)

    kw = {}
    if remat == "save_convs":
        from torch.utils.checkpoint import create_selective_checkpoint_contexts

        kw["context_fn"] = functools.partial(create_selective_checkpoint_contexts,
                                             [torch.ops.aten.convolution.default])
    return torch.utils.checkpoint.checkpoint(fn, x, use_reentrant=False, **kw)


class YOLOModel(nn.Module):
    """The full layer graph as one module.

    ``forward(x, training, start_layer)``: detection graphs return the nl
    raw maps (bs, ny, nx, na, 5+nc) with ``training=True`` and (decoded,
    raw maps) with ``training=False``; headless graphs (``simclr.yaml``)
    return the final tensor. The flag picks the head's output only;
    BatchNorm follows ``train()`` / ``eval()`` as usual, and ``build_model``
    returns the model in eval mode.

    ``s2d_stem``: layer 0's 6x6/s2 conv computed by ``layers.s2d_conv`` in
    that mode (True = "reshape"; same parameters). ``remat``: in training
    with gradients on, each layer (each repeat) is an activation checkpoint
    (:func:`remat_call`). ``out_xyxy``: the decoded boxes as xyxy.
    ``quant``: every ConvBnAct's (``layers.ConvBnAct``; True needs
    ``fused``). ``decompose_map``: {JAX module path ("model_4/m0/cv2"):
    (rank_in, rank_out)}; each named ConvBnAct (module "model.4.m.0.cv2")
    becomes its Tucker-2 stack.
    """

    def __init__(self, specs: Tuple[LayerSpec, ...], save: Tuple[int, ...],
                 head_index: Optional[int], nc: int,
                 anchors: Tuple[Tuple[float, ...], ...], strides: Tuple[float, ...],
                 in_ch: int = 3, fused: bool = False, s2d_stem=False, remat=False,
                 out_xyxy: bool = False, quant=False, decompose_map=()):
        super().__init__()
        if remat not in REMAT_MODES:
            raise ValueError(f"remat={remat!r}: one of {REMAT_MODES}")
        if quant not in QUANT_MODES:
            raise ValueError(f"quant={quant!r}: one of {QUANT_MODES}")
        self.specs = tuple(specs)
        self.save = tuple(save)
        self.head_index = head_index
        self.nc = nc
        self.anchors = anchors
        self.strides = tuple(strides)
        self.fused = fused
        self.in_ch = in_ch
        self.s2d_stem = s2d_stem
        self.remat = remat
        self.out_xyxy = out_xyxy
        self.quant = quant
        self.decompose_map = decompose_map_of(decompose_map)
        channels = {-1: in_ch}  # out channels by layer index; -1 = the image
        mods = []
        for spec in self.specs:
            srcs = [_source(spec, f) for f in spec.from_idx]
            if spec.module == "YOLOHead":
                mods.append(YOLOHead([channels[s] for s in srcs], nc, anchors, strides,
                                     out_xyxy=out_xyxy))
                continue
            c_in = channels[srcs[0]]
            s2d = s2d_stem if spec.index == 0 else False
            if spec.module in ("C3", "Concat") or spec.repeat == 1:
                mods.append(_make_module(spec, c_in, fused, s2d, quant))
            else:
                mods.append(nn.Sequential(*(
                    _make_module(spec, c_in if r == 0 else spec.out_channels, fused, s2d, quant)
                    for r in range(spec.repeat)
                )))
            channels[spec.index] = spec.out_channels
        self.model = nn.ModuleList(mods)
        for path, (r_in, r_out) in self.decompose_map.items():
            mod = self.get_submodule(module_name(path))
            if not isinstance(mod, L.ConvBnAct):
                raise ValueError(f"decompose_map: {path} is not a conv block")
            mod.decompose(r_in, r_out)

    @property
    def head(self) -> Optional[YOLOHead]:
        return None if self.head_index is None else self.model[self.head_index]

    def _run(self, mod: nn.Module, x):
        """One layer, each repeat an activation checkpoint under remat."""
        if not (self.remat and self.training and torch.is_grad_enabled()):
            return mod(x)
        for part in (mod if isinstance(mod, nn.Sequential) else (mod,)):
            x = remat_call(part, x, self.remat)
        return x

    def forward(self, x: torch.Tensor, training: bool = False, start_layer: int = 0):
        """``start_layer > 0``: ``x`` is the activation entering spec
        ``start_layer``; the specs before it are skipped. The fused early
        network (ops/early_pipeline.py) computes layers 0..3 this way; the
        skipped layers must not feed skip connections."""
        if start_layer > 0 and any(s < start_layer for s in self.save):
            raise ValueError(f"start_layer={start_layer} skips saved layers {self.save}")
        param = next(self.parameters())
        y = x.to(param.dtype)
        saved: Dict[int, torch.Tensor] = {}
        for spec in self.specs[start_layer:]:
            mod = self.model[spec.index]
            if spec.module == "YOLOHead":
                feats = [saved[f] if f >= 0 else y for f in spec.from_idx]
                decoded, raw = mod(feats, training=training)
                return raw if training else (decoded, raw)
            if spec.module == "Concat":
                y = mod([y if f == -1 else saved[_source(spec, f)] for f in spec.from_idx])
            else:
                f = spec.from_idx[0]
                y = self._run(mod, y if f == -1 else saved[_source(spec, f)])
            if spec.index in self.save:
                saved[spec.index] = y
        return y

    @property
    def nl(self) -> int:
        return len(self.anchors)

    def replace_anchors(self, anchors) -> "YOLOModel":
        """Set pixel-space anchors (nl, na, 2) in the model and its head, in
        place (auto-anchor); returns the model."""
        a = tuple(tuple(float(v) for v in np.asarray(level).reshape(-1))
                  for level in np.asarray(anchors, np.float32).reshape(self.nl, -1, 2))
        self.anchors = a
        if self.head is not None:
            self.head.anchors = a
        return self

    def fuse(self) -> "YOLOModel":
        """A new model with BatchNorm folded into the convs (eps 1e-3)."""
        if self.fused:
            return self
        param = next(self.parameters())
        with torch.device(param.device):
            fused = YOLOModel(self.specs, self.save, self.head_index, self.nc,
                              self.anchors, self.strides, in_ch=self.in_ch, fused=True,
                              s2d_stem=self.s2d_stem, out_xyxy=self.out_xyxy,
                              quant=self.quant, decompose_map=self.decompose_map)
        fused.cfg = getattr(self, "cfg", None)
        sd = {k: v.float() for k, v in self.state_dict().items()}
        fused.load_state_dict(fuse_params(sd), strict=True)
        return fused.to(param.dtype).eval()


def build_model(cfg: Union[str, Dict[str, Any]], nc: Optional[int] = None,
                fused: bool = False, dtype: torch.dtype = torch.float32,
                device: Optional[Union[str, torch.device]] = None, s2d_stem=False,
                remat=False, out_xyxy: bool = False, quant=False,
                decompose_map=()) -> YOLOModel:
    """Build a YOLOModel from a config dict or YAML path, in eval mode.

    ``nc`` overrides the config's n_classes. ``device`` defaults to the card
    and raises without CUDA; pass ``"cpu"`` (or ``"meta"`` for shapes and
    parameter counts only) explicitly. ``s2d_stem`` (False, True, "reshape",
    "slice", "im2col"), ``remat`` (False, True, "save_convs"), ``out_xyxy``,
    ``quant`` (False, "calib", True) and ``decompose_map``: see
    :class:`YOLOModel`. The config dict is kept as ``model.cfg``.
    """
    device = resolve_device(device)
    cfg = parse_model_config(cfg)
    specs, save, head_index = _build_specs(cfg)
    anchors = _freeze(cfg.get("anchors", ()))
    n_classes = int(nc if nc is not None else cfg.get("n_classes", 80))
    in_ch = int(cfg.get("input_channel", 3))
    strides: Tuple[float, ...] = ()
    if head_index is not None:
        strides = _infer_strides(specs, save, head_index, anchors, n_classes, in_ch)
    with torch.device(device):
        model = YOLOModel(tuple(specs), tuple(save), head_index, n_classes, anchors,
                          strides, in_ch=in_ch, fused=fused, s2d_stem=s2d_stem, remat=remat,
                          out_xyxy=out_xyxy, quant=quant, decompose_map=decompose_map)
    model.cfg = cfg
    return model.to(dtype).eval()


def _infer_strides(specs, save, head_index, anchors, nc, in_ch) -> Tuple[float, ...]:
    """Shape-only forward on the meta device to find each level's stride."""
    with torch.device("meta"):
        probe = YOLOModel(tuple(specs), tuple(save), head_index, nc, anchors,
                          tuple(8.0 * 2 ** i for i in range(len(anchors))), in_ch=in_ch)
        size = 256
        raw = probe(torch.empty(1, in_ch, size, size), training=True)
    return tuple(float(size / r.shape[1]) for r in raw)


def init_model(model: YOLOModel, seed: int = 0) -> YOLOModel:
    """Initialise ``model`` in place as flax initialises the JAX package's:
    every conv and dense kernel ``lecun_normal`` (drawn from ``torch.Generator`` seeded
    with ``seed``, on the CPU, in module order), BatchNorm scale 1, bias 0,
    mean 0, variance 1, LayerNorm scale 1, bias 0, and the head's prior bias. The draws differ from
    JAX's; the distribution is the same. Returns the model."""
    gen = torch.Generator(device="cpu").manual_seed(int(seed))
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, nn.Conv2d):
                L.lecun_normal_(mod.weight, gen)
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, nn.Linear):
                L.lecun_normal_(mod.weight, gen)
                mod.bias.zero_()
            elif isinstance(mod, (nn.BatchNorm2d, nn.LayerNorm)):
                mod.reset_parameters()
    if model.head is not None:
        model.head.reset_bias()
    return model


def count_params(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())


def fuse_params(state_dict: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Fold BatchNorm into the preceding convs of a state_dict.

    W' = W * gamma / sqrt(var + eps); b' = beta - mean * gamma / sqrt(var + eps),
    eps = 1e-3, into ``conv`` or, in a decomposed block, ``conv_last``.
    Returns the state_dict of the same model built ``fused=True``.
    """
    eps = 1e-3
    out: Dict[str, torch.Tensor] = {}
    for k, v in state_dict.items():
        if ".bn." in k:
            continue
        out[k] = v
    for k in state_dict:
        if not k.endswith(".bn.weight"):
            continue
        base = k[: -len(".bn.weight")]
        gamma = state_dict[f"{base}.bn.weight"]
        beta = state_dict[f"{base}.bn.bias"]
        mean = state_dict[f"{base}.bn.running_mean"]
        var = state_dict[f"{base}.bn.running_var"]
        scale = gamma / torch.sqrt(var + eps)
        conv = f"{base}.conv_last" if f"{base}.conv_last.weight" in state_dict else f"{base}.conv"
        out[f"{conv}.weight"] = state_dict[f"{conv}.weight"] * scale.reshape(-1, 1, 1, 1)
        out[f"{conv}.bias"] = beta - mean * scale
    return out
