"""Post-training int8 quantization of the serving path.

The counterpart of ``ayolov2_tpu/compress/quantize.py``, over the same
trees: the JAX package's fused ``{'params': ...}`` tree as nested dicts of
numpy arrays (the weight bridge, ``utils/weights.py``, carries them to and
from the port's state_dict).

1. :func:`collect_activation_stats` runs a model built with
   ``quant="calib"`` over calibration batches; every quantizable conv
   records the absmax and the p99.9 of its input's |x|, and the result is
   JAX's ``quant_stats`` tree (``{"model_2": {"cv1": {"in_absmax": ...,
   "in_p999": ...}}}``), the maximum over the batches.
2. :func:`quantize_params` turns each ``conv`` ``{kernel (k, k, cin, f),
   bias}`` with cin > 4 and a recorded stat into ``{q_kernel int8, w_scale
   (f,), in_scale (), bias}``: w_scale = max(absmax over (kh, kw, cin),
   1e-12) / 127, q = clip(rint(kernel / w_scale), -127, 127), in f32.
3. :func:`quantize_model` is both in one call and returns the model built
   with ``fused=True, quant=True`` holding the int8 tree.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, Iterable, Optional, Tuple, Union

import numpy as np
import torch

LOGGER = logging.getLogger(__name__)
STAT_KEYS = {"absmax": "in_absmax", "p999": "in_p999"}


def collect_activation_stats(calib_model, fused_variables: Optional[Dict[str, Any]],
                             batches: Iterable[torch.Tensor]) -> Dict[str, Any]:
    """Run ``calib_model`` (built with ``quant="calib"``; ``fused_variables``
    loaded into it first unless None) over ``batches`` (NCHW, preprocessed
    as serving inputs are: letterboxed, /255, the model's dtype, on its
    device); returns the per-conv stats tree under the JAX module paths."""
    from ayolov2_torch.models.layers import ConvBnAct
    from ayolov2_torch.utils.weights import flax_module_path, load_flax_variables

    if fused_variables is not None:
        load_flax_variables(calib_model, fused_variables)
    convs = {name: m for name, m in calib_model.named_modules()
             if isinstance(m, ConvBnAct) and m.quant == "calib" and m.quantizable}
    for m in convs.values():
        m.reset_stats()
    n = 0
    with torch.no_grad():
        for batch in batches:
            calib_model(batch, training=True)
            n += 1
    if n == 0:
        raise ValueError("calibration needs at least one batch")
    LOGGER.info("int8 calibration: %d batches", n)
    stats: Dict[str, Any] = {}
    for name, m in convs.items():
        if m.in_absmax is None:
            continue
        node = stats
        for part in flax_module_path(name):
            node = node.setdefault(part, {})
        node["in_absmax"] = np.float32(m.in_absmax.item())
        node["in_p999"] = np.float32(m.in_p999.item())
    return stats


def quantize_params(fused_variables: Dict[str, Any], stats: Dict[str, Any],
                    method: str = "absmax") -> Dict[str, Any]:
    """Fused ``{'params': ...}`` + calibration stats -> the int8 tree.

    ``method``: "absmax" takes the full calibrated input range, "p999" the
    99.9th percentile of |x| (outliers saturate). Raises when no conv was
    quantized: the stats belong to another tree, or the tree is unfused (its
    convs have no bias)."""
    stat_key = STAT_KEYS[method]
    n_quant = 0

    def walk(p: Dict[str, Any], s: Any) -> Dict[str, Any]:
        nonlocal n_quant
        out: Dict[str, Any] = {}
        s = s if isinstance(s, dict) else {}
        for k, v in p.items():
            if not isinstance(v, dict):
                out[k] = v
                continue
            if (k == "conv" and set(v) == {"kernel", "bias"}
                    and getattr(v["kernel"], "ndim", 0) == 4
                    and v["kernel"].shape[2] > 4 and stat_key in s):
                kern = np.asarray(v["kernel"], np.float32)
                w_scale = np.maximum(np.abs(kern).max(axis=(0, 1, 2)), 1e-12) / 127.0
                q = np.clip(np.rint(kern / w_scale), -127, 127).astype(np.int8)
                in_absmax = float(np.asarray(s[stat_key]))
                out[k] = {
                    "q_kernel": q,
                    "w_scale": np.asarray(w_scale, np.float32),
                    "in_scale": np.asarray(max(in_absmax, 1e-6), np.float32),
                    "bias": np.asarray(v["bias"], np.float32),
                }
                n_quant += 1
            else:
                out[k] = walk(v, s.get(k, {}))
        return out

    qparams = walk(fused_variables["params"], stats)
    if n_quant == 0:
        raise ValueError("no conv was quantized: the calibration stats don't match the "
                         "parameter tree (same model config and fused variables required)")
    LOGGER.info("int8 quantization: %d convs", n_quant)
    return {"params": qparams}


def fuse_variables(variables: Dict[str, Any]) -> Dict[str, Any]:
    """An unfused {'params', 'batch_stats'} tree with BatchNorm folded in
    (``models/builder.fuse_params`` over the bridged state_dict)."""
    from ayolov2_torch.models.builder import fuse_params
    from ayolov2_torch.utils.weights import flax_from_state_dict, state_dict_from_flax

    fused = fuse_params(state_dict_from_flax(variables))
    return {"params": flax_from_state_dict(fused)["params"]}


def quantize_model(model_cfg: Union[str, Dict[str, Any]], variables: Dict[str, Any],
                   calib_batches: Iterable[torch.Tensor], dtype: torch.dtype = torch.bfloat16,
                   nc: Optional[int] = None, decompose_map: Any = (), method: str = "absmax",
                   device=None) -> Tuple[Any, Dict[str, Any]]:
    """Fuse (if unfused) -> calibrate -> quantize. Returns ``(quant_model,
    quant_variables)``: the model built with ``fused=True, quant=True`` in
    ``dtype`` on ``device`` (default the card) holding the int8 tree, and
    the tree."""
    from ayolov2_torch.models import build_model
    from ayolov2_torch.utils.weights import load_flax_variables

    if variables.get("batch_stats"):
        variables = fuse_variables(variables)
    kw = dict(nc=nc, fused=True, dtype=dtype, device=device, decompose_map=decompose_map)
    calib_model = build_model(model_cfg, quant="calib", **kw)
    stats = collect_activation_stats(calib_model, variables, calib_batches)
    qvars = quantize_params(variables, stats, method=method)
    qmodel = load_flax_variables(build_model(model_cfg, quant=True, **kw), qvars)
    return qmodel, qvars
