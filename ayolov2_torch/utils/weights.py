"""The weight bridge: the JAX package's variables <-> the port's state_dict.

Input is ``{'params': ..., 'batch_stats': ...}`` as nested dicts of numpy
arrays (fused or unfused), e.g. a flax ``init`` result or the ``ema`` entry
of a JAX checkpoint read by that package. The port does not read flax
msgpack files itself.

Name mapping (flax path -> kindle/torch name):
  model_{i}/conv/kernel          -> model.{i}.conv.weight      (HWIO -> OIHW)
  model_{i}/bn/{scale,bias}      -> model.{i}.bn.{weight,bias}
  batch_stats .../bn/{mean,var}  -> model.{i}.bn.running_{mean,var}
  model_{i}/m{k}/...             -> model.{i}.m.{k}...
  model_{i}_{r}/...              -> model.{i}.{r}...          (repeats)
  head model_{i}/m{k}/kernel     -> model.{i}.m.{k}.weight
  .../{fc,fc1,fc2}/kernel        -> ....weight                (Dense: (in, out) -> (out, in))
  .../{ln1,ln2,ln_out}/scale     -> ....weight                (LayerNorm)
  .../attn/{query,key,value}/kernel (d, heads, d/heads) -> ....weight (d, d)
  .../attn/{query,key,value}/bias   (heads, d/heads)    -> ....bias (d,)
  .../attn/out/kernel  (heads, d/heads, d)               -> ....weight (d, d)
  .../conv/q_kernel    int8 HWIO                         -> ....q_kernel int8 OIHW
  .../conv/{w_scale,in_scale,bias} (in_scale 0-d)        -> kept as they are (f32)
Every other name (``expand``, ``depthwise``, ``project``, ``tr{i}``,
``local_conv``, ``proj_in``, ``proj_out``, ``fusion``, ...) is kept as it is.
The attention's head count is not in the state_dict: ``flax_from_state_dict``
splits the kernels into ``ATTN_HEADS`` heads, MobileViT's 4.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch

QKV = ("query", "key", "value")
ATTN_HEADS = 4  # MobileViT's transformer blocks (JAX package: _TransformerBlock)


def _torch_name(path: Tuple[str, ...]) -> str:
    parts: List[str] = []
    for p in path:
        if p.startswith("model_"):
            parts.append("model")
            parts.extend(p.split("_")[1:])
        elif len(p) > 1 and p[0] == "m" and p[1:].isdigit():
            parts.extend(["m", p[1:]])
        else:
            parts.append(p)
    return ".".join(parts)


def module_name(path: str) -> str:
    """A JAX module path ('model_4/m0/cv2') as the port's module name
    ('model.4.m.0.cv2')."""
    return _torch_name(tuple(path.split("/")))


def flax_module_path(name: str) -> Tuple[str, ...]:
    """The port's module name ('model.2.m.0.cv1') as a JAX module path
    (('model_2', 'm0', 'cv1'))."""
    return _flax_path(name + ".leaf")[0]


def state_dict_from_flax(variables: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX variables -> a torch state_dict with kindle names (float32; an
    int8 kernel stays int8)."""
    out: Dict[str, torch.Tensor] = {}

    def put(name: str, arr) -> None:
        out[name] = torch.from_numpy(np.array(arr, dtype=np.float32))

    def walk(tree, path, is_stats):
        for k, v in tree.items():
            if hasattr(v, "items"):
                walk(v, path + (k,), is_stats)
                continue
            arr = np.asarray(v)
            base = _torch_name(path)
            if is_stats:
                put(f"{base}.running_{k}", arr)
                out[f"{base}.num_batches_tracked"] = torch.zeros((), dtype=torch.long)
            elif k == "kernel" and arr.ndim == 4:
                put(f"{base}.weight", arr.transpose(3, 2, 0, 1))
            elif k == "q_kernel":
                out[f"{base}.q_kernel"] = torch.from_numpy(
                    np.ascontiguousarray(arr.astype(np.int8).transpose(3, 2, 0, 1)))
            elif k == "kernel" and arr.ndim == 3 and path[-1] in QKV:
                put(f"{base}.weight", arr.reshape(arr.shape[0], -1).T)
            elif k == "kernel" and arr.ndim == 3 and path[-1] == "out":
                put(f"{base}.weight", arr.reshape(-1, arr.shape[-1]).T)
            elif k == "kernel" and arr.ndim == 2:
                put(f"{base}.weight", arr.T)
            elif k == "kernel":
                raise ValueError(f"{'/'.join(path)}/kernel: no torch layout for shape {arr.shape}")
            elif k == "scale":
                put(f"{base}.weight", arr)
            else:
                put(f"{base}.{k}", arr.reshape(-1) if k == "bias" else arr)

    walk(variables["params"], (), False)
    walk(variables.get("batch_stats", {}), (), True)
    return out


def _flax_path(name: str) -> Tuple[Tuple[str, ...], str]:
    """'model.2.m.0.cv1.conv.weight' -> (('model_2', 'm0', 'cv1', 'conv'), 'weight')."""
    parts = name.split(".")
    leaf, parts = parts[-1], parts[:-1]
    out: List[str] = []
    i = 0
    while i < len(parts):
        p = parts[i]
        if p == "model":
            idx = parts[i + 1]
            i += 2
            if i < len(parts) and parts[i].isdigit():
                out.append(f"model_{idx}_{parts[i]}")
                i += 1
            else:
                out.append(f"model_{idx}")
        elif p == "m" and i + 1 < len(parts) and parts[i + 1].isdigit():
            out.append(f"m{parts[i + 1]}")
            i += 2
        else:
            out.append(p)
            i += 1
    return tuple(out), leaf


def flax_from_state_dict(state_dict: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """Inverse of :func:`state_dict_from_flax` (numpy leaves: f32, and int8
    for ``q_kernel``)."""
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}

    def put(tree, path, value):
        for p in path[:-1]:
            tree = tree.setdefault(p, {})
        tree[path[-1]] = value

    for name, t in state_dict.items():
        path, leaf = _flax_path(name)
        if leaf == "num_batches_tracked":
            continue
        if leaf == "q_kernel":
            put(params, path + (leaf,), t.detach().cpu().numpy().transpose(2, 3, 1, 0))
            continue
        arr = t.detach().cpu().float().numpy()
        if leaf.startswith("running_"):
            put(stats, path + (leaf[len("running_"):],), arr)
        elif leaf == "weight" and arr.ndim == 4:
            put(params, path + ("kernel",), arr.transpose(2, 3, 1, 0))
        elif leaf == "weight" and path[-1] in QKV:
            put(params, path + ("kernel",), arr.T.reshape(arr.shape[1], ATTN_HEADS, -1))
        elif leaf == "bias" and path[-1] in QKV:
            put(params, path + ("bias",), arr.reshape(ATTN_HEADS, -1))
        elif leaf == "weight" and path[-1] == "out":
            put(params, path + ("kernel",), arr.T.reshape(ATTN_HEADS, -1, arr.shape[0]))
        elif leaf == "weight" and arr.ndim == 2:
            put(params, path + ("kernel",), arr.T)
        elif leaf == "weight":
            put(params, path + ("scale",), arr)
        else:
            put(params, path + (leaf,), arr)
    out = {"params": params}
    if stats:
        out["batch_stats"] = stats
    return out


def load_flax_variables(model: torch.nn.Module, variables: Dict[str, Any]) -> torch.nn.Module:
    """Load JAX variables into ``model`` with ``strict=True``."""
    model.load_state_dict(state_dict_from_flax(variables), strict=True)
    return model
