"""The reference's torch checkpoints (``.pt``) read into the port.

The counterpart of ``ayolov2_tpu/utils/torch_import.py``. The reference
saves ``{epoch, model, ema, ...}`` dicts whose ``model`` / ``ema`` is an
``nn.Module`` or a state_dict, or a bare state_dict. The port's modules
carry the reference's (kindle) names already (``utils/weights.py``), so a
reference state_dict maps onto ``build_model(...).state_dict()`` without
renaming: :func:`transfer_state_dict` keeps the shape-matched transfer
(``intersect_dicts``: a tensor whose name or shape has no match is left
out, and the template keeps its own value there) and counts what matched.

The way back, a port state_dict from JAX-named variables, is
``utils/weights.state_dict_from_flax``: it is the port's counterpart of the
JAX package's ``pytree_to_torch_state_dict``.

``torch.load`` of a pickle can run code. :func:`load_torch_checkpoint`
reads with ``weights_only=True`` first, which takes state_dicts and dicts
of them; only a file that holds module objects is read again with
``weights_only=False``, and only paths that the user named on the command
line come here.
"""

from __future__ import annotations

import logging
import pickle
from typing import Dict, List, Tuple

import torch

LOGGER = logging.getLogger(__name__)

# the leaves the transfer maps; other entries (num_batches_tracked, the
# anchors' buffers) are skipped without counting, as the JAX package does
MAPPED_LEAVES = ("weight", "bias", "running_mean", "running_var")


def _torch_load(path: str):
    try:
        return torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError:
        # module objects: the classes must be importable (e.g. kindle's)
        LOGGER.warning("%s holds pickled objects, not only tensors: reading it with "
                       "weights_only=False", path)
        return torch.load(path, map_location="cpu", weights_only=False)


def load_torch_checkpoint(path: str, prefer_ema: bool = True) -> Dict[str, torch.Tensor]:
    """A reference ``.pt`` file as a flat name -> tensor state_dict.

    Takes ``{epoch, model, ema, ...}`` dicts (``ema`` first when
    ``prefer_ema`` and it is set), ``nn.Module`` values (their
    ``.float().state_dict()``) and bare state_dicts."""
    ckpt = _torch_load(str(path))
    obj = ckpt
    if isinstance(ckpt, dict) and ("ema" in ckpt or "model" in ckpt):
        obj = (ckpt.get("ema") if prefer_ema else None) or ckpt.get("model") or ckpt
    if hasattr(obj, "state_dict"):
        obj = obj.float().state_dict()
    if not isinstance(obj, dict):
        raise ValueError(f"cannot interpret checkpoint {path}: {type(obj).__name__}")
    return obj


def transfer_state_dict(state_dict: Dict[str, torch.Tensor],
                        template: Dict[str, torch.Tensor]
                        ) -> Tuple[Dict[str, torch.Tensor], int, List[str]]:
    """The template with every tensor of ``state_dict`` whose name and shape
    it has; returns (merged copy, matched, unmatched names). Entries whose
    last name part is not in ``MAPPED_LEAVES`` are neither counted nor
    copied."""
    out = {k: v.clone() for k, v in template.items()}
    n_matched = 0
    unmatched: List[str] = []
    for name, tensor in state_dict.items():
        if name.rsplit(".", 1)[-1] not in MAPPED_LEAVES:
            continue
        t = torch.as_tensor(tensor).detach().cpu()
        current = out.get(name)
        if current is not None and tuple(current.shape) == tuple(t.shape):
            out[name] = t.to(current.dtype).clone()
            n_matched += 1
        else:
            unmatched.append(name)
    if unmatched:
        LOGGER.warning("%d torch tensors had no matching tensor in the model (first: %s)",
                       len(unmatched), unmatched[:5])
    return out, n_matched, unmatched
