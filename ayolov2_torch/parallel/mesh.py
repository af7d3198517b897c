"""Ranks, the device mesh and the sharding rules, over ``torch.distributed``.

The counterpart of ``ayolov2_tpu/parallel/mesh.py``. JAX runs one program
over an N-device mesh (one process, or N under ``jax.distributed``); here
both become N processes, one rank each, joined by ``torch.distributed``:
NCCL between cards, gloo on the CPU (or, named by the caller, gloo between
ranks that share one card). A ``DeviceMesh`` names the axes: ``("data",)``
for data parallelism, ``("data", "model")`` with tensor parallelism.

Where JAX places global arrays with a ``NamedSharding``, a rank here holds
its part as a plain tensor: :func:`batch_sharding` is the slice of rows a
rank owns, :func:`replicate` the whole, and :func:`zero_sharding` /
:func:`tp_sharding` give, leaf by leaf over the port's kindle-named state,
the dim a leaf is split on (or None), by the JAX package's rules.
"""

from __future__ import annotations

import datetime
import os
from typing import Any, Dict, Mapping, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

# the port's leaf layouts listed in the order of the JAX package's: a conv
# kernel is OIHW here and HWIO there, a Linear weight (out, in) and (in, out)
_JAX_DIM_ORDER = {4: (2, 3, 1, 0), 2: (1, 0)}


def _env_int(key: str) -> Optional[int]:
    return int(os.environ[key]) if os.environ.get(key, "") != "" else None


def initialize_distributed(backend: Optional[str] = None, device=None
                           ) -> Optional[torch.device]:
    """Join this process to its ranks; returns the rank's device, or None
    when the environment names no ranks (one process, nothing to join).

    The environment is JAX's contract (``AYOLO_NUM_PROCS`` > 1,
    ``AYOLO_PROC_ID``, ``AYOLO_COORDINATOR`` host:port, default
    localhost:12321) or torchrun's (``WORLD_SIZE``, ``RANK``,
    ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``; a ``WORLD_SIZE`` of 1
    joins a group of one). Rank r runs on ``cuda:LOCAL_RANK`` (``cuda:r``
    under JAX's contract) unless ``device`` names one; more ranks than cards
    on a node raise, naming both counts. The backend is ``nccl`` for a card
    and ``gloo`` for the CPU unless ``backend`` names one (gloo also takes
    CUDA tensors, staged through the host: the way two ranks share one
    card, which NCCL refuses). A rendezvous or collective that waits longer
    than ``AYOLO_DIST_TIMEOUT_S`` seconds (default 600) raises.
    """
    if dist.is_initialized():
        return _RANK_DEVICE[0]
    n_procs = _env_int("AYOLO_NUM_PROCS") or 0
    if n_procs > 1:
        world, rank = n_procs, _env_int("AYOLO_PROC_ID") or 0
        local_rank = _env_int("LOCAL_RANK")
        local_rank = rank if local_rank is None else local_rank
        init_method = "tcp://" + os.environ.get("AYOLO_COORDINATOR", "localhost:12321")
    elif _env_int("WORLD_SIZE") is not None:
        world, rank = _env_int("WORLD_SIZE"), _env_int("RANK") or 0
        local_rank = _env_int("LOCAL_RANK")
        local_rank = rank if local_rank is None else local_rank
        init_method = "env://"
    else:
        return None
    if device is not None:
        device = torch.device(device)
    elif torch.cuda.is_available():
        n_cards = torch.cuda.device_count()
        if local_rank >= n_cards:
            raise ValueError(f"rank {rank} (local rank {local_rank}) of {world} ranks has no card: "
                             f"this node has {n_cards} card(s) for its ranks")
        device = torch.device("cuda", local_rank)
    else:
        device = torch.device("cpu")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    timeout_s = float(os.environ.get("AYOLO_DIST_TIMEOUT_S", "600"))
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))
    _RANK_DEVICE[0] = device
    return device


_RANK_DEVICE: list = [None]  # the device initialize_distributed gave this rank


def world_size() -> int:
    """The number of ranks (1 without ``torch.distributed``)."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def is_main_process() -> bool:
    """Rank 0 (or a process without ranks): the one that writes
    checkpoints, plots, validates and logs at INFO."""
    return rank() == 0


def comm_device(group=None) -> torch.device:
    """Where a tensor for ``group``'s collectives lives: the rank's card
    under NCCL, the CPU under gloo."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def host_broadcast_max(mesh, value: float) -> float:
    """The largest ``value`` over all ranks (an all-reduce MAX), the same
    number on every rank: the consensus on a stop or a preemption. One
    process: ``value``."""
    if world_size() == 1:
        return value
    t = torch.tensor([float(value)], dtype=torch.float64, device=comm_device())
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return float(t.item())


def broadcast_object(obj: Any, src: int = 0) -> Any:
    """Rank ``src``'s Python object on every rank."""
    if world_size() == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src, device=comm_device())
    return box[0]


def get_mesh(axis_names: Tuple[str, ...] = ("data",), shape: Optional[Tuple[int, ...]] = None):
    """A ``DeviceMesh`` over every rank: ``("data",)`` by default, or
    ``("data", "model")`` with ``shape``."""
    from torch.distributed.device_mesh import init_device_mesh

    n = world_size()
    if shape is None:
        shape = (n,) + (1,) * (len(axis_names) - 1)
    if int(np.prod(shape)) != n:
        raise ValueError(f"mesh shape {tuple(shape)} does not hold the {n} ranks")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(axis_names))


def axis_size(mesh, axis: str = "data") -> int:
    """The size of ``axis``: of a ``DeviceMesh``, or of a mapping of axis
    names to sizes (what the spec rules take without ranks)."""
    if isinstance(mesh, Mapping):
        return int(mesh.get(axis, 1))
    names = tuple(mesh.mesh_dim_names or ())
    return int(mesh.shape[names.index(axis)]) if axis in names else 1


def axis_index(mesh, axis: str = "data") -> int:
    """This rank's coordinate on ``axis``."""
    names = tuple(mesh.mesh_dim_names or ())
    return int(mesh.get_local_rank(axis)) if axis in names else 0


def batch_sharding(mesh, n: int, axis: str = "data") -> slice:
    """The rows of a global batch of ``n`` this rank owns on ``axis``;
    ``n`` must divide."""
    size, idx = axis_size(mesh, axis), axis_index(mesh, axis)
    if n % size:
        raise ValueError(f"batch {n} not divisible by data-axis size {size}")
    per = n // size
    return slice(idx * per, (idx + 1) * per)


def replicate(mesh) -> slice:  # noqa: ARG001 - the JAX signature
    """The whole: every rank holds all of a replicated leaf."""
    return slice(None)


def shard_batch(mesh, tree: Any, axis: str = "data") -> Any:
    """This rank's rows of every array in ``tree`` (dict, list, tuple or
    a leaf); dim 0 must divide over ``axis``."""
    if isinstance(tree, dict):
        return {k: shard_batch(mesh, v, axis) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(shard_batch(mesh, v, axis) for v in tree)
    return tree[batch_sharding(mesh, tree.shape[0], axis)]


class LocalBatch(NamedTuple):
    """A rank's part of a global batch, with what the global batch adds:
    ``offset``, the global row of its first image, and ``global_size``."""

    images: Any
    targets: Any
    target_mask: Any
    offset: int
    global_size: int

    def global_targets(self) -> np.ndarray:
        """The targets with their image index in global batch rows."""
        t = np.array(self.targets, copy=True)
        t[:, 0] += self.offset
        return t


def make_global_batch(mesh, images: Any, targets: Any, target_mask: Any) -> LocalBatch:
    """The rank's loader shard as its part of the global batch.

    Each rank keeps its rows (``DataLoader(shard=(index, count))`` loads
    batch/count items of every batch): the step's loss takes the global
    counts by an all-reduce, so nothing is gathered. The image-index offset
    and the global batch size are made explicit here. Without a mesh (one
    process): the batch as it is, offset 0."""
    local = int(np.shape(images)[0])
    if mesh is None:
        return LocalBatch(images, targets, target_mask, 0, local)
    size, idx = axis_size(mesh, "data"), axis_index(mesh, "data")
    return LocalBatch(images, targets, target_mask, idx * local, local * size)


# -- the sharding rules ------------------------------------------------------------


def _shape(x) -> Tuple[int, ...]:
    return tuple(int(s) for s in (x.shape if hasattr(x, "shape") else x))


def zero_sharding(mesh, tree: Mapping[str, Any], axis: str = "data",
                  min_elems: int = 65536) -> Dict[str, Optional[int]]:
    """ZeRO's rule, leaf by leaf: a leaf of at least ``min_elems`` elements
    is split over ``axis`` along its largest dim that the axis divides,
    ties going to the dim the JAX package lists first in its own layout
    (HWIO kernels, (in, out) Linear weights); anything else is replicated.

    ``tree`` maps the port's names to tensors or shapes; returns each name's
    dim in the port's layout, or None."""
    n = axis_size(mesh, axis)
    out: Dict[str, Optional[int]] = {}
    for name, x in tree.items():
        shape = _shape(x)
        if n <= 1 or not shape or int(np.prod(shape)) < min_elems:
            out[name] = None
            continue
        order = _JAX_DIM_ORDER.get(len(shape), tuple(range(len(shape))))
        cands = [d for d in order if shape[d] % n == 0 and shape[d] >= n]
        out[name] = max(cands, key=lambda d: shape[d]) if cands else None
    return out


# leaf name -> {rank: output-channel dim}, the port's names and layouts of the
# JAX package's table (kernel -> weight OIHW / (out, in), scale -> a 1-D
# weight, mean / var -> running_mean / running_var)
_TP_DIM = {
    "weight": {4: 0, 2: 0, 1: 0},
    "q_kernel": {4: 0},
    "bias": {1: 0},
    "running_mean": {1: 0},
    "running_var": {1: 0},
    "w_scale": {1: 0},
}
# the attention's projections are 3-D kernels in the JAX package, outside
# its table (replicated); the port holds them as (d, d)
_ATTN = ("query", "key", "value", "out")


def tp_sharding(mesh, tree: Mapping[str, Any], axis: str = "model") -> Dict[str, Optional[int]]:
    """Tensor parallelism's rule, leaf by leaf: a conv kernel, Linear
    weight, bias, BatchNorm scale or statistics (and an int8 kernel's
    scales) is split on its output-channel dim over ``axis`` when the axis
    divides it; any other leaf, or one it does not divide (the 255-wide
    head), is replicated. Keyed on the leaf's name, as the JAX package's.

    Returns each name's dim in the port's layout, or None."""
    n = axis_size(mesh, axis)
    out: Dict[str, Optional[int]] = {}
    for name, x in tree.items():
        shape = _shape(x)
        parts = name.split(".")
        d = _TP_DIM.get(parts[-1], {}).get(len(shape))
        if len(parts) > 1 and parts[-2] in _ATTN and parts[-1] in ("weight", "bias"):
            d = None
        if n <= 1 or not shape or d is None or shape[d] % n or shape[d] < n:
            out[name] = None
        else:
            out[name] = d
    return out
