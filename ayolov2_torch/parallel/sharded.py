"""One rank's part in a train step on N ranks: data parallelism, ZeRO
(``train.fsdp``) and tensor parallelism (``train.tp``).

The counterpart of the JAX package's jitted step over a mesh
(``ayolov2_tpu/train/trainer.py:290-336``), where XLA inserts the
collectives; here :class:`Parallel` places them by hand:

- **Data parallelism.** Each rank runs the forward on its rows of the
  global batch. BatchNorm normalises over the global batch
  (``models.layers.batchnorm_sync``), the loss divides by the global counts
  (``ComputeLoss(..., reduce=)``) and returns the rank's share of the
  global loss times the global batch size, so the ranks' gradients *sum* to
  the one-device gradient: a hand-written bucketed all-reduce (one buffer
  per dtype, a SUM over the data axis, every micro-step) sums them; no
  averaging. The optimizer, the EMA and the counters then run the same
  update on every rank, so the replicated leaves stay bit-equal.
- **ZeRO.** Every parameter that ``zero_sharding`` selects is stored,
  updated and EMA'd as the rank's slice along its chosen dim; the optimizer
  state follows the parameter. Before the forward of the module that reads
  it, the whole weight is all-gathered (again before its recomputation
  under remat); its gradient comes back summed over the data axis and
  sliced (``collectives.gather_shards``), so it skips the bucket.
- **Tensor parallelism.** On a ``("data", "model")`` mesh each conv that
  ``tp_sharding`` splits (a ``ConvBnAct``, with its BatchNorm, or a head
  conv whose width the model axis divides) holds and computes its slice of
  the output channels, with its BatchNorm, EMA and optimizer state sliced
  the same way; its input's gradient is summed over the model axis
  (``copy_to_group``) and its output all-gathered along the channels
  before the next layer (``gather_slices``). Indivisible convs (the
  255-wide head), grouped convs and the other leaves stay replicated.

Checkpoints and validation see :meth:`Parallel.full_state`: every split leaf
all-gathered back to the one-device layout (a collective: every rank calls
it), so a checkpoint is the file one device writes.
"""

from __future__ import annotations

import copy
import logging
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from ayolov2_torch.parallel import collectives as C
from ayolov2_torch.parallel.mesh import (
    axis_index,
    axis_size,
    tp_sharding,
    zero_sharding,
)

LOGGER = logging.getLogger(__name__)


class _FullOptimizer:
    """An optimizer's gathered ``state_dict`` in the place of the optimizer."""

    def __init__(self, sd: Dict[str, Any]) -> None:
        self._sd = sd

    def state_dict(self) -> Dict[str, Any]:
        return self._sd


class Parallel:
    """This rank's data, ZeRO and tensor parallelism over ``mesh``.

    ``fsdp``: ZeRO over the data axis, leaves of ``fsdp_min_elems`` and more;
    ``tp``: the model axis's size (a ``("data", "model")`` mesh), which wins
    over ``fsdp`` as in the JAX package.
    """

    def __init__(self, mesh, fsdp: bool = False, tp: int = 1,
                 fsdp_min_elems: int = 65536) -> None:
        self.mesh = mesh
        self.data_group = mesh.get_group("data")
        self.data_size = axis_size(mesh, "data")
        self.data_index = axis_index(mesh, "data")
        self.tp = tp if tp > 1 else 1
        self.model_group = mesh.get_group("model") if self.tp > 1 else None
        if self.tp > 1 and fsdp:
            LOGGER.warning("train.tp=%d overrides train.fsdp: ZeRO sharding of the data axis is "
                           "ignored when tensor parallelism is on", self.tp)
        self.fsdp = bool(fsdp) and self.tp == 1 and self.data_size > 1
        self.fsdp_min_elems = int(fsdp_min_elems)
        self.dims: Dict[str, int] = {}  # state name -> the dim its leaf is split on
        self.split_modules: List[str] = []  # tensor parallelism's convs
        self._in_backward: set = set()  # ids of ZeRO shards (reduced by their gather)
        self.ready = False

    @property
    def mode(self) -> str:
        return "tp" if self.tp > 1 else ("fsdp" if self.fsdp else "dp")

    def _split_group(self):
        return self.model_group if self.tp > 1 else self.data_group

    def _split_index(self) -> int:
        return axis_index(self.mesh, "model") if self.tp > 1 else self.data_index

    # -- set-up -------------------------------------------------------------------
    def setup(self, state) -> None:
        """Make the replicas equal to rank 0's, then split the leaves this
        mode splits and hook the model (once; every rank calls it)."""
        if self.ready:
            return
        self._sync_replicas(state)
        model, ema = state.model, state.ema_model
        sd = model.state_dict()
        if self.tp > 1:
            self._plan_tp(model, tp_sharding(self.mesh, sd, axis="model"))
        elif self.fsdp:
            specs = zero_sharding(self.mesh, sd, axis="data", min_elems=self.fsdp_min_elems)
            params = dict(model.named_parameters())
            for name, d in specs.items():
                if d is None:
                    continue
                if name not in params:
                    raise ValueError(f"train.fsdp: {name} is a buffer of {sd[name].numel()} "
                                     "elements; ZeRO shards parameters only (raise "
                                     "train.fsdp_min_elems above it)")
                self.dims[name] = d
        self._slice(state)
        if self.tp > 1:
            self._hook_tp(model)
        elif self.dims:
            self._hook_fsdp(model)
        self.ready = True
        LOGGER.info("parallel %s: data axis %d, model axis %d, %d leaves split", self.mode,
                    self.data_size, self.tp, len(self.dims))

    @staticmethod
    def _sync_replicas(state) -> None:
        C.bucketed_([t for m in (state.model, state.ema_model)
                     for t in m.state_dict().values() if t.is_floating_point()],
                    lambda flat: dist.broadcast(flat, src=0))

    def _plan_tp(self, model: nn.Module, specs: Dict[str, Optional[int]]) -> None:
        from ayolov2_torch.models.layers import ConvBnAct

        inner = set()
        for name, m in model.named_modules():
            if isinstance(m, ConvBnAct):
                inner.add(f"{name}.conv")
        for name, m in model.named_modules():
            if isinstance(m, ConvBnAct):
                ok = (m.groups == 1 and m.ranks is None and isinstance(m.conv, nn.Conv2d))
            elif isinstance(m, nn.Conv2d) and name not in inner:
                ok = m.groups == 1
            else:
                continue
            leaves = {f"{name}.{k}": specs.get(f"{name}.{k}")
                      for k, t in m.state_dict().items() if t.dim() > 0}
            if ok and leaves and all(d == 0 for d in leaves.values()):
                self.split_modules.append(name)
                # every tensor of the module, BatchNorm's scratch buffers too
                self.dims.update({f"{name}.{k}": 0 for k, t in
                                  list(m.named_parameters()) + list(m.named_buffers())
                                  if t.dim() > 0})

    @torch.no_grad()
    def _slice(self, state) -> None:
        n, i = (self.tp if self.tp > 1 else self.data_size), self._split_index()
        params = dict(state.model.named_parameters())
        for m in (state.model, state.ema_model):
            tensors = dict(m.named_parameters())
            tensors.update(m.named_buffers())
            for name, d in self.dims.items():
                t = tensors[name]
                t.data = t.data.chunk(n, d)[i].clone()
        opt = state.optimizer
        for name, p in zip(opt.names, opt.params):
            d = self.dims.get(name)
            if d is None:
                continue
            for k, v in opt.opt.state.get(p, {}).items():
                if torch.is_tensor(v) and v.dim() > 0:
                    opt.opt.state[p][k] = v.chunk(n, d)[i].clone()
            if p.grad is not None and p.grad.shape != p.shape:
                p.grad = p.grad.chunk(n, d)[i].clone()
        if self.fsdp:
            self._in_backward = {id(params[name]) for name in self.dims}

    def _hook_fsdp(self, model: nn.Module) -> None:
        """Each module that reads a ZeRO shard gathers it before its forward
        (the ``ConvBnAct`` for its conv: the s2d stem reads the weight
        there) and drops the whole after it."""
        from ayolov2_torch.models.layers import ConvBnAct

        readers: Dict[str, list] = {}
        for name, d in self.dims.items():
            owner, attr = name.rsplit(".", 1)
            parent = owner.rsplit(".", 1)[0] if "." in owner else ""
            reader = owner
            if owner.endswith(".conv") and isinstance(model.get_submodule(parent), ConvBnAct):
                reader = parent
            readers.setdefault(reader, []).append(
                (model.get_submodule(owner), attr, getattr(model.get_submodule(owner), attr), d))
        group = self.data_group

        def pre(entries):
            def hook(module, args):
                for owner, attr, p, d in entries:
                    owner.__dict__[attr] = C.gather_shards(p, d, group)
            return hook

        def post(entries):
            def hook(module, args, out):
                for owner, attr, _, _ in entries:
                    owner.__dict__.pop(attr, None)
            return hook

        for reader, entries in readers.items():
            m = model.get_submodule(reader)
            m.register_forward_pre_hook(pre(entries))
            m.register_forward_hook(post(entries))

    def _hook_tp(self, model: nn.Module) -> None:
        group = self.model_group

        def pre(module, args):
            return (C.copy_to_group(args[0], group),) + tuple(args[1:])

        def post(module, args, out):
            return C.gather_slices(out, 1, group)

        for name in self.split_modules:
            m = model.get_submodule(name)
            m.register_forward_pre_hook(pre)
            m.register_forward_hook(post)

    # -- the step -----------------------------------------------------------------
    def data_sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over the data axis, detached: the loss's counts,
        and the global loss items from the ranks' shares."""
        out = t.detach().clone()
        dist.all_reduce(out, group=self.data_group)
        return out

    def backward(self, loss: torch.Tensor, model: nn.Module) -> None:
        """The gradient of the global loss into each parameter's ``grad``
        (added to what accumulation holds): this rank's gradient, summed over
        the data axis in one bucket per dtype (ZeRO shards arrive summed)."""
        params = [p for p in model.parameters() if p.requires_grad]
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
        C.bucketed_([g for p, g in zip(params, grads) if id(p) not in self._in_backward],
                    lambda flat: dist.all_reduce(flat, group=self.data_group))
        for p, g in zip(params, grads):
            p.grad = g if p.grad is None else p.grad.add_(g)

    # -- the one-device layout -------------------------------------------------------
    def _full(self, name: str, t: torch.Tensor) -> torch.Tensor:
        d = self.dims.get(name)
        if d is None:
            return t.detach().clone()
        return C.gather(t.detach(), d, self._split_group())

    @torch.no_grad()
    def full_model(self, model: nn.Module, like: nn.Module) -> nn.Module:
        """A hook-free copy of ``like``'s graph holding ``model``'s leaves in
        the one-device layout (collective)."""
        full = copy.deepcopy(like)
        dst = dict(full.named_parameters())
        dst.update(full.named_buffers())
        src = dict(model.named_parameters())
        src.update(model.named_buffers())
        for name in dst:
            dst[name].data = self._full(name, src[name])
        return full

    def full_optimizer_state(self, sd: Dict[str, Any], device) -> Dict[str, Any]:
        """An optimizer ``state_dict`` (numpy leaves) with each split slot
        and gradient gathered (collective)."""
        def full(name, v):
            d = self.dims.get(name)
            if d is None or not isinstance(v, np.ndarray) or v.ndim == 0:
                return v
            return C.gather(torch.from_numpy(v).to(device), d,
                            self._split_group()).cpu().numpy()

        out = dict(sd)
        out["state"] = {n: {k: full(n, v) for k, v in slots.items()}
                        for n, slots in sd["state"].items()}
        if "grads" in sd:
            out["grads"] = {n: full(n, v) for n, v in sd["grads"].items()}
        return out

    def full_state(self, state):
        """``state`` in the one-device layout: itself when nothing is split,
        else gathered copies of the model, the EMA and the optimizer's state
        (collective: every rank calls it; rank 0 writes and validates)."""
        if not self.dims:
            return state
        from ayolov2_torch.train.train_state import TrainState

        device = next(state.model.parameters()).device
        return TrainState(
            model=self.full_model(state.model, state.ema_model),
            optimizer=_FullOptimizer(self.full_optimizer_state(state.optimizer.state_dict(),
                                                               device)),
            ema_model=self.full_model(state.ema_model, state.ema_model),
            ema_updates=state.ema_updates, step=state.step)

    def state_bytes(self, state) -> Dict[str, int]:
        """Bytes this rank holds of the model, the EMA and the optimizer's
        slots: all, and of the split leaves alone."""
        out = {"all": 0, "split": 0}
        named = [(n, t) for m in (state.model, state.ema_model)
                 for n, t in list(m.named_parameters()) + list(m.named_buffers())]
        for name, p in zip(state.optimizer.names, state.optimizer.params):
            named += [(name, v) for v in state.optimizer.opt.state.get(p, {}).values()
                      if torch.is_tensor(v) and v.dim() > 0]
        for name, t in named:
            b = t.numel() * t.element_size()
            out["all"] += b
            out["split"] += b if name in self.dims else 0
        return out
