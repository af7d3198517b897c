"""YOLOv5's three parameter groups, warmup and epoch schedules, and
gradient accumulation.

The counterpart of ``ayolov2_tpu/train/optimizer.py``:

- groups: ``bn_scale`` (BatchNorm scale and bias; no weight decay),
  ``weight`` (conv kernels; weight decay scaled by ``bs * accumulate /
  64``), ``bias`` (no decay; its warmup starts at ``warmup_bias_lr``);
- SGD with momentum and Nesterov, or Adam, each group's lr and SGD's
  momentum set from the schedules before every update: a linear warmup
  over ``nw = max(round(warmup_epochs * updates per epoch),
  warmup_min_iters)`` updates, then ``lr0 * lf(epoch)`` with a cosine
  (default) or linear ``lf``;
- accumulation as ``optax.MultiSteps``: the gradients of ``accumulate``
  micro-batches are averaged, the update is applied on the last of them,
  and the schedules count updates (``warmup_min_iters`` and the epoch
  length are divided by ``accumulate``);
- ``freeze``: the updates of the first n ``model.{i}`` layers are dropped
  while the optimizer's state still advances (``_freeze_layers``).

The schedules compute in float32, as the JAX package's do on the device.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Iterable, List, Tuple

import numpy as np
import torch

NBS_NOMINAL = 64  # the nominal batch size
GROUPS = ("bn_scale", "weight", "bias")
_F = np.float32


def lr_schedule(epochs: int, lrf: float, linear: bool = False) -> Callable[[float], np.float32]:
    """The per-epoch lr multiplier lf(e): cosine (default) or linear."""

    def lf(epoch) -> np.float32:
        e = _F(epoch)
        if linear:
            return (_F(1.0) - e / _F(epochs)) * _F(1.0 - lrf) + _F(lrf)
        return ((_F(1.0) + np.cos(e * _F(math.pi) / _F(epochs))) / _F(2.0)) * _F(1.0 - lrf) + _F(lrf)

    return lf


def _interp(x, x0, x1, y0, y1) -> np.float32:
    """np.interp over one segment, clamped."""
    t = np.clip((_F(x) - _F(x0)) / max(_F(x1) - _F(x0), _F(1e-9)), _F(0.0), _F(1.0))
    return _F(y0) + t * (_F(y1) - _F(y0))


def make_group_schedules(lr0: float, lrf: float, epochs: int, steps_per_epoch: int,
                         warmup_epochs: float = 3.0, warmup_bias_lr: float = 0.1,
                         warmup_momentum: float = 0.8, momentum: float = 0.937,
                         linear_lr: bool = False, warmup_min_iters: int = 1000):
    """(lr_fn(step, group), momentum_fn(step)) over optimizer updates."""
    lf = lr_schedule(epochs, lrf, linear_lr)
    nw = max(int(round(warmup_epochs * steps_per_epoch)), warmup_min_iters)

    def lr_fn(step, group: str) -> np.float32:
        epoch = np.floor(_F(step) / _F(steps_per_epoch))
        base = _F(lr0) * lf(epoch)
        if step < nw:
            return _interp(step, 0, nw, warmup_bias_lr if group == "bias" else 0.0, base)
        return base

    def mom_fn(step) -> np.float32:
        if step < nw:
            return _interp(step, 0, nw, warmup_momentum, momentum)
        return _F(momentum)

    return lr_fn, mom_fn


def _param_labels(names: Iterable[str]) -> Dict[str, str]:
    """Each parameter name's group: ``bn_scale`` under a ``bn`` (or ``ln*``)
    module, ``bias`` for other biases, ``weight`` for the rest."""
    out = {}
    for name in names:
        parts = name.split(".")
        if any(p == "bn" or p.startswith("ln") for p in parts[:-1]):
            out[name] = "bn_scale"
        elif parts[-1] == "bias":
            out[name] = "bias"
        else:
            out[name] = "weight"
    return out


def _frozen(name: str, n_freeze: int) -> bool:
    parts = name.split(".")
    return n_freeze > 0 and parts[0] == "model" and parts[1].isdigit() and int(parts[1]) < n_freeze


class Optimizer:
    """The 3-group optimizer with its schedules and accumulation.

    Call :meth:`step` after the backward of every micro-batch: it counts the
    micro-batch and, on every ``accumulate``-th, averages the gradients,
    sets lr and momentum from the schedules, updates the parameters and
    clears the gradients. Returns whether it updated.
    """

    def __init__(self, named_params: List[Tuple[str, torch.nn.Parameter]], lr_fn, mom_fn,
                 weight_decay: float, accumulate: int = 1, optimizer: str = "SGD",
                 nesterov: bool = True, betas=(0.937, 0.999), freeze: int = 0) -> None:
        self.names = [n for n, _ in named_params]
        self.params = [p for _, p in named_params]
        self.lr_fn, self.mom_fn = lr_fn, mom_fn
        self.accumulate = max(int(accumulate), 1)
        self.kind = optimizer.lower()
        self.updates = 0    # optimizer updates applied (the schedules' step)
        self.mini_step = 0  # micro-batches accumulated since the last update
        labels = _param_labels(self.names)
        groups = []
        for g in GROUPS:
            ps = [p for n, p in named_params if labels[n] == g]
            groups.append({"params": ps, "name": g,
                           "weight_decay": weight_decay if g == "weight" else 0.0})
        if self.kind == "adam":
            self.opt = torch.optim.Adam(groups, lr=0.0, betas=tuple(betas), eps=1e-8)
        else:
            self.opt = torch.optim.SGD(groups, lr=0.0, momentum=float(mom_fn(0)),
                                       nesterov=nesterov)
        self.frozen = [p for n, p in named_params if _frozen(n, freeze)]

    def step(self) -> bool:
        self.mini_step += 1
        if self.mini_step < self.accumulate:
            return False
        if self.accumulate > 1:
            torch._foreach_div_([p.grad for p in self.params if p.grad is not None],
                                float(self.accumulate))
        for group in self.opt.param_groups:
            group["lr"] = float(self.lr_fn(self.updates, group["name"]))
            if self.kind != "adam":
                group["momentum"] = float(self.mom_fn(self.updates))
        kept = [p.detach().clone() for p in self.frozen]
        self.opt.step()
        with torch.no_grad():
            for p, k in zip(self.frozen, kept):
                p.copy_(k)
        self.opt.zero_grad(set_to_none=True)
        self.updates += 1
        self.mini_step = 0
        return True

    # -- checkpoints: the port's own layout, keyed by parameter name -----------
    def state_dict(self) -> Dict[str, Any]:
        """{kind, updates, mini_step, state: {name: {slot: array}}, grads:
        {name: array} (the accumulated sums, mid-accumulation only)} with
        numpy leaves."""
        state = {}
        for name, p in zip(self.names, self.params):
            st = self.opt.state.get(p, {})
            state[name] = {k: v.detach().cpu().numpy().copy() if torch.is_tensor(v) else v
                           for k, v in st.items()}
        out = {"kind": self.kind, "updates": self.updates, "mini_step": self.mini_step,
               "state": state}
        if self.mini_step:
            out["grads"] = {n: p.grad.detach().cpu().numpy().copy()
                            for n, p in zip(self.names, self.params) if p.grad is not None}
        return out

    def load_state_dict(self, sd: Dict[str, Any]) -> None:
        if sd.get("kind", self.kind) != self.kind:
            raise ValueError(f"optimizer state is {sd.get('kind')!r}, this optimizer {self.kind!r}")
        self.updates = int(sd["updates"])
        self.mini_step = int(sd.get("mini_step", 0))
        for name, p in zip(self.names, self.params):
            st = sd["state"].get(name, {})
            if st:
                # Adam's step count stays a CPU scalar, as torch keeps it
                self.opt.state[p] = {k: torch.as_tensor(np.array(v)).float() if k == "step"
                                     else torch.as_tensor(np.array(v)).to(p.device)
                                     for k, v in st.items()}
            g = sd.get("grads", {}).get(name)
            p.grad = None if g is None else torch.as_tensor(np.array(g)).to(p.device)


    # -- a JAX run's optax state ------------------------------------------------
    def load_optax_state(self, opt: Dict[str, Any], source: str = "checkpoint") -> None:
        """Take the state of the JAX package's optimizer (its checkpoint's
        ``optimizer`` section, read as nested dicts): ``optax.MultiSteps``
        (``mini_step``, ``gradient_step``, ``acc_grads``: the running mean of
        the window's gradients) around ``multi_transform`` of the groups
        (``inner_states/{weight,bias,bn_scale}/inner_state``), each SGD
        (``momentum`` trace, ``step``) or Adam (``adam/{count, mu, nu}``,
        ``step``); without accumulation there is no ``MultiSteps`` level.

        The traces become torch's per-parameter slots under the port's
        names (HWIO kernels as OIHW); the groups' ``step`` becomes
        ``updates``, so the schedules go on at the same update; a window in
        progress becomes ``mini_step`` and the gradients summed so far
        (mean x mini_step), to which the next backward adds."""
        from ayolov2_torch.utils.weights import state_dict_from_flax

        def port_names(tree) -> Dict[str, torch.Tensor]:
            # optax's masked leaves are empty dicts: they hold no tensor
            return state_dict_from_flax({"params": tree})

        if "inner_opt_state" in opt:
            inner, mini_step = opt["inner_opt_state"], int(np.asarray(opt["mini_step"]))
            acc = opt.get("acc_grads")
        else:
            inner, mini_step, acc = opt, 0, None
        groups = inner.get("inner_states") if isinstance(inner, dict) else None
        if not isinstance(groups, dict) or set(groups) - set(GROUPS):
            raise ValueError(f"{source}: its optimizer state is neither the port's nor the JAX "
                             f"package's (optax) layout; found keys {sorted(opt)}"
                             + (f", groups {sorted(groups)}" if isinstance(groups, dict) else ""))
        slots: Dict[str, Dict[str, torch.Tensor]] = {}
        steps = set()
        for g, st in groups.items():
            st = st.get("inner_state", st)
            if "momentum" in st:
                kind, names = "sgd", {"momentum_buffer": st["momentum"]}
            elif "adam" in st:
                kind = "adam"
                names = {"exp_avg": st["adam"]["mu"], "exp_avg_sq": st["adam"]["nu"]}
                count = float(np.asarray(st["adam"]["count"]))
            else:
                raise ValueError(f"{source}: group {g!r} holds {sorted(st)}, neither SGD's "
                                 "momentum trace nor Adam's moments")
            if kind != self.kind:
                raise ValueError(f"{source}: optimizer state is {kind!r}, this optimizer "
                                 f"{self.kind!r}")
            steps.add(int(np.asarray(st["step"])))
            for slot, tree in names.items():
                for name, t in port_names(tree).items():
                    slots.setdefault(name, {})[slot] = t
                    if kind == "adam":
                        slots[name]["step"] = torch.tensor(count)
        if len(steps) != 1:
            raise ValueError(f"{source}: the groups' step counts differ: {sorted(steps)}")
        missing = [n for n in self.names if n not in slots]
        if missing:
            raise ValueError(f"{source}: no optimizer state for {len(missing)} parameters "
                             f"(first: {missing[:3]})")
        def like(p, t):  # in the parameter's dtype, device and memory layout
            return torch.empty_like(p).copy_(t.reshape(p.shape))

        grads = port_names(acc) if acc is not None and mini_step else {}
        for name, p in zip(self.names, self.params):
            self.opt.state[p] = {k: v if k == "step" else like(p, v)
                                 for k, v in slots[name].items()}
            g = grads.get(name)
            p.grad = None if g is None else like(p, g * mini_step)
        self.updates = steps.pop()
        self.mini_step = mini_step


def build_optimizer(model: torch.nn.Module, hyp: Dict[str, Any], epochs: int,
                    steps_per_epoch: int, batch_size: int, accumulate: int = 1,
                    optimizer: str = "SGD", linear_lr: bool = False,
                    freeze: int = 0) -> Optimizer:
    """The optimizer of the ``hyper_params`` section for ``model``.

    ``steps_per_epoch`` counts micro-batches (``len(train_loader)``); the
    schedules are built in update units, as under ``optax.MultiSteps``.
    """
    opt_params = hyp.get("optimizer_params", {})
    lr0 = float(opt_params.get("lr", 0.01))
    momentum = float(opt_params.get("momentum", hyp.get("momentum", 0.937)))
    weight_decay = float(hyp.get("weight_decay", 5e-4)) * batch_size * accumulate / NBS_NOMINAL
    lr_fn, mom_fn = make_group_schedules(
        lr0=lr0,
        lrf=float(hyp.get("lrf", 0.1)),
        epochs=epochs,
        steps_per_epoch=max(steps_per_epoch // accumulate, 1),
        warmup_epochs=float(hyp.get("warmup_epochs", 3.0)),
        warmup_bias_lr=float(hyp.get("warmup_bias_lr", 0.1)),
        warmup_momentum=float(hyp.get("warmup_momentum", 0.8)),
        momentum=momentum,
        linear_lr=linear_lr,
        warmup_min_iters=max(int(hyp.get("warmup_min_iters", 1000)) // accumulate, 1),
    )
    return Optimizer(list(model.named_parameters()), lr_fn, mom_fn, weight_decay,
                     accumulate=accumulate, optimizer=optimizer,
                     nesterov=bool(opt_params.get("nesterov", True)),
                     betas=opt_params.get("betas", [0.937, 0.999]), freeze=freeze)
