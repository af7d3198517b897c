"""Spatially split serving: the row plan and the layer walk over row slabs.

One image's height is split over the ranks. Each rank owns a band of rows
of every layer's output map and computes them from its band of the layer's
input widened by the layer's receptive field (its halo), through the
module unchanged; the rows it lacks come from the other ranks
(``collectives.halo_exchange``). JAX gets the same from XLA's SPMD
partitioner (``ayolov2_tpu/parallel/serve.py``, ``make_latency_serving_fn``);
here :func:`row_plan` works out the rows and :func:`run_rows` walks the
layers.

The rules, read from the modules of ``models/layers.py``, as a
:class:`Field`: output row j of a layer reads input rows [s j - top,
s j + bot] (``stride`` s), or row j // up (an upsample). A conv is its
k, s, p (a decomposed one its core's, an int8 one the same); a Bottleneck
and C3 one row each side per 3x3; SPP k//2 of its largest pool; SPPF three
pools of k//2; Focus a stride-2 space-to-depth before its conv; MV2Block its
depthwise conv; UpSample its scale; Concat and the head's 1x1 convs nothing.
MobileViTBlock, the transformer, GlobalAvgPool, Flatten and Linear read the
whole map: every rank gathers it and computes the whole output, which it then
holds whole, as it holds the image. A module of another type raises, naming it.

Each map of height h is split evenly: rank r owns rows [r h // n, (r + 1) h
// n), so two maps of one height agree (a Concat needs no exchange) and a
rank may own none (it then computes nothing, but joins every collective).
A layer's input slab starts on a multiple of its stride (so a strided conv
keeps its phase) and ends at the map's end or a multiple of the stride
past its start; the rows a module's own padding spoils at a slab's inner
edge lie inside the halo and are cropped. Where K1 runs, layers 0-3 are one
step: K1 on the image rows its /8 rows read (``ops/early_pipeline.slab_rows``).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch
from torch import nn

from ayolov2_torch.models import layers as L

Rows = Tuple[int, int]  # [start, stop) of a map's rows

# every output row reads every input row: gathered whole, computed whole
WHOLE_MAP = (L.MobileViTBlock, L.TransformerBlock, L.Attention, L.GlobalAvgPool, L.Flatten,
             L.Linear)


class Window(NamedTuple):
    """One row window: output row j reads input rows s j - p ... s j - p + k - 1."""

    k: int
    s: int
    p: int

    def size(self, h: int) -> int:
        return (h + 2 * self.p - self.k) // self.s + 1


@dataclasses.dataclass(frozen=True)
class Field:
    """The input rows a layer's output row reads: row j reads [stride j -
    top, stride j + bot] (``up`` 1), or row j // up (an upsample).
    ``windows`` give the output's size (along the longest branch)."""

    stride: int = 1
    top: int = 0
    bot: int = 0
    up: int = 1
    windows: Tuple[Window, ...] = ()

    @staticmethod
    def of(w: Window) -> "Field":
        return Field(w.s, w.p, w.k - 1 - w.p, 1, (w,))

    def then(self, nxt: "Field") -> "Field":
        """This field followed by ``nxt``."""
        if self.up != 1 or nxt.up != 1:
            raise ValueError("an upsample is a layer of its own, never inside a module")
        return Field(self.stride * nxt.stride, self.top + self.stride * nxt.top,
                     self.bot + self.stride * nxt.bot, 1, self.windows + nxt.windows)

    def size(self, h: int) -> int:
        """The output's height (or width) from the input's."""
        if self.up != 1:
            return h * self.up
        for w in self.windows:
            h = w.size(h)
        return h

    def rows(self, a: int, b: int, h_in: int) -> Tuple[int, int, int]:
        """(lo, hi, first): the input rows [lo, hi) from which the module
        computes output rows [a, b), and the output row its first row is."""
        if self.up != 1:
            lo, hi = a // self.up, (b - 1) // self.up + 1
            return lo, hi, lo * self.up
        s = self.stride
        lo = max(0, (s * a - self.top) // s * s)
        hi = min(h_in, s * (b - 1) + self.bot + 1)
        hi = min(h_in, lo + -(-(hi - lo) // s) * s)
        return lo, hi, lo // s


def widest(*fields: Field) -> Field:
    """Branches of one module side by side (their outputs concatenated or
    added): the widest reach each side."""
    if len({(f.stride, f.up) for f in fields}) != 1:
        raise ValueError("branches of one module with different strides")
    f0 = fields[0]
    return Field(f0.stride, max(f.top for f in fields), max(f.bot for f in fields), f0.up,
                 f0.windows)


def _chain(*mods) -> Field:
    return functools.reduce(Field.then, (module_field(m) for m in mods if m is not None), Field())


def _pool(k: int) -> Field:
    return Field.of(Window(k, 1, k // 2))


def module_field(mod: nn.Module) -> Optional[Field]:
    """The :class:`Field` of a layer's module; None where every output row
    reads the whole input. Raises TypeError, naming the type, for a module
    the plan does not know."""
    if isinstance(mod, WHOLE_MAP):
        return None
    if isinstance(mod, nn.Sequential):
        fields = [module_field(m) for m in mod]
        return None if any(f is None for f in fields) else functools.reduce(Field.then, fields,
                                                                            Field())
    if isinstance(mod, L.ConvBnAct):
        return Field.of(Window(mod.k, mod.s, mod.p))
    if isinstance(mod, L.QuantConv):
        return Field.of(Window(mod.q_kernel.shape[2], mod.stride, mod.pad))
    if isinstance(mod, L.Bottleneck):
        return _chain(mod.cv1, mod.cv2)
    if isinstance(mod, L.C3):
        return widest(_chain(mod.cv1, mod.m), _chain(mod.cv2)).then(_chain(mod.cv3))
    if isinstance(mod, L.SPP):
        pools = widest(Field(), *(_pool(k) for k in mod.kernels))
        return _chain(mod.cv1).then(pools).then(_chain(mod.cv2))
    if isinstance(mod, L.SPPF):
        return _chain(mod.cv1).then(_pool(mod.k).then(_pool(mod.k)).then(_pool(mod.k))).then(
            _chain(mod.cv2))
    if isinstance(mod, L.Focus):  # x[::2] and x[1::2]: rows 2j, 2j + 1
        return Field.of(Window(2, 2, 0)).then(_chain(mod.conv))
    if isinstance(mod, L.MV2Block):
        return _chain(mod.expand, mod.depthwise, mod.project)
    if isinstance(mod, L.UpSample):
        return Field(up=int(mod.scale))
    if isinstance(mod, L.Concat):
        return Field()
    raise TypeError(f"the row plan does not know module type {type(mod).__name__}")


def _whole_size(mod: nn.Module, h: Optional[int]) -> Optional[int]:
    """The output height of a whole-map module (None: no H axis)."""
    if isinstance(mod, nn.Sequential):
        for m in mod:
            h = _whole_size(m, h)
        return h
    if isinstance(mod, L.GlobalAvgPool):
        return 1
    if isinstance(mod, (L.Flatten, L.Linear)):
        return None
    return h


def split(h: int, n: int) -> Tuple[Rows, ...]:
    """Each of ``n`` ranks' rows of a map of height ``h``: an even split."""
    return tuple((r * h // n, (r + 1) * h // n) for r in range(n))


@dataclasses.dataclass(frozen=True)
class MapRows:
    """A map (a layer's output, or the image at index -1): its height,
    width and channels (height None: no H axis) and each rank's rows, or
    None where every rank holds the whole map."""

    height: Optional[int]
    width: Optional[int]
    channels: int
    owned: Optional[Tuple[Rows, ...]]


@dataclasses.dataclass(frozen=True)
class LayerRows:
    """One step of the walk.

    ``kind``: "slab" (the module on each rank's rows), "whole" (the whole
    map on every rank), "early" (K1 for layers 0-3) or "head". ``sources``:
    the absolute indices of the maps it reads (-1 the image). ``need``: each
    rank's input rows [lo, hi) (of every source; the head: None). ``first``:
    the output row that the first row the rank computes is (it keeps its own
    rows from there). ``exchange``: per source, (up, down), the edge rows
    every rank sends in the halo exchange, or None where no rank needs a row
    it does not hold. ``halo``: the most input rows any rank reads above and
    below ``stride`` x its own output rows."""

    index: int
    module: str
    kind: str
    sources: Tuple[int, ...]
    need: Optional[Tuple[Rows, ...]]
    first: Tuple[int, ...]
    exchange: Tuple[Optional[Tuple[int, int]], ...]
    stride: int = 1
    halo: Tuple[int, int] = (0, 0)


@dataclasses.dataclass(frozen=True)
class RowPlan:
    """The plan of one (model, H, W, world): ``maps`` by layer index,
    ``layers`` the walk's steps in order, ``levels`` the head's sources
    (each level's raw map is split as its source). ``early_halo``: K1's
    (t, u) where it runs."""

    hw: Tuple[int, int]
    world: int
    maps: Dict[int, MapRows]
    layers: Tuple[LayerRows, ...]
    levels: Tuple[int, ...]
    early_halo: Optional[Tuple[int, int]] = None

    def level_split(self, k: int) -> Tuple[Rows, ...]:
        """Every rank's rows of raw map ``k``."""
        return split(self.maps[self.levels[k]].height, self.world)

    def level_rows(self, rank: int) -> List[Rows]:
        """This rank's rows of each raw map."""
        return [self.level_split(k)[rank] for k in range(len(self.levels))]

    def received(self, rank: int) -> Dict[Tuple[int, int], int]:
        """{(layer, source): rows} this rank receives from the others in the
        halo exchanges and the whole-map gathers."""
        out = {}
        for lr in self.layers:
            for k, src in enumerate(lr.sources):
                owned = self.maps[src].owned
                if owned is None or (lr.kind != "whole" and lr.exchange[k] is None):
                    continue
                lo, hi = (0, self.maps[src].height) if lr.kind == "whole" else lr.need[rank]
                mine = owned[rank]
                got = (hi - lo) - max(0, min(hi, mine[1]) - max(lo, mine[0]))
                if got:
                    out[(lr.index, src)] = got
        return out


def _source(spec, f: int) -> int:
    return spec.index - 1 if f == -1 else (f if f >= 0 else spec.index + f)


def _exchange(owned: Optional[Tuple[Rows, ...]], need: Tuple[Rows, ...]
              ) -> Optional[Tuple[int, int]]:
    """(up, down) edge rows for ``need`` of a map split as ``owned``, or
    None where every rank holds what it needs."""
    if owned is None:
        return None
    up = down = 0
    for (s, e), (lo, hi) in zip(owned, need):
        if hi <= lo or (s <= lo and hi <= e):
            continue
        up = max(up, min(hi, s) - lo)
        down = max(down, hi - max(lo, e))
    return (up, down) if up or down else None


def row_plan(model, hw: Tuple[int, int], world: int, early_n: Optional[int] = None
             ) -> RowPlan:
    """The plan for ``model`` (a ``YOLOModel``) at image size ``hw`` on
    ``world`` ranks. ``early_n``: K1 computes layers 0-3 (C3 depth n) and
    the walk starts at layer 4. Raises TypeError for a module type the plan
    does not know, naming it."""
    from ayolov2_torch.ops.early_pipeline import slab_halo, slab_rows

    h, w = int(hw[0]), int(hw[1])
    maps: Dict[int, MapRows] = {-1: MapRows(h, w, model.in_ch, None)}
    steps: List[LayerRows] = []
    specs = model.specs
    start = 0
    if early_n is not None:
        spec = specs[3]
        hh, ww = h // 8, w // 8
        owned = split(hh, world)
        need = tuple(slab_rows(a, b, h, early_n) if b > a else (0, 0) for a, b in owned)
        maps[3] = MapRows(hh, ww, spec.out_channels, owned)
        t, u = slab_halo(early_n)
        steps.append(LayerRows(3, "early_pipeline", "early", (-1,), need,
                               tuple(lo // 8 for lo, _ in need), (None,), 8, (8 * t, 8 * u)))
        start = 4
    levels: Tuple[int, ...] = ()
    for spec in specs[start:]:
        mod = model.model[spec.index]
        srcs = tuple(_source(spec, f) for f in spec.from_idx)
        if spec.module == "YOLOHead":
            levels = srcs
            steps.append(LayerRows(spec.index, spec.module, "head", srcs, None, (),
                                   (None,) * len(srcs)))
            break
        src = maps[srcs[0]]
        field = module_field(mod)
        if field is None or src.height is None:
            size = (_whole_size(mod, src.height) if field is None
                    else field.size(src.height))
            width = (_whole_size(mod, src.width) if field is None else field.size(src.width))
            maps[spec.index] = MapRows(size, width, spec.out_channels, None)
            steps.append(LayerRows(spec.index, spec.module, "whole", srcs,
                                   ((0, src.height),) * world, (0,) * world,
                                   (None,) * len(srcs)))
            continue
        size, width = field.size(src.height), field.size(src.width)
        owned = split(size, world)
        rows = [field.rows(a, b, src.height) if b > a else (0, 0, 0) for a, b in owned]
        need = tuple((lo, hi) for lo, hi, _ in rows)
        stride, halo = field.stride, (0, 0)
        if field.up == 1:  # an upsample reads its rows // up: no halo
            halo = tuple(max((max(0, d) for d in ds), default=0) for ds in zip(
                *((stride * a - lo, hi - stride * b)
                  for (a, b), (lo, hi) in zip(owned, need) if b > a)))
        maps[spec.index] = MapRows(size, width, spec.out_channels, owned)
        steps.append(LayerRows(spec.index, spec.module, "slab", srcs, need,
                               tuple(f for _, _, f in rows),
                               tuple(_exchange(maps[s].owned, need) for s in srcs),
                               stride, halo))
    return RowPlan((h, w), world, maps, tuple(steps), levels,
                   slab_halo(early_n) if early_n is not None else None)


def run_rows(core, plan: RowPlan, images: torch.Tensor, rank: int, group,
             received: Optional[Dict[Tuple[int, int], int]] = None) -> List[torch.Tensor]:
    """The head's raw maps of this rank's rows, (bs, rows, nx, na, no) per
    level, from whole (bs, H, W, 3) uint8 ``images`` on ``core``'s device,
    walking ``plan`` through ``core.model`` (a ``ServingModule``'s network;
    K1 through ``core.k1_weights`` where ``core.early``). Every rank of
    ``group`` must call it with the same plan. ``received`` collects the
    rows taken from the other ranks, by (layer, source)."""
    from ayolov2_torch.ops import early_pipeline as early
    from ayolov2_torch.parallel.collectives import gather_rows, halo_exchange

    model = core.model
    dtype = next(model.parameters()).dtype
    bs = images.shape[0]
    held: Dict[int, Tuple[torch.Tensor, int]] = {}  # map -> (its rows this rank holds, first)
    keep = set(model.save)

    def note(lr: LayerRows, src: int, got: int) -> None:
        if received is not None and got:
            received[(lr.index, src)] = received.get((lr.index, src), 0) + got

    def fetch(lr: LayerRows, k: int, lo: int, hi: int) -> torch.Tensor:
        """Rows [lo, hi) of source k of ``lr``."""
        src = lr.sources[k]
        if src == -1:
            x = images[:, lo:hi].permute(0, 3, 1, 2).to(core.image_dtype) / 255.0
            return x.to(dtype)
        m = plan.maps[src]
        x, first = held[src]
        if m.owned is not None and lr.kind == "whole":
            (x,) = gather_rows([x], [m.owned], 2, group)
            note(lr, src, m.height - (m.owned[rank][1] - m.owned[rank][0]))
            first = 0
        elif lr.exchange[k] is not None:
            x, got = halo_exchange(x, m.owned, lr.need, rank, group, *lr.exchange[k])
            note(lr, src, got)
            return x
        if x.dim() < 4:  # no H axis
            return x
        return x[:, :, lo - first:hi - first]

    last = -1
    for lr in plan.layers:
        if lr.kind == "head":
            mine = plan.level_rows(rank)
            head = model.model[lr.index]
            raw = []
            for k, (a, b) in enumerate(mine):
                if b > a:
                    raw.append(head.level(k, fetch(lr, k, a, b)))
                else:
                    m = plan.maps[lr.sources[k]]
                    raw.append(torch.empty((bs, 0, m.width, head.na, head.no), dtype=dtype,
                                           device=images.device))
            return raw
        m = plan.maps[lr.index]
        if lr.kind == "early":
            a, b = m.owned[rank]
            c0, c1, ch, c2, n = core.ep.widths
            act = early.early_pipeline_rows(images, core.k1_weights, a, b, c0, n, c1, ch, c2)
            held[lr.index] = act.permute(0, 3, 1, 2).to(dtype), a
            last = lr.index
            continue
        mod = model.model[lr.index]
        if lr.kind == "whole":
            held[lr.index] = mod(fetch(lr, 0, *lr.need[rank])), 0
        else:
            a, b = m.owned[rank]
            lo, hi = lr.need[rank]
            xs = [fetch(lr, k, lo, hi) for k in range(len(lr.sources))]
            if b > a:
                y = mod(xs if lr.module == "Concat" else xs[0])
                held[lr.index] = y[:, :, a - lr.first[rank]:b - lr.first[rank]], a
            else:  # no rows here: nothing to compute, but the exchanges were joined
                held[lr.index] = torch.empty((bs, m.channels, 0, m.width), dtype=dtype,
                                             device=images.device), a
        if last not in keep:
            held.pop(last, None)
        last = lr.index
    raise ValueError("the model has no detection head to serve")
