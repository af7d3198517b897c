"""Training augmentation rendered on the card: mosaic, warp, mixup, HSV, flips.

The counterpart of ``ayolov2_tpu/data/device_augment.py``. The host plans
each item's geometry and labels with the JAX package's seeded stream
(``DetectionDataset.plan_item``); this module turns a batch of plans into
the (B, s, s, 3) uint8 training batch on the card, in one batched call:

- every output pixel is projected back through the plan's ``minv`` into
  the virtual 2s x 2s mosaic canvas; its four bilinear taps find which of
  the four paste rectangles holds them (integer tests) and read the source
  frame there, or the fill 114 outside every rectangle: the pixels of a
  paste followed by ``cv2.warpAffine(borderValue=114)``, without the canvas;
- two renderers: ``gather`` takes any warp and gathers the taps;
  ``separable`` takes warps without rotation, shear or perspective (the
  reference recipe's), where the back-projection splits by axis and each
  slot's paste and resample is the banded product ``R_k @ frame_k @ C_k^T``
  on the tensor cores; ``auto`` picks per batch from the plans;
- the pair members (mixup) are rounded, blended and truncated as the host's
  ``mixup`` does; then the HSV jitter in cv2's uint8 conventions, computed
  in float and rounded once, and the flips;
- source frames are uint8 on the card: the resident store (N, S, S, 3)
  moved once, or each batch's own frames (streaming). The renderer gathers
  the frames or taps it needs from the uint8 store and converts those.

Tensors are batched as (B, ...) and every input lies on one device; on a
CPU tensor the same torch code runs on the CPU.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ayolov2_torch.loss.yolo_loss import pad_targets
from ayolov2_torch.utils.general import host_to_device, resolve_device

FILL = 114.0


class PlanBatch:
    """One collated batch of plans, with P pair members (2 when mixup is
    configured, else 1):

      src        (B, P, 4, S, S, 3) uint8 source frames, or None (resident)
      src_idx    (B, P, 4) int32 dataset indices of the four slots
      rects      (B, P, 4, 4) int32 canvas paste rectangle x1, y1, x2, y2
      offs       (B, P, 4, 2) int32 canvas -> source offset (dx, dy)
      minv       (B, P, 3, 3) float32 output -> canvas projection
      blend      (B,) float32 mixup weight of pair 0 (1 = no mixup)
      hsv        (B, 3) float32 HSV gains (1 = identity)
      flips      (B, 2) int32 (left-right, up-down)

    with the fields of ``loader.Batch`` (targets, target_mask, paths,
    shapes, n_labels, n_real); ``images`` stays None.
    """

    __slots__ = ("src", "src_idx", "rects", "offs", "minv", "blend", "hsv", "flips",
                 "targets", "target_mask", "paths", "shapes", "n_labels", "n_real", "images")

    def __init__(self, **kw):
        self.images = None
        for k, v in kw.items():
            setattr(self, k, v)


def collate_plans(items: Sequence, batch_size: int, max_labels_per_image: int,
                  n_real: Optional[int] = None) -> PlanBatch:
    """Stack (plan, labels, path, shapes) items into a ``PlanBatch``."""
    plans, labels, paths, shapes = zip(*items)
    bs = len(items)
    targets, mask = pad_targets(labels, bs, bs * max_labels_per_image)
    stack = {k: np.stack([p[k] for p in plans]) for k in plans[0] if k != "src"}
    src = None
    if plans[0].get("src") is not None:
        src = np.stack([p["src"] for p in plans])
    return PlanBatch(
        src=src, targets=targets, target_mask=mask, paths=list(paths), shapes=list(shapes),
        n_labels=[len(lab) for lab in labels], n_real=bs if n_real is None else n_real, **stack)


# ---------------------------------------------------------------------------
# the renderers; every tensor's first dimension is the batch
# ---------------------------------------------------------------------------


def _fma(a, b, c):
    """a * b + c rounded once to f32, as a fused multiply-add (how XLA
    compiles the JAX package's projections): in f64 the product of two f32
    values is exact and so, at these magnitudes, is the sum. A tap's
    fraction one rounding off moves a pixel by up to 255 ulp of the
    coordinate, enough to flip its rounding."""
    return (a.double() * b.double() + c.double()).float()


def _resolve_taps(src_idx, rects, offs, ui, vi, S: int):
    """Integer canvas taps (B, n) -> flat indices into the (N * S * S, 3)
    frame store (in the taps' integer type) and the mask of taps inside a
    paste rectangle. The rectangles are disjoint (mosaic quadrants); the
    first that holds a tap wins (the slots are visited last to first, so
    its index is written last), and a tap in none takes the fill."""
    gidx = torch.zeros_like(ui)
    hit = torch.zeros(ui.shape, dtype=torch.bool, device=ui.device)
    for k in range(3, -1, -1):
        in_k = ((ui >= rects[:, k, 0, None]) & (ui < rects[:, k, 2, None])
                & (vi >= rects[:, k, 1, None]) & (vi < rects[:, k, 3, None]))
        sx = torch.clamp(ui - offs[:, k, 0, None], 0, S - 1)
        sy = torch.clamp(vi - offs[:, k, 1, None], 0, S - 1)
        g = sy * S + sx + src_idx[:, k, None].to(ui.dtype) * (S * S)
        gidx = torch.where(in_k, g, gidx)
        hit = hit | in_k
    return gidx, hit


def _render_canvas(frames, src_idx, rects, offs, minv, out_hw: Tuple[int, int], S: int):
    """Back-projection and bilinear gather, any warp: (B, 3, h, w) f32 in
    [0, 255], not rounded. ``frames`` (N, S, S, 3) uint8; the taps are read
    from it as uint8 and converted. cv2's INTER_LINEAR with the constant
    border 114 over the virtual paste canvas."""
    h, w = out_hw
    dev = minv.device
    ys, xs = torch.meshgrid(torch.arange(h, device=dev), torch.arange(w, device=dev),
                            indexing="ij")
    x = xs.reshape(1, -1).float()
    y = ys.reshape(1, -1).float()
    m = minv[..., None]  # (B, 3, 3, 1)
    u = _fma(m[:, 0, 0], x, m[:, 0, 1] * y) + m[:, 0, 2]
    v = _fma(m[:, 1, 0], x, m[:, 1, 1] * y) + m[:, 1, 2]
    z = _fma(m[:, 2, 0], x, m[:, 2, 1] * y) + m[:, 2, 2]
    u = u / z
    v = v / z
    u0 = torch.floor(u)
    v0 = torch.floor(v)
    fu = (u - u0)[..., None]
    fv = (v - v0)[..., None]
    # int32 taps while the store's flat index fits (the 2 GiB resident cap
    # keeps it well inside)
    itype = torch.int32 if frames.shape[0] * S * S < 2**31 else torch.int64
    u0 = u0.to(itype)
    v0 = v0.to(itype)

    flat = frames.reshape(-1, 3)
    acc = torch.zeros((minv.shape[0], h * w, 3), dtype=torch.float32, device=dev)
    for du in (0, 1):
        for dv in (0, 1):
            wgt = (fu if du else 1.0 - fu) * (fv if dv else 1.0 - fv)
            gidx, hit = _resolve_taps(src_idx, rects, offs, u0 + du, v0 + dv, S)
            val = torch.where(hit[..., None], flat[gidx].float(), FILL)
            acc = acc + wgt * val
    return acc.reshape(-1, h, w, 3).permute(0, 3, 1, 2).contiguous()


def _axis_weight_matrix(scale, off, lo, hi, src_off, out_len: int, S: int):
    """(B, out_len, S) bilinear weights of one axis of one paste rectangle.

    Output coordinate x projects to canvas u = scale * x + off; its taps u0
    and u0 + 1 weigh (1 - fu, fu), count only inside [lo, hi), and land on
    source column clip(u - src_off, 0, S - 1): the taps and weights of
    ``_render_canvas``, one axis at a time. A row's sum is that output
    coordinate's coverage by the rectangle."""
    x = torch.arange(out_len, dtype=torch.float32, device=scale.device)
    u = _fma(scale[:, None], x, off[:, None])
    u0f = torch.floor(u)
    fu = u - u0f
    u0 = u0f.int()
    W = torch.zeros((scale.shape[0], out_len, S), dtype=torch.float32, device=scale.device)
    for d, wgt in ((0, 1.0 - fu), (1, fu)):
        ut = u0 + d
        in_ax = (ut >= lo[:, None]) & (ut < hi[:, None])
        sx = torch.clamp(ut - src_off[:, None], 0, S - 1)
        W.scatter_add_(2, sx[..., None].long(), (wgt * in_ax)[..., None])
    return W


def _matmul_f32(a, b, dt):
    """a @ b (batched) from operands in ``dt``, the sum and the result in
    f32. bf16 on the card: cuBLAS with a f32 output (a bf16 result would
    round the pixel sums, which reach 255, to steps of 1). On the CPU:
    the bf16-rounded operands multiplied in f32, the same numbers."""
    if dt == torch.float32:
        return torch.matmul(a, b)
    if a.device.type == "cuda":
        return torch.bmm(a.to(dt), b.to(dt), out_dtype=torch.float32)
    return torch.matmul(a.to(dt).float(), b.to(dt).float())


def _render_canvas_separable(frames, src_idx, rects, offs, minv, out_hw: Tuple[int, int],
                             S: int, dt=torch.float32):
    """Axis-aligned warps only (minv[0, 1] = minv[1, 0] = minv[2, 0] =
    minv[2, 1] = 0: degrees, shear and perspective 0). Then u depends on x
    only and v on y only, the hit test of slot k is inx_k(u) * iny_k(v), and
    the bilinear resample of the canvas is sum_k R_k @ frame_k @ C_k^T plus
    FILL * (1 - coverage). Returns (B, 3, h, w) f32, not rounded: the
    values of ``_render_canvas`` up to the order of the sums.

    ``dt``: the products' operand type. uint8 pixels are exact in bf16; only
    the bilinear weights round (2^-9 relative). Both products sum in f32;
    the first one's result is rounded to ``dt`` as the second's operand (as
    in the JAX package), the second's stays f32. The source rows are
    contracted first (as in the JAX package), on frames laid out (S, 3, S)
    so that both products need no transposed copy: the first yields
    (h, 3, S), the second (h, 3, w)."""
    h, w = out_hw
    B = minv.shape[0]
    z = minv[:, 2, 2]
    acc = torch.zeros((B, h * 3, w), dtype=torch.float32, device=minv.device)
    cov = torch.zeros((B, h, w), dtype=torch.float32, device=minv.device)
    for k in range(4):
        C = _axis_weight_matrix(minv[:, 0, 0] / z, minv[:, 0, 2] / z,
                                rects[:, k, 0], rects[:, k, 2], offs[:, k, 0], w, S)
        R = _axis_weight_matrix(minv[:, 1, 1] / z, minv[:, 1, 2] / z,
                                rects[:, k, 1], rects[:, k, 3], offs[:, k, 1], h, S)
        # the uint8 frames gathered, then laid out and cast in one copy
        f = frames[src_idx[:, k].long()].permute(0, 1, 3, 2).to(dt).reshape(B, S, 3 * S)
        t = _matmul_f32(R, f, dt).reshape(B, h * 3, S)  # contract source rows
        acc += _matmul_f32(t.to(dt), C.transpose(1, 2), dt)  # contract source columns
        cov += R.sum(2)[:, :, None] * C.sum(2)[:, None, :]
    out = acc.reshape(B, h, 3, w) + FILL * (1.0 - cov)[:, :, None, :]
    return out.permute(0, 2, 1, 3).contiguous()


def _hsv_jitter(img, r):
    """cv2's uint8 HSV jitter on (B, 3, h, w) f32 BGR in [0, 255] with gains
    ``r`` (B, 3): H in half-degrees [0, 180) scaled modulo 180, S and V
    scaled and clipped; in float, not rounded (the host path goes through
    integer HSV)."""
    b, g, rr = img[:, 0], img[:, 1], img[:, 2]
    v = torch.maximum(torch.maximum(b, g), rr)
    mn = torch.minimum(torch.minimum(b, g), rr)
    c = v - mn
    safe_c = torch.where(c == 0, 1.0, c)
    h = torch.where(
        v == rr, 30.0 * (g - b) / safe_c,
        torch.where(v == g, 60.0 + 30.0 * (b - rr) / safe_c, 120.0 + 30.0 * (rr - g) / safe_c))
    h = torch.where(c == 0, 0.0, h)
    h = torch.where(h < 0, h + 180.0, h)
    s = torch.where(v == 0, 0.0, 255.0 * c / torch.where(v == 0, 1.0, v))

    gains = r[:, :, None, None]
    h2 = torch.remainder(h * gains[:, 0], 180.0)  # Python's floored modulo
    s2 = torch.clamp(s * gains[:, 1], 0, 255)
    v2 = torch.clamp(v * gains[:, 2], 0, 255)

    # HSV -> BGR, H in half-degrees
    c2 = v2 * s2 / 255.0
    hp = h2 / 30.0  # sector in [0, 6)
    xcomp = c2 * (1.0 - torch.abs(torch.remainder(hp, 2.0) - 1.0))
    m = v2 - c2
    sector = torch.remainder(torch.floor(hp).int(), 6)
    in_sector = [sector == k for k in range(5)]

    out = torch.empty_like(img)
    # per sector 0..5 the (R, G, B) before + m; the first matching sector wins
    for ch, values in ((2, (c2, xcomp, 0.0, 0.0, xcomp, c2)),
                       (1, (xcomp, c2, c2, xcomp, 0.0, 0.0)),
                       (0, (0.0, 0.0, xcomp, c2, c2, xcomp))):
        sel = values[5] if isinstance(values[5], torch.Tensor) else torch.zeros_like(c2)
        for k in range(4, -1, -1):
            sel = torch.where(in_sector[k], values[k], sel)
        torch.add(sel, m, out=out[:, ch])
    return out


def _render_body(img_size: int, frame_size: int, pairs: int, mode: str, dtype):
    """render(frames, src_idx, rects, offs, minv, blend, hsv, flips) ->
    (B, s, s, 3) uint8: each pair member rendered and rounded (as the host's
    warp rounds to uint8), mixup's blend truncated, HSV rounded, flips."""
    out_hw = (img_size, img_size)

    def canvas(frames, src_idx, rects, offs, minv):
        if mode == "gather":
            return _render_canvas(frames, src_idx, rects, offs, minv, out_hw, frame_size)
        return _render_canvas_separable(frames, src_idx, rects, offs, minv, out_hw, frame_size,
                                        dt=dtype)

    def render(frames, src_idx, rects, offs, minv, blend, hsv, flips):
        img = torch.round(canvas(frames, src_idx[:, 0], rects[:, 0], offs[:, 0], minv[:, 0]))
        if pairs == 2:
            img2 = torch.round(canvas(frames, src_idx[:, 1], rects[:, 1], offs[:, 1],
                                      minv[:, 1]))
            bl = blend[:, None, None, None]
            # the host's mixup: (im * r + im2 * (1 - r)).astype(uint8) truncates
            img = torch.floor(_fma(img, bl, img2 * (1.0 - bl)))
        img = torch.round(_hsv_jitter(img, hsv))
        img = torch.where(flips[:, 0, None, None, None] > 0, torch.flip(img, (3,)), img)
        img = torch.where(flips[:, 1, None, None, None] > 0, torch.flip(img, (2,)), img)
        return torch.clamp(img, 0, 255).to(torch.uint8).permute(0, 2, 3, 1).contiguous()

    return render


def make_render_fn(img_size: int, frame_size: int, pairs: int = 1, mode: str = "gather",
                   dtype=torch.float32, mesh=None, axis: str = "data"):
    """The batch renderer.

    Args:
        img_size: output side s (square training batches).
        frame_size: side S of the source slots (frames padded to (S, S, 3)).
        pairs: 2 when the config has mixup, else 1.
        mode: "gather" (any warp) or "separable" (axis-aligned warps, the
            banded products).
        dtype: the separable products' operand type, torch.float32 or
            torch.bfloat16 (sums in f32 either way); the gather renderer
            reads f32 taps whatever it is.
        mesh: the render split over the ranks of a mesh's data axis (the JAX
            package's SPMD render, one process a rank): every rank holds the
            replicated frames and the global plan batch and renders its
            rows of it, B / n of them (B must divide); they equal those
            rows of the one-device render bit for bit.
        axis: the mesh axis that carries the batch.

    Returns render(frames, src_idx, rects, offs, minv, blend, hsv, flips)
    -> (B, s, s, 3) uint8 (the rank's (B / n, s, s, 3) with ``mesh``), every
    argument a tensor on one device; frames is (N, S, S, 3) uint8, indexed
    by src_idx.
    """
    if mode not in ("gather", "separable"):
        raise ValueError(f"unknown render mode {mode!r}")
    body = _render_body(img_size, frame_size, pairs, mode, dtype)
    if mesh is None:
        return body
    from ayolov2_torch.parallel.mesh import shard_batch

    def render_rows(frames, src_idx, *geometry):
        return body(frames, *shard_batch(mesh, (src_idx, *geometry), axis))

    return render_rows


class DeviceAugmenter:
    """The trainer's renderer: holds the render functions and, when resident,
    the source frames on the device; turns a ``PlanBatch`` into the uint8
    image batch on the device.

    ``mode``: "auto" (separable when every plan of the batch is axis-aligned,
    else gather), "gather" or "separable" (raises on a batch that is not
    axis-aligned); ``dtype``: "bfloat16" or "float32", the separable
    products' operands. ``AYOLO_DEVICE_AUG_MODE`` and
    ``AYOLO_DEVICE_AUG_DTYPE`` override both, as in the JAX package.
    ``device``: default the card (raises without CUDA); "cpu" explicitly.
    """

    def __init__(self, img_size: int, frame_size: int, pairs: int = 1,
                 resident_frames: Optional[np.ndarray] = None, mode: str = "auto",
                 dtype: str = "bfloat16", device=None) -> None:
        mode = os.environ.get("AYOLO_DEVICE_AUG_MODE", mode)
        if mode not in ("auto", "gather", "separable"):
            raise ValueError(f"unknown render mode {mode!r}")
        dtype = os.environ.get("AYOLO_DEVICE_AUG_DTYPE", dtype)
        if dtype not in ("float32", "bfloat16"):
            raise ValueError(f"unknown render dtype {dtype!r}")
        self.img_size = img_size
        self.frame_size = frame_size
        self.pairs = pairs
        self.mode = mode
        self.dtype = torch.bfloat16 if dtype == "bfloat16" else torch.float32
        self.device = resolve_device(device)
        self._render_fns: Dict[str, Any] = {}
        self._frames = None
        if resident_frames is not None:
            self._frames = torch.from_numpy(np.ascontiguousarray(resident_frames)).to(self.device)

    def _fn(self, mode: str):
        if mode not in self._render_fns:
            self._render_fns[mode] = make_render_fn(self.img_size, self.frame_size, self.pairs,
                                                    mode, dtype=self.dtype)
        return self._render_fns[mode]

    @staticmethod
    def _batch_separable(minv) -> bool:
        """True when every plan of the batch is axis-aligned (host arrays)."""
        m = np.asarray(minv)
        return bool(np.all(m[..., 0, 1] == 0) and np.all(m[..., 1, 0] == 0)
                    and np.all(m[..., 2, 0] == 0) and np.all(m[..., 2, 1] == 0))

    def __call__(self, batch: PlanBatch) -> torch.Tensor:
        mode = self.mode
        if mode == "auto":
            mode = "separable" if self._batch_separable(batch.minv) else "gather"
        elif mode == "separable" and not self._batch_separable(batch.minv):
            raise ValueError("separable renderer requires axis-aligned plans (hyp degrees == "
                             "shear == perspective == 0); use mode='auto' or 'gather'")
        if self._frames is not None:
            frames, src_idx = self._frames, host_to_device(batch.src_idx, self.device)
        else:
            if batch.src is None:
                raise ValueError("streaming PlanBatch without src frames (dataset not in "
                                 "resident mode either)")
            b, p = batch.src.shape[:2]
            S = self.frame_size
            frames = host_to_device(batch.src.reshape(b * p * 4, S, S, 3), self.device)
            src_idx = torch.arange(b * p * 4, dtype=torch.int32,
                                   device=self.device).reshape(b, p, 4)
        # the plan arrays are a few hundred bytes a sample
        geometry = (batch.rects, batch.offs, batch.minv, batch.blend, batch.hsv, batch.flips)
        return self._fn(mode)(frames, src_idx, *(host_to_device(a, self.device) for a in geometry))
