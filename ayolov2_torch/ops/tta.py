"""Test-time augmentation: multi-scale and flipped inference.

The counterpart of ``ayolov2_tpu/ops/tta.py``, on NHWC tensors with the
same axes: ``flips`` name NHWC axes (1 = up-down, 2 = left-right), and the
schedule defaults to scales (1, 0.83, 0.67) with flips (none, left-right,
none). Each branch resizes the normalised batch (bilinear, antialiased when
it shrinks, as ``jax.image.resize`` is), pads it to a multiple of the grid
stride with 0.447, runs the forward, and maps the decoded boxes back;
``clip_augmented`` trims the first branch's largest-stride tail and the
last branch's smallest-stride head, and the branches are concatenated.

``tta_decode`` runs a serving function's model this way on a uint8 batch.
Its unscaled, unflipped branch is the serving function's own forward
(``serve.raw_maps``), so the early-network kernel runs there when the
serving function uses it; the scaled and flipped branches run the model
from layer 0 on the normalised images. (JAX's TTA never calls its Pallas
kernel.)
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

DEFAULT_SCALES: Tuple[float, ...] = (1.0, 0.83, 0.67)
DEFAULT_FLIPS: Tuple[Optional[int], ...] = (None, 2, None)  # 2 = width axis of NHWC


def scale_img(img: torch.Tensor, ratio: float = 1.0, gs: int = 32,
              pad_value: float = 0.447) -> torch.Tensor:
    """Resize an NHWC batch by ``ratio`` (sizes truncated: 640 -> 531 at
    0.83) and pad it at the bottom and right to a multiple of ``gs``.

    The resize is ``jax.image.resize(..., "bilinear")``: half-pixel centres,
    and a triangle filter widened by 1 / ratio when shrinking (antialias),
    computed in f32 and cast back to the batch's dtype."""
    if ratio == 1.0:
        return img
    b, h, w, c = img.shape
    nh, nw = int(h * ratio), int(w * ratio)
    out = F.interpolate(img.permute(0, 3, 1, 2).float(), size=(nh, nw), mode="bilinear",
                        align_corners=False, antialias=True).to(img.dtype)
    ph, pw = -nh % gs, -nw % gs
    if ph or pw:
        out = F.pad(out, (0, pw, 0, ph), value=pad_value)
    return out.permute(0, 2, 3, 1)


def descale_pred(pred: torch.Tensor, flip: Optional[int], scale: float,
                 img_wh: Tuple[int, int]) -> torch.Tensor:
    """Undo the scale and flip of decoded (bs, n, 5+nc) xywh predictions:
    coordinates divided by ``scale``, x mirrored about the image's width
    (flip 2) or y about its height (flip 1)."""
    xy = pred[..., :2] / scale
    wh = pred[..., 2:4] / scale
    x, y = xy[..., 0:1], xy[..., 1:2]
    if flip == 1:  # up-down
        y = img_wh[1] - y
    elif flip == 2:  # left-right
        x = img_wh[0] - x
    return torch.cat([x, y, wh, pred[..., 4:]], dim=-1)


def clip_augmented(ys: List[torch.Tensor], nl: int, grid_points: Sequence[int]) -> List[torch.Tensor]:
    """Trim the TTA tails: the first (scale 1) prediction loses its
    largest-stride cells, the last augmented one its smallest-stride cells.
    ``grid_points``: each branch's anchor count (unused; the cut follows
    each branch's own length, as in the JAX package)."""
    g = sum(4 ** x for x in range(nl))
    e = 1  # number of levels to trim
    n0 = (ys[0].shape[1] // g) * sum(4 ** x for x in range(e))
    ys[0] = ys[0][:, : ys[0].shape[1] - n0]  # drop the largest-stride tail
    nl_last = (ys[-1].shape[1] // g) * sum(4 ** (nl - 1 - x) for x in range(e))
    ys[-1] = ys[-1][:, nl_last:]  # drop the smallest-stride head
    return ys


def inference_with_tta(
    forward: Callable[[torch.Tensor], torch.Tensor],
    imgs: torch.Tensor,
    nl: int = 3,
    gs: int = 32,
    scales: Sequence[float] = DEFAULT_SCALES,
    flips: Sequence[Optional[int]] = DEFAULT_FLIPS,
) -> torch.Tensor:
    """Multi-scale and flipped inference.

    Args:
        forward: a normalised NHWC float batch -> decoded (bs, n, 5+nc) xywh.
        imgs: the normalised (0..1) NHWC float batch at the base resolution;
            the unscaled, unflipped branch passes this very tensor.
        nl: the head's levels (for ``clip_augmented``).
        gs: the grid stride the scaled batches are padded to.

    Returns (bs, n_total, 5+nc): the de-scaled predictions of every branch.
    """
    h, w = imgs.shape[1], imgs.shape[2]
    ys: List[torch.Tensor] = []
    for scale, flip in zip(scales, flips):
        x = torch.flip(imgs, dims=(flip,)) if flip else imgs
        x = scale_img(x, scale, gs=gs)
        ys.append(descale_pred(forward(x), flip, scale, (w, h)))
    ys = clip_augmented(ys, nl, [y.shape[1] for y in ys])
    return torch.cat(ys, dim=1)


@torch.inference_mode()
def tta_decode(serve, images: torch.Tensor, image_dtype: torch.dtype,
               scales: Optional[Sequence[float]] = None,
               flips: Optional[Sequence[Optional[int]]] = None) -> torch.Tensor:
    """Decoded f32 TTA predictions of a uint8 (bs, H, W, 3) batch through
    ``serve`` (a ``make_serving_fn`` result): the unscaled, unflipped branch
    is ``serve.raw_maps`` (the early-network kernel where ``serve.early``),
    the others run ``serve.model`` from layer 0."""
    net = serve.model
    imgs = images.to(image_dtype) / 255.0

    def forward(x: torch.Tensor) -> torch.Tensor:
        raw = serve.raw_maps(images) if x is imgs else net(x.permute(0, 3, 1, 2), training=True)
        return net.head.decode(raw).float()

    return inference_with_tta(forward, imgs, nl=net.nl, gs=int(max(net.strides)),
                              scales=DEFAULT_SCALES if scales is None else tuple(scales),
                              flips=DEFAULT_FLIPS if flips is None else tuple(flips))
