"""YOLOv5 detection head with the eval-mode decode.

Raw maps are laid out ``(bs, ny, nx, na, no)`` as in the JAX package (not
torch's usual ``(bs, na, ny, nx, no)``): a head conv's channel ``a*no + o``
is anchor ``a``, field ``o``, so ``permute(0, 2, 3, 1)`` then a reshape gives
the JAX order, which ``ops/nms.flat_grid_meta`` assumes.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn


def make_grid(ny: int, nx: int) -> np.ndarray:
    """(ny, nx, 1, 2) grid of cell top-left indices, xy order."""
    yv, xv = np.meshgrid(np.arange(ny), np.arange(nx), indexing="ij")
    return np.stack([xv, yv], axis=-1).reshape(ny, nx, 1, 2).astype(np.float32)


def check_anchor_order(anchors: np.ndarray, strides: Sequence[float]) -> np.ndarray:
    """Ensure anchor areas grow with stride; flip if inverted.

    ``anchors`` is (nl, na, 2) in pixel units.
    """
    a = anchors.reshape(len(strides), -1, 2)
    area = a.prod(-1).mean(-1)
    da = area[-1] - area[0]
    ds = strides[-1] - strides[0]
    if np.sign(da) != np.sign(ds):
        a = a[::-1].copy()
    return a


class YOLOHead(nn.Module):
    """Per-level 1x1 conv to na*(5+nc) channels + static-shape decode;
    ``out_xyxy`` decodes the boxes as xyxy instead of xywh."""

    def __init__(self, ch: Sequence[int], nc: int,
                 anchors: Tuple[Tuple[float, ...], ...],
                 strides: Tuple[float, ...], out_xyxy: bool = False):
        super().__init__()
        self.out_xyxy = out_xyxy
        self.nc = nc
        self.anchors = anchors
        self.strides = tuple(strides)
        self.m = nn.ModuleList(nn.Conv2d(c, self.na * self.no, 1) for c in ch)
        if self.m[0].bias.device.type != "meta":
            self.reset_bias()

    @property
    def nl(self) -> int:
        return len(self.anchors)

    @property
    def na(self) -> int:
        return len(self.anchors[0]) // 2

    @property
    def no(self) -> int:
        return self.nc + 5

    def anchor_grid(self) -> np.ndarray:
        """Pixel-space anchors (nl, na, 2), stride-order corrected."""
        a = np.asarray(self.anchors, dtype=np.float32).reshape(self.nl, self.na, 2)
        return check_anchor_order(a, self.strides)

    def stride_anchors(self) -> np.ndarray:
        """Stride-normalised anchors (nl, na, 2): the loss's anchors."""
        return self.anchor_grid() / np.asarray(self.strides, dtype=np.float32).reshape(-1, 1, 1)

    def reset_bias(self) -> None:
        """The prior bias of every level's conv (the head's initialisation)."""
        with torch.no_grad():
            for i, conv in enumerate(self.m):
                conv.bias.copy_(torch.from_numpy(self._bias_init_for_level(i)))

    def _bias_init_for_level(self, i: int, img_size: float = 640.0) -> np.ndarray:
        """YOLOv5 prior bias: obj ~ 8 objects/640px image, cls ~ 0.6/(nc-1)."""
        b = np.zeros((self.na, self.no), dtype=np.float32)
        b[:, 4] += np.log(8.0 / (img_size / self.strides[i]) ** 2)
        b[:, 5:] += np.log(0.6 / (self.nc - 0.999999)) if self.nc > 1 else 0.0
        return b.reshape(-1)

    def forward(self, xs: List[torch.Tensor], training: bool = False
                ) -> Tuple[Optional[torch.Tensor], List[torch.Tensor]]:
        """xs: nl feature maps (bs, c, ny, nx), fine to coarse.

        Returns (decoded or None, raw maps); decoded is None in training mode.
        """
        assert len(xs) == self.nl, f"expected {self.nl} feature maps, got {len(xs)}"
        raw = [self.level(i, x) for i, x in enumerate(xs)]
        if training:
            return None, raw
        return self.decode(raw), raw

    def level(self, i: int, x: torch.Tensor) -> torch.Tensor:
        """Level ``i``'s raw map (bs, ny, nx, na, no) of its feature map x."""
        y = self.m[i](x)
        bs, _, ny, nx = y.shape
        return y.permute(0, 2, 3, 1).reshape(bs, ny, nx, self.na, self.no)

    def decode(self, raw: List[torch.Tensor]) -> torch.Tensor:
        """Raw maps -> (bs, sum ny*nx*na, 5+nc) f32: xywh (``out_xyxy``:
        xyxy) pixels, objectness and class probabilities."""
        anchor_grid = self.anchor_grid()
        decoded = []
        for i, y in enumerate(raw):
            bs, ny, nx = y.shape[:3]
            sig = torch.sigmoid(y.float())
            grid = torch.from_numpy(make_grid(ny, nx)).to(y.device)
            anchors = torch.from_numpy(anchor_grid[i].copy()).to(y.device)
            xy = (sig[..., 0:2] * 2.0 - 0.5 + grid) * self.strides[i]
            wh = (sig[..., 2:4] * 2.0) ** 2 * anchors
            out = torch.cat([xy, wh, sig[..., 4:]], dim=-1)
            decoded.append(out.reshape(bs, ny * nx * self.na, self.no))
        z = torch.cat(decoded, dim=1)
        if self.out_xyxy:
            xy, wh = z[..., 0:2], z[..., 2:4]
            z = torch.cat([xy - wh / 2, xy + wh / 2, z[..., 4:]], dim=-1)
        return z
