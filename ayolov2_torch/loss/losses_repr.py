"""Representation-learning losses: SimpleRL's L1 and SimCLR's InfoNCE.

The counterpart of ``ayolov2_tpu/loss/losses_repr.py``. Both take the
features of a view batch laid out image-major (img0_v0, img0_v1, img1_v0,
...; ``data/datasets_repr.RLDataLoader``) and return (loss * bs, [loss]).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch


@dataclasses.dataclass(frozen=True)
class RLLoss:
    """SimpleRL: the mean L1 distance between the even and the odd rows (the
    two views of each image)."""

    def __call__(self, pred: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        p1, p2 = pred[0::2], pred[1::2]
        loss = (p1 - p2).abs().sum() / p1.numel()
        return loss * p1.shape[0], loss.reshape(1)


@dataclasses.dataclass(frozen=True)
class InfoNCELoss:
    """SimCLR's NT-Xent over ``n_trans`` views per image.

    Row i belongs to image i // n_trans. The rows are normalised (norm +
    1e-12), the similarities are ``f @ f.T / temperature``; each row is one
    cross-entropy example whose target is its first positive (the smallest
    other row of the same image) and whose denominator is the logsumexp of
    every off-diagonal entry of the row."""

    batch_size: int = 32
    n_trans: int = 2
    temperature: float = 0.07

    def __call__(self, features: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        n = features.shape[0]
        bs = n // self.n_trans
        img_ids = torch.arange(bs, device=features.device).repeat_interleave(self.n_trans)
        eye = torch.eye(n, dtype=torch.bool, device=features.device)
        pos_mask = (img_ids[:, None] == img_ids[None, :]) & ~eye

        f = features / (torch.linalg.vector_norm(features, dim=1, keepdim=True) + 1e-12)
        sim = f @ f.T / self.temperature
        denom = torch.logsumexp(sim.masked_fill(eye, -1e9), dim=1)
        first_pos = pos_mask.int().argmax(dim=1)
        pos_logit = sim.gather(1, first_pos[:, None])[:, 0]
        loss = -(pos_logit - denom).mean()
        return loss * bs, loss.reshape(1)
