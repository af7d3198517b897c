"""YOLOv5-family building blocks as torch modules (NCHW tensors, channels_last).

The counterpart of ``ayolov2_tpu/models/layers.py``: Conv (``ConvBnAct``,
grouped and with the space-to-depth stem), Bottleneck, C3, SPP, SPPF,
Focus, UpSample, Concat, MV2Block, MobileViTBlock, GlobalAvgPool, Flatten
and Linear. Attribute names follow the kindle/torch convention (``conv``,
``bn``, ``cv1``, ``m.0``) and the JAX package's module names elsewhere
(``expand``, ``tr0``, ``attn.query``), so a state_dict bridged from the JAX
package loads with ``strict=True``.

BatchNorm carries eps=1e-3 and follows flax's ``nn.BatchNorm`` in training
(:class:`BatchNorm2d`). Conv kernels start from flax's default,
``lecun_normal`` (:func:`lecun_normal_`). ``fused=True`` builds the
BN-folded form: a conv with bias and no BN.

``quant`` (every module with convs takes it): False; "calib", the float
conv that records its input's range (:class:`ConvBnAct`); True, the int8
conv (:class:`QuantConv`) wherever :meth:`ConvBnAct.quantizable` holds. A
Tucker-2 decomposed conv (:meth:`ConvBnAct.decompose`) is a 1x1 -> kxk ->
1x1 stack ``conv_first`` / ``conv_core`` / ``conv_last``.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ayolov2_torch.ops.int8_conv import dequantize, int8_conv

ACTIVATIONS = {
    "SiLU": F.silu,
    "Swish": F.silu,
    "ReLU": F.relu,
    "ReLU6": lambda x: torch.clamp(x, 0.0, 6.0),
    "LeakyReLU": lambda x: F.leaky_relu(x, 0.1),
    "Hardswish": F.hardswish,
    "Mish": lambda x: x * torch.tanh(F.softplus(x)),
    "Sigmoid": torch.sigmoid,
    "Tanh": torch.tanh,
    "Identity": lambda x: x,
    None: lambda x: x,
}


def get_activation(name: Optional[str]) -> Callable[[torch.Tensor], torch.Tensor]:
    if callable(name):
        return name
    return ACTIVATIONS[name]


def lecun_normal_(weight: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """flax's ``lecun_normal``: a normal truncated at two standard deviations,
    variance 1 / fan_in (fan_in = input channels x kernel area), drawn on
    the CPU from ``generator`` and copied in, so every device gets the same
    values."""
    fan_in = weight.shape[1] * weight[0, 0].numel()
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978  # the truncation's std
    draw = torch.empty(weight.shape, dtype=torch.float32)
    nn.init.trunc_normal_(draw, 0.0, 1.0, -2.0, 2.0, generator=generator)
    with torch.no_grad():
        weight.copy_(draw * std)
    return weight


class BatchNorm2d(nn.BatchNorm2d):
    """BatchNorm with flax's semantics (eps 1e-3, decay 0.97).

    In ``train()`` mode the batch is normalised by its mean and *biased*
    variance, and the running statistics move as ``0.97 * old + 0.03 *
    batch`` with the biased variance, in f32 (torch's own update uses the
    unbiased one). Under bf16 autocast the input stays bf16 and the
    statistics are reduced in f32. ``eval()`` uses the running statistics.
    ``num_batches_tracked`` is not counted: the momentum is fixed.
    ``update_stats = False`` leaves the running statistics alone in training
    (an activation checkpoint's recomputation sets it).
    """

    def __init__(self, num_features: int) -> None:
        super().__init__(num_features, eps=1e-3, momentum=0.03)
        self.update_stats = True
        # this batch's mean and unbiased variance, overwritten in every
        # training forward (momentum 1), not saved
        self.register_buffer("batch_mean", torch.zeros(num_features), persistent=False)
        self.register_buffer("batch_var", torch.ones(num_features), persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                                False, 0.0, self.eps)
        out = F.batch_norm(x, self.batch_mean, self.batch_var, self.weight, self.bias, True, 1.0,
                           self.eps)
        if not self.update_stats:
            return out
        n = x.numel() // x.shape[1]
        with torch.no_grad():  # the biased variance averaged in, as flax does
            self.running_mean.lerp_(self.batch_mean, self.momentum)
            self.running_var.lerp_(self.batch_var * ((n - 1) / n), self.momentum)
        return out


def autopad(k: int, p: Optional[int] = None) -> int:
    """'same'-style padding for odd kernels (YOLOv5 autopad convention)."""
    return k // 2 if p is None else p


S2D_MODES = ("reshape", "slice", "im2col")


def s2d_conv(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
             mode: str = "reshape") -> torch.Tensor:
    """A 6x6/s2/p2 conv computed as space-to-depth + a 3x3/s1 VALID conv
    (the JAX package's ``_S2DConv``): the same function of the same (o, c,
    6, 6) weight, rearranged at call time as W'[o, (p, q, c), a, b] =
    W[o, c, 2a + p, 2b + q], so the conv sees 4c input channels.

    ``mode`` picks how the four phases are made: "reshape" (a 6-D reshape
    and permute), "slice" (strided slices and a channel concat), "im2col"
    (``F.unfold`` to (c, kh, kw) columns and one matrix product, K = 36c).
    The JAX package refuses "slice" on its TPU, where it faulted the
    worker; nothing like that holds on a GPU, so all three run here."""
    if mode not in S2D_MODES:
        raise ValueError(f"s2d_stem mode {mode!r}: one of {S2D_MODES}")
    n, c, h, w = x.shape
    if h % 2 or w % 2:
        raise ValueError(f"the s2d stem needs an even H and W, got {h}x{w}")
    o = weight.shape[0]
    if mode == "im2col":
        cols = F.unfold(x, 6, stride=2, padding=2)  # (n, 36c, L), rows in (c, kh, kw) order
        y = torch.matmul(weight.reshape(o, 36 * c), cols).reshape(n, o, h // 2, w // 2)
        return y if bias is None else y + bias.reshape(1, o, 1, 1)
    k = weight.reshape(o, c, 3, 2, 3, 2).permute(0, 3, 5, 1, 2, 4).reshape(o, 4 * c, 3, 3)
    x = F.pad(x, (2, 2, 2, 2))
    hp, wp = h + 4, w + 4
    if mode == "slice":
        x = torch.cat([x[:, :, p::2, q::2] for p in (0, 1) for q in (0, 1)], dim=1)
    else:
        x = x.reshape(n, c, hp // 2, 2, wp // 2, 2).permute(0, 3, 5, 1, 2, 4)
        x = x.reshape(n, 4 * c, hp // 2, wp // 2)
    return F.conv2d(x, k, bias)


class QuantConv(nn.Module):
    """Symmetric per-channel int8 conv (the JAX package's ``_QuantConv``).

    Buffers: ``q_kernel`` (cout, cin, k, k) int8, ``w_scale`` (cout,) f32,
    the 0-d ``in_scale`` f32 (the calibrated input range) and ``bias``
    (cout,) f32. The function, as JAX computes it: s_in = in_scale / 127;
    xq = clip(round_half_even(x.f32 / s_in), -127, 127) as int8; an int32
    accumulator (``ops/int8_conv.int8_conv``); y = acc.f32 * (w_scale *
    s_in) + bias with one rounding (``ops/int8_conv.dequantize``), cast to
    the input's dtype. A cast of the module's dtype
    (``.to(torch.bfloat16)``) leaves every buffer as it is: the scales and
    the bias stay f32 under any serving dtype, as in JAX; device moves
    apply."""

    def __init__(self, c_in: int, c_out: int, k: int = 1, s: int = 1, p: int = 0):
        super().__init__()
        self.stride, self.pad = s, p
        self.register_buffer("q_kernel", torch.zeros((c_out, c_in, k, k), dtype=torch.int8))
        self.register_buffer("w_scale", torch.ones(c_out))
        self.register_buffer("in_scale", torch.ones(()))
        self.register_buffer("bias", torch.zeros(c_out))

    def _apply(self, fn, recurse=True):
        for key, buf in self._buffers.items():
            if buf is not None:
                moved = fn(buf)
                self._buffers[key] = buf.to(moved.device) if moved.dtype != buf.dtype else moved
        return self

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # a true division on every device: CUDA multiplies by the reciprocal
        # of a Python scalar divisor, which is one ulp off for some scales
        s_in = self.in_scale / self.in_scale.new_tensor(127.0)
        xq = torch.clamp(torch.round(x.permute(0, 2, 3, 1).float() / s_in), -127.0, 127.0)
        acc = int8_conv(xq.to(torch.int8), self.q_kernel, self.stride, self.pad)
        y = dequantize(acc, self.w_scale * s_in, self.bias)
        return y.to(x.dtype).permute(0, 3, 1, 2)


def percentile_999(v: torch.Tensor) -> torch.Tensor:
    """The 99.9th percentile of a 1-D f32 tensor with linear interpolation,
    as JAX's ``jnp.percentile`` computes it on the CPU: the rank 99.9 *
    (0.01 * (n - 1)) and the weights in f32 (XLA folds the /100 into the
    constant), the two order statistics joined by one fma. The order
    statistics come from ``topk`` instead of a sort of the whole tensor."""
    f32 = np.float32
    n = v.numel()
    rank = f32(99.9) * (f32(0.01) * f32(n - 1))
    lo, hi = int(np.floor(rank)), int(np.ceil(rank))
    w_hi = f32(rank - f32(lo))
    w_lo = f32(1) - w_hi
    top = torch.topk(v, n - lo).values  # descending: top[-1] is the lo-th smallest
    low = top[-1] * float(w_lo)
    return (top[-1 - (hi - lo)].double() * float(w_hi) + low.double()).float()


def quantizable(c_in: int, groups: int, decomposed: bool, fused: bool) -> bool:
    """Whether a conv takes the int8 path under quant mode (the JAX
    package's ``_quantizable``): fused, not grouped, not decomposed, cin > 4.
    That leaves out the cin-3 stem, depthwise convs, decomposed stacks and
    the head's convs (they are not ConvBnActs)."""
    return fused and groups == 1 and not decomposed and c_in > 4


class ConvBnAct(nn.Module):
    """Conv2d + BatchNorm + activation: the YOLOv5 'Conv' block.

    ``groups``: a grouped conv (``groups = c_in = c_out``: MV2Block's
    depthwise one). ``s2d``: a 6x6/s2/p2 conv computed by :func:`s2d_conv`
    in that mode (False: the plain conv); the parameters are the same.
    ``quant``: True makes a quantizable conv a :class:`QuantConv`; "calib"
    keeps the float conv and records, over every call since
    :meth:`reset_stats`, the largest absmax and p99.9 of its input's |x|
    (``in_absmax``, ``in_p999``; the p99.9 of at most ~2^20 elements, a
    stride through |x| flattened in NHWC order, as JAX takes it). A
    decomposed conv (:meth:`decompose`) is neither."""

    def __init__(self, c_in: int, c_out: int, k: int = 1, s: int = 1,
                 p: Optional[int] = None, act: Optional[str] = "SiLU",
                 fused: bool = False, groups: int = 1, s2d=False, quant=False):
        super().__init__()
        self.c_in, self.c_out, self.k, self.s, self.p = c_in, c_out, k, s, autopad(k, p)
        self.groups, self.fused, self.quant = groups, fused, quant
        self.ranks = None
        if quant is True and self.quantizable:
            self.conv = QuantConv(c_in, c_out, k, s, self.p)
        else:
            self.conv = nn.Conv2d(c_in, c_out, k, s, self.p, groups=groups, bias=fused)
        self.bn = None if fused else BatchNorm2d(c_out)
        self.act = get_activation(act)
        stem = k == 6 and s == 2 and self.p == 2 and groups == 1
        self.s2d = ("reshape" if s2d is True else str(s2d)) if (s2d and stem) else None
        if self.s2d is not None and self.s2d not in S2D_MODES:
            raise ValueError(f"s2d_stem mode {s2d!r}: one of {S2D_MODES}")
        self.reset_stats()

    @property
    def quantizable(self) -> bool:
        return quantizable(self.c_in, self.groups, self.ranks is not None, self.fused)

    @property
    def plain(self) -> bool:
        """A float conv of the given weight: not int8, not recording its
        input for calibration, not decomposed."""
        return self.ranks is None and not (self.quant and self.quantizable)

    def reset_stats(self) -> None:
        self.in_absmax = self.in_p999 = None

    def decompose(self, r_in: int, r_out: int) -> None:
        """Become the Tucker-2 form: 1x1 to ``r_in``, the k x k conv (stride,
        padding) to ``r_out``, 1x1 to c_out with the bias when fused; the
        BatchNorm and activation follow as before."""
        if self.groups != 1:
            raise ValueError(f"cannot decompose a grouped conv (groups {self.groups})")
        device = next(iter(self.conv.buffers() if isinstance(self.conv, QuantConv)
                           else self.conv.parameters())).device
        del self.conv
        self.ranks = (int(r_in), int(r_out))
        self.s2d = None
        self.conv_first = nn.Conv2d(self.c_in, self.ranks[0], 1, bias=False, device=device)
        self.conv_core = nn.Conv2d(self.ranks[0], self.ranks[1], self.k, self.s, self.p,
                                   bias=False, device=device)
        self.conv_last = nn.Conv2d(self.ranks[1], self.c_out, 1, bias=self.fused, device=device)

    def _record(self, x: torch.Tensor) -> None:
        with torch.no_grad():
            ax = x.float().abs()
            flat = ax.permute(0, 2, 3, 1).reshape(-1)
            step = max(1, flat.numel() // (1 << 20))
            absmax, p999 = ax.max(), percentile_999(flat[::step])
            if self.in_absmax is not None:
                absmax = torch.maximum(self.in_absmax, absmax)
                p999 = torch.maximum(self.in_p999, p999)
            self.in_absmax, self.in_p999 = absmax, p999

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.ranks is not None:
            x = self.conv_last(self.conv_core(self.conv_first(x)))
        elif self.s2d is not None:
            x = s2d_conv(x, self.conv.weight, self.conv.bias, self.s2d)
        else:
            if self.quant == "calib" and self.quantizable:
                self._record(x)
            x = self.conv(x)
        if self.bn is not None:
            x = self.bn(x)
        return self.act(x)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 with an optional residual."""

    def __init__(self, c_in: int, c_out: int, shortcut: bool = True,
                 expansion: float = 0.5, act: Optional[str] = "SiLU",
                 fused: bool = False, quant=False):
        super().__init__()
        c_ = int(c_out * expansion)
        self.cv1 = ConvBnAct(c_in, c_, 1, 1, act=act, fused=fused, quant=quant)
        self.cv2 = ConvBnAct(c_, c_out, 3, 1, act=act, fused=fused, quant=quant)
        self.add = shortcut and c_in == c_out

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.cv2(self.cv1(x))
        return x + y if self.add else y


class C3(nn.Module):
    """CSP bottleneck with 3 convolutions."""

    def __init__(self, c_in: int, c_out: int, n: int = 1, shortcut: bool = True,
                 expansion: float = 0.5, act: Optional[str] = "SiLU",
                 fused: bool = False, quant=False):
        super().__init__()
        c_ = int(c_out * expansion)
        self.cv1 = ConvBnAct(c_in, c_, 1, 1, act=act, fused=fused, quant=quant)
        self.m = nn.Sequential(*(
            Bottleneck(c_, c_, shortcut, 1.0, act=act, fused=fused, quant=quant) for _ in range(n)
        ))
        self.cv2 = ConvBnAct(c_in, c_, 1, 1, act=act, fused=fused, quant=quant)
        self.cv3 = ConvBnAct(2 * c_, c_out, 1, 1, act=act, fused=fused, quant=quant)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.cv3(torch.cat([self.m(self.cv1(x)), self.cv2(x)], dim=1))


class SPP(nn.Module):
    """Spatial pyramid pooling: parallel k x k max pools (stride 1, same
    padding) of the 1x1 conv's output, concatenated with it."""

    def __init__(self, c_in: int, c_out: int, kernels=(5, 9, 13),
                 act: Optional[str] = "SiLU", fused: bool = False, quant=False):
        super().__init__()
        c_ = c_in // 2
        self.cv1 = ConvBnAct(c_in, c_, 1, 1, act=act, fused=fused, quant=quant)
        self.cv2 = ConvBnAct(c_ * (len(kernels) + 1), c_out, 1, 1, act=act, fused=fused,
                             quant=quant)
        self.kernels = tuple(int(k) for k in kernels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.cv1(x)
        pools = [x] + [F.max_pool2d(x, k, 1, k // 2) for k in self.kernels]
        return self.cv2(torch.cat(pools, dim=1))


class SPPF(nn.Module):
    """Fast SPP: 3 cascaded max pools equivalent to SPP(5, 9, 13)."""

    def __init__(self, c_in: int, c_out: int, k: int = 5,
                 act: Optional[str] = "SiLU", fused: bool = False, quant=False):
        super().__init__()
        c_ = c_in // 2
        self.cv1 = ConvBnAct(c_in, c_, 1, 1, act=act, fused=fused, quant=quant)
        self.cv2 = ConvBnAct(c_ * 4, c_out, 1, 1, act=act, fused=fused, quant=quant)
        self.k = k

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.cv1(x)
        y1 = F.max_pool2d(x, self.k, 1, self.k // 2)
        y2 = F.max_pool2d(y1, self.k, 1, self.k // 2)
        y3 = F.max_pool2d(y2, self.k, 1, self.k // 2)
        return self.cv2(torch.cat([x, y1, y2, y3], dim=1))


class Focus(nn.Module):
    """The legacy YOLOv5 stem: 2x2 space-to-depth slicing, then a conv. The
    slices are concatenated along channels in the order [::2, ::2],
    [1::2, ::2], [::2, 1::2], [1::2, 1::2] over (h, w)."""

    def __init__(self, c_in: int, c_out: int, k: int = 1, s: int = 1,
                 act: Optional[str] = "SiLU", fused: bool = False, quant=False):
        super().__init__()
        self.conv = ConvBnAct(4 * c_in, c_out, k, s, act=act, fused=fused, quant=quant)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(torch.cat([x[:, :, ::2, ::2], x[:, :, 1::2, ::2],
                                    x[:, :, ::2, 1::2], x[:, :, 1::2, 1::2]], dim=1))


class UpSample(nn.Module):
    """Nearest-neighbour upsample by an integer factor."""

    def __init__(self, scale: int = 2):
        super().__init__()
        self.scale = scale

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.interpolate(x, scale_factor=self.scale, mode="nearest")


class Concat(nn.Module):
    """Channel concat (dim 1); holds no parameters."""

    def forward(self, xs) -> torch.Tensor:
        return torch.cat(list(xs), dim=1)


class MV2Block(nn.Module):
    """MobileNetV2 inverted residual: 1x1 expand (when expansion != 1),
    3x3 depthwise at ``stride``, 1x1 project without activation; the input
    is added back at stride 1 with equal widths. The hidden width is
    ``round(c_in * expansion)`` of the real input width."""

    def __init__(self, c_in: int, c_out: int, stride: int = 1, expansion: float = 4,
                 act: Optional[str] = "SiLU", fused: bool = False, quant=False):
        super().__init__()
        hidden = int(round(c_in * expansion))
        self.expand = (ConvBnAct(c_in, hidden, 1, 1, act=act, fused=fused, quant=quant)
                       if expansion != 1 else None)
        self.depthwise = ConvBnAct(hidden, hidden, 3, stride, act=act, fused=fused,
                                   groups=hidden, quant=quant)
        self.project = ConvBnAct(hidden, c_out, 1, 1, act=None, fused=fused, quant=quant)
        self.add = stride == 1 and c_in == c_out

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.expand(x) if self.expand is not None else x
        y = self.project(self.depthwise(y))
        return x + y if self.add else y


class Attention(nn.Module):
    """flax's ``MultiHeadDotProductAttention`` (self-attention, ``heads``
    heads of dim / heads): q/k/v/out projections with biases, the query
    scaled by (dim / heads) ** -0.5, softmax over the tokens (dim -2).
    ``query``/``key``/``value``/``out`` are ``nn.Linear`` whose rows and
    columns are flax's (dim, heads, head_dim) and (heads, head_dim, dim)
    kernels flattened (``utils/weights.py``)."""

    def __init__(self, dim: int, heads: int = 4):
        super().__init__()
        self.heads = heads
        self.query = nn.Linear(dim, dim)
        self.key = nn.Linear(dim, dim)
        self.value = nn.Linear(dim, dim)
        self.out = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        lead, (n, d) = x.shape[:-2], x.shape[-2:]
        h = self.heads

        def split(t):  # (..., n, d) -> (B, h, n, d / h)
            return t.reshape(-1, n, h, d // h).transpose(1, 2)

        y = F.scaled_dot_product_attention(split(self.query(x)), split(self.key(x)),
                                           split(self.value(x)))
        return self.out(y.transpose(1, 2).reshape(*lead, n, d))


class TransformerBlock(nn.Module):
    """Pre-norm transformer encoder block (MobileViT): LayerNorm (flax's
    epsilon, 1e-6) -> attention -> residual, LayerNorm -> Linear -> SiLU ->
    Linear -> residual."""

    def __init__(self, dim: int, mlp_dim: int, heads: int = 4):
        super().__init__()
        self.ln1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim, heads)
        self.ln2 = nn.LayerNorm(dim, eps=1e-6)
        self.fc1 = nn.Linear(dim, mlp_dim)
        self.fc2 = nn.Linear(mlp_dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.ln1(x))
        return x + self.fc2(F.silu(self.fc1(self.ln2(x))))


class MobileViTBlock(nn.Module):
    """MobileViT block: a local 3x3 conv and a 1x1 projection to ``dim``,
    ``depth`` transformer blocks over the (h/2)(w/2) tokens of each of the
    four 2x2 patch phases, LayerNorm, a 1x1 projection back to c_in,
    concatenation with the input and a 3x3 fusion conv. Output width = c_in;
    H and W must be even."""

    def __init__(self, c_in: int, dim: int, mlp_dim: int, depth: int,
                 act: Optional[str] = "SiLU", fused: bool = False, quant=False):
        super().__init__()
        self.local_conv = ConvBnAct(c_in, c_in, 3, 1, act=act, fused=fused, quant=quant)
        self.proj_in = ConvBnAct(c_in, dim, 1, 1, act=None, fused=fused, quant=quant)
        self.depth = depth
        for i in range(depth):
            setattr(self, f"tr{i}", TransformerBlock(dim, mlp_dim))
        self.ln_out = nn.LayerNorm(dim, eps=1e-6)
        self.proj_out = ConvBnAct(dim, c_in, 1, 1, act=act, fused=fused, quant=quant)
        self.fusion = ConvBnAct(2 * c_in, c_in, 3, 1, act=act, fused=fused, quant=quant)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.proj_in(self.local_conv(x))
        b, d, h, w = y.shape
        # unfold: (b, d, h, w) -> (b, 4 phases (ph, pw), (h/2)(w/2) tokens, d)
        y = y.reshape(b, d, h // 2, 2, w // 2, 2).permute(0, 3, 5, 2, 4, 1)
        y = y.reshape(b, 4, (h // 2) * (w // 2), d)
        for i in range(self.depth):
            y = getattr(self, f"tr{i}")(y)
        y = self.ln_out(y)
        # fold back to (b, d, h, w)
        y = y.reshape(b, 2, 2, h // 2, w // 2, d).permute(0, 5, 3, 1, 4, 2).reshape(b, d, h, w)
        y = self.proj_out(y)
        return self.fusion(torch.cat([x, y], dim=1))


class GlobalAvgPool(nn.Module):
    """Mean over H and W, kept as (B, C, 1, 1)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x.mean(dim=(2, 3), keepdim=True)


class Flatten(nn.Module):
    """(B, C, H, W) -> (B, H * W * C) in the JAX package's NHWC order."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dim() == 4:
            x = x.permute(0, 2, 3, 1)
        return x.reshape(x.shape[0], -1)


class Linear(nn.Module):
    """A dense layer (``fc``) and its activation (none by default)."""

    def __init__(self, c_in: int, c_out: int, act: Optional[str] = None):
        super().__init__()
        self.fc = nn.Linear(c_in, c_out)
        self.act = get_activation(act)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.act(self.fc(x))
