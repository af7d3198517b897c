"""The int8 convolution of the quantized serving path: s8 x s8 -> s32.

The counterpart of the integer product in ``_QuantConv`` of the JAX
package's ``models/layers.py``, which XLA computes as
``conv_general_dilated(..., preferred_element_type=int32)``. Here the conv
is a product over an NHWC im2col: the K axis of a row holds the (kh, kw,
cin) window in the order of an HWIO kernel reshaped to (K, cout), so a 1x1
conv at stride 1 is the activation itself, viewed as (rows, cin).

- :func:`im2col` pads and concatenates one strided slice per tap
  (indexing works for int8 on every device, where ``F.unfold`` and
  ``conv2d`` do not).
- :func:`int8_matmul` is the wrapper: on a CUDA tensor it calls
  ``torch._int_mm`` (cuBLASLt's int8 tensor-core product), on a CPU tensor
  the plain version :func:`int8_matmul_ref`; any other device raises.
  ``_int_mm`` on CUDA wants more than 16 rows and K and N that are
  multiples of 8: the operands are padded with zeros to that, which leaves
  every sum as it is. ``int8_matmul.launches`` counts the ``_int_mm`` calls.
- :func:`int8_matmul_ref` is the plain version: the same product in f64,
  exact while |sum| < 2^53 (a 3x3 conv over 1280 channels sums at most
  1.9e8).
- :func:`dequantize` is the epilogue acc.f32 * scale + bias with one
  rounding, as XLA computes it (it contracts the multiply-add into an fma):
  on the CPU an exact fma emulated in f64 (round to odd, then to f32), on
  the card ``torch.addcmul``, which nvcc compiles to an fma.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def weight_matrix(q_kernel: torch.Tensor) -> torch.Tensor:
    """(cout, cin, kh, kw) int8 -> (K, cout), K in (kh, kw, cin) order."""
    o = q_kernel.shape[0]
    return q_kernel.permute(2, 3, 1, 0).reshape(-1, o)


def im2col(xq: torch.Tensor, k: int, stride: int,
           pad: int) -> Tuple[torch.Tensor, Tuple[int, int, int]]:
    """NHWC int8 (n, h, w, c) -> ((n * ho * wo, k * k * c) int8, (n, ho,
    wo)): each row one output position's k x k window in (kh, kw, c) order."""
    n, h, w, c = xq.shape
    ho = (h + 2 * pad - k) // stride + 1
    wo = (w + 2 * pad - k) // stride + 1
    if k == 1 and stride == 1 and pad == 0:
        return xq.reshape(n * h * w, c), (n, ho, wo)
    xp = F.pad(xq, (0, 0, pad, pad, pad, pad)) if pad else xq
    cols = torch.cat([xp[:, i:i + stride * (ho - 1) + 1:stride, j:j + stride * (wo - 1) + 1:stride]
                      for i in range(k) for j in range(k)], dim=-1)
    return cols.reshape(n * ho * wo, k * k * c), (n, ho, wo)


def int8_matmul_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version: int8 (m, k) @ int8 (k, n) -> int32 (m, n), in f64."""
    return torch.matmul(a.double(), b.double()).to(torch.int32)


def int_mm_padded(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch._int_mm`` of int8 (m, k) @ (k, n) with m, k and n padded with
    zeros to what its CUDA version takes (m > 16, k and n multiples of 8);
    the second operand goes in as the transpose of a contiguous (n, k)."""
    m, k = a.shape
    n = b.shape[1]
    mp, kp, np_ = max(m, 17), _round_up(k, 8), _round_up(n, 8)
    if (mp, kp) != (m, k):
        a = _pad2(a, mp, kp)
    bt = b.t()
    if (np_, kp) != (n, k):
        bt = _pad2(bt, np_, kp)
    out = torch._int_mm(a.contiguous(), bt.contiguous().t())
    return out[:m, :n] if (mp, np_) != (m, n) else out


def _pad2(t: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    out = t.new_zeros((rows, cols))
    out[:t.shape[0], :t.shape[1]] = t
    return out


def int8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int8 (m, k) @ int8 (k, n) -> int32 (m, n): ``_int_mm`` on the card
    (counted in ``int8_matmul.launches``), the plain version on the CPU."""
    if a.device.type == "cpu":
        return int8_matmul_ref(a, b)
    if a.device.type != "cuda":
        raise RuntimeError(f"int8_matmul: no route for a tensor on {a.device}")
    int8_matmul.launches += 1
    return int_mm_padded(a, b)


int8_matmul.launches = 0


def dequantize(acc: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """fma(acc.f32, scale, bias) in f32: int32 (..., c) with f32 (c,) scale
    and bias."""
    a = acc.float()
    if a.device.type != "cpu":
        return torch.addcmul(bias, a, scale)
    # the product of two f32 is exact in f64; the sum is rounded to odd in
    # f64 (its error by TwoSum), so that the one rounding to f32 is correct
    p = a.double() * scale.double()
    c = bias.double().expand_as(p)
    s = p + c
    v = s - p
    err = (p - (s - v)) + (c - v)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, float("inf"), -float("inf")).to(s.dtype)
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.float()


def int8_conv(xq: torch.Tensor, q_kernel: torch.Tensor, stride: int, pad: int,
              matmul=int8_matmul) -> torch.Tensor:
    """int8 NHWC (n, h, w, cin) conv int8 (cout, cin, k, k) -> int32 NHWC
    (n, ho, wo, cout), zero padding ``pad``, one ``matmul`` of the im2col."""
    k = q_kernel.shape[-1]
    wm = weight_matrix(q_kernel)
    cols, (n, ho, wo) = im2col(xq, k, stride, pad)
    return matmul(cols, wm).reshape(n, ho, wo, -1)
