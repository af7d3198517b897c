"""The fused early network: stem -> conv1 -> C3_1 -> conv2, as one kernel.

The counterpart of ``ayolov2_tpu/ops/early_pipeline.py`` (the Pallas kernel
K1). Layers 0..3 of a BN-folded YOLOv5 v6 model run as one CUDA kernel for
Hopper (``csrc/early_pipeline.cu``) that reads raw uint8 images and writes
the /8 activation ``(bs, H/8, W/8, c2)`` bf16 NHWC, from which the model
continues with ``forward(..., start_layer=4)``.

- :func:`extract_early_params` builds the kernel's weights from the port's
  fused state_dict: (co, K) bf16 matrices, K in (kh, kw, cin) order, the
  stem as a 3x3 over 12 space-to-depth planes with /255 folded in.
- :func:`early_pipeline_ref` is the plain torch version of the same math
  with the same bf16 rounding points; the CPU tests and the on-card check
  use it.
- :func:`early_pipeline` is the wrapper: on a CPU tensor it runs the plain
  version, on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from ayolov2_torch.ops import _build

SMEM_LIMIT = 232448  # bytes of shared memory one block may use on Hopper
# /8-output tiles tried in order, largest first (see csrc/early_pipeline.cu)
TILES = ((8, 8), (4, 8), (4, 4), (2, 2))  # s/n, m, l, x at their widths


@dataclasses.dataclass
class EarlyParams:
    """Matmul-ready bf16 weights: W (co, K_pad), b (co,); n = C3 depth."""

    w_stem: torch.Tensor                # (c0, 112)  K = 108 = 3x3 x 12 planes
    b_stem: torch.Tensor
    w_c1: torch.Tensor                  # (c1, 9*c0)
    b_c1: torch.Tensor
    w_cv1: torch.Tensor                 # (ch, c1)
    b_cv1: torch.Tensor
    w_m_cv1: Tuple[torch.Tensor, ...]   # n x (ch, ch)
    b_m_cv1: Tuple[torch.Tensor, ...]
    w_m_cv2: Tuple[torch.Tensor, ...]   # n x (ch, 9*ch)
    b_m_cv2: Tuple[torch.Tensor, ...]
    w_cv2: torch.Tensor                 # (ch, c1)
    b_cv2: torch.Tensor
    w_cv3: torch.Tensor                 # (c1, 2*ch)
    b_cv3: torch.Tensor
    w_c2: torch.Tensor                  # (c2, 9*c1)
    b_c2: torch.Tensor
    _packed: Dict = dataclasses.field(default_factory=dict, compare=False, repr=False)

    @property
    def c0(self) -> int:
        return self.w_stem.shape[0]

    @property
    def c1(self) -> int:
        return self.w_c1.shape[0]

    @property
    def ch(self) -> int:
        return self.w_cv1.shape[0]

    @property
    def c2(self) -> int:
        return self.w_c2.shape[0]

    @property
    def n(self) -> int:
        return len(self.w_m_cv1)

    def segments(self) -> List[torch.Tensor]:
        """Weights in the kernel's packing order (see csrc/early_pipeline.cu)."""
        seg = [self.w_stem, self.b_stem, self.w_c1, self.b_c1, self.w_cv1, self.b_cv1]
        for i in range(self.n):
            seg += [self.w_m_cv1[i], self.b_m_cv1[i], self.w_m_cv2[i], self.b_m_cv2[i]]
        seg += [self.w_cv2, self.b_cv2, self.w_cv3, self.b_cv3, self.w_c2, self.b_c2]
        return seg

    def to(self, device) -> "EarlyParams":
        moved = {f.name: getattr(self, f.name) for f in dataclasses.fields(self)
                 if f.name != "_packed"}
        for k, v in moved.items():
            moved[k] = tuple(t.to(device) for t in v) if isinstance(v, tuple) else v.to(device)
        return EarlyParams(**moved)


def can_fuse_early(specs) -> bool:
    """True when the first 4 specs match the YOLOv5 v6 early pattern and
    none of them feeds a skip connection."""
    if len(specs) < 5:
        return False
    s0, s1, s2, s3 = specs[0], specs[1], specs[2], specs[3]

    def conv_ks(s):
        a = s.args
        return (a[1] if len(a) > 1 else 1), (a[2] if len(a) > 2 else 1)

    return (
        s0.module == "Conv" and conv_ks(s0) == (6, 2)
        and s1.module == "Conv" and conv_ks(s1) == (3, 2)
        and s2.module == "C3" and (len(s2.args) < 2 or bool(s2.args[1]))
        and s3.module == "Conv" and conv_ks(s3) == (3, 2)
        and all(f == -1 for s in (s1, s2, s3) for f in s.from_idx)
    )


def _wk(kernel: torch.Tensor, bias: torch.Tensor, k_pad: int = None):
    """(kh, kw, cin, co) fused kernel -> ((co, K_pad), (co,)) bf16; rows of
    K in (kh, kw, cin) order, zero past the true K."""
    kh, kw, cin, co = kernel.shape
    k_true = kh * kw * cin
    w = kernel.reshape(k_true, co).T
    if k_pad is None:
        k_pad = -(-k_true // 16) * 16
    w = F.pad(w, (0, k_pad - k_true))
    return w.to(torch.bfloat16).contiguous(), bias.to(torch.bfloat16).contiguous()


def extract_early_params(fused_state: Dict[str, torch.Tensor]) -> EarlyParams:
    """Layers 0..3 of a fused (BN-folded) state_dict as kernel weights.

    The stem's 6x6 kernel becomes a 3x3 over 12 space-to-depth planes,
    K'[a, b, (p, q, c)] = K[2a + p, 2b + q, c], divided by 255 (the kernel
    reads raw uint8 pixels). Computed in f32, then rounded to bf16.
    """
    def hwio(name):
        return fused_state[name].detach().float().permute(2, 3, 1, 0)

    def bias(name):
        return fused_state[name].detach().float()

    k0 = hwio("model.0.conv.weight")  # (6, 6, cin, c0)
    cin, c0 = k0.shape[2], k0.shape[3]
    k0 = k0.reshape(3, 2, 3, 2, cin, c0).permute(0, 2, 1, 3, 4, 5)
    k0 = k0.reshape(3, 3, 4 * cin, c0) / 255.0
    w_stem, b_stem = _wk(k0, bias("model.0.conv.bias"))
    w_c1, b_c1 = _wk(hwio("model.1.conv.weight"), bias("model.1.conv.bias"))
    p = "model.2."
    cv1k = hwio(p + "cv1.conv.weight")
    w_cv1, b_cv1 = _wk(cv1k, bias(p + "cv1.conv.bias"), k_pad=cv1k.shape[2])
    cv2k = hwio(p + "cv2.conv.weight")
    w_cv2, b_cv2 = _wk(cv2k, bias(p + "cv2.conv.bias"), k_pad=cv2k.shape[2])
    w_cv3, b_cv3 = _wk(hwio(p + "cv3.conv.weight"), bias(p + "cv3.conv.bias"))
    wm1, bm1, wm2, bm2 = [], [], [], []
    i = 0
    while f"{p}m.{i}.cv1.conv.weight" in fused_state:
        m1k = hwio(f"{p}m.{i}.cv1.conv.weight")
        w, b = _wk(m1k, bias(f"{p}m.{i}.cv1.conv.bias"), k_pad=m1k.shape[2])
        wm1.append(w)
        bm1.append(b)
        w, b = _wk(hwio(f"{p}m.{i}.cv2.conv.weight"), bias(f"{p}m.{i}.cv2.conv.bias"))
        wm2.append(w)
        bm2.append(b)
        i += 1
    w_c2, b_c2 = _wk(hwio("model.3.conv.weight"), bias("model.3.conv.bias"))
    return EarlyParams(w_stem, b_stem, w_c1, b_c1, w_cv1, b_cv1,
                       tuple(wm1), tuple(bm1), tuple(wm2), tuple(bm2),
                       w_cv2, b_cv2, w_cv3, b_cv3, w_c2, b_c2)


def _check(images: torch.Tensor, ep: EarlyParams) -> None:
    if images.dtype != torch.uint8 or images.dim() != 4 or images.shape[-1] != 3:
        raise ValueError(f"expected (bs, H, W, 3) uint8 images, got {tuple(images.shape)} "
                         f"{images.dtype}")
    bs, h, w, _ = images.shape
    if bs < 1 or h % 8 or w % 8:
        raise ValueError(f"image batch {tuple(images.shape)}: need bs >= 1 and H, W "
                         "multiples of 8")
    if not images.is_contiguous():
        raise ValueError("images must be contiguous")
    if (ep.w_stem.shape[1] != 112 or ep.n < 1 or ep.ch * 2 != ep.w_cv3.shape[1]
            or any(c % 16 for c in (ep.c0, ep.c1, ep.ch, ep.c2))):
        raise ValueError(f"unsupported widths c0={ep.c0} c1={ep.c1} ch={ep.ch} "
                         f"c2={ep.c2} n={ep.n}")


def _conv_silu(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, k: int,
               stride: int = 1, pad: int = 0) -> torch.Tensor:
    """One fused conv as the kernel computes it: bf16 operands, f32 sums,
    bias + SiLU in f32, result rounded to bf16. w: (co, K) in (kh, kw, cin)."""
    co, cin = w.shape[0], x.shape[1]
    wt = w[:, : k * k * cin].float().reshape(co, k, k, cin).permute(0, 3, 1, 2)
    y = F.conv2d(x.float(), wt, b.float(), stride=stride, padding=pad)
    return F.silu(y).to(torch.bfloat16)


def early_pipeline_ref(images: torch.Tensor, ep: EarlyParams) -> torch.Tensor:
    """Plain torch version of the kernel: (bs, H, W, 3) uint8 ->
    (bs, H/8, W/8, c2) bf16 NHWC."""
    _check(images, ep)
    bs, h, w, cin = images.shape
    x = F.pad(images.permute(0, 3, 1, 2).float(), (2, 2, 2, 2))
    # space-to-depth planes in (p, q, c) order: s2d[a, b] = x[2a + p, 2b + q]
    x = x.reshape(bs, cin, (h + 4) // 2, 2, (w + 4) // 2, 2)
    x = x.permute(0, 3, 5, 1, 2, 4).reshape(bs, 4 * cin, (h + 4) // 2, (w + 4) // 2)
    x = _conv_silu(x, ep.w_stem, ep.b_stem, 3)
    x = _conv_silu(x, ep.w_c1, ep.b_c1, 3, 2, 1)
    m = _conv_silu(x, ep.w_cv1, ep.b_cv1, 1)
    for i in range(ep.n):
        r = _conv_silu(_conv_silu(m, ep.w_m_cv1[i], ep.b_m_cv1[i], 1),
                       ep.w_m_cv2[i], ep.b_m_cv2[i], 3, 1, 1)
        m = (m.float() + r.float()).to(torch.bfloat16)
    y = torch.cat([m, _conv_silu(x, ep.w_cv2, ep.b_cv2, 1)], dim=1)
    y = _conv_silu(y, ep.w_cv3, ep.b_cv3, 1)
    y = _conv_silu(y, ep.w_c2, ep.b_c2, 3, 2, 1)
    return y.permute(0, 2, 3, 1).contiguous()


def _lib() -> ctypes.CDLL:
    lib = _build.load("early_pipeline")
    if not getattr(lib, "_typed", False):
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.early_pipeline_launch.argtypes = [vp, vp, vp, vp] + [i] * 10 + [vp]
        lib.early_pipeline_launch.restype = i
        lib.early_pipeline_smem_bytes.argtypes = [i] * 6
        lib.early_pipeline_smem_bytes.restype = i
        lib._typed = True
    return lib


def tile_for(ep: EarlyParams) -> Tuple[int, int]:
    """The largest /8-output tile whose shared memory fits one block."""
    lib = _lib()
    for th, tw in TILES:
        if lib.early_pipeline_smem_bytes(ep.c0, ep.c1, ep.ch, ep.n, th, tw) <= SMEM_LIMIT:
            return th, tw
    raise ValueError(f"no tile fits widths c0={ep.c0} c1={ep.c1} ch={ep.ch} n={ep.n}")


def _packed(ep: EarlyParams, device: torch.device):
    """All weights in one bf16 buffer (segments 16-byte aligned) plus the
    int32 offset of each segment, cached per device."""
    key = str(device)
    if key not in ep._packed:
        flat, offs, pos = [], [], 0
        for t in ep.segments():
            t = t.reshape(-1).to(torch.bfloat16)
            pad = (-t.numel()) % 8
            offs.append(pos)
            flat.append(F.pad(t, (0, pad)))
            pos += t.numel() + pad
        ep._packed[key] = (torch.cat(flat).to(device),
                           torch.tensor(offs, dtype=torch.int32, device=device))
    return ep._packed[key]


def early_pipeline(images: torch.Tensor, ep: EarlyParams) -> torch.Tensor:
    """Fused stem/conv1/C3/conv2: (bs, H, W, 3) uint8 raw pixels ->
    (bs, H/8, W/8, c2) bf16 NHWC. CPU tensors take the plain version; CUDA
    tensors launch the kernel (counted in ``early_pipeline.launches``)."""
    _check(images, ep)
    if images.device.type == "cpu":
        return early_pipeline_ref(images, ep)
    if images.device.type != "cuda":
        raise ValueError(f"early_pipeline runs on cpu or cuda, not {images.device}")
    lib = _lib()
    th, tw = tile_for(ep)
    bs, h, w, _ = images.shape
    wpack, offs = _packed(ep, images.device)
    out = torch.empty((bs, h // 8, w // 8, ep.c2), dtype=torch.bfloat16, device=images.device)
    with torch.cuda.device(images.device):
        stream = torch.cuda.current_stream(images.device).cuda_stream
        err = lib.early_pipeline_launch(
            images.data_ptr(), out.data_ptr(), wpack.data_ptr(), offs.data_ptr(),
            bs, h, w, ep.c0, ep.c1, ep.ch, ep.c2, ep.n, th, tw, stream)
    if err != 0:
        raise RuntimeError(f"early_pipeline kernel launch failed: CUDA error {err}")
    early_pipeline.launches += 1
    return out


early_pipeline.launches = 0
