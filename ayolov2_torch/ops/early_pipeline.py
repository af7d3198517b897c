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
  version, on a CUDA tensor it launches the kernel or raises. It calls the
  operator ``torch.ops.ayolov2.early_pipeline(images, packed, c0, n)``
  (:func:`early_pipeline_op`), whose arguments are the uint8 images, the
  kernel's packed weight buffer (:func:`pack_weights`) and the two ints
  that fix the widths, so that ``torch.export`` records it in a graph with
  the packed weights as a buffer of the exported module. Its CPU
  implementation unpacks the weights and runs the plain version; its CUDA
  implementation launches the kernel; a fake implementation gives the
  output's shape to the tracer. Importing this module registers it.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from ayolov2_torch.ops import _build

SMEM_LIMIT = 232448  # bytes of shared memory one block may use on Hopper


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
    # the packed buffer of each device, made on the first call of the wrapper
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
        """Every weight and bias tensor, layer by layer (their bytes are what
        the kernel's bound counts; `pack_weights` builds the kernel's buffer)."""
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


def can_fuse_early_model(model) -> bool:
    """:func:`can_fuse_early` of the model's specs, and every conv of layers
    0..3 a plain float conv: none int8, recording for calibration or
    decomposed (``layers.ConvBnAct.plain``). An int8 model (its layers 1-3
    are int8) and a decomposed one whose map names a layer below 4 serve
    without the kernel. The widths are not looked at: the kernel's weights
    are packed only for widths it is built for (:func:`plan_early`), and
    others raise there, naming the width."""
    if not can_fuse_early(model.specs):
        return False
    return all(getattr(m, "plain", True) for i in range(4) for m in model.model[i].modules())


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


# ---- the tile and shared-memory plan of the kernel ---------------------------

PAD = 8            # extra bf16 per pixel of a shared buffer (pitch = odd multiple of 16 bytes)
S2D_BYTES = 32     # bytes of one space-to-depth pixel: two planes of 8 bf16
STEM_K = 144       # the kernel's stem K: 9 taps x (12 planes padded to 16)
# /8-output tiles tried, in the order of their halo factor with 64-row tiles
# for each model (widths that divide the 80 columns of a 640-pixel image)
TILES = ((8, 16), (8, 10), (8, 8), (4, 8), (4, 4), (2, 4), (2, 2))
PLAN_FIELDS = ("th", "tw", "rb", "stages", "stage_bytes", "off_ring", "off_c1", "off_raw",
               "off_s2d", "off_stem", "off_mcat", "off_mt", "off_bias", "total")


@dataclasses.dataclass(frozen=True)
class EarlyPlan:
    """Tile (th x tw of the /8 output), band height rb (conv1 rows per band
    of the rolling stem), depth and stage size of the weight ring, byte
    offset of every shared buffer and the dynamic shared memory to ask for
    (``total`` includes 1024 bytes of slack for aligning the ring).
    ``sizes`` maps each buffer to its bytes; ``halo`` is the tile's computed
    MACs over the MACs of its own output."""

    th: int
    tw: int
    rb: int
    stages: int
    stage_bytes: int
    off_ring: int
    off_c1: int
    off_raw: int
    off_s2d: int
    off_stem: int
    off_mcat: int
    off_mt: int
    off_bias: int
    total: int
    sizes: Dict[str, int] = dataclasses.field(compare=False, default_factory=dict)
    halo: float = dataclasses.field(compare=False, default=0.0)

    def as_ints(self) -> List[int]:
        return [getattr(self, f) for f in PLAN_FIELDS]


def tile_geometry(n: int, th: int, tw: int) -> Dict[str, int]:
    """Rows and columns of each region a th x tw tile needs (see the kernel's
    ``Geo``): C3 output r3 x c3, conv1 output r1 x c1, stem output r0 x c0,
    space-to-depth columns cs, parity-plane widths, raw row pitch."""
    r3, c3 = 2 * th + 1, 2 * tw + 1
    r1, c1 = r3 + 2 * n, c3 + 2 * n
    r0, c0 = 2 * r1 + 1, 2 * c1 + 1
    cs = c0 + 2
    return dict(r3=r3, c3=c3, r1=r1, c1=c1, r0=r0, c0=c0, cs=cs, half0=(c0 + 1) // 2,
                half3=(c3 + 1) // 2, raw_pitch=(6 * cs + 14) // 8 * 8)


def halo_factor(c0: int, n: int, th: int, tw: int, row_tile: int = 1) -> float:
    """MACs a tile computes (its whole receptive field, true K) over the MACs
    of its own th x tw output. With ``row_tile=64`` every product's pixels are
    rounded up to whole 64-row tiles, as the kernel's wgmmas compute them:
    the factor the tiles are ranked by."""
    c1, ch, c2 = 2 * c0, c0, 4 * c0
    g = tile_geometry(n, th, tw)

    def up(pixels):
        return -(-pixels // row_tile) * row_tile

    def macs(p_stem, p_c1, p_m2, p_c3, p_out):
        return (p_stem * c0 * 108 + p_c1 * c1 * 9 * c0 + p_c1 * 2 * ch * c1
                + n * (p_c1 * ch * ch + p_m2 * ch * 9 * ch) + p_c3 * c1 * 2 * ch
                + p_out * c2 * 9 * c1)

    p8 = th * tw
    own = macs(16 * p8, 4 * p8, 4 * p8, 4 * p8, p8)
    done = macs(up(g["r0"] * g["c0"]), up(g["r1"] * g["c1"]),
                up((g["r1"] - 2) * (g["c1"] - 2)), up(g["r3"] * g["c3"]), up(p8))
    return done / own


def _align(x: int, a: int = 128) -> int:
    return -(-x // a) * a


def _plan_for(c0: int, n: int, th: int, tw: int, stages: int, rb: int) -> EarlyPlan:
    c1, ch, c2 = 2 * c0, c0, 4 * c0
    g = tile_geometry(n, th, tw)
    p0, p1, pc, ph = ((c + PAD) * 2 for c in (c0, c1, 2 * ch, ch))
    s2d_rows = 2 * rb + 3
    sizes = dict(
        ring=stages * c2 * 128,
        c1=max(g["r1"] * g["c1"], g["r3"] * 2 * g["half3"]) * p1,  # conv1 out, then C3 out
        raw=2 * s2d_rows * g["raw_pitch"],
        s2d=s2d_rows * g["cs"] * S2D_BYTES,
        stem=(2 * rb + 1) * 2 * g["half0"] * p0,
        mcat=g["r1"] * g["c1"] * pc,
        mt=g["r1"] * g["c1"] * ph,
        bias=c0 * (11 + 2 * n) * 2,
    )
    off, pos = {}, 0
    for name in ("ring", "c1", "raw", "bias"):
        off[name] = pos
        pos += _align(sizes[name])
    # the stem's buffers (dead once conv1 is done) share the space of the C3's
    off["s2d"], off["stem"] = pos, pos + _align(sizes["s2d"])
    off["mcat"], off["mt"] = pos, pos + _align(sizes["mcat"])
    pos = max(off["stem"] + _align(sizes["stem"]), off["mt"] + _align(sizes["mt"]))
    return EarlyPlan(th, tw, rb, stages, c2 * 128, off["ring"], off["c1"], off["raw"],
                     off["s2d"], off["stem"], off["mcat"], off["mt"], off["bias"],
                     pos + 1024, sizes, halo_factor(c0, n, th, tw))


# Stages of the weight ring. Measured on an H100, a third stage bought yolov5s nothing
# while shorter bands cost time (PERF.md, section 6): the space goes to the bands.
RING_STAGES = 2
STATIC_SMEM = 1024  # the kernel's barriers and tables (static shared memory), rounded up


@functools.lru_cache(maxsize=None)  # on the launch path: the search runs once per width
def plan_early(c0: int, n: int) -> EarlyPlan:
    """The kernel's plan for widths c0 (c1 = 2 c0, ch = c0, c2 = 4 c0) and C3
    depth n: the tile of least halo factor (counted in whole 64-row tiles:
    measured, yolov5s is faster at 8x8, where conv2 is one full row tile, than
    at 8x10) that fits a block's shared memory with bands of at least 4 conv1
    rows (any band height for the smallest tile), in as few bands as fit, of
    even height. Raises if no tile fits."""
    if c0 not in (16, 32, 48, 64, 80) or not 1 <= n <= 4:
        raise ValueError(f"no kernel for widths c0={c0} c1={2 * c0} ch={c0} c2={4 * c0} n={n}: "
                         "it is built for stems of 16, 32, 48, 64 or 80 channels and C3 depths "
                         "1-4; run layers 0..3 on cuDNN (early_pipeline=False) instead")
    for th, tw in sorted(TILES, key=lambda t: halo_factor(c0, n, *t, row_tile=64)):
        r1 = 2 * th + 1 + 2 * n
        for rb in range(r1, 0, -1):
            plan = _plan_for(c0, n, th, tw, RING_STAGES, rb)
            if rb < min(4, r1) and (th, tw) != TILES[-1]:
                break  # bands this short cost more than the next tile's halo
            if plan.total + STATIC_SMEM <= SMEM_LIMIT:
                # as few bands as fit, of even height: a short last band wastes row tiles
                bands = -(-r1 // rb)
                return _plan_for(c0, n, th, tw, RING_STAGES, -(-r1 // bands))
    raise ValueError(f"no tile fits widths c0={c0} c1={2 * c0} ch={c0} c2={4 * c0} n={n}")


def tile_for(ep: EarlyParams) -> Tuple[int, int]:
    """The /8-output tile the kernel takes for these widths."""
    plan = _kernel_plan(ep)
    return plan.th, plan.tw


# ---- weight packing ------------------------------------------------------------

def stem_k144(w_stem: torch.Tensor) -> torch.Tensor:
    """(c0, 112) stem matrix (108 true columns: 9 taps x 12 planes) ->
    (c0, 144): each tap's 12 planes padded to 16 with zeros."""
    c0 = w_stem.shape[0]
    return F.pad(w_stem[:, :108].reshape(c0, 9, 12), (0, 4)).reshape(c0, STEM_K)


def layer_matrices(ep: EarlyParams) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """(W (co, K), b (co,)) of every product the kernel runs, in its order:
    stem (K = 144), conv1, cv1|cv2 as one (2 ch, c1), n x [m.cv1, m.cv2],
    cv3, conv2."""
    out = [(stem_k144(ep.w_stem), ep.b_stem), (ep.w_c1, ep.b_c1),
           (torch.cat([ep.w_cv1, ep.w_cv2]), torch.cat([ep.b_cv1, ep.b_cv2]))]
    for i in range(ep.n):
        out += [(ep.w_m_cv1[i], ep.b_m_cv1[i]), (ep.w_m_cv2[i], ep.b_m_cv2[i])]
    return out + [(ep.w_cv3, ep.b_cv3), (ep.w_c2, ep.b_c2)]


def steps_per_chunk(k: int) -> int:
    """k16 steps in one chunk of a layer with K = k: the largest of 4, 3, 2, 1
    that divides k / 16, so that no chunk is ragged."""
    ksteps = k // 16
    return next(c for c in (4, 3, 2, 1) if ksteps % c == 0)


def _swizzle_index(chunks: int, co: int, device) -> torch.Tensor:
    unit = torch.arange(8).view(1, 8) ^ (torch.arange(co).view(co, 1) % 8)  # (co, 8)
    return unit.view(1, co, 8, 1).expand(chunks, co, 8, 8).to(device)


def pack_chunks(w: torch.Tensor) -> torch.Tensor:
    """(co, K) bf16 -> (chunks, co, 64): chunks of ``steps_per_chunk(K)`` k16
    steps along K (zeros up to 64), each a (co, 64) tile of 128-byte rows in
    the 128-byte-swizzle order a wgmma descriptor reads: the 16-byte unit u
    of row r sits at unit u ^ (r % 8)."""
    co, k = w.shape
    if k % 16:
        raise ValueError(f"K={k} is not a multiple of 16")
    per = 16 * steps_per_chunk(k)
    chunks = k // per
    t = F.pad(w.reshape(co, chunks, per), (0, 64 - per)).reshape(co, chunks, 8, 8)
    t = t.permute(1, 0, 2, 3)
    out = torch.empty_like(t).scatter_(2, _swizzle_index(chunks, co, w.device), t)
    return out.reshape(chunks, co, 64).contiguous()


def unpack_chunks(packed: torch.Tensor, k: int) -> torch.Tensor:
    """The inverse of :func:`pack_chunks`: (chunks, co, 64) -> (co, k)."""
    chunks, co, _ = packed.shape
    per = 16 * steps_per_chunk(k)
    t = packed.reshape(chunks, co, 8, 8).gather(2, _swizzle_index(chunks, co, packed.device))
    return t.permute(1, 0, 2, 3).reshape(co, chunks, 64)[:, :, :per].reshape(co, k).contiguous()


def pack_weights(ep: EarlyParams) -> torch.Tensor:
    """All of the kernel's weights as one bf16 buffer: every layer's chunks
    in the kernel's order, then every layer's bias."""
    mats = layer_matrices(ep)
    parts = [pack_chunks(w.to(torch.bfloat16)).reshape(-1) for w, _ in mats]
    parts += [b.to(torch.bfloat16).reshape(-1) for _, b in mats]
    return torch.cat(parts)


def packed_layout(c0: int, n: int) -> List[Tuple[int, int]]:
    """(co, K) of every product in :func:`layer_matrices`' order for widths
    c0 (c1 = 2 c0, ch = c0, c2 = 4 c0) and C3 depth n."""
    c1, ch, c2 = 2 * c0, c0, 4 * c0
    return ([(c0, STEM_K), (c1, 9 * c0), (2 * ch, c1)] + [(ch, ch), (ch, 9 * ch)] * n
            + [(c1, 2 * ch), (c2, 9 * c1)])


def packed_numel(c0: int, n: int) -> int:
    """Elements of the buffer :func:`pack_weights` makes for these widths."""
    return sum(co * 64 * (k // (16 * steps_per_chunk(k))) + co for co, k in packed_layout(c0, n))


def unpack_weights(wpack: torch.Tensor, c0: int, n: int) -> EarlyParams:
    """The inverse of :func:`pack_weights`: the packed buffer of widths c0
    and depth n -> EarlyParams (bit for bit: both are bf16)."""
    if wpack.dim() != 1 or wpack.numel() != packed_numel(c0, n):
        raise ValueError(f"packed weights of {tuple(wpack.shape)} elements do not hold widths "
                         f"c0={c0} n={n} ({packed_numel(c0, n)} elements)")
    layout = packed_layout(c0, n)
    mats, pos = [], 0
    for co, k in layout:
        size = co * 64 * (k // (16 * steps_per_chunk(k)))
        mats.append(unpack_chunks(wpack[pos:pos + size].reshape(-1, co, 64), k))
        pos += size
    biases = []
    for co, _ in layout:
        biases.append(wpack[pos:pos + co])
        pos += co
    ch = c0
    w_stem = F.pad(mats[0].reshape(c0, 9, 16)[:, :, :12].reshape(c0, 108), (0, 4))
    m = range(3, 3 + 2 * n, 2)
    return EarlyParams(
        w_stem, biases[0], mats[1], biases[1], mats[2][:ch], biases[2][:ch],
        tuple(mats[i] for i in m), tuple(biases[i] for i in m),
        tuple(mats[i + 1] for i in m), tuple(biases[i + 1] for i in m),
        mats[2][ch:], biases[2][ch:], mats[-2], biases[-2], mats[-1], biases[-1])


def _packed(ep: EarlyParams, device: torch.device) -> torch.Tensor:
    """The packed weights on ``device``, cached per device."""
    key = str(device)
    if key not in ep._packed:
        ep._packed[key] = pack_weights(ep).to(device)
    return ep._packed[key]


# ---- the wrapper -----------------------------------------------------------------

def _lib_with(c0: int, extra: Tuple[str, ...] = (), source: str = "early_pipeline") -> ctypes.CDLL:
    """The kernel's library for stem width c0 (one build per width), built
    with the ``extra`` -D switches; ``source`` may be the path of another
    version of the kernel's source with the same C interface."""
    lib = _build.load(source, defines=(f"EARLY_C0={c0}",) + tuple(extra))
    if not getattr(lib, "_typed", False):
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.early_pipeline_launch.argtypes = [vp, vp, vp, vp, i, i, i, i, i,
                                              ctypes.POINTER(ctypes.c_int), vp]
        lib.early_pipeline_launch.restype = i
        lib.early_pipeline_profile_slots.argtypes = []
        lib.early_pipeline_profile_slots.restype = i
        lib._typed = True
    return lib


def _lib(c0: int, profile: bool = False) -> ctypes.CDLL:
    return _lib_with(c0, ("EARLY_PROFILE",) if profile else ())


def _kernel_plan(ep: EarlyParams) -> EarlyPlan:
    """The plan for these weights; raises on widths the kernel does not take."""
    if (ep.c1, ep.ch, ep.c2) != (2 * ep.c0, ep.c0, 4 * ep.c0):
        raise ValueError(f"no kernel for widths c0={ep.c0} c1={ep.c1} ch={ep.ch} c2={ep.c2}")
    return plan_early(ep.c0, ep.n)


def _launch(lib: ctypes.CDLL, images: torch.Tensor, wpack: torch.Tensor, c0: int, n: int,
            prof: torch.Tensor = None) -> torch.Tensor:
    plan = plan_early(c0, n)
    bs, h, w, _ = images.shape
    out = torch.empty((bs, h // 8, w // 8, 4 * c0), dtype=torch.bfloat16, device=images.device)
    ints = (ctypes.c_int * len(PLAN_FIELDS))(*plan.as_ints())
    with torch.cuda.device(images.device):
        stream = torch.cuda.current_stream(images.device).cuda_stream
        err = lib.early_pipeline_launch(
            images.data_ptr(), out.data_ptr(), wpack.data_ptr(),
            prof.data_ptr() if prof is not None else None,
            bs, h, w, c0, n, ints, stream)
    if err != 0:
        raise RuntimeError(f"early_pipeline kernel launch failed: error {err} (widths "
                           f"c0={c0} c1={2 * c0} ch={c0} c2={4 * c0} n={n}, tile "
                           f"{plan.th}x{plan.tw})")
    early_pipeline.launches += 1
    return out


def _check_op(images: torch.Tensor, wpack: torch.Tensor, c0: int, n: int) -> None:
    if images.dtype != torch.uint8 or images.dim() != 4 or images.shape[-1] != 3:
        raise ValueError(f"expected (bs, H, W, 3) uint8 images, got {tuple(images.shape)} "
                         f"{images.dtype}")
    if images.shape[1] % 8 or images.shape[2] % 8 or not images.is_contiguous():
        raise ValueError(f"image batch {tuple(images.shape)}: need contiguous images with H, "
                         "W multiples of 8")
    if wpack.dtype != torch.bfloat16 or wpack.device != images.device:
        raise ValueError(f"packed weights {wpack.dtype} on {wpack.device}: need bf16 on "
                         f"{images.device}")
    if wpack.numel() != packed_numel(c0, n):
        raise ValueError(f"packed weights of {wpack.numel()} elements do not hold widths "
                         f"c0={c0} n={n}")


@torch.library.custom_op("ayolov2::early_pipeline", mutates_args=(), device_types="cpu")
def early_pipeline_op(images: torch.Tensor, wpack: torch.Tensor, c0: int,
                      n: int) -> torch.Tensor:
    """The operator: (bs, H, W, 3) uint8, the packed bf16 weights of widths
    c0 and C3 depth n -> (bs, H/8, W/8, 4 c0) bf16. This body is the CPU
    implementation: the plain version on the unpacked weights."""
    _check_op(images, wpack, c0, n)
    return early_pipeline_ref(images, unpack_weights(wpack, c0, n))


@early_pipeline_op.register_kernel("cuda")
def _early_pipeline_cuda(images: torch.Tensor, wpack: torch.Tensor, c0: int,
                         n: int) -> torch.Tensor:
    _check_op(images, wpack, c0, n)
    plan_early(c0, n)  # raises before any build is tried
    return _launch(_lib(c0), images, wpack, c0, n)


@early_pipeline_op.register_fake
def _early_pipeline_fake(images: torch.Tensor, wpack: torch.Tensor, c0: int,
                         n: int) -> torch.Tensor:
    bs, h, w, _ = images.shape
    return images.new_empty((bs, h // 8, w // 8, 4 * c0), dtype=torch.bfloat16)


def early_pipeline(images: torch.Tensor, ep: EarlyParams) -> torch.Tensor:
    """Fused stem/conv1/C3/conv2: (bs, H, W, 3) uint8 raw pixels ->
    (bs, H/8, W/8, c2) bf16 NHWC, through the operator. CPU tensors take the
    plain version; CUDA tensors launch the kernel (counted in
    ``early_pipeline.launches``); other devices raise."""
    _check(images, ep)
    if images.device.type not in ("cpu", "cuda"):
        raise ValueError(f"early_pipeline runs on cpu or cuda, not {images.device}")
    _kernel_plan(ep)  # raises before any build is tried
    return early_pipeline_op(images, _packed(ep, images.device), ep.c0, ep.n)


early_pipeline.launches = 0

PROFILE_SLOTS = ("wait for raw rows", "convert to s2d", "stem", "conv1", "cv1|cv2",
                 "bottlenecks", "cv3", "conv2")
PROFILE_INNER = ("warpgroups: waiting for weights", "warpgroups: ldmatrix + wgmma",
                 "warpgroups: epilogue", "warpgroups: no item this round",
                 "warpgroups: at the block barrier")


def early_pipeline_profile(images: torch.Tensor, ep: EarlyParams) -> Dict[str, float]:
    """Where the kernel's time goes: one launch of a build of the same source
    with clock stamps at each layer boundary (``-DEARLY_PROFILE``); returns
    each phase's share of the stamped clocks, summed over all blocks."""
    _check(images, ep)
    _kernel_plan(ep)
    lib = _lib(ep.c0, profile=True)
    slots = lib.early_pipeline_profile_slots()
    prof = torch.zeros((4096, slots), dtype=torch.int64, device=images.device)
    _launch(lib, images, _packed(ep, images.device), ep.c0, ep.n, prof)
    torch.cuda.synchronize(images.device)
    total = prof.sum(0).double()
    layers, inner = total[:len(PROFILE_SLOTS)], total[len(PROFILE_SLOTS):].view(4, -1).sum(0)
    per_group = total[len(PROFILE_SLOTS):].view(4, -1)
    out = dict(zip(PROFILE_SLOTS, (layers / layers.sum()).tolist()))
    out.update(zip(PROFILE_INNER, (inner / inner.sum()).tolist()))
    blocks = int((prof[:, :len(PROFILE_SLOTS)].sum(1) > 0).sum())
    groups = int((prof[:, len(PROFILE_SLOTS):].view(prof.shape[0], 4, -1).sum(2) > 0).sum())
    out["barrier share by warpgroup"] = [round(float(x), 3) for x in
                                         (per_group[:, 4] / per_group.sum(1).clamp(min=1))]
    out["clocks per block"] = layers.sum().item() / max(blocks, 1)
    out["clocks per warpgroup"] = inner.sum().item() / max(groups, 1)
    return out
