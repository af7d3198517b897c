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
  version at any widths, on a CUDA tensor it launches the kernel or raises.
  It calls the operator ``torch.ops.ayolov2.early_pipeline(images, packed,
  c0, n, c1, ch, c2)`` (:func:`early_pipeline_op`), whose arguments are the
  uint8 images, the kernel's packed weight buffer (:func:`pack_weights`) and
  the ints that fix the widths, so that ``torch.export`` records it in a
  graph with the packed weights as a buffer of the exported module. c1, ch
  and c2 may be left out: they then follow the v6 ratios of c0 (2 c0, c0,
  4 c0), the only widths of the operator's first form, so artifacts written
  with that form still load. Its CPU implementation unpacks the weights and
  runs the plain version; its CUDA implementation launches the kernel; a
  fake implementation gives the output's shape to the tracer. Importing
  this module registers it.

:func:`early_pipeline_rows` runs the operator on the image rows that some
/8 output rows read (their halo, :func:`slab_halo`) and keeps those rows:
a rank's part in spatially split serving (``parallel/spatial.py``).

The kernel holds every width padded (:func:`padded_widths`): c0, c1 and ch
to multiples of 16 and c2 to a multiple of its N tile, with zero weights and
biases, so that every padded channel is exactly 0 after SiLU; it stores only
the true c2 channels. One library is built per padded width set.

It has two forms, chosen per width set by :func:`plan_early` from a cost
(:func:`form_cost`: MACs done and bytes moved at the card's data-sheet
rates): the fused one, one kernel that keeps every
intermediate in a block's shared memory (yolov5n, s and a stem of 8), and
the staged one, 2 + n kernels through a device-memory workspace, each with
a halo of at most one conv (yolov5m, l, l_0.5, x and the width-1.05
config), for which a fused tile small enough for one block would recompute
its receptive field many times over. Callers see one operator either way.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from ayolov2_torch.ops import _build

SMEM_LIMIT = 232448  # bytes of shared memory one block may use on Hopper
Widths = Tuple[int, int, int, int, int]  # (c0, c1, ch, c2, n)


@dataclasses.dataclass
class EarlyParams:
    """Matmul-ready bf16 weights: W (co, K_pad), b (co,); n = C3 depth."""

    w_stem: torch.Tensor                # (c0, 112)  K = 108 = 3x3 x 12 planes
    b_stem: torch.Tensor
    w_c1: torch.Tensor                  # (c1, 9*c0 up to a multiple of 16)
    b_c1: torch.Tensor
    w_cv1: torch.Tensor                 # (ch, c1)
    b_cv1: torch.Tensor
    w_m_cv1: Tuple[torch.Tensor, ...]   # n x (ch, ch)
    b_m_cv1: Tuple[torch.Tensor, ...]
    w_m_cv2: Tuple[torch.Tensor, ...]   # n x (ch, 9*ch up to a multiple of 16)
    b_m_cv2: Tuple[torch.Tensor, ...]
    w_cv2: torch.Tensor                 # (ch, c1)
    b_cv2: torch.Tensor
    w_cv3: torch.Tensor                 # (c1, 2*ch up to a multiple of 16)
    b_cv3: torch.Tensor
    w_c2: torch.Tensor                  # (c2, 9*c1 up to a multiple of 16)
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

    @property
    def widths(self) -> "Widths":
        """(c0, c1, ch, c2, n), read from the weight shapes as JAX reads them."""
        return self.c0, self.c1, self.ch, self.c2, self.n

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
    without the kernel, and so does a model whose later layers read one of
    layers 0..3 (a head on layer 3): the kernel returns layer 3's output
    alone. The widths are not looked at: the kernel's weights are packed
    only for widths it is built for (:func:`plan_early`), and others raise
    there, naming the width."""
    if not can_fuse_early(model.specs) or any(i < 4 for i in model.save):
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
    c0, c1, ch, c2, n = ep.widths
    if (ep.w_stem.shape[1] != 112 or n < 1 or ep.w_c1.shape[1] < 9 * c0
            or ep.w_cv1.shape[1] != c1 or ep.w_cv3.shape[1] < 2 * ch
            or ep.w_c2.shape[1] < 9 * c1):
        raise ValueError(f"inconsistent early-network weights: widths c0={c0} c1={c1} ch={ch} "
                         f"c2={c2} n={n}, stem K {ep.w_stem.shape[1]}, conv1 K "
                         f"{ep.w_c1.shape[1]}, cv3 K {ep.w_cv3.shape[1]}")


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
# /8-output tiles tried by the fused form, in the order of their halo factor with
# 64-row tiles for each model (widths that divide the 80 columns of a 640-pixel image)
TILES = ((8, 16), (8, 10), (8, 8), (4, 8), (4, 4), (2, 4), (2, 2))
# The kernel's two forms. "fused": one kernel, a block computes a /8 tile's
# whole receptive field at every level in shared memory. "staged": 2 + n
# kernels through device memory, each with a halo of at most one conv:
# "head" (stem, conv1, cv1|cv2 of a /4 tile), one "bottleneck" kernel per
# bottleneck (the last also runs cv3), "tail" (conv2 of a /8 tile).
FORMS = ("fused", "staged")
PART_FIELDS = ("th", "tw", "rb", "stages", "stage_bytes", "off_ring", "off_c1", "off_raw",
               "off_s2d", "off_stem", "off_mcat", "off_mt", "off_bias", "total")
PLAN_PARTS = 3     # parts of the launch's ints: the fused form fills the first
PLAN_FIELDS = ("form",) + tuple(f"{i}.{f}" for i in range(PLAN_PARTS) for f in PART_FIELDS)


@dataclasses.dataclass(frozen=True)
class StagePlan:
    """One kernel's plan: its tile th x tw (of the /8 output for "fused" and
    "tail", of the /4 level for "head" and "bottleneck"), band height rb
    (conv1 rows per band of the rolling stem; 0 where there is no stem),
    depth and stage size of the weight ring, byte offset of every shared
    buffer (0 where the kind has none) and the dynamic shared memory to ask
    for (``total`` includes 1024 bytes of slack for aligning the ring).
    ``sizes`` maps each buffer to its bytes."""

    kind: str
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

    def as_ints(self) -> List[int]:
        return [getattr(self, f) for f in PART_FIELDS]


@dataclasses.dataclass(frozen=True)
class EarlyPlan:
    """The kernel's plan for one width set: its form, one :class:`StagePlan`
    per kernel kind it launches, and what the choice was made from, per call
    at the reference batch (``REFERENCE``): ``halo``, the MACs its tiles
    compute (every product's pixels rounded up to whole 64-row tiles) over
    the MACs of the output; ``weight_bytes``, the packed weight bytes the
    ring streams from L2; ``act_bytes``, the bytes the staged form moves
    through device memory between its kernels; ``cost_ms``, the time these
    take at the card's data-sheet rates (:func:`form_cost`)."""

    form: str
    parts: Tuple[StagePlan, ...]
    halo: float = dataclasses.field(compare=False, default=0.0)
    weight_bytes: float = dataclasses.field(compare=False, default=0.0)
    act_bytes: float = dataclasses.field(compare=False, default=0.0)
    cost_ms: float = dataclasses.field(compare=False, default=0.0)

    @property
    def th(self) -> int:
        """Rows of the /8 output tile (the fused kernel's, or the tail's)."""
        return self.parts[-1].th

    @property
    def tw(self) -> int:
        return self.parts[-1].tw

    def as_ints(self) -> List[int]:
        """The launch's ints (``PLAN_FIELDS``): the form, then each part's
        fields, zeros for the parts the form does not have."""
        ints = [FORMS.index(self.form)]
        for i in range(PLAN_PARTS):
            ints += self.parts[i].as_ints() if i < len(self.parts) else [0] * len(PART_FIELDS)
        return ints

    def describe(self) -> str:
        def one(p):
            rb = f", bands of {p.rb}" if p.rb else ""
            return f"{p.kind} tile {p.th}x{p.tw}{rb}, smem {p.total} B"
        return (f"{self.form} ({'; '.join(one(p) for p in self.parts)}; ring {self.parts[0].stages}"
                f"x{self.parts[0].stage_bytes} B; halo factor {self.halo:.3f}, weights "
                f"{self.weight_bytes / 1e9:.3f} GB and activations {self.act_bytes / 1e9:.3f} GB "
                f"a call at bs {REFERENCE[0]}, {REFERENCE[1]}x{REFERENCE[2]}; cost "
                f"{self.cost_ms:.3f} ms)")


def tile_geometry(n: int, th: int, tw: int) -> Dict[str, int]:
    """Rows and columns of each region a th x tw tile of the fused form needs
    (see the kernel's ``Geo``): C3 output r3 x c3, conv1 output r1 x c1, stem
    output r0 x c0, space-to-depth columns cs, parity-plane widths, raw row
    pitch."""
    r3, c3 = 2 * th + 1, 2 * tw + 1
    return _geometry(r3 + 2 * n, c3 + 2 * n, r3, c3)


def head_geometry(th: int, tw: int) -> Dict[str, int]:
    """The regions of a head tile of th x tw conv1 pixels (/4): conv1 output
    r1 x c1 = th x tw, stem output r0 x c0 = (2 th + 1) x (2 tw + 1)."""
    return _geometry(th, tw, 0, 0)


def _geometry(r1: int, c1: int, r3: int, c3: int) -> Dict[str, int]:
    r0, c0 = 2 * r1 + 1, 2 * c1 + 1
    cs = c0 + 2
    return dict(r3=r3, c3=c3, r1=r1, c1=c1, r0=r0, c0=c0, cs=cs, half0=(c0 + 1) // 2,
                half3=(c3 + 1) // 2, raw_pitch=(6 * cs + 14) // 8 * 8)


MAX_C0, MAX_CH, MAX_C1, MAX_C2 = 80, 80, 160, 320  # padded widths the kernel's N tiles cover


def widths_of(c0: int, n: int, c1: Optional[int] = None, ch: Optional[int] = None,
              c2: Optional[int] = None) -> Widths:
    """(c0, c1, ch, c2, n); c1, ch and c2 left out follow the v6 ratios of the
    stem width c0: 2 c0, c0, 4 c0."""
    return (c0, 2 * c0 if c1 is None else c1, c0 if ch is None else ch,
            4 * c0 if c2 is None else c2, n)


def padded_width(c: int) -> int:
    """A width as the kernel holds it: a multiple of 16 (one k16 step, and an
    N tile of a multiple of 8 where a product of up to 160 channels is cut
    in two), of 32 above 160 (cut in four)."""
    return -(-c // 16) * 16 if c <= 160 else -(-c // 32) * 32


def padded_widths(c0: int, c1: int, ch: int, c2: int) -> Tuple[int, int, int, int]:
    return padded_width(c0), padded_width(c1), padded_width(ch), padded_width(c2)


def stage_rows(c0p: int, c1p: int, chp: int, c2p: int) -> int:
    """Rows of 128 bytes in one stage of the weight ring: the widest product,
    and the stem's three chunks, which its nine wgmmas read from one stage."""
    return max(3 * c0p, c1p, 2 * chp, c2p)


def kernel_defines(c0: int, c1: int, ch: int, c2: int) -> Tuple[str, ...]:
    """The -D switches of the kernel's library for these (true) widths: one
    library per padded width set."""
    p0, p1, ph, p2 = padded_widths(c0, c1, ch, c2)
    return (f"EARLY_C0={p0}", f"EARLY_C1={p1}", f"EARLY_CH={ph}", f"EARLY_C2={p2}")


def _width_text(c0: int, c1: int, ch: int, c2: int, n: int) -> str:
    return f"widths c0={c0} c1={c1} ch={ch} c2={c2} n={n}"


def halo_factor(c0: int, n: int, th: int, tw: int, row_tile: int = 1,
                c1: Optional[int] = None, ch: Optional[int] = None,
                c2: Optional[int] = None) -> float:
    """MACs a tile of the fused form computes (its whole receptive field, at
    the padded widths the kernel computes) over the MACs of its own th x tw
    output. With ``row_tile=64`` every product's pixels are rounded up to
    whole 64-row tiles, as the kernel's wgmmas compute them: the factor the
    tiles are ranked by."""
    c0, c1, ch, c2, n = widths_of(c0, n, c1, ch, c2)
    c0, c1, ch, c2 = padded_widths(c0, c1, ch, c2)
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


def total_bias(c0p: int, c1p: int, chp: int, c2p: int, n: int) -> int:
    """Biases of every product, padded: stem, conv1, cv1|cv2, n x [m.cv1,
    m.cv2], cv3, conv2 (the kernel's ``total_bias``)."""
    return c0p + c1p + 2 * chp + n * 2 * chp + c1p + c2p


def _pitches(widths: Widths) -> Dict[str, int]:
    """Bytes of one pixel in each kind of shared buffer: stem output (p0),
    conv1 and C3 output (p1), the concat (pc), the bottleneck 1x1 (ph)."""
    p0w, p1w, phw, _ = padded_widths(*widths[:4])
    return dict(p0=(p0w + PAD) * 2, p1=(p1w + PAD) * 2, pc=(2 * phw + PAD) * 2,
                ph=(phw + PAD) * 2)


def _buffer_sizes(kind: str, widths: Widths, th: int, tw: int, stages: int,
                  rb: int) -> Dict[str, int]:
    """Bytes of each shared buffer a kernel of this kind uses (the kernel's
    ``plan_extent`` and ``stage_extent`` count the same)."""
    n = widths[4]
    pw = padded_widths(*widths[:4])
    pt = _pitches(widths)
    sizes = dict(ring=stages * stage_rows(*pw) * 128, bias=total_bias(*pw, n) * 2)
    if kind in ("fused", "head"):
        g = tile_geometry(n, th, tw) if kind == "fused" else head_geometry(th, tw)
        s2d_rows = 2 * rb + 3
        sizes.update(raw=2 * s2d_rows * g["raw_pitch"], s2d=s2d_rows * g["cs"] * S2D_BYTES,
                     stem=(2 * rb + 1) * 2 * g["half0"] * pt["p0"])
        if kind == "fused":  # conv1 out, then C3 out; the C3's buffers
            sizes.update(c1=max(g["r1"] * g["c1"], g["r3"] * 2 * g["half3"]) * pt["p1"],
                         mcat=g["r1"] * g["c1"] * pt["pc"], mt=g["r1"] * g["c1"] * pt["ph"])
        else:  # conv1 out
            sizes.update(c1=th * tw * pt["p1"])
    elif kind == "bottleneck":  # the tile and its ring of one pixel: concat, 1x1 output
        ring_px = (th + 2) * (tw + 2)
        sizes.update(mcat=ring_px * pt["pc"], mt=ring_px * pt["ph"])
    else:  # tail: the C3 output conv2 reads, parity-split
        sizes.update(c1=(2 * th + 1) * 2 * (tw + 1) * pt["p1"])
    return sizes


def _plan_for(widths: Widths, th: int, tw: int, stages: int, rb: int,
              kind: str = "fused") -> StagePlan:
    """The plan of one kernel of ``kind`` at this tile: its buffers laid out
    one after the other (the fused form's stem buffers, dead once conv1 is
    done, share the space of the C3's)."""
    sizes = _buffer_sizes(kind, widths, th, tw, stages, rb)
    stage_bytes = stage_rows(*padded_widths(*widths[:4])) * 128
    off, pos = {}, 0
    for name in ("ring", "c1", "raw", "bias", "mcat", "mt", "s2d", "stem"):
        if name in sizes and not (kind == "fused" and name in ("mcat", "mt", "s2d", "stem")):
            off[name] = pos
            pos += _align(sizes[name])
    if kind == "fused":
        off["s2d"], off["stem"] = pos, pos + _align(sizes["s2d"])
        off["mcat"], off["mt"] = pos, pos + _align(sizes["mcat"])
        pos = max(off["stem"] + _align(sizes["stem"]), off["mt"] + _align(sizes["mt"]))
    return StagePlan(kind, th, tw, rb if kind in ("fused", "head") else 0, stages, stage_bytes,
                     *(off.get(b, 0) for b in ("ring", "c1", "raw", "s2d", "stem", "mcat",
                                               "mt", "bias")),
                     pos + 1024, sizes)


# Stages of the weight ring. Measured on an H100, a third stage bought yolov5s nothing
# while shorter bands cost time (PERF.md, section 6): the space goes to the bands.
RING_STAGES = 2
STATIC_SMEM = 1024  # the kernel's barriers and tables (static shared memory), rounded up


def _fits(part: StagePlan) -> bool:
    return part.total + STATIC_SMEM <= SMEM_LIMIT


def _bands(widths: Widths, th: int, tw: int, r1: int, kind: str,
           shortest: int) -> Optional[StagePlan]:
    """The plan with as few bands of conv1 rows as fit (of even height: a
    short last band wastes row tiles), none shorter than ``shortest``; None
    where none fits."""
    for rb in range(r1, max(shortest, 1) - 1, -1):
        if _fits(_plan_for(widths, th, tw, RING_STAGES, rb, kind)):
            bands = -(-r1 // rb)
            return _plan_for(widths, th, tw, RING_STAGES, -(-r1 // bands), kind)
    return None


def _plan_fused(widths: Widths) -> Optional[StagePlan]:
    """The fused form's tile: the least halo factor (counted in whole 64-row
    tiles: measured, yolov5s is faster at 8x8, where conv2 is one full row
    tile, than at 8x10) that fits a block's shared memory, with bands of at
    least 4 conv1 rows (any band height for the smallest tile)."""
    c0, c1, ch, c2, n = widths
    for th, tw in sorted(TILES, key=lambda t: halo_factor(c0, n, *t, row_tile=64, c1=c1,
                                                          ch=ch, c2=c2)):
        r1 = 2 * th + 1 + 2 * n
        part = _bands(widths, th, tw, r1, "fused", 1 if (th, tw) == TILES[-1] else min(4, r1))
        if part is not None:
            return part
    return None


# Tiles the staged form's kernels try: (rows, columns) of the /4 level for the
# head and the bottlenecks, of the /8 output for the tail
HEAD_TILES = tuple((r, c) for r in (4, 8, 12, 16) for c in (8, 16, 24, 32))
BOTTLENECK_TILES = tuple((r, c) for r in (4, 6, 8, 10, 12, 14, 16) for c in (8, 12, 16, 20, 24, 32))
TAIL_TILES = ((8, 8), (4, 16), (4, 8), (8, 4), (4, 4))


def stage_window(kind: str, y0: int, rows: int) -> Tuple[int, int]:
    """Rows [lo, hi) of its input that a staged kernel's tile of ``rows``
    rows from row ``y0`` of its own level reads (columns alike), zeros
    outside the image: the head reads raw image rows (stem 6x6/s2/p2, then
    conv1 3x3/s2/p1), a bottleneck the m rows of its tile and a ring of one
    (1x1, then 3x3/p1), the tail the C3 output rows (conv2 3x3/s2/p1)."""
    if kind == "head":
        return 4 * y0 - 4, 4 * (y0 + rows) + 2
    if kind == "bottleneck":
        return y0 - 1, y0 + rows + 1
    if kind == "tail":
        return 2 * y0 - 1, 2 * (y0 + rows)
    raise ValueError(f"no staged kernel {kind!r}")


def _plan_staged(widths: Widths) -> Optional[Tuple[StagePlan, ...]]:
    """The staged form's kernels, each at the tile of least cost
    (:func:`form_cost` of that kernel alone) that fits a block."""
    out = []
    for kind, tiles in (("head", HEAD_TILES), ("bottleneck", BOTTLENECK_TILES),
                        ("tail", TAIL_TILES)):
        fits = [p for p in (_bands(widths, th, tw, th, kind, min(4, th)) if kind == "head"
                            else _plan_for(widths, th, tw, RING_STAGES, 0, kind)
                            for th, tw in tiles) if p is not None and _fits(p)]
        if not fits:
            return None
        out.append(min(fits, key=lambda p: form_cost(widths, (p,))["ms"]))
    return tuple(out)


# ---- the cost that picks the form and the staged form's tiles ------------------

# The call the plan is chosen for: bs 8 at 640x640. Each term of the cost grows with
# the images' pixels, so the choice is the same at any batch and size but for the
# edges' partial tiles.
REFERENCE = (8, 640, 640)
# The H100 SXM's data-sheet rates: dense bf16 (989 TFLOP/s, as MACs) and HBM. Every
# byte is counted at HBM's rate, the weights the ring streams from L2 too (the data
# sheet gives no L2 rate): so counted, the cost takes the faster form at every
# width set timed on the card (PERF.md section 6).
PEAK_MACS = 989e12 / 2
PEAK_BYTES = 3.35e12


def _products(kind: str, widths: Widths, part: StagePlan) -> List[Tuple[int, int, int, int]]:
    """(layer, pixels, padded co, MACs per pixel and channel) of every product
    a whole tile of this kernel runs (a tile at the image's edge clips the
    products that write device memory), in the kernel's order; layers index
    the packed buffer: 0 stem, 1 conv1, 2 cv1|cv2, 3 + 2i / 4 + 2i m[i].cv1 /
    m[i].cv2, 3 + 2n cv3, 4 + 2n conv2. The bottleneck kind lists all n
    kernels' products, the last one's cv3 included."""
    c0, c1, ch, c2, n = widths
    p0, p1, ph, p2 = padded_widths(c0, c1, ch, c2)
    th, tw = part.th, part.tw
    out = []
    if kind in ("fused", "head"):
        g = tile_geometry(n, th, tw) if kind == "fused" else head_geometry(th, tw)
        for b in range(-(-g["r1"] // part.rb)):
            r = min(part.rb, g["r1"] - b * part.rb)
            out += [(0, (2 * r + 1 - (b > 0)) * g["cs"], p0, 108), (1, r * g["c1"], p1, 9 * p0)]
        if kind == "head":
            return out + [(2, th * tw, 2 * ph, p1)]
        out.append((2, g["r1"] * g["c1"], 2 * ph, p1))
        for i in range(n):
            out += [(3 + 2 * i, g["r1"] * g["c1"], ph, ph),
                    (4 + 2 * i, (g["r1"] - 2) * (g["c1"] - 2), ph, 9 * ph)]
        return out + [(3 + 2 * n, g["r3"] * g["c3"], p1, 2 * ph), (4 + 2 * n, th * tw, p2, 9 * p1)]
    if kind == "bottleneck":  # the tile and its ring of one pixel: 1x1, then 3x3 + residual
        for i in range(n):
            out += [(3 + 2 * i, (th + 2) * (tw + 2), ph, ph), (4 + 2 * i, th * tw, ph, 9 * ph)]
        return out + [(3 + 2 * n, th * tw, p1, 2 * ph)]
    return [(4 + 2 * n, th * tw, p2, 9 * p1)]


def _layer_bytes(widths: Widths) -> List[int]:
    """Bytes of every product's packed chunks, in the kernel's layer order."""
    return [co * 128 * (k // (16 * steps_per_chunk(k))) for co, k in packed_layout(
        widths[0], widths[4], *widths[1:4])]


def _part_cost(widths: Widths, part: StagePlan,
               shape: Tuple[int, int, int]) -> Tuple[int, int, int]:
    """(MACs done, every product's pixels rounded up to whole 64-row tiles as
    the wgmmas compute them; packed weight bytes streamed, every product's
    chunks once a tile; activation bytes through device memory) of one
    kind's kernels in a call of ``shape`` = (bs, h, w)."""
    bs, h, w = shape
    level = 8 if part.kind in ("fused", "tail") else 4
    tiles = bs * -(-(h // level) // part.th) * -(-(w // level) // part.tw)
    prods = _products(part.kind, widths, part)
    lb = _layer_bytes(widths)
    macs = tiles * sum(-(-m // 64) * 64 * co * k for _, m, co, k in prods)
    weights = tiles * sum(lb[layer] for layer, *_ in prods)
    _, p1, ph, _ = padded_widths(*widths[:4])
    n = widths[4]
    # bf16 channels a /4 pixel: the head writes cv1|cv2, each bottleneck reads and
    # writes m (the last reads the cv2 half and writes the C3 output), the tail reads it
    channels = {"fused": 0, "head": 2 * ph, "bottleneck": 2 * n * ph + p1, "tail": p1}
    return macs, weights, channels[part.kind] * 2 * bs * (h // 4) * (w // 4)


def _ms(macs: float, nbytes: float) -> float:
    return (macs / PEAK_MACS + nbytes / PEAK_BYTES) * 1e3


def own_macs(widths: Widths, shape: Tuple[int, int, int]) -> int:
    """The MACs of the output alone (no halo, no rounding), at the padded
    widths the kernel computes."""
    bs, h, w = shape
    c0, c1, ch, c2, n = widths
    p0, p1, ph, p2 = padded_widths(c0, c1, ch, c2)
    p8 = bs * (h // 8) * (w // 8)
    return (16 * p8 * p0 * 108 + 4 * p8 * (p1 * 9 * p0 + 2 * ph * p1 + n * 10 * ph * ph
                                           + p1 * 2 * ph) + p8 * p2 * 9 * p1)


def form_cost(widths: Widths, parts: Tuple[StagePlan, ...],
              shape: Tuple[int, int, int] = REFERENCE) -> Dict[str, float]:
    """The cost a form and its tiles are chosen by, for one call of
    ``shape``: ``halo`` (MACs done in 64-row tiles over :func:`own_macs`),
    ``weight_bytes`` (packed weights streamed), ``act_bytes`` (the staged
    form's activations through device memory) and ``ms`` = MACs done /
    ``PEAK_MACS`` + (weight + activation bytes) / ``PEAK_BYTES``."""
    macs, weights, act = (sum(x) for x in zip(*(_part_cost(widths, p, shape) for p in parts)))
    return dict(halo=macs / own_macs(widths, shape), weight_bytes=weights, act_bytes=act,
                ms=_ms(macs, weights + act))


def plan_early(c0: int, n: int, c1: Optional[int] = None, ch: Optional[int] = None,
               c2: Optional[int] = None) -> EarlyPlan:
    """The kernel's plan for widths c0, c1, ch, c2 (c1 = 2 c0, ch = c0, c2 =
    4 c0 where left out) and C3 depth n: of the fused form (:func:`_plan_fused`)
    and the staged one (:func:`_plan_staged`), the one of least cost
    (:func:`form_cost`) whose every kernel fits a block's shared memory, at
    ``REFERENCE``: every call of these widths takes it, whatever its batch
    and size (each of the cost's terms grows with the pixels). Raises,
    naming the widths, where the kernel does not take them or no
    form fits."""
    return _plan_early(widths_of(c0, n, c1, ch, c2))


def plan_of_form(widths: Widths, form: str) -> EarlyPlan:
    """The plan of one form for these widths, whether or not the cost picks
    that form (to time both); raises where the form does not fit."""
    _check_widths(widths)
    parts = (_plan_fused(widths),) if form == "fused" else _plan_staged(widths)
    if parts is None or parts[0] is None:
        raise ValueError(f"no tile of the {form} form fits {_width_text(*widths)} in "
                         f"{SMEM_LIMIT} bytes of shared memory")
    cost = form_cost(widths, parts)
    return EarlyPlan(form, parts, cost["halo"], cost["weight_bytes"], cost["act_bytes"],
                     cost["ms"])


def _check_widths(widths: Widths) -> None:
    c0, c1, ch, c2, n = widths
    p0, p1, ph, p2 = padded_widths(c0, c1, ch, c2)
    if (min(c0, c1, ch, c2) < 1 or p0 > MAX_C0 or p1 > MAX_C1 or ph > MAX_CH or p2 > MAX_C2
            or c2 % 2 or not 1 <= n <= 4):
        raise ValueError(
            f"no kernel for {_width_text(*widths)}: it takes stems of 1-{MAX_C0} channels, "
            f"conv1 up to {MAX_C1}, a C3 hidden width up to {MAX_CH}, an even conv2 width up "
            f"to {MAX_C2} and C3 depths 1-4; run layers 0..3 on cuDNN "
            "(early_pipeline=False) instead")


@functools.lru_cache(maxsize=None)  # on the launch path: the search runs once per width set
def _plan_early(widths: Widths) -> EarlyPlan:
    _check_widths(widths)
    plans = []
    for form in FORMS:
        try:
            plans.append(plan_of_form(widths, form))
        except ValueError:
            pass
    if not plans:
        raise ValueError(f"no tile fits {_width_text(*widths)} in {SMEM_LIMIT} bytes of "
                         "shared memory; run layers 0..3 on cuDNN (early_pipeline=False) "
                         "instead")
    return min(plans, key=lambda p: p.cost_ms)


def tile_for(ep: EarlyParams) -> Tuple[int, int]:
    """The /8-output tile the kernel takes for these widths (the fused
    kernel's, or the staged form's tail)."""
    plan = kernel_plan(ep)
    return plan.th, plan.tw


# ---- weight packing ------------------------------------------------------------

def stem_k144(w_stem: torch.Tensor) -> torch.Tensor:
    """(c0, 112) stem matrix (108 true columns: 9 taps x 12 planes) ->
    (c0, 144): each tap's 12 planes padded to 16 with zeros."""
    c0 = w_stem.shape[0]
    return F.pad(w_stem[:, :108].reshape(c0, 9, 12), (0, 4)).reshape(c0, STEM_K)


def _ceil16(k: int) -> int:
    return -(-k // 16) * 16


def _layers(widths: Widths) -> List[Tuple[int, int, int, int, int, int]]:
    """(taps, cin, co, cin_p, co_p, K of the true matrix) of every product the
    kernel runs, in its order: stem (its K = 144 layout is already 9 taps of
    16 planes), conv1, cv1 and cv2 (one product in the kernel), n x [m.cv1,
    m.cv2], cv3 (a 1x1 over the two halves of the concat, two "taps" of ch
    channels each), conv2. The true matrices' K is what
    :func:`extract_early_params` gives: a 1x1 on one input keeps its K, the
    others are padded to a multiple of 16 (the stem's is its K = 144 form)."""
    c0, c1, ch, c2, n = widths
    p0, p1, ph, p2 = padded_widths(c0, c1, ch, c2)
    out = [(9, 16, c0, 16, p0, STEM_K), (9, c0, c1, p0, p1, _ceil16(9 * c0)),
           (1, c1, ch, p1, ph, c1), (1, c1, ch, p1, ph, c1)]
    out += [(1, ch, ch, ph, ph, ch), (9, ch, ch, ph, ph, _ceil16(9 * ch))] * n
    return out + [(2, ch, c1, ph, p1, _ceil16(2 * ch)), (9, c1, c2, p1, p2, _ceil16(9 * c1))]


def _pad_conv(w: torch.Tensor, b: torch.Tensor, taps: int, cin: int, cin_p: int,
              co_p: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(co, K >= taps cin), (co,) -> (co_p, taps cin_p), (co_p,): each tap's
    cin columns followed by zeros up to cin_p, zero rows and biases past co."""
    co = w.shape[0]
    w = F.pad(w[:, :taps * cin].reshape(co, taps, cin), (0, cin_p - cin, 0, 0, 0, co_p - co))
    return w.reshape(co_p, taps * cin_p), F.pad(b, (0, co_p - co))


def _unpad_conv(w: torch.Tensor, b: torch.Tensor, taps: int, cin: int, co: int,
                k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The inverse of :func:`_pad_conv`: the true (co, k) matrix, zero past
    taps cin, and its (co,) bias."""
    w = w[:co].reshape(co, taps, -1)[:, :, :cin].reshape(co, taps * cin)
    return F.pad(w, (0, k - taps * cin)), b[:co]


def layer_matrices(ep: EarlyParams) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """(W (co_p, K_p), b (co_p,)) of every product the kernel runs, in its
    order, at the padded widths: stem (K = 144), conv1, cv1|cv2 as one
    (2 ch_p, c1_p), n x [m.cv1, m.cv2], cv3, conv2."""
    true = [(stem_k144(ep.w_stem), ep.b_stem), (ep.w_c1, ep.b_c1), (ep.w_cv1, ep.b_cv1),
            (ep.w_cv2, ep.b_cv2)]
    for i in range(ep.n):
        true += [(ep.w_m_cv1[i], ep.b_m_cv1[i]), (ep.w_m_cv2[i], ep.b_m_cv2[i])]
    true += [(ep.w_cv3, ep.b_cv3), (ep.w_c2, ep.b_c2)]
    out = [_pad_conv(w, b, taps, cin, cin_p, co_p)
           for (w, b), (taps, cin, _, cin_p, co_p, _) in zip(true, _layers(ep.widths))]
    (w1, b1), (w2, b2) = out[2], out[3]
    return out[:2] + [(torch.cat([w1, w2]), torch.cat([b1, b2]))] + out[4:]


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


def packed_layout(c0: int, n: int, c1: Optional[int] = None, ch: Optional[int] = None,
                  c2: Optional[int] = None) -> List[Tuple[int, int]]:
    """(co_p, K_p) of every product in :func:`layer_matrices`' order for
    widths c0, c1, ch, c2 (the v6 ratios of c0 where left out) and C3 depth n."""
    layers = _layers(widths_of(c0, n, c1, ch, c2))
    out = [(co_p, taps * cin_p) for taps, _, _, cin_p, co_p, _ in layers]
    return out[:2] + [(2 * out[2][0], out[2][1])] + out[4:]


def packed_numel(c0: int, n: int, c1: Optional[int] = None, ch: Optional[int] = None,
                 c2: Optional[int] = None) -> int:
    """Elements of the buffer :func:`pack_weights` makes for these widths."""
    return sum(co * 64 * (k // (16 * steps_per_chunk(k))) + co
               for co, k in packed_layout(c0, n, c1, ch, c2))


def unpack_weights(wpack: torch.Tensor, c0: int, n: int, c1: Optional[int] = None,
                   ch: Optional[int] = None, c2: Optional[int] = None) -> EarlyParams:
    """The inverse of :func:`pack_weights`: the packed buffer of these widths
    -> EarlyParams at the true widths (bit for bit: both are bf16)."""
    widths = widths_of(c0, n, c1, ch, c2)
    if wpack.dim() != 1 or wpack.numel() != packed_numel(c0, n, c1, ch, c2):
        raise ValueError(f"packed weights of {tuple(wpack.shape)} elements do not hold "
                         f"{_width_text(*widths)} ({packed_numel(c0, n, c1, ch, c2)} elements)")
    layout = packed_layout(c0, n, c1, ch, c2)
    mats, pos = [], 0
    for co, k in layout:
        size = co * 64 * (k // (16 * steps_per_chunk(k)))
        mats.append(unpack_chunks(wpack[pos:pos + size].reshape(-1, co, 64), k))
        pos += size
    biases = []
    for co, _ in layout:
        biases.append(wpack[pos:pos + co])
        pos += co
    half = layout[2][0] // 2  # cv1 | cv2: two halves of ch_p rows
    mats[2:3] = [mats[2][:half], mats[2][half:]]
    biases[2:3] = [biases[2][:half], biases[2][half:]]
    true = [_unpad_conv(w, b, taps, cin, co, k)
            for w, b, (taps, cin, co, _, _, k) in zip(mats, biases, _layers(widths))]
    stem = true[0][0].reshape(widths[0], 9, 16)[:, :, :12].reshape(widths[0], 108)
    true[0] = (F.pad(stem, (0, 4)), true[0][1])
    m = range(4, 4 + 2 * n, 2)
    return EarlyParams(
        *true[0], *true[1], *true[2],
        tuple(true[i][0] for i in m), tuple(true[i][1] for i in m),
        tuple(true[i + 1][0] for i in m), tuple(true[i + 1][1] for i in m),
        *true[3], *true[-2], *true[-1])


def _packed(ep: EarlyParams, device: torch.device) -> torch.Tensor:
    """The packed weights on ``device``, cached per device."""
    key = str(device)
    if key not in ep._packed:
        ep._packed[key] = pack_weights(ep).to(device)
    return ep._packed[key]


# ---- the wrapper -----------------------------------------------------------------

def _lib_with(widths: Widths, extra: Tuple[str, ...] = (),
              source: str = "early_pipeline") -> ctypes.CDLL:
    """The kernel's library for the padded set of these widths (one build per
    set), built with the ``extra`` -D switches; ``source`` may be the path of
    another version of the kernel's source with the same C interface."""
    lib = _build.load(source, defines=kernel_defines(*widths[:4]) + tuple(extra))
    if not getattr(lib, "_typed", False):
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.early_pipeline_launch.argtypes = [vp, vp, vp, vp, i, i, i, i, i, i, i, i, i,
                                              ctypes.POINTER(ctypes.c_int), vp]
        lib.early_pipeline_launch.restype = i
        lib.early_pipeline_profile_slots.argtypes = []
        lib.early_pipeline_profile_slots.restype = i
        if hasattr(lib, "early_pipeline_launch_staged"):  # a source of the fused form alone lacks it
            lib.early_pipeline_launch_staged.argtypes = [vp, vp, vp, vp, i, i, i, i, i, i, i, i, i,
                                                         ctypes.POINTER(ctypes.c_int), vp]
            lib.early_pipeline_launch_staged.restype = i
            lib.early_pipeline_workspace.argtypes = [i, i, i]
            lib.early_pipeline_workspace.restype = ctypes.c_longlong
        lib._typed = True
    return lib


def _lib(widths: Widths, profile: bool = False) -> ctypes.CDLL:
    return _lib_with(widths, ("EARLY_PROFILE",) if profile else ())


def kernel_plan(ep: EarlyParams) -> EarlyPlan:
    """The plan for these weights; raises on widths the kernel does not take."""
    return plan_early(ep.c0, ep.n, ep.c1, ep.ch, ep.c2)


def _launch(lib: ctypes.CDLL, images: torch.Tensor, wpack: torch.Tensor, widths: Widths,
            prof: torch.Tensor = None, plan: Optional[EarlyPlan] = None) -> torch.Tensor:
    """One call of the kernel's library in the plan's form (``plan_early``'s
    where left out): the fused kernel, or the staged form's kernels with their
    workspace, allocated here on the images' stream."""
    c0, c1, ch, c2, n = widths
    plan = plan_early(c0, n, c1, ch, c2) if plan is None else plan
    bs, h, w, _ = images.shape
    out = torch.empty((bs, h // 8, w // 8, c2), dtype=torch.bfloat16, device=images.device)
    ints = plan.as_ints()[1:]
    with torch.cuda.device(images.device):
        stream = torch.cuda.current_stream(images.device).cuda_stream
        if plan.form == "fused":
            err = lib.early_pipeline_launch(
                images.data_ptr(), out.data_ptr(), wpack.data_ptr(),
                prof.data_ptr() if prof is not None else None,
                bs, h, w, *padded_widths(c0, c1, ch, c2), c2, n,
                (ctypes.c_int * len(PART_FIELDS))(*ints[:len(PART_FIELDS)]), stream)
        else:
            if prof is not None:
                raise ValueError("clock stamps are taken in the fused form only")
            work = torch.empty(lib.early_pipeline_workspace(bs, h, w), dtype=torch.uint8,
                               device=images.device)
            err = lib.early_pipeline_launch_staged(
                images.data_ptr(), out.data_ptr(), wpack.data_ptr(), work.data_ptr(),
                bs, h, w, *padded_widths(c0, c1, ch, c2), c2, n,
                (ctypes.c_int * len(ints))(*ints), stream)
    if err != 0:
        raise RuntimeError(f"early_pipeline kernel launch failed: error {err} "
                           f"({_width_text(*widths)}, {plan.form} form, /8 tile "
                           f"{plan.th}x{plan.tw})")
    early_pipeline.launches += 1
    early_pipeline.last_input = tuple(images.shape)
    return out


def _check_op(images: torch.Tensor, wpack: torch.Tensor, widths: Widths) -> None:
    if images.dtype != torch.uint8 or images.dim() != 4 or images.shape[-1] != 3:
        raise ValueError(f"expected (bs, H, W, 3) uint8 images, got {tuple(images.shape)} "
                         f"{images.dtype}")
    if images.shape[1] % 8 or images.shape[2] % 8 or not images.is_contiguous():
        raise ValueError(f"image batch {tuple(images.shape)}: need contiguous images with H, "
                         "W multiples of 8")
    if wpack.dtype != torch.bfloat16 or wpack.device != images.device:
        raise ValueError(f"packed weights {wpack.dtype} on {wpack.device}: need bf16 on "
                         f"{images.device}")
    c0, c1, ch, c2, n = widths
    if wpack.numel() != packed_numel(c0, n, c1, ch, c2):
        raise ValueError(f"packed weights of {wpack.numel()} elements do not hold "
                         f"{_width_text(*widths)}")


@torch.library.custom_op("ayolov2::early_pipeline", mutates_args=(), device_types="cpu")
def early_pipeline_op(images: torch.Tensor, wpack: torch.Tensor, c0: int, n: int,
                      c1: Optional[int] = None, ch: Optional[int] = None,
                      c2: Optional[int] = None) -> torch.Tensor:
    """The operator: (bs, H, W, 3) uint8, the packed bf16 weights of widths
    c0, c1, ch, c2 (the v6 ratios of c0 where left out) and C3 depth n ->
    (bs, H/8, W/8, c2) bf16. This body is the CPU implementation: the plain
    version on the unpacked weights, at any widths."""
    widths = widths_of(c0, n, c1, ch, c2)
    _check_op(images, wpack, widths)
    return early_pipeline_ref(images, unpack_weights(wpack, c0, n, c1, ch, c2))


@early_pipeline_op.register_kernel("cuda")
def _early_pipeline_cuda(images: torch.Tensor, wpack: torch.Tensor, c0: int, n: int,
                         c1: Optional[int] = None, ch: Optional[int] = None,
                         c2: Optional[int] = None) -> torch.Tensor:
    widths = widths_of(c0, n, c1, ch, c2)
    _check_op(images, wpack, widths)
    plan_early(c0, n, c1, ch, c2)  # raises before any build is tried
    return _launch(_lib(widths), images, wpack, widths)


@early_pipeline_op.register_fake
def _early_pipeline_fake(images: torch.Tensor, wpack: torch.Tensor, c0: int, n: int,
                         c1: Optional[int] = None, ch: Optional[int] = None,
                         c2: Optional[int] = None) -> torch.Tensor:
    bs, h, w, _ = images.shape
    c2 = widths_of(c0, n, c1, ch, c2)[3]
    return images.new_empty((bs, h // 8, w // 8, c2), dtype=torch.bfloat16)


def early_pipeline(images: torch.Tensor, ep: EarlyParams) -> torch.Tensor:
    """Fused stem/conv1/C3/conv2: (bs, H, W, 3) uint8 raw pixels ->
    (bs, H/8, W/8, c2) bf16 NHWC, through the operator. CPU tensors take the
    plain version at any widths; CUDA tensors launch the kernel (counted in
    ``early_pipeline.launches``), or raise where it does not take the widths;
    other devices raise."""
    _check(images, ep)
    if images.device.type not in ("cpu", "cuda"):
        raise ValueError(f"early_pipeline runs on cpu or cuda, not {images.device}")
    if images.device.type == "cuda":
        kernel_plan(ep)  # raises before any build is tried
    c0, c1, ch, c2, n = ep.widths
    return early_pipeline_op(images, _packed(ep, images.device), c0, n, c1, ch, c2)


early_pipeline.launches = 0
early_pipeline.last_input = None  # the (bs, H, W, 3) of the kernel's last launch


def slab_halo(n: int) -> Tuple[int, int]:
    """(t, u): the /8 rows of input above and below a /8 output row's own 8
    input rows that the row reads, in whole /8 rows, for C3 depth ``n``.
    Output row r reads input rows 8r - 8 - 4n ... 8r + 9 + 4n: conv2
    (3x3/s2/p1) /4 rows 2r - 1 ... 2r + 1, the n bottlenecks' 3x3 convs one
    /4 row more each side apiece, conv1 (3x3/s2/p1) /2 rows 2q - 1 ... 2q +
    1 of /4 row q, and the stem (6x6/s2/p2) input rows 2p - 2 ... 2p + 3 of
    /2 row p: 12 + 4n rows above the 8 and 2 + 4n below them."""
    return -(-(8 + 4 * n) // 8), -(-(2 + 4 * n) // 8)


def slab_rows(a: int, b: int, h: int, n: int) -> Tuple[int, int]:
    """The input rows [lo, hi) that /8 output rows [a, b) of an image of
    height ``h`` read: [8 (a - t), 8 (b + u)) clamped to [0, h), with (t, u)
    :func:`slab_halo`. They start on a multiple of 8, so each of the
    network's strides keeps its phase."""
    t, u = slab_halo(n)
    return max(0, 8 * (a - t)), min(h, 8 * (b + u))


def early_pipeline_rows(images: torch.Tensor, wpack: torch.Tensor, a: int, b: int, c0: int,
                        n: int, c1: Optional[int] = None, ch: Optional[int] = None,
                        c2: Optional[int] = None) -> torch.Tensor:
    """Rows [a, b) of the operator's /8 output for whole (bs, H, W, 3) uint8
    ``images``, computed from the input rows they read alone
    (:func:`slab_rows`): the operator (kernel on the card, plain version on
    the CPU) on that slab, its output cropped to [a, b). The operator
    zero-pads each layer at its input's edge, which is right only at the
    image's own top and bottom; the rows that padding reaches at a slab's
    inner edge lie in the halo and are dropped. The slab is a view of the
    images for bs 1 and a copy for bs > 1. No rows: an empty output and no
    launch."""
    bs, h, w, _ = images.shape
    c2_true = widths_of(c0, n, c1, ch, c2)[3]
    if b <= a:
        return images.new_empty((bs, 0, w // 8, c2_true), dtype=torch.bfloat16)
    lo, hi = slab_rows(a, b, h, n)
    slab = images[:, lo:hi]
    if not slab.is_contiguous():
        slab = slab.contiguous()
    out = early_pipeline_op(slab, wpack, c0, n, c1, ch, c2)
    return out[:, a - lo // 8:b - lo // 8]


PROFILE_SLOTS = ("wait for raw rows", "convert to s2d", "stem", "conv1", "cv1|cv2",
                 "bottlenecks", "cv3", "conv2")
PROFILE_INNER = ("warpgroups: waiting for weights", "warpgroups: ldmatrix + wgmma",
                 "warpgroups: epilogue", "warpgroups: no item this round",
                 "warpgroups: at the block barrier")


def early_pipeline_profile(images: torch.Tensor, ep: EarlyParams) -> Dict[str, float]:
    """Where the fused kernel's time goes: one launch of a build of the same
    source with clock stamps at each layer boundary (``-DEARLY_PROFILE``), in
    the fused form whichever form the plan takes; returns each phase's share
    of the stamped clocks, summed over all blocks."""
    _check(images, ep)
    plan = plan_of_form(ep.widths, "fused")
    lib = _lib(ep.widths, profile=True)
    slots = lib.early_pipeline_profile_slots()
    prof = torch.zeros((4096, slots), dtype=torch.int64, device=images.device)
    _launch(lib, images, _packed(ep, images.device), ep.widths, prof, plan)
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
