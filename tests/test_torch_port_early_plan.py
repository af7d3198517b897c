"""The early-network kernel's tile and shared-memory plan
(``ayolov2_torch.ops.early_pipeline.plan_early``) in both of its forms, the
fused one and the staged one, checked on the CPU: what can be verified
without a card, before the kernel runs. The staged form is also emulated
here tile by tile, each kernel's tile computed from the input rows it reads
alone, against the plain version bit for bit."""

import itertools

import numpy as np
import pytest
import torch

from ayolov2_torch.ops import early_pipeline as early

torch.set_num_threads(1)

VARIANTS = {"n": (16, 1), "s": (32, 1), "m": (48, 2), "l": (64, 3), "x": (80, 4)}
# every shipped width set, (c0, c1, ch, c2, n): the v6 models, yolov5l_0.5, the
# width-1.05 config and the stem-8 set (yolov5s at width 0.125)
SETS = {v: early.widths_of(c0, n) for v, (c0, n) in VARIANTS.items()}
SETS.update({"l_0.5": (80, 160, 80, 320, 1), "1.05": (72, 136, 68, 272, 4),
             "stem8": (8, 16, 8, 32, 1)})
BUFFERS = ("ring", "c1", "raw", "s2d", "stem", "mcat", "mt", "bias")
# the fused kernel's stem buffers are dead before the C3's come alive: they share space
SHARED_SPACE = {frozenset(p) for p in itertools.product(("s2d", "stem"), ("mcat", "mt"))}
# the fused form's weight stream at bs 8, 640x640 before the staged form (bytes, as
# the 2x2 tile streams it: every packed weight once a tile)
FUSED_2X2_STREAM = {"x": 33.2e9, "1.05": 29.2e9}


def _plans():
    """(set, form) of every width set and each form that fits it."""
    out = []
    for name, widths in SETS.items():
        for form in early.FORMS:
            try:
                early.plan_of_form(widths, form)
            except ValueError:
                continue
            out.append((name, form))
    return out


PLANS = _plans()


def _offsets(part):
    return {b: getattr(part, f"off_{b}") for b in BUFFERS}


def test_every_set_has_both_forms():
    assert {(n, f) for n in SETS for f in early.FORMS} == set(PLANS)


@pytest.mark.parametrize("name,form", PLANS)
def test_plan_fits_one_block(name, form):
    plan = early.plan_of_form(SETS[name], form)
    kinds = ("fused",) if form == "fused" else ("head", "bottleneck", "tail")
    assert tuple(p.kind for p in plan.parts) == kinds
    for part in plan.parts:
        off = _offsets(part)
        end = max(off[b] + part.sizes[b] for b in part.sizes)
        assert end + 1024 <= part.total  # 1024 bytes of slack to align the ring
        assert part.total + early.STATIC_SMEM <= early.SMEM_LIMIT == 232448
        assert part.stages == early.RING_STAGES
        assert part.as_ints() == [getattr(part, f) for f in early.PART_FIELDS]
        if part.kind in ("fused", "head"):
            r1 = (early.tile_geometry(SETS[name][4], part.th, part.tw)["r1"]
                  if part.kind == "fused" else part.th)
            assert 1 <= part.rb <= r1
        else:
            assert part.rb == 0
    tiles = early.TILES if form == "fused" else early.TAIL_TILES
    assert (plan.th, plan.tw) in tiles
    ints = plan.as_ints()
    assert len(ints) == len(early.PLAN_FIELDS) == 1 + 3 * 14
    assert ints[0] == early.FORMS.index(form)
    for i, part in enumerate(plan.parts):
        assert ints[1 + 14 * i:15 + 14 * i] == part.as_ints()
    assert not any(ints[1 + 14 * len(plan.parts):])


class _FakeWidths:
    def __init__(self, c0, n):
        self.c0, self.c1, self.ch, self.c2, self.n = c0, 2 * c0, c0, 4 * c0, n


@pytest.mark.parametrize("name,form", PLANS)
def test_live_buffers_do_not_overlap(name, form):
    for part in early.plan_of_form(SETS[name], form).parts:
        off = _offsets(part)
        for a, b in itertools.combinations(sorted(part.sizes), 2):
            if part.kind == "fused" and frozenset((a, b)) in SHARED_SPACE:
                continue
            disjoint = (off[a] + part.sizes[a] <= off[b] or off[b] + part.sizes[b] <= off[a])
            assert disjoint, (part.kind, a, b, off[a], part.sizes[a], off[b], part.sizes[b])
        if part.kind == "fused":  # the sharing really saves space
            assert off["s2d"] == off["mcat"]
        # each kind holds the buffers its kernel uses, and no others
        want = {"fused": set(BUFFERS), "head": {"ring", "c1", "raw", "s2d", "stem", "bias"},
                "bottleneck": {"ring", "mcat", "mt", "bias"}, "tail": {"ring", "c1", "bias"}}
        assert set(part.sizes) == want[part.kind]


@pytest.mark.parametrize("name,form", PLANS)
def test_alignment_of_swizzled_chunks_and_ldmatrix_rows(name, form):
    widths = SETS[name]
    p0, p1, ph, p2 = early.padded_widths(*widths[:4])
    for part in early.plan_of_form(widths, form).parts:
        off = _offsets(part)
        # a 128-byte-swizzled chunk needs its stage on a 1024-byte boundary
        assert off["ring"] == 0 and part.stage_bytes % 1024 == 0
        assert part.stage_bytes == early.stage_rows(p0, p1, ph, p2) * 128
        assert part.sizes["ring"] == part.stages * part.stage_bytes
        for b in part.sizes:
            assert off[b] % 128 == 0, b
    # ldmatrix rows are 16 bytes; a pitch that is an odd multiple of 16 bytes
    # puts the 8 rows of a phase in 8 different 16-byte bank groups
    for pitch in early._pitches(widths).values():
        assert pitch % 16 == 0 and (pitch // 16) % 2 == 1
    # the stem reads two planes of 16-byte pixels through a descriptor: 8 pixels are
    # one 128-byte core matrix
    assert early.S2D_BYTES == 32
    for part in early.plan_of_form(widths, form).parts:
        if part.kind in ("fused", "head"):
            g = (early.tile_geometry(widths[4], part.th, part.tw) if part.kind == "fused"
                 else early.head_geometry(part.th, part.tw))
            assert g["raw_pitch"] % 8 == 0 and g["raw_pitch"] >= 6 * g["cs"] + 7


def test_halo_of_yolov5s_is_no_worse_than_the_8x8_tile():
    """yolov5s keeps the fused form at the 8x8 tile with bands of 10, the plan
    it had before the staged form (the card's times keep it there: PERF.md)."""
    c0, n = VARIANTS["s"]
    plan = early.plan_early(c0, n)
    assert plan.form == "fused" and (plan.th, plan.tw) == (8, 8) and plan.parts[0].rb == 10
    assert plan.parts[0].total == 195968
    assert plan == early.plan_of_form(SETS["s"], "fused")
    assert early.halo_factor(c0, n, plan.th, plan.tw) <= 1.27
    assert plan.halo == early.form_cost(SETS["s"], plan.parts)["halo"]
    assert early.tile_for(_FakeWidths(c0, n)) == (8, 8)


@pytest.mark.parametrize("name,form", [(n, f) for n, f in PLANS
                                       if f == "fused" or n in ("x", "1.05", "s")])
def test_band_buffers_cover_every_band(name, form):
    """Bands of rb conv1 rows: the stem buffer holds 2 rb + 1 rows, the
    space-to-depth buffer 2 more, the raw buffer two rows for each of those."""
    widths = SETS[name]
    pt = early._pitches(widths)
    for part in early.plan_of_form(widths, form).parts:
        if part.kind not in ("fused", "head"):
            continue
        g = (early.tile_geometry(widths[4], part.th, part.tw) if part.kind == "fused"
             else early.head_geometry(part.th, part.tw))
        bands = -(-g["r1"] // part.rb)
        rows = [min(part.rb, g["r1"] - b * part.rb) for b in range(bands)]
        assert sum(rows) == g["r1"] and all(r >= 1 for r in rows)
        for b, r in enumerate(rows):
            first = 1 if b else 0
            stem_rows = 2 * r + 1
            assert stem_rows * 2 * g["half0"] * pt["p0"] <= part.sizes["stem"]
            s2d_rows = stem_rows - first + 2
            assert s2d_rows * g["cs"] * early.S2D_BYTES <= part.sizes["s2d"]
            assert 2 * s2d_rows * g["raw_pitch"] <= part.sizes["raw"]
        if part.kind == "fused":  # the C3 output (parity-split) reuses the conv1 buffer
            assert g["r3"] * 2 * g["half3"] * pt["p1"] <= part.sizes["c1"]


@pytest.mark.parametrize("c0,n", [(88, 1), (96, 1), (32, 0), (32, 5)])
def test_plan_raises_on_widths_the_kernel_does_not_take(c0, n):
    with pytest.raises(ValueError, match=f"c0={c0}"):
        early.plan_early(c0, n)


@pytest.mark.parametrize("name", ["x", "1.05"])
def test_wide_sets_take_the_staged_form(name):
    """yolov5x and the width-1.05 set: the staged form, computing at most 2.2
    times the MACs of their output (in 64-row tiles) where the fused form's
    2x2 tile computes 11-19 times, and streaming at most an eighth of the
    weight bytes the 2x2 tile streamed at bs 8, 640x640."""
    widths = SETS[name]
    plan = early.plan_early(widths[0], widths[4], *widths[1:4])
    fused = early.plan_of_form(widths, "fused")
    assert plan.form == "staged" and (fused.th, fused.tw) == (2, 2)
    assert plan.halo <= 2.2 < fused.halo
    assert early.REFERENCE == (8, 640, 640)
    assert plan.weight_bytes <= FUSED_2X2_STREAM[name] / 8 < fused.weight_bytes
    assert plan.cost_ms < fused.cost_ms


@pytest.mark.parametrize("name", sorted(SETS))
def test_plan_takes_the_form_of_least_modelled_time(name):
    """The form is chosen by the cost alone: the plan is the cheaper of the
    two forms' plans, and the cost is the MACs done (in 64-row tiles) at the
    H100's data-sheet bf16 rate plus the weight and activation bytes at its
    HBM rate, nothing fitted."""
    widths = SETS[name]
    plans = {f: early.plan_of_form(widths, f) for f in early.FORMS}
    plan = early.plan_early(widths[0], widths[4], *widths[1:4])
    assert plan == min(plans.values(), key=lambda p: p.cost_ms)
    assert (early.PEAK_MACS, early.PEAK_BYTES) == (494.5e12, 3.35e12)
    for p in plans.values():
        cost = early.form_cost(widths, p.parts)
        assert (cost["halo"], cost["weight_bytes"], cost["ms"]) == (
            p.halo, p.weight_bytes, p.cost_ms)
        assert (cost["act_bytes"] == 0) == (p.form == "fused")
        assert p.halo >= 1.0
        macs = cost["halo"] * early.own_macs(widths, early.REFERENCE)
        assert cost["ms"] == pytest.approx(
            (macs / 494.5e12 + (cost["weight_bytes"] + cost["act_bytes"]) / 3.35e12) * 1e3)


@pytest.mark.parametrize("name", sorted(SETS))
def test_form_cost_grows_with_the_batch_alone(name):
    """The plan is chosen once per width set (at ``REFERENCE``) and every call
    of those widths takes it: each of the cost's terms is the batch times
    one image's, so no batch would pick the other form."""
    widths = SETS[name]
    for form in early.FORMS:
        parts = early.plan_of_form(widths, form).parts
        for h, w in ((640, 640), (336, 640), (800, 800), (72, 136)):
            one, many = (early.form_cost(widths, parts, (bs, h, w)) for bs in (1, 16))
            assert many["weight_bytes"] == 16 * one["weight_bytes"]
            assert many["act_bytes"] == 16 * one["act_bytes"]
            assert many["halo"] == pytest.approx(one["halo"])
            assert many["ms"] == pytest.approx(16 * one["ms"])


# ---- the staged form, emulated tile by tile --------------------------------------


def _seeded_params(widths, seed):
    """Kernel weights of these widths from numpy: He-scaled, biases ~ N(0, 0.1),
    every K padded as extract_early_params pads it."""
    c0, c1, ch, c2, n = widths
    rng = np.random.default_rng(seed)

    def mat(co, k_true, k_pad=None):
        k_pad = -(-k_true // 16) * 16 if k_pad is None else k_pad
        w = np.zeros((co, k_pad), np.float32)
        w[:, :k_true] = rng.normal(0, np.sqrt(2.0 / k_true), (co, k_true))
        b = rng.normal(0, 0.1, co).astype(np.float32)
        return torch.from_numpy(w).to(torch.bfloat16), torch.from_numpy(b).to(torch.bfloat16)

    stem, conv1 = mat(c0, 108, 112), mat(c1, 9 * c0)
    cv1, cv2 = mat(ch, c1, c1), mat(ch, c1, c1)
    m1 = [mat(ch, ch, ch) for _ in range(n)]
    m2 = [mat(ch, 9 * ch) for _ in range(n)]
    cv3, conv2 = mat(c1, 2 * ch), mat(c2, 9 * c1)
    return early.EarlyParams(*stem, *conv1, *cv1, tuple(w for w, _ in m1),
                             tuple(b for _, b in m1), tuple(w for w, _ in m2),
                             tuple(b for _, b in m2), *cv2, *cv3, *conv2)


def _crop(x, rows, cols):
    """x (NCHW) at rows [lo, hi) and cols [lo, hi), zeros outside it."""
    (r0, r1), (q0, q1) = rows, cols
    _, _, h, w = x.shape
    out = x.new_zeros((*x.shape[:2], r1 - r0, q1 - q0))
    a, b, c, d = max(r0, 0), min(r1, h), max(q0, 0), min(q1, w)
    if a < b and c < d:
        out[:, :, a - r0:b - r0, c - q0:d - q0] = x[:, :, a:b, c:d]
    return out


def _inside(x, r0, q0, h, w):
    """x with every pixel outside the h x w image zeroed; (r0, q0) is its (0, 0)."""
    rows, cols = torch.arange(x.shape[2]) + r0, torch.arange(x.shape[3]) + q0
    keep = ((rows >= 0) & (rows < h))[:, None] & ((cols >= 0) & (cols < w))[None, :]
    return x * keep.to(x.dtype)


def _tiles(part, h, w):
    for y0 in range(0, h, part.th):
        for x0 in range(0, w, part.tw):
            yield y0, x0, min(part.th, h - y0), min(part.tw, w - x0)


def emulate_staged(images, ep, plan):
    """The staged form as its kernels compute it: every tile of every kernel
    from the input rows and columns ``stage_window`` says it reads (zeros
    outside the image), with the same products and the same rounding as the
    plain version; each tile keeps only its own pixels inside the image.
    Also returns, per kind, the windows the tiles read."""
    conv = early._conv_silu
    bs, h, w, _ = images.shape
    c0, c1, ch, c2, n = ep.widths
    head, bott, tail = plan.parts
    raw = images.permute(0, 3, 1, 2).float()
    windows = {"head": set(), "bottleneck": set(), "tail": set()}

    def window(kind, y0, x0, r, c):
        rows, cols = early.stage_window(kind, y0, r), early.stage_window(kind, x0, c)
        windows[kind].add((rows, cols))
        return rows, cols

    g = torch.zeros((bs, 2 * ch, h // 4, w // 4), dtype=torch.bfloat16)
    for y0, x0, r, c in _tiles(head, h // 4, w // 4):
        rows, cols = window("head", y0, x0, head.th, head.tw)
        x = _crop(raw, rows, cols)
        hr, hc = (rows[1] - rows[0]) // 2, (cols[1] - cols[0]) // 2
        x = x.reshape(bs, 3, hr, 2, hc, 2).permute(0, 3, 5, 1, 2, 4).reshape(bs, 12, hr, hc)
        x = _inside(conv(x, ep.w_stem, ep.b_stem, 3), 2 * y0 - 1, 2 * x0 - 1, h // 2, w // 2)
        x = conv(x, ep.w_c1, ep.b_c1, 3, 2)
        y = torch.cat([conv(x, ep.w_cv1, ep.b_cv1, 1), conv(x, ep.w_cv2, ep.b_cv2, 1)], 1)
        g[:, :, y0:y0 + r, x0:x0 + c] = y[:, :, :r, :c]
    m = g[:, :ch]
    c3 = torch.zeros((bs, c1, h // 4, w // 4), dtype=torch.bfloat16)
    for i in range(n):
        out = torch.zeros_like(m)
        for y0, x0, r, c in _tiles(bott, h // 4, w // 4):
            rows, cols = window("bottleneck", y0, x0, bott.th, bott.tw)
            x = _crop(m, rows, cols)
            t = _inside(conv(x, ep.w_m_cv1[i], ep.b_m_cv1[i], 1), rows[0], cols[0], h // 4, w // 4)
            y = (x[:, :, 1:-1, 1:-1].float()
                 + conv(t, ep.w_m_cv2[i], ep.b_m_cv2[i], 3).float()).to(torch.bfloat16)
            out[:, :, y0:y0 + r, x0:x0 + c] = y[:, :, :r, :c]
            if i == n - 1:  # the last bottleneck kernel runs cv3 on its tile
                y2 = g[:, ch:, y0:y0 + r, x0:x0 + c]
                c3[:, :, y0:y0 + r, x0:x0 + c] = conv(torch.cat([y[:, :, :r, :c], y2], 1),
                                                      ep.w_cv3, ep.b_cv3, 1)
        m = out
    y = torch.zeros((bs, c2, h // 8, w // 8), dtype=torch.bfloat16)
    for z0, x0, r, c in _tiles(tail, h // 8, w // 8):
        rows, cols = window("tail", z0, x0, tail.th, tail.tw)
        y[:, :, z0:z0 + r, x0:x0 + c] = conv(_crop(c3, rows, cols), ep.w_c2, ep.b_c2, 3, 2)[
            :, :, :r, :c]
    return y.permute(0, 2, 3, 1).contiguous(), windows


def _field(a, b, convs):
    """Input rows [lo, hi) that output rows [a, b) of a chain of convs read;
    ``convs`` are (kernel, stride, padding), the last applied first."""
    for k, s, p in convs:
        a, b = s * a - p, s * (b - 1) - p + k
    return a, b


@pytest.mark.parametrize("name,hw", list(itertools.product(["x", "1.05"], [(64, 96), (72, 136)])))
def test_staged_emulation_equals_the_plain_version(name, hw):
    """Two images of 64x96 and of a ragged 72x136 through the staged form of
    the x and 1.05 widths, tile by tile at the plan's tiles, equal
    early_pipeline_ref bit for bit; and each tile reads exactly the rows its
    convs read: the receptive field of its own rows and nothing more."""
    widths = SETS[name]
    plan = early.plan_early(widths[0], widths[4], *widths[1:4])
    assert plan.form == "staged"
    ep = _seeded_params(widths, seed=hw[1])
    imgs = torch.from_numpy(np.random.default_rng(hw[0]).integers(0, 256, (2, *hw, 3),
                                                                  dtype=np.uint8))
    got, windows = emulate_staged(imgs, ep, plan)
    want = early.early_pipeline_ref(imgs, ep)
    assert got.shape == want.shape == (2, hw[0] // 8, hw[1] // 8, widths[3])
    assert torch.equal(got, want)
    # the tiles cover each level, ragged at its bottom and right edges
    head, bott, tail = plan.parts
    assert len(windows["tail"]) == -(-hw[0] // 8 // tail.th) * -(-hw[1] // 8 // tail.tw)
    assert len(windows["bottleneck"]) == -(-hw[0] // 4 // bott.th) * -(-hw[1] // 4 // bott.tw)
    # stem 6x6/s2/p2 then conv1 3x3/s2/p1; a bottleneck's 1x1 then 3x3/p1; conv2 3x3/s2/p1
    chains = {"head": ((3, 2, 1), (6, 2, 2)), "bottleneck": ((3, 1, 1), (1, 1, 0)),
              "tail": ((3, 2, 1),)}
    for kind, part in zip(("head", "bottleneck", "tail"), plan.parts):
        for y0 in (0, part.th, 5 * part.th):
            assert early.stage_window(kind, y0, part.th) == _field(y0, y0 + part.th, chains[kind])
