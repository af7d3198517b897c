"""The early-network kernel's tile and shared-memory plan
(``ayolov2_torch.ops.early_pipeline.plan_early``), checked on the CPU: what
can be verified without a card, before the kernel runs."""

import itertools

import pytest
import torch

from ayolov2_torch.ops import early_pipeline as early

torch.set_num_threads(1)

VARIANTS = {"n": (16, 1), "s": (32, 1), "m": (48, 2), "l": (64, 3), "x": (80, 4)}
BUFFERS = ("ring", "c1", "raw", "s2d", "stem", "mcat", "mt", "bias")
# the stem's buffers are dead before the C3's come alive: they share space
SHARED_SPACE = {frozenset(p) for p in itertools.product(("s2d", "stem"), ("mcat", "mt"))}


def _offsets(plan):
    return {b: getattr(plan, f"off_{b}") for b in BUFFERS}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_plan_fits_one_block(variant):
    c0, n = VARIANTS[variant]
    plan = early.plan_early(c0, n)
    off = _offsets(plan)
    end = max(off[b] + plan.sizes[b] for b in BUFFERS)
    assert end + 1024 <= plan.total  # 1024 bytes of slack to align the ring
    assert plan.total + early.STATIC_SMEM <= early.SMEM_LIMIT == 232448
    assert (plan.th, plan.tw) in early.TILES and (plan.th, plan.tw) == early.tile_for(
        _FakeWidths(c0, n))
    r1 = early.tile_geometry(n, plan.th, plan.tw)["r1"]
    assert 1 <= plan.rb <= r1 and plan.stages in (2, 3)
    assert plan.as_ints() == [getattr(plan, f) for f in early.PLAN_FIELDS]
    assert len(early.PLAN_FIELDS) == 14


class _FakeWidths:
    def __init__(self, c0, n):
        self.c0, self.c1, self.ch, self.c2, self.n = c0, 2 * c0, c0, 4 * c0, n


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_live_buffers_do_not_overlap(variant):
    plan = early.plan_early(*VARIANTS[variant])
    off = _offsets(plan)
    for a, b in itertools.combinations(BUFFERS, 2):
        if frozenset((a, b)) in SHARED_SPACE:
            continue
        disjoint = off[a] + plan.sizes[a] <= off[b] or off[b] + plan.sizes[b] <= off[a]
        assert disjoint, (a, b, off[a], plan.sizes[a], off[b], plan.sizes[b])
    # and the sharing really saves space: each pair of groups starts together
    assert off["s2d"] == off["mcat"]


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_alignment_of_swizzled_chunks_and_ldmatrix_rows(variant):
    c0, n = VARIANTS[variant]
    plan = early.plan_early(c0, n)
    off = _offsets(plan)
    # a 128-byte-swizzled chunk needs its stage on a 1024-byte boundary
    assert off["ring"] % 1024 == 0 and plan.stage_bytes % 1024 == 0
    assert plan.stage_bytes == 4 * c0 * 128 and plan.sizes["ring"] == plan.stages * plan.stage_bytes
    for b in BUFFERS:
        assert off[b] % 128 == 0, b
    # ldmatrix rows are 16 bytes; a pitch that is an odd multiple of 16 bytes
    # puts the 8 rows of a phase in 8 different 16-byte bank groups
    for c in (c0, 2 * c0):
        pitch = (c + early.PAD) * 2
        assert pitch % 16 == 0 and (pitch // 16) % 2 == 1
    # the stem reads two planes of 16-byte pixels through a descriptor: 8 pixels are
    # one 128-byte core matrix
    assert early.S2D_BYTES == 32
    g = early.tile_geometry(n, plan.th, plan.tw)
    assert g["raw_pitch"] % 8 == 0 and g["raw_pitch"] >= 6 * g["cs"] + 7


def test_halo_of_yolov5s_is_no_worse_than_the_8x8_tile():
    c0, n = VARIANTS["s"]
    plan = early.plan_early(c0, n)
    assert plan.halo == early.halo_factor(c0, n, plan.th, plan.tw)
    assert plan.halo <= 1.27
    assert plan.halo <= early.halo_factor(c0, n, 8, 8)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_band_buffers_cover_every_band(variant):
    """Bands of rb conv1 rows: the stem buffer holds 2 rb + 1 rows, the
    space-to-depth buffer 2 more, the raw buffer two rows for each of those."""
    c0, n = VARIANTS[variant]
    plan = early.plan_early(c0, n)
    g = early.tile_geometry(n, plan.th, plan.tw)
    bands = -(-g["r1"] // plan.rb)
    rows = [min(plan.rb, g["r1"] - b * plan.rb) for b in range(bands)]
    assert sum(rows) == g["r1"] and all(r >= 1 for r in rows)
    for b, r in enumerate(rows):
        first = 1 if b else 0
        stem_rows = 2 * r + 1
        assert stem_rows * 2 * g["half0"] * (c0 + early.PAD) * 2 <= plan.sizes["stem"]
        s2d_rows = stem_rows - first + 2
        assert s2d_rows * g["cs"] * early.S2D_BYTES <= plan.sizes["s2d"]
        assert 2 * s2d_rows * g["raw_pitch"] <= plan.sizes["raw"]
    # the C3 output (parity-split) reuses the conv1 buffer
    assert g["r3"] * 2 * g["half3"] * (2 * c0 + early.PAD) * 2 <= plan.sizes["c1"]


@pytest.mark.parametrize("c0,n", [(24, 1), (96, 1), (32, 0), (32, 5)])
def test_plan_raises_on_widths_the_kernel_does_not_take(c0, n):
    with pytest.raises(ValueError, match=f"c0={c0}"):
        early.plan_early(c0, n)
