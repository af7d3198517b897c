"""The early-network kernel at every width the Pallas kernel takes: the
shipped width-1.05 config (stem 72, conv1 136, C3 68 x 4, conv2 272) and a
stem of 8 (width_multiple 0.125), checked on the CPU.

- the port's plain early network against JAX's ``early_pipeline`` in
  interpret mode, on the same seeded BN-folded weights carried across by the
  weight bridge (the interpret-mode test's tolerance: max|d| < 0.03 and
  p99.9 < 0.015 of the peak);
- the padded packing: pack -> unpack gives back the true matrices, and every
  padded row, column and bias is 0;
- the plan: a tile for every shipped config and every width_multiple from
  0.125 to 1.25 at C3 depths 1-4, one library per padded set built by
  default for the shipped ones, and a refusal naming the widths beyond;
- the operator at these widths, and in the first form an artifact of the
  v6 widths recorded (images, wpack, c0, n);
- the kernel against its plain version at these widths (marked ``cuda``:
  skips here)."""

import itertools

import numpy as np
import pytest
import torch

from _torch_port_common import (
    ROOT,
    images,
    jax_interpreted,
    p999_to_peak,
    rel_to_peak,
    zoo_cfg,
)

torch.set_num_threads(1)

WIDE = "yolov5_depth1.5_width1.05_800"
CASES = {"1.05": (72, 136, 68, 272, 4), "stem8": (8, 16, 8, 32, 1)}


def v6_widths(w: float, n: int):
    """The early block of a v6 model of width_multiple w and C3 depth n."""
    from ayolov2_torch.utils.general import make_divisible

    c1 = make_divisible(128 * w, 8)
    return make_divisible(64 * w, 8), c1, c1 // 2, make_divisible(256 * w, 8), n


def nt_of(co: int) -> int:
    """The kernel's N tile of a product of co (padded) channels (``nt_of`` in
    csrc/early_pipeline.cu): the widest of co, co / 2, co / 4 up to 80."""
    return co if co <= 80 else co // 2 if co // 2 <= 80 else co // 4


def fused_early_tree(widths, seed: int) -> dict:
    """Seeded BN-folded weights of layers 0..3 as JAX's fused tree holds
    them (HWIO kernels, He-scaled; biases ~ N(0, 0.1))."""
    c0, c1, ch, c2, n = widths
    rng = np.random.default_rng(seed)

    def conv(k, cin, cout):
        return {"conv": {
            "kernel": rng.normal(0, np.sqrt(2.0 / (k * k * cin)), (k, k, cin, cout))
            .astype(np.float32),
            "bias": rng.normal(0, 0.1, cout).astype(np.float32)}}

    c3 = {"cv1": conv(1, c1, ch), "cv2": conv(1, c1, ch), "cv3": conv(1, 2 * ch, c1)}
    for i in range(n):
        c3[f"m{i}"] = {"cv1": conv(1, ch, ch), "cv2": conv(3, ch, ch)}
    return {"params": {"model_0": conv(6, 3, c0), "model_1": conv(3, c0, c1), "model_2": c3,
                       "model_3": conv(3, c1, c2)}}


def port_params(tree):
    from ayolov2_torch.ops.early_pipeline import extract_early_params
    from ayolov2_torch.utils.weights import state_dict_from_flax

    return extract_early_params(state_dict_from_flax(tree))


def test_shipped_configs_have_these_widths():
    from ayolov2_torch.models import build_model, yolov5_cfg
    from ayolov2_torch.ops.early_pipeline import can_fuse_early_model
    from ayolov2_torch.utils.config import load_yaml

    wide = build_model(load_yaml(zoo_cfg(WIDE)), nc=80, device="meta")
    tiny = yolov5_cfg("s")
    tiny["width_multiple"] = 0.125
    for model, name in ((wide, "1.05"), (build_model(tiny, device="meta"), "stem8")):
        assert can_fuse_early_model(model)
        c3 = model.model[2]
        widths = (model.model[0].conv.out_channels, model.model[1].conv.out_channels,
                  c3.cv1.conv.out_channels, model.model[3].conv.out_channels, len(c3.m))
        assert widths == CASES[name]


INTERPRETED = {"1.05": ((64, 64), 8), "stem8": ((64, 96), 4)}


@pytest.fixture(scope="module")
def interpreted(tmp_path_factory):
    """(fused tree, images, JAX's kernel in interpret mode on them) of each
    case, all in one fresh interpreter with its own time limit (slow)."""
    jobs = {case: (fused_early_tree(CASES[case], seed=hw[1]), images((2, *hw, 3), seed=hw[0] + 1),
                   strip_h) for case, (hw, strip_h) in INTERPRETED.items()}
    out = jax_interpreted(jobs, tmp_path_factory.mktemp("interpret"))
    return {case: (tree, imgs, out[case]) for case, (tree, imgs, _) in jobs.items()}


@pytest.mark.parametrize("case", sorted(INTERPRETED))
def test_ref_matches_jax_interpreted_kernel_at_width(interpreted, case):
    import jax
    import jax.numpy as jnp

    from ayolov2_torch.ops.early_pipeline import early_pipeline_ref
    from ayolov2_tpu.ops.early_pipeline import extract_early_params

    tree, imgs, want = interpreted[case]
    jep = extract_early_params(jax.tree_util.tree_map(jnp.asarray, tree))
    ep = port_params(tree)
    assert ep.widths == CASES[case] == (jep.c0, jep.c1, jep.ch, jep.c2, jep.n)
    got = early_pipeline_ref(torch.from_numpy(imgs), ep)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
    assert want.shape[-1] == CASES[case][3]
    g = got.float().numpy()
    assert rel_to_peak(g, want) < 0.03
    assert p999_to_peak(g, want) < 0.015


@pytest.mark.parametrize("case", sorted(CASES))
def test_padded_pack_round_trip(case):
    """pack -> unpack gives back every true matrix and bias bit for bit; the
    packed products are the true ones padded with zeros only."""
    from ayolov2_torch.ops import early_pipeline as early

    ep = port_params(fused_early_tree(CASES[case], seed=3))
    c0, c1, ch, c2, n = ep.widths
    packed = early.pack_weights(ep)
    assert packed.numel() == early.packed_numel(c0, n, c1, ch, c2)
    back = early.unpack_weights(packed, c0, n, c1, ch, c2)
    assert back.widths == ep.widths
    for a, b in zip(ep.segments(), back.segments()):
        assert a.shape == b.shape and torch.equal(a, b)
    p0, p1, ph, p2 = early.padded_widths(c0, c1, ch, c2)
    assert all(p % 16 == 0 for p in (p0, p1, ph, p2))
    mats = early.layer_matrices(ep)
    assert [tuple(w.shape) for w, _ in mats] == early.packed_layout(c0, n, c1, ch, c2)
    # (taps, true cin, padded cin, true co) of each product; cv1|cv2 is two halves
    true_in = [(9, 12, 16, c0), (9, c0, p0, c1), (1, c1, p1, ch)]
    true_in += [(1, ch, ph, ch), (9, ch, ph, ch)] * n + [(2, ch, ph, c1), (9, c1, p1, c2)]
    halves = [mats[0], mats[1], (mats[2][0][:ph], mats[2][1][:ph]),
              (mats[2][0][ph:], mats[2][1][ph:])] + mats[3:]
    for (w, b), (taps, cin, cin_p, co) in zip(halves, true_in[:3] + true_in[2:]):
        w = w.reshape(w.shape[0], taps, cin_p)
        assert not w[co:].any() and not b[co:].any()
        assert not w[:, :, cin:].any()
        assert w[:co, :, :cin].any()


@pytest.mark.parametrize("n,form", list(itertools.product([1, 2, 3, 4], ["fused", "staged"])))
def test_plan_finds_a_tile_for_every_width(n, form):
    """Every v6 early block of a width_multiple in 0.125 .. 1.25 (steps of
    0.125, and 1.05) at this C3 depth has, in each form, a tile for each of
    the form's kernels whose shared memory fits, sized from the padded
    widths; c0 = make_divisible(64 w) runs 8 .. 80. The plan is one of the
    two."""
    from ayolov2_torch.ops import early_pipeline as early

    stems = set()
    for w in [0.125 * k for k in range(1, 11)] + [1.05]:
        c0, c1, ch, c2, _ = v6_widths(w, n)
        stems.add(c0)
        widths = (c0, c1, ch, c2, n)
        plan = early.plan_of_form(widths, form)
        assert early.plan_early(c0, n, c1, ch, c2).form in early.FORMS
        assert (plan.th, plan.tw) in (early.TILES if form == "fused" else early.TAIL_TILES)
        p0, p1, ph, p2 = early.padded_widths(c0, c1, ch, c2)
        for part in plan.parts:
            assert part.total + early.STATIC_SMEM <= early.SMEM_LIMIT
            assert part.stages == early.RING_STAGES
            assert part.stage_bytes == max(3 * p0, p1, 2 * ph, p2) * 128
            assert part.sizes["bias"] == 2 * (p0 + 2 * p1 + 2 * ph * (n + 1) + p2)
        for co in (p0, p1, 2 * ph, p2):  # a wgmma's N: a multiple of 8
            nt = nt_of(co)
            assert nt % 8 == 0 and co % nt == 0 and nt <= 80
    assert min(stems) == 8 and max(stems) == 80


def test_plan_of_every_shipped_config_and_its_build():
    """Each shipped config whose first layers K1 fuses has a plan, and its
    padded width set is among the libraries built by default; so is the
    stem-8 set."""
    from ayolov2_torch.models import build_model
    from ayolov2_torch.ops import _build
    from ayolov2_torch.ops import early_pipeline as early
    from ayolov2_torch.utils.config import load_yaml

    built = set(_build.VARIANTS["early_pipeline"])
    seen = set()
    for path in sorted((ROOT / "res/configs/model").glob("*.yaml")):
        model = build_model(load_yaml(path), nc=80, device="meta")
        if not early.can_fuse_early_model(model):
            continue
        c3 = model.model[2]
        c0, c1, ch, c2, n = (model.model[0].conv.out_channels, model.model[1].conv.out_channels,
                             c3.cv1.conv.out_channels, model.model[3].conv.out_channels,
                             len(c3.m))
        early.plan_early(c0, n, c1, ch, c2)
        assert early.kernel_defines(c0, c1, ch, c2) in built, path.name
        seen.add(path.stem)
    assert {"yolov5n", "yolov5s", "yolov5m", "yolov5l", "yolov5x", "yolov5l_0.5",
            WIDE} <= seen
    assert early.kernel_defines(*CASES["stem8"][:4]) in built
    assert len(built) == len(_build.VARIANTS["early_pipeline"]) == 7


@pytest.mark.parametrize("widths,named", [
    ((88, 176, 88, 352, 1), "c0=88"),            # width_multiple 1.375
    ((72, 136, 68, 272, 5), "n=5"),              # C3 depth 5
    ((64, 128, 64, 255, 1), "c2=255"),           # an odd conv2 width
    ((64, 176, 64, 256, 1), "c1=176"),           # conv1 beyond 160
])
def test_plan_raises_beyond_naming_the_widths(widths, named):
    from ayolov2_torch.ops import early_pipeline as early

    c0, c1, ch, c2, n = widths
    with pytest.raises(ValueError, match=f"{named}.*early_pipeline=False"):
        early.plan_early(c0, n, c1, ch, c2)


@pytest.mark.parametrize("case", sorted(CASES))
def test_operator_at_these_widths_on_the_cpu(case):
    """The operator with the widths equals the plain version (CPU: no plan,
    no build); its fake gives c2 channels; the wrapper runs on the CPU."""
    from ayolov2_torch.ops import early_pipeline as early

    ep = port_params(fused_early_tree(CASES[case], seed=5))
    c0, c1, ch, c2, n = ep.widths
    x = torch.from_numpy(images((1, 48, 40, 3), seed=6))
    want = early.early_pipeline_ref(x, ep)
    packed = early.pack_weights(ep)
    assert torch.equal(torch.ops.ayolov2.early_pipeline(x, packed, c0, n, c1, ch, c2), want)
    before = early.early_pipeline.launches
    assert torch.equal(early.early_pipeline(x, ep), want)
    assert early.early_pipeline.launches == before
    with torch._subclasses.fake_tensor.FakeTensorMode() as mode:
        fake = torch.ops.ayolov2.early_pipeline(mode.from_tensor(x), mode.from_tensor(packed),
                                                c0, n, c1, ch, c2)
    assert fake.shape == want.shape == (1, 6, 5, c2)
    with pytest.raises(ValueError, match="do not hold"):
        torch.ops.ayolov2.early_pipeline(x, packed[:-1], c0, n, c1, ch, c2)


def test_operator_in_its_first_form_loads_from_an_artifact(tmp_path):
    """An artifact whose graph calls the operator as (images, wpack, c0, n),
    the only form before the widths were added, loads and runs: c1, ch and
    c2 then follow the v6 ratios of c0."""
    from ayolov2_torch.export import load_exported
    from ayolov2_torch.ops import early_pipeline as early

    ep = port_params(fused_early_tree((16, 32, 16, 64, 1), seed=7))

    class FirstForm(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.register_buffer("k1_weights", early.pack_weights(ep))

        def forward(self, x):
            return torch.ops.ayolov2.early_pipeline(x, self.k1_weights, 16, 1)

    x = torch.from_numpy(images((1, 32, 48, 3), seed=8))
    program = torch.export.export(FirstForm(), (x,))
    calls = [n for n in program.graph.nodes if n.target == torch.ops.ayolov2.early_pipeline.default]
    assert len(calls) == 1 and len(calls[0].args) == 4
    torch.export.save(program, str(tmp_path / "first_form.pt2"))
    got = load_exported(str(tmp_path / "first_form.pt2"))(x)
    assert torch.equal(got, early.early_pipeline_ref(x, ep))


@pytest.mark.cuda
@pytest.mark.parametrize("case,shape", list(itertools.product(
    sorted(CASES), [(2, 64, 64), (1, 136, 200), (2, 40, 24)])))
def test_kernel_matches_plain_version_at_width(case, shape):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the early-network kernel runs only on the card")
    from ayolov2_torch.ops import early_pipeline as early

    torch.backends.cudnn.allow_tf32 = False
    ep = port_params(fused_early_tree(CASES[case], seed=9)).to("cuda")
    imgs = torch.from_numpy(images((*shape, 3), seed=shape[1])).cuda()
    before = early.early_pipeline.launches
    got = early.early_pipeline(imgs, ep)
    torch.cuda.synchronize()
    assert early.early_pipeline.launches == before + 1
    want = early.early_pipeline_ref(imgs, ep)
    g, w = got.float().cpu().numpy(), want.float().cpu().numpy()
    assert got.shape == want.shape and np.isfinite(g).all()
    assert rel_to_peak(g, w) < 0.03 and p999_to_peak(g, w) < 0.015
