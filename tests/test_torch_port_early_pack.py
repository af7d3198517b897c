"""The early-network kernel's weight packing, checked on the CPU: chunks of
up to 64 along K in the 128-byte-swizzle order, the K = 144 stem layout, and the
per-device cache."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from _torch_port_common import images
from ayolov2_torch.ops import early_pipeline as early

torch.set_num_threads(1)


def _seeded_ep(variant, seed):
    from ayolov2_torch.models import build_model, yolov5_cfg

    model = build_model(yolov5_cfg(variant), device="cpu")
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.from_numpy(rng.normal(0, 0.2, tuple(p.shape)).astype(np.float32)))
        for name, b in model.named_buffers():
            if name.endswith("running_var"):
                b.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, tuple(b.shape)).astype(np.float32)))
    return early.extract_early_params(model.fuse().state_dict())


@pytest.mark.parametrize("variant", ["n", "s", "m"])
def test_unpacking_the_chunks_gives_back_every_matrix(variant):
    ep = _seeded_ep(variant, 3)
    mats = early.layer_matrices(ep)
    assert len(mats) == 5 + 2 * ep.n
    assert [tuple(w.shape) for w, _ in mats[:3]] == [
        (ep.c0, 144), (ep.c1, 9 * ep.c0), (2 * ep.ch, ep.c1)]
    flat = early.pack_weights(ep)
    pos = 0
    for w, _ in mats:
        co, k = w.shape
        per = 16 * early.steps_per_chunk(k)  # K elements in one chunk
        chunks = k // per
        assert k % per == 0 and per in (16, 32, 48, 64)
        packed = flat[pos:pos + chunks * co * 64].reshape(chunks, co, 64)
        assert torch.equal(packed, early.pack_chunks(w))
        assert torch.equal(early.unpack_chunks(packed, k), w)
        # the 16-byte unit u of row r sits at unit u ^ (r % 8) of its 128-byte row
        for r, kk in ((0, 0), (co - 1, k - 1), (co // 2 + 1, k // 2 + 3)):
            unit = ((kk % per) // 8) ^ (r % 8)
            assert packed[kk // per, r, unit * 8 + kk % 8] == w[r, kk]
        # what a chunk holds past its K elements is zero
        unswizzled = packed.reshape(chunks, co, 8, 8).gather(
            2, early._swizzle_index(chunks, co, "cpu")).reshape(chunks, co, 64)
        assert not unswizzled[:, :, per:].any()
        pos += chunks * co * 64
    biases = torch.cat([b for _, b in mats])
    assert biases.numel() == ep.c0 * (11 + 2 * ep.n)
    assert torch.equal(flat[pos:], biases) and flat.dtype == torch.bfloat16


def test_stem_k144_equals_the_plain_stem():
    """The 16-plane layout adds zero columns only: the same sums, so the
    same stem output as early_pipeline_ref's first conv."""
    ep = _seeded_ep("s", 5)
    w144 = early.stem_k144(ep.w_stem)
    assert tuple(w144.shape) == (32, 144)
    assert torch.equal(w144.reshape(32, 9, 16)[:, :, :12].reshape(32, 108), ep.w_stem[:, :108])
    assert not w144.reshape(32, 9, 16)[:, :, 12:].any()

    imgs = torch.from_numpy(images((2, 40, 56, 3), seed=6))
    bs, h, w, cin = imgs.shape
    x = F.pad(imgs.permute(0, 3, 1, 2).double(), (2, 2, 2, 2))
    x = x.reshape(bs, cin, (h + 4) // 2, 2, (w + 4) // 2, 2)
    s2d12 = x.permute(0, 3, 5, 1, 2, 4).reshape(bs, 12, (h + 4) // 2, (w + 4) // 2)
    s2d16 = F.pad(s2d12, (0, 0, 0, 0, 0, 4))

    def conv(planes, wmat, c):
        wt = wmat.double().reshape(32, 3, 3, c).permute(0, 3, 1, 2)
        return F.conv2d(planes, wt)

    # in f64 every product and sum of these integers x bf16 weights is exact
    want = conv(s2d12, ep.w_stem[:, :108], 12)
    got = conv(s2d16, w144, 16)
    assert torch.equal(got, want)
    y = F.silu(got.float() + ep.b_stem.float().view(1, -1, 1, 1)).to(torch.bfloat16)
    ref = early._conv_silu(s2d12.float(), ep.w_stem, ep.b_stem, 3)
    assert y.shape == ref.shape == (2, 32, 20, 28)
    # the plain version sums in f32: equal up to the rounding of that sum
    same = (y == ref).float().mean().item()
    assert same > 0.999
    assert (y.float() - ref.float()).abs().max() <= 2.0 ** -7 * ref.float().abs().max()


def test_packed_weights_are_cached_per_device():
    ep = _seeded_ep("n", 7)
    a = early._packed(ep, torch.device("cpu"))
    assert early._packed(ep, torch.device("cpu")) is a
    assert list(ep._packed) == ["cpu"]
    assert torch.equal(a, early.pack_weights(ep))
    moved = ep.to("cpu")
    assert moved._packed == {}  # a moved copy packs anew


@pytest.mark.parametrize("variant", ["n", "s", "m", "l", "x"])
def test_layer_offsets_follow_the_kernels_table(variant):
    """The kernel derives each layer's offset from c0 and n alone
    (``fill_layers``): chunks of co x 128 bytes, layer after layer."""
    c0, n = {"n": (16, 1), "s": (32, 1), "m": (48, 2), "l": (64, 3), "x": (80, 4)}[variant]
    c1, ch, c2 = 2 * c0, c0, 4 * c0
    table = [(c0, 9), (c1, 9 * c0 // 16), (2 * ch, c1 // 16)]
    for _ in range(n):
        table += [(ch, ch // 16), (ch, 9 * ch // 16)]
    table += [(c1, 2 * ch // 16), (c2, 9 * c1 // 16)]
    shapes = [(c0, 144), (c1, 9 * c0), (2 * ch, c1)] + [(ch, ch), (ch, 9 * ch)] * n + [
        (c1, 2 * ch), (c2, 9 * c1)]
    for (co, ksteps), (rows, k) in zip(table, shapes):
        assert co == rows and ksteps * 16 == k
        packed = early.pack_chunks(torch.zeros(rows, k, dtype=torch.bfloat16))
        kpc = next(c for c in (4, 3, 2, 1) if ksteps % c == 0)
        assert kpc == early.steps_per_chunk(k)
        assert packed.numel() * 2 == (ksteps // kpc) * co * 128


def test_build_targets_one_library_per_source_and_define_set(tmp_path):
    """The build helper names a library by its source's bytes and its -D set,
    builds the early kernel once per stem width, and takes a path to another
    version of a source."""
    from ayolov2_torch.ops import _build

    src = _build._source("early_pipeline")
    assert src == _build.CSRC / "early_pipeline.cu" and src.exists()
    widths = _build.VARIANTS["early_pipeline"]
    assert widths == [(f"EARLY_C0={c0}",) for c0 in (16, 32, 48, 64, 80)]
    targets = {_build._target(src, d) for d in widths}
    targets.add(_build._target(src, ("EARLY_C0=32", "EARLY_PROFILE")))
    assert len(targets) == 6 and all(t.parent == _build.BUILD_DIR for t in targets)
    other = tmp_path / "early_pipeline.cu"
    other.write_bytes(src.read_bytes() + b"\n// another version\n")
    assert _build._source(str(other)) == other
    assert _build._target(other, widths[1]) not in targets
