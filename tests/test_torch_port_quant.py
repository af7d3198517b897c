"""int8 post-training quantization: the port against the JAX package on the
same seeded numpy weights and inputs (yolov5n, 64 px), on the CPU.

``QuantConv`` computes ``_QuantConv``'s function bit for bit; the ``_int_mm``
route (with the padding its CUDA version needs) equals the plain product;
calibration stats, ``quantize_params`` and the quantized model's raw maps
match JAX's; the int8 model serves with f32 scales, without the
early-network kernel, exports and reads back, and the entry points take
``--int8`` / ``--dtype int8 --calib-dir``."""

import json

import numpy as np
import pytest
import torch

from _torch_port_common import (
    GOLDEN,
    LABELLED_IMG,
    as_np,
    call_artifacts_fresh,
    images,
    jax_zoo_variables,
    labelled_set,
    nchw,
    p999_to_peak,
    rel_to_peak,
    tree_leaves,
    zoo_cfg,
)

torch.set_num_threads(1)
WEIGHTS = str(GOLDEN / "weights/best.ckpt")


def _jax_quant_conv(q, ws, ins, b, x, k, s, dtype):
    import jax
    import jax.numpy as jnp

    from ayolov2_tpu.models.layers import _QuantConv

    m = _QuantConv(q.shape[-1], k, s, k // 2, dtype=dtype)
    v = {"params": {"q_kernel": q, "w_scale": ws, "in_scale": ins, "bias": b}}
    return np.asarray(jax.jit(lambda v, x: m.apply(v, x))(v, jnp.asarray(x, dtype))
                      .astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k,s,cin,cout", [(1, 1, 12, 16), (3, 1, 20, 24), (3, 2, 13, 8),
                                          (1, 2, 9, 5)])
def test_quant_conv_equals_jax_bit_for_bit(dtype, k, s, cin, cout):
    import jax.numpy as jnp

    from ayolov2_torch.models.layers import QuantConv

    rng = np.random.default_rng(k * 100 + s * 10 + cin)
    x = rng.normal(size=(2, 9, 11, cin)).astype(np.float32)
    q = rng.integers(-127, 128, (k, k, cin, cout)).astype(np.int8)
    ws = rng.uniform(0.001, 0.01, cout).astype(np.float32)
    # 0x1.5ff60cp+4 / 127 is one of the quotients that a reciprocal misses
    ins = np.float32(2.7) if dtype == "float32" else np.float32(float.fromhex("0x1.5ff60cp+4"))
    b = rng.normal(size=cout).astype(np.float32)
    want = _jax_quant_conv(q, ws, ins, b, x, k, s, getattr(jnp, dtype))

    conv = QuantConv(cin, cout, k, s, k // 2)
    conv.q_kernel.copy_(torch.from_numpy(q.transpose(3, 2, 0, 1).copy()))
    conv.w_scale.copy_(torch.from_numpy(ws))
    conv.in_scale.fill_(float(ins))
    conv.bias.copy_(torch.from_numpy(b))
    got = conv(nchw(x).to(getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(as_np(got.permute(0, 2, 3, 1)), want)


@pytest.mark.parametrize("m,k,n", [(5, 12, 3), (17, 24, 16), (40, 27, 13), (16, 8, 8)])
def test_int_mm_route_equals_the_plain_product(m, k, n):
    """``int_mm_padded`` (the card's route, padded to m > 16 and k, n
    multiples of 8) against the f64 plain product, and both inside a conv."""
    from ayolov2_torch.ops.int8_conv import int8_conv, int8_matmul_ref, int_mm_padded

    rng = np.random.default_rng(m + k + n)
    a = torch.from_numpy(rng.integers(-127, 128, (m, k), dtype=np.int8))
    b = torch.from_numpy(rng.integers(-127, 128, (k, n), dtype=np.int8))
    want = (a.long() @ b.long()).int()
    assert torch.equal(int8_matmul_ref(a, b), want)
    assert torch.equal(int_mm_padded(a, b), want)
    xq = torch.from_numpy(rng.integers(-127, 128, (2, 7, 9, k), dtype=np.int8))
    wq = torch.from_numpy(rng.integers(-127, 128, (n, k, 3, 3), dtype=np.int8))
    want_c = torch.nn.functional.conv2d(xq.permute(0, 3, 1, 2).double(), wq.double(),
                                        stride=2, padding=1).permute(0, 2, 3, 1)
    got = int8_conv(xq, wq, 2, 1, matmul=int_mm_padded)
    assert got.dtype == torch.int32 and torch.equal(got.double(), want_c)
    assert torch.equal(int8_conv(xq, wq, 2, 1), got)


def test_calibration_p999_flattens_in_nhwc_order():
    """A conv input of more than 2^21 elements: absmax equal, p99.9 within
    1e-6 relative of JAX's (which strides through |x| in NHWC order); the
    NCHW order would pick other elements."""
    import jax
    import jax.numpy as jnp

    from ayolov2_torch.models.layers import ConvBnAct
    from ayolov2_tpu.models.layers import ConvBnAct as JaxConv

    x = np.random.default_rng(3).standard_t(4, size=(1, 520, 512, 8)).astype(np.float32)
    assert x.size > 1 << 21
    jm = JaxConv(8, 1, fuse=True, quant="calib")
    v = {"params": {"conv": {"kernel": np.zeros((1, 1, 8, 8), np.float32),
                             "bias": np.zeros(8, np.float32)}}}
    _, st = jax.jit(lambda v, x: jm.apply(v, x, mutable=["quant_stats"]))(v, jnp.asarray(x))
    st = st["quant_stats"]
    conv = ConvBnAct(8, 8, 1, fused=True, quant="calib")
    conv(nchw(x))
    assert float(conv.in_absmax) == float(st["in_absmax"])
    p = float(conv.in_p999)
    assert abs(p - float(st["in_p999"])) <= 1e-6 * abs(p)
    flat = torch.from_numpy(np.abs(x)).permute(0, 3, 1, 2).reshape(-1)
    wrong = float(torch.quantile(flat[::max(1, flat.numel() // (1 << 20))], 0.999))
    assert abs(wrong - p) > 1e-6 * abs(p)


@pytest.fixture(scope="module")
def fused_n():
    """(JAX fused variables of seeded yolov5n, one 64 px calibration batch
    NHWC f32, JAX's calibration stats of it)."""
    import jax

    from ayolov2_tpu.compress.quantize import collect_activation_stats
    from ayolov2_tpu.models import build_model, fuse_params

    _, v = jax_zoo_variables("yolov5n", seed=41)
    fused = jax.tree_util.tree_map(np.asarray, fuse_params(v))
    x = images((2, 64, 64, 3), 42).astype(np.float32) / 255.0
    calib = build_model(zoo_cfg("yolov5n"), fused=True, quant="calib")
    stats = collect_activation_stats(calib, fused, [x])
    return fused, x, jax.tree_util.tree_map(np.asarray, stats)


def test_calibration_stats_equal_jax(fused_n):
    from ayolov2_torch.compress.quantize import collect_activation_stats
    from ayolov2_torch.models import build_model

    fused, x, want = fused_n
    calib = build_model(zoo_cfg("yolov5n"), fused=True, quant="calib", device="cpu")
    got = collect_activation_stats(calib, fused, [nchw(x)])
    g, w = tree_leaves(got), tree_leaves(want)
    assert g.keys() == w.keys() and len(g) > 40
    # the float forwards of XLA and torch part by about 1e-5 by the head
    for key in w:
        assert abs(float(g[key]) - float(w[key])) <= 1e-4 * abs(float(w[key])), key


def test_quantize_params_equals_jax(fused_n):
    """Bit-equal q_kernel, w_scale, in_scale and bias for both methods; the
    same eligible set: the stem (cin 3) and the head stay float."""
    from ayolov2_torch.compress.quantize import quantize_params
    from ayolov2_tpu.compress.quantize import quantize_params as jax_quantize_params

    fused, _, stats = fused_n
    for method in ("absmax", "p999"):
        got = tree_leaves(quantize_params(fused, stats, method)["params"])
        want = {k: np.asarray(v) for k, v in
                tree_leaves(jax_quantize_params(fused, stats, method)["params"]).items()}
        assert got.keys() == want.keys()
        for key in want:
            assert got[key].dtype == want[key].dtype, key
            np.testing.assert_array_equal(got[key], want[key], err_msg=str(key))
    quantized = {k[:-1] for k in got if k[-1] == "q_kernel"}
    assert ("model_0", "conv") not in quantized and ("model_1", "conv") in quantized
    assert not any(k[0] == "model_24" for k in quantized)


def test_quantize_params_eligibility_errors_and_unfused_input(fused_n):
    """A depthwise kernel (cin 1) and a decomposed block stay float, as in
    JAX; stats of another tree and an unfused tree raise in both."""
    from ayolov2_torch.compress.quantize import quantize_params
    from ayolov2_tpu.compress.quantize import quantize_params as jax_quantize_params

    rng = np.random.default_rng(5)

    def conv(shape):
        return {"kernel": rng.normal(size=shape).astype(np.float32),
                "bias": rng.normal(size=shape[-1]).astype(np.float32)}

    tree = {"params": {"a": {"depthwise": {"conv": conv((3, 3, 1, 16))},
                             "project": {"conv": conv((1, 1, 16, 8))}},
                       "b": {"conv_first": {"kernel": np.ones((1, 1, 16, 4), np.float32)},
                             "conv_core": {"kernel": np.ones((3, 3, 4, 4), np.float32)},
                             "conv_last": conv((1, 1, 4, 16))}}}
    stats = {"a": {"depthwise": {"in_absmax": np.float32(2.0), "in_p999": np.float32(1.0)},
                   "project": {"in_absmax": np.float32(3.0), "in_p999": np.float32(1.5)}},
             "b": {"in_absmax": np.float32(1.0), "in_p999": np.float32(1.0)}}
    got = tree_leaves(quantize_params(tree, stats)["params"])
    want = tree_leaves(jax_quantize_params(tree, stats)["params"])
    assert got.keys() == {k for k in want}
    assert {k[:2] for k in got if k[-1] == "q_kernel"} == {("a", "project")}
    fused, _, real = fused_n
    for fn in (quantize_params, jax_quantize_params):
        with pytest.raises(ValueError, match="no conv was quantized"):
            fn(fused, {"other": real["model_1"]})
    _, unfused = jax_zoo_variables("yolov5n", seed=41)
    for fn in (quantize_params, jax_quantize_params):
        with pytest.raises(ValueError, match="no conv was quantized"):
            fn(unfused, real)


@pytest.fixture(scope="module")
def jax_int8(fused_n):
    """(JAX's int8 tree of yolov5n, JAX's raw maps of it in f32 at 64 px)."""
    import jax
    import jax.numpy as jnp

    from ayolov2_tpu.compress.quantize import quantize_model

    fused, x, _ = fused_n
    qmodel, qvars = quantize_model(zoo_cfg("yolov5n"), fused, [x], dtype=jnp.float32)
    qvars = jax.tree_util.tree_map(np.asarray, qvars)
    raw = jax.jit(lambda v, x: qmodel.apply(v, x, training=True))(qvars, x)
    return qvars, [np.asarray(r) for r in raw]


def test_quantized_model_raw_maps_equal_jax(fused_n, jax_int8):
    from ayolov2_torch.models import build_model
    from ayolov2_torch.utils.weights import load_flax_variables

    _, x, _ = fused_n
    qvars, want = jax_int8
    model = load_flax_variables(build_model(zoo_cfg("yolov5n"), fused=True, quant=True,
                                            device="cpu"), qvars)
    with torch.no_grad():
        got = model(nchw(x), training=True)
    for g, w in zip(got, want):
        assert rel_to_peak(as_np(g), w) <= 1e-2
        assert p999_to_peak(as_np(g), w) <= 1e-3


def test_quantize_model_equals_jax_quantize_model(fused_n, jax_int8):
    """The port's one-call PTQ on the same batch quantizes the same convs
    with the same kernels (its float forward differs from XLA's by ulps, so
    the input scales agree to 1e-5)."""
    from ayolov2_torch.compress.quantize import quantize_model

    fused, x, _ = fused_n
    _, qvars = quantize_model(zoo_cfg("yolov5n"), fused, [nchw(x)], dtype=torch.float32,
                              device="cpu")
    got, want = tree_leaves(qvars["params"]), tree_leaves(jax_int8[0]["params"])
    assert got.keys() == want.keys()
    for key in want:
        if key[-1] == "in_scale":
            assert abs(float(got[key]) - float(want[key])) <= 1e-5 * float(want[key])
        else:
            np.testing.assert_array_equal(got[key], want[key], err_msg=str(key))


def test_scales_stay_f32_under_bf16_serving(jax_int8):
    from ayolov2_torch.export import make_serving_fn
    from ayolov2_torch.models import build_model
    from ayolov2_torch.models.layers import QuantConv
    from ayolov2_torch.utils.weights import load_flax_variables

    model = load_flax_variables(build_model(zoo_cfg("yolov5n"), fused=True, quant=True,
                                            device="cpu"), jax_int8[0])
    serve = make_serving_fn(model, image_dtype=torch.bfloat16, device="cpu")
    quants = [m for m in serve.model.modules() if isinstance(m, QuantConv)]
    assert len(quants) > 40
    for m in quants:
        assert m.q_kernel.dtype == torch.int8
        assert m.w_scale.dtype == m.in_scale.dtype == m.bias.dtype == torch.float32
    src = dict(model.named_buffers())
    for name, buf in serve.model.named_buffers():
        if name.endswith(("w_scale", "in_scale", "bias")):
            assert torch.equal(buf, src[name]), name
    assert serve.model.model[0].conv.weight.dtype == torch.bfloat16
    det, n = serve(torch.from_numpy(images((2, 64, 64, 3), 7)))
    assert det.shape == (2, 100, 6) and bool(torch.isfinite(det).all())


@pytest.mark.parametrize("case,early", [("int8", False), ("map at model_1", False),
                                        ("map at layer 4 and above", True), ("float", True)])
def test_serve_early_follows_the_first_four_layers(case, early, jax_int8):
    from ayolov2_torch.export import make_serving_fn
    from ayolov2_torch.models import build_model

    kw = {"int8": dict(fused=True, quant=True),
          "map at model_1": dict(decompose_map={"model_1": (4, 4)}),
          "map at layer 4 and above": dict(decompose_map={"model_4/m0/cv2": (4, 4),
                                                          "model_6/m1/cv2": (4, 4)}),
          "float": {}}[case]
    model = build_model(zoo_cfg("yolov5n"), device="cpu", **kw)
    assert make_serving_fn(model, device="cpu").early is early


@pytest.fixture(scope="module")
def data_cfg(tmp_path_factory):
    root = tmp_path_factory.mktemp("labelled")
    img_dir = labelled_set(root)
    cfg = root / "data.json"
    cfg.write_text(json.dumps({"val_path": str(img_dir), "nc": 20, "dataset": "VOC",
                               "names": [f"class{i}" for i in range(20)]}))
    return cfg


@pytest.mark.parametrize("method", ["absmax", "p999"])
def test_val_cli_int8_on_the_cpu(data_cfg, tmp_path, method):
    from ayolov2_torch.cli import val

    out = tmp_path / "val.json"
    got = val.main(["--weights", WEIGHTS, "--data-cfg", str(data_cfg), "-iw",
                    str(LABELLED_IMG), "--batch-size", "4", "--device", "cpu", "--no-half",
                    "--int8", "--calib-batches", "2", "--calib-method", method,
                    "--json-path", str(out)])
    assert json.loads(out.read_text())["seen"] == got["seen"] == 9
    assert 0.5 <= got["map50"] <= 1.0
    with pytest.raises(SystemExit, match="requires the fused serving path"):
        val.main(["--weights", WEIGHTS, "--data-cfg", str(data_cfg), "--device", "cpu",
                  "--int8", "--no-fuse"])


def test_int8_export_round_trip_on_the_cpu(data_cfg, tmp_path):
    """``cli.export --dtype int8 --calib-dir``: int8 weights in the artifact,
    the sidecar's ``quant`` true, and the artifact read in a fresh
    interpreter equal to serving the same int8 model in-process."""
    from ayolov2_torch.cli import export as cli_export
    from ayolov2_torch.export import make_serving_fn
    from ayolov2_torch.models import build_model
    from ayolov2_torch.utils.checkpoint import load_variables
    from ayolov2_torch.utils.weights import load_flax_variables

    images_dir = json.loads(data_cfg.read_text())["val_path"]
    argv = ["--weights", WEIGHTS, "--platforms", "cpu", "--dtype", "int8", "--calib-dir",
            images_dir, "--calib-batches", "2", "--nc", "20", "-iw", "64", "--batch-size", "2",
            "--out", str(tmp_path / "q"), "--no-dry-run"]
    paths = cli_export.main(argv)
    side = json.loads(open(paths["yaml"]).read())
    assert side["quant"] is True and side["half"] is True and side["early_pipeline"] is False
    state = torch.export.load(paths["pt2"]).state_dict
    assert sum(t.dtype == torch.int8 for t in state.values()) > 50
    assert all(t.dtype in (torch.int8, torch.bfloat16) for t in state.values() if t.dim() == 4)

    x = images((2, 64, 64, 3), 8)
    np.save(tmp_path / "x.npy", x)
    out = call_artifacts_fresh({"q": (paths["pt2"], str(tmp_path / "x.npy"))},
                               tmp_path / "out.npz")
    args = cli_export.get_parser().parse_args(argv)
    args.img_height = args.img_width
    variables, meta = load_variables(WEIGHTS)
    cfg = json.loads(meta["model_cfg"])
    qvars = cli_export.calibrated_int8(args, cfg, variables, {}, torch.device("cpu"))
    model = load_flax_variables(build_model(cfg, nc=20, fused=True, quant=True, device="cpu"),
                                qvars)
    det, n = make_serving_fn(model, keep_top_k=100, device="cpu")(torch.from_numpy(x))
    np.testing.assert_array_equal(out["q_1"], n.numpy())
    np.testing.assert_array_equal(out["q_0"], det.numpy())
