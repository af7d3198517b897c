"""Tucker-2 / EVBMF decomposition: the port against the JAX package on the
same seeded numpy inputs, on the CPU.

EVBMF ranks, ``tucker2``'s parts and ``decompose_model``'s map, ranks,
prune ratios and report equal JAX's; the decomposed yolov5n's forward
(unfused and fused) matches JAX's; decomposed checkpoints are read both
ways; and the entry points take them with ``--device cpu``."""

import json

import numpy as np
import pytest
import torch

from _torch_port_common import (
    as_np,
    images,
    jax_zoo_variables,
    labelled_set,
    nchw,
    rel_to_peak,
    tree_leaves,
    zoo_cfg,
)

torch.set_num_threads(1)
PLANTED = ("model_2/m0/cv2", "model_4/m0/cv2", "model_6/m1/cv2")


@pytest.fixture(autouse=True, scope="module")
def one_blas_thread():
    """One BLAS thread: the f64 SVDs of several test workers at once
    oversubscribe the cores many times over otherwise."""
    from threadpoolctl import threadpool_limits

    with threadpool_limits(1):
        yield


@pytest.mark.parametrize("case", ["rank3", "rank8", "noise", "tall", "sigma"])
def test_evbmf_ranks_equal_jax(case):
    from ayolov2_torch.compress import EVBMF
    from ayolov2_tpu.compress import EVBMF as jax_evbmf

    rng = np.random.default_rng(len(case))
    if case.startswith("rank"):
        r = int(case[4:])
        y = rng.standard_normal((64, r)) @ rng.standard_normal((r, 256))
        y += 0.01 * rng.standard_normal(y.shape)
    elif case == "tall":
        y = rng.standard_normal((300, 5)) @ rng.standard_normal((5, 40))
    else:
        y = rng.standard_normal((64, 256))
    kw = {"sigma2": 1.0} if case == "sigma" else {}
    assert EVBMF(y, **kw) == jax_evbmf(y, **kw)


def test_estimate_ranks_and_tucker2_equal_jax():
    from ayolov2_torch.compress import estimate_ranks, tucker2
    from ayolov2_torch.compress.decomposition import decomposed_conv_params, reconstruct_kernel
    from ayolov2_tpu.compress import estimate_ranks as jax_ranks
    from ayolov2_tpu.compress import tucker2 as jax_tucker2
    from ayolov2_tpu.compress.decomposition import decomposed_conv_params as jax_parts

    rng = np.random.default_rng(0)
    core = rng.standard_normal((3, 3, 4, 6))
    u_in = np.linalg.qr(rng.standard_normal((32, 4)))[0]
    u_out = np.linalg.qr(rng.standard_normal((64, 6)))[0]
    kernel = np.einsum("hwrs,cr,os->hwco", core, u_in, u_out) + 1e-3 * rng.standard_normal(
        (3, 3, 32, 64))
    assert estimate_ranks(kernel) == jax_ranks(kernel)
    for got, want in zip(tucker2(kernel, 4, 6), jax_tucker2(kernel, 4, 6)):
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= 1e-12
    parts = decomposed_conv_params(kernel, 4, 6)
    want = jax_parts(kernel, 4, 6)
    for key in parts:
        np.testing.assert_array_equal(parts[key]["kernel"], want[key]["kernel"])
    assert np.linalg.norm(reconstruct_kernel(parts) - kernel) < 1e-2 * np.linalg.norm(kernel)


def _plant(params, paths=PLANTED, rank=4, seed=0):
    """Rank-``rank`` kernels at ``paths`` (seeded), as the JAX package's
    decomposition tests plant them."""
    rng = np.random.default_rng(seed)
    for path in paths:
        sub = params
        for p in path.split("/"):
            sub = sub[p]
        kh, kw, cin, cout = sub["conv"]["kernel"].shape
        r = min(rank, cin, cout)
        core = rng.standard_normal((kh, kw, r, r)) * 0.1
        u_in = np.linalg.qr(rng.standard_normal((cin, r)))[0]
        u_out = np.linalg.qr(rng.standard_normal((cout, r)))[0]
        sub["conv"]["kernel"] = np.einsum("hwrs,cr,os->hwco", core, u_in,
                                          u_out).astype(np.float32)


def test_decompose_model_equals_jax():
    """Map, ranks, prune ratios, report and the new tree equal JAX's on
    seeded yolov5n weights with planted kernels (the drawn kernels rank too
    low to pass the loss gate, so those are skipped alike)."""
    from ayolov2_torch.compress import decompose_model
    from ayolov2_tpu.compress import decompose_model as jax_decompose

    _, v = jax_zoo_variables("yolov5n", seed=63)
    _plant(v["params"], rank=8)
    params = v["params"]
    kw = dict(loss_thr=0.1, prune_step=0.25, n_test=256, seed=3)
    dmap, new, report = decompose_model(params, **kw)
    jmap, jnew, jreport = jax_decompose(params, **kw)
    assert dmap == jmap and report == jreport
    assert set(dmap) == set(PLANTED)
    assert any(layer.get("skipped") for layer in report["layers"])
    assert any(layer.get("prune_ratio", 0) > 0 for layer in report["layers"])
    got, want = tree_leaves(new), tree_leaves(jnew)
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_array_equal(got[key], np.asarray(want[key]), err_msg=str(key))


@pytest.fixture(scope="module")
def decomposed_n():
    """(JAX unfused variables of seeded yolov5n decomposed at PLANTED, the map)."""
    from ayolov2_tpu.compress import decompose_model as jax_decompose

    _, v = jax_zoo_variables("yolov5n", seed=61)
    _plant(v["params"])
    dmap, new, _ = jax_decompose(v["params"], loss_thr=0.1, prune_step=0.0, n_test=128)
    assert set(dmap) == set(PLANTED)
    return {"params": new, "batch_stats": v["batch_stats"]}, dmap


@pytest.mark.parametrize("fused", [False, True])
def test_decomposed_forward_equals_jax(decomposed_n, fused):
    import jax

    from ayolov2_torch.models import build_model
    from ayolov2_torch.utils.weights import load_flax_variables
    from ayolov2_tpu.models import build_model as jax_build
    from ayolov2_tpu.models import fuse_params

    variables, dmap = decomposed_n
    jmodel = jax_build(zoo_cfg("yolov5n"), fused=fused, decompose_map=dmap)
    jvars = fuse_params(variables) if fused else variables
    x = images((2, 64, 64, 3), 62).astype(np.float32) / 255.0
    want = jax.jit(lambda v, x: jmodel.apply(v, x, training=False)[1])(jvars, x)
    model = load_flax_variables(build_model(zoo_cfg("yolov5n"), device="cpu",
                                            decompose_map=dmap), variables)
    if fused:
        model = model.fuse()
        names = model.state_dict()
        assert all(f"{k}.conv_last.bias" in names
                   for k in ("model.2.m.0.cv2", "model.4.m.0.cv2", "model.6.m.1.cv2"))
    with torch.no_grad():
        got = model(nchw(x), training=False)[1]
    for g, w in zip(got, want):
        assert rel_to_peak(as_np(g), np.asarray(w)) <= 1e-4


def test_decomposed_checkpoints_read_both_ways(decomposed_n, tmp_path):
    """The port writes a decomposed checkpoint that the JAX package loads
    into its decomposed graph, and reads the one JAX's entry point writes."""
    import jax
    import jax.numpy as jnp
    from flax import serialization

    from ayolov2_torch.models import build_model, yolov5_cfg
    from ayolov2_torch.utils.checkpoint import load_model, write_checkpoint
    from ayolov2_torch.utils.weights import load_flax_variables
    from ayolov2_tpu.models import build_model as jax_build
    from ayolov2_tpu.utils.checkpoint import load_variables as jax_load

    variables, dmap = decomposed_n
    cfg = yolov5_cfg("n", nc=80)
    meta = {"version": 1, "epoch": 0, "best_score": 0.0, "map50": -1.0, "ema_updates": 0,
            "step": 0, "model_cfg": json.dumps(cfg), "decompose_map": json.dumps(dmap)}
    payload = {"meta": meta, "model": variables, "ema": variables}
    jax_written = tmp_path / "jax.ckpt"
    jax_written.write_bytes(serialization.msgpack_serialize(payload))
    model = load_model(jax_written, device="cpu", fuse=False)
    assert model.decompose_map == {k: tuple(v) for k, v in dmap.items()}
    want = load_flax_variables(build_model(cfg, device="cpu", decompose_map=dmap), variables)
    for (k, a), (_, b) in zip(model.state_dict().items(), want.state_dict().items()):
        assert torch.equal(a, b), k

    port_written = tmp_path / "port.ckpt"
    write_checkpoint(port_written, payload)
    jv, jmeta = jax_load(port_written)
    jdmap = json.loads(jmeta["decompose_map"])
    jmodel = jax_build(json.loads(jmeta["model_cfg"]), decompose_map=jdmap)
    x = jnp.zeros((1, 64, 64, 3), jnp.float32)
    out = jax.jit(lambda v, x: jmodel.apply(v, x, training=False)[1])(jv, x)
    assert len(out) == 3 and all(np.isfinite(np.asarray(o)).all() for o in out)

    # the write side of a trained state keeps the map in its meta
    from ayolov2_torch.utils.checkpoint import _decompose_meta

    assert json.loads(_decompose_meta(model)["decompose_map"]) == {k: list(v)
                                                                   for k, v in dmap.items()}


@pytest.fixture(scope="module")
def data_cfg(tmp_path_factory):
    root = tmp_path_factory.mktemp("labelled")
    img_dir = labelled_set(root)
    cfg = root / "data.json"
    cfg.write_text(json.dumps({"val_path": str(img_dir), "nc": 20, "dataset": "VOC",
                               "names": [f"class{i}" for i in range(20)]}))
    return cfg


def test_entry_points_take_a_decomposed_checkpoint(data_cfg, tmp_path):
    """``cli.decompose_model`` at its defaults on a yolov5n checkpoint (nc
    20, the port's initialisation) with planted kernels decomposes those
    three at their rank and none of its own 14, then ``cli.val``,
    ``cli.val2`` and ``cli.export`` of the decomposed checkpoint, all with
    ``--device cpu``; the JAX package reads the checkpoint too."""
    from ayolov2_torch.cli import decompose_model as cli_decompose
    from ayolov2_torch.cli import export as cli_export
    from ayolov2_torch.cli import val, val2
    from ayolov2_torch.models import build_model, init_model, yolov5_cfg
    from ayolov2_torch.utils.checkpoint import write_checkpoint
    from ayolov2_torch.utils.weights import flax_from_state_dict
    from ayolov2_tpu.utils.checkpoint import load_variables as jax_load

    cfg = yolov5_cfg("n", nc=20)
    variables = flax_from_state_dict(init_model(build_model(cfg, device="cpu"), seed=5)
                                     .state_dict())
    _plant(variables["params"])
    meta = {"version": 1, "epoch": 0, "best_score": 0.0, "map50": -1.0, "ema_updates": 0,
            "step": 0, "model_cfg": json.dumps(cfg)}
    planted = tmp_path / "planted.ckpt"
    write_checkpoint(planted, {"meta": meta, "model": variables, "ema": variables})
    out = tmp_path / "dec.ckpt"
    res = cli_decompose.main(["--weights", str(planted), "--data-cfg", str(data_cfg), "-iw",
                              "128", "--batch-size", "4", "--device", "cpu", "--out", str(out)])
    want_map = {p: [4, 4] for p in PLANTED}
    assert {k: list(v) for k, v in res["decompose_map"].items()} == want_map
    assert abs(res["map50_after"] - res["map50_before"]) <= 0.01
    args_yaml = json.loads(out.with_suffix(".args.yaml").read_text())
    assert args_yaml["params_after"] < args_yaml["params_before"]
    layers = args_yaml["report"]["layers"]
    assert len(layers) == 17 and sum(bool(x.get("skipped")) for x in layers) == 14
    assert json.loads(jax_load(out)[1]["decompose_map"]) == want_map

    common = ["--weights", str(out), "--data-cfg", str(data_cfg), "-iw", "128",
              "--batch-size", "4", "--device", "cpu"]
    r = val.main(common)
    assert r["map50"] == pytest.approx(res["map50_after"], abs=1e-9)
    metrics = val2.main(common + ["--json-path", str(tmp_path / "sheet.json")])
    assert 0.0 <= metrics["map50"] <= 1.0
    paths = cli_export.main(["--weights", str(out), "--platforms", "cpu", "--nc", "20", "-iw",
                             "64", "--batch-size", "1", "--out", str(tmp_path / "dec"),
                             "--no-dry-run", "--type", "tpu_raw"])
    state = torch.export.load(paths["pt2"]).state_dict
    assert any("conv_core" in k for k in state)
