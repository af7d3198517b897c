"""The exported graph's operators: the greedy NMS loop as a ``while_loop``
(equal to the eager loop on deep suppression chains, inside an exported
graph too), the early-network kernel as ``ayolov2::early_pipeline`` inside
an artifact read by a fresh interpreter, ``approx_prefilter`` against JAX,
and ``cli.val`` scoring an exported golden checkpoint."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_common import (
    GOLDEN,
    LABELLED_IMG,
    call_artifacts_fresh,
    images,
    labelled_set,
    port_zoo_model,
    seeded_head_variables,
)

torch.set_num_threads(1)
BS, IMG = 2, 64


def test_early_pipeline_operator_inside_an_exported_graph(tmp_path):
    """The early-network kernel as the operator ``ayolov2::early_pipeline``:
    its packed weights are a buffer of the exported module, the graph calls
    it, and the artifact read in a fresh interpreter gives what
    ``make_serving_fn`` with the kernel's path gives (on the CPU the
    operator is the plain version)."""
    from ayolov2_torch.export import make_serving_fn
    from ayolov2_torch.export.exporter import ServingModule
    from ayolov2_torch.ops import early_pipeline as early

    v = seeded_head_variables("yolov5s", 36)
    model = port_zoo_model("yolov5s", v).fuse()
    serve = ServingModule(model, torch.device("cpu"), torch.float32, 0.001, 0.65, 512, 100,
                          1000, True, True, True, False, False, "nms", img_hw=(IMG, IMG),
                          graph_nms=True)
    x = images((BS, IMG, IMG, 3), seed=37)
    program = torch.export.export(serve, (torch.from_numpy(x),))
    ops = [n.target for n in program.graph.nodes if n.op == "call_function"]
    assert ops.count(torch.ops.ayolov2.early_pipeline.default) == 1
    assert any("while_loop" in str(t) for t in ops)
    assert "k1_weights" in program.state_dict
    path = tmp_path / "k1.pt2"
    torch.export.save(program, str(path))
    np.save(tmp_path / "x.npy", x)
    got = call_artifacts_fresh({"k1": (str(path), str(tmp_path / "x.npy"))}, tmp_path / "out.npz")
    eager = make_serving_fn(model, image_dtype=torch.float32, device="cpu")
    assert eager.early
    before = early.early_pipeline.launches
    det, n = eager(torch.from_numpy(x))
    assert early.early_pipeline.launches == before  # the plain version launches nothing
    np.testing.assert_array_equal(got["k1_1"], n.numpy())
    np.testing.assert_allclose(got["k1_0"], det.numpy(), rtol=0, atol=1e-4)


def test_early_pipeline_operator_on_the_cpu():
    """The operator's CPU implementation is the plain version on the
    unpacked weights (bit for bit); its fake implementation gives the
    shape; packing and unpacking are inverse."""
    from ayolov2_torch.models import build_model, init_model, yolov5_cfg
    from ayolov2_torch.ops import early_pipeline as early

    for variant in "nm":
        ep = early.extract_early_params(init_model(build_model(
            yolov5_cfg(variant), device="cpu"), 3).fuse().state_dict())
        packed = early.pack_weights(ep)
        assert packed.numel() == early.packed_numel(ep.c0, ep.n)
        back = early.unpack_weights(packed, ep.c0, ep.n)
        assert all(torch.equal(a, b) for a, b in zip(ep.segments(), back.segments()))
        x = torch.from_numpy(images((1, 48, 40, 3), seed=38))
        want = early.early_pipeline_ref(x, ep)
        assert torch.equal(torch.ops.ayolov2.early_pipeline(x, packed, ep.c0, ep.n), want)
        assert torch.equal(early.early_pipeline(x, ep), want)
        with torch._subclasses.fake_tensor.FakeTensorMode() as mode:
            fake = torch.ops.ayolov2.early_pipeline(mode.from_tensor(x), mode.from_tensor(packed),
                                                    ep.c0, ep.n)
        assert fake.shape == want.shape and fake.dtype == torch.bfloat16
    with pytest.raises(ValueError, match="do not hold widths"):
        early.unpack_weights(packed[:-1], ep.c0, ep.n)


def _chain_iou(bs: int, k: int, depth: int, seed: int) -> torch.Tensor:
    """Random IoUs below the threshold plus a suppression chain 0 -> 1 ->
    ... -> depth (each candidate overlaps the next): greedy keeps every
    other one, and the Jacobi sweeps need depth + 1 rounds to settle."""
    rng = np.random.default_rng(seed)
    iou = rng.uniform(0.0, 0.6, (bs, k, k)).astype(np.float32)
    iou = np.minimum(iou, iou.transpose(0, 2, 1))
    for i in range(depth):
        iou[:, i, i + 1] = iou[:, i + 1, i] = 0.9
    extra = rng.uniform(size=(bs, k, k)) < 0.01  # and a few random overlaps off the chain
    extra[:, :depth + 1] = extra[:, :, :depth + 1] = False
    iou[extra] = 0.8
    return torch.from_numpy(iou)


@pytest.mark.parametrize("depth", [0, 1, 7, 8, 9, 31, 130])
def test_while_loop_suppression_equals_the_loop(depth):
    """The greedy NMS as a ``while_loop`` operator keeps exactly what the
    eager loop keeps, on chains of suppression deeper than 8 too, eager and
    inside an exported graph, and both equal the sequential definition."""
    from ayolov2_torch.ops.nms import _greedy_suppress

    iou = _chain_iou(3, 160, depth, seed=depth)
    valid = torch.from_numpy(np.random.default_rng(depth + 1).uniform(size=(3, 160)) < 0.9)
    valid[:, :depth + 1] = True
    want = _greedy_suppress(iou, valid, 0.65)
    assert _greedy_suppress.last_sweeps >= depth + 1
    assert torch.equal(_greedy_suppress(iou, valid, 0.65, graph=True), want)

    class Suppress(torch.nn.Module):
        def forward(self, iou, valid):
            return _greedy_suppress(iou, valid, 0.65, graph=True)

    program = torch.export.export(Suppress(), (iou, valid))
    assert torch.equal(program.module()(iou, valid), want)
    for b in range(3):  # the sequential definition
        keep = []
        for j in range(160):
            keep.append(bool(valid[b, j]) and not any(keep[i] and iou[b, i, j] > 0.65
                                                      for i in range(j)))
        assert keep == want[b].tolist()


def test_approx_prefilter_is_the_exact_top_k_as_jax_off_the_tpu():
    """``approx_prefilter`` is taken; off the TPU JAX's ``approx_max_k``
    returns the exact top-k, so both sides give the exact path's result."""
    from ayolov2_tpu.ops import nms as jax_nms
    from ayolov2_torch.ops import nms

    rng = np.random.default_rng(39)
    raw = rng.normal(0, 2, (2, 2835, 25)).astype(np.float32)
    meta = nms.flat_grid_meta((8.0, 16.0, 32.0), np.full((3, 3, 2), 20.0, np.float32),
                              (96, 480))
    assert meta[0].shape[0] == 2835
    kw = dict(conf_thres=0.001, iou_thres=0.65, nms_box=1000, pre_top_k=512, keep_top_k=100)
    jd, jn = jax_nms.fused_decode_nms(jnp.asarray(raw), *(jnp.asarray(m) for m in meta),
                                      approx_prefilter=True, **kw)
    jd0, jn0 = jax_nms.fused_decode_nms(jnp.asarray(raw), *(jnp.asarray(m) for m in meta), **kw)
    np.testing.assert_array_equal(np.asarray(jd), np.asarray(jd0))
    d, n = nms.fused_decode_nms(torch.from_numpy(raw), *(torch.from_numpy(m) for m in meta),
                                approx_prefilter=True, **kw)
    np.testing.assert_array_equal(n.numpy(), np.asarray(jn))
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=0, atol=1e-4)


@pytest.fixture(scope="module")
def data_cfg(tmp_path_factory):
    root = tmp_path_factory.mktemp("labelled")
    img_dir = labelled_set(root)
    cfg = root / "data.json"
    cfg.write_text(json.dumps({"val_path": str(img_dir), "nc": 20, "dataset": "VOC",
                               "names": [f"class{i}" for i in range(20)]}))
    return cfg


def test_val_cli_scores_an_exported_golden_checkpoint(data_cfg, tmp_path):
    """``cli.export`` of the golden checkpoint (CPU, f32, bs 4, 160), then
    ``cli.val --weights model.pt2``: the sidecar's batch and size, square
    batches, the final batch padded. Its scores equal (1e-6) the validator's
    over the same loader with the serving function of the checkpoint as its
    detection function (the best class of each box, as the artifact's NMS
    keeps); ``cli.val`` of the checkpoint at the same square geometry takes
    every class of a box and scores within 0.02 of it."""
    from ayolov2_torch.cli import export as cli_export
    from ayolov2_torch.cli import val
    from ayolov2_torch.data import DataLoader, DetectionDataset
    from ayolov2_torch.eval import YoloValidator
    from ayolov2_torch.export import make_serving_fn
    from ayolov2_torch.utils.checkpoint import load_model

    weights = str(GOLDEN / "weights/best.ckpt")
    paths = cli_export.main(["--weights", weights, "--nc", "20", "--platforms", "cpu",
                             "--no-half", "-iw", str(LABELLED_IMG), "--batch-size", "4",
                             "--out", str(tmp_path / "golden")])
    out = tmp_path / "art.json"
    art = val.main(["--weights", paths["pt2"], "--data-cfg", str(data_cfg), "--device", "cpu",
                    "--json-path", str(out)])
    assert art["seen"] == 9 and json.loads(out.read_text())["seen"] == 9

    ds = DetectionDataset(json.loads(data_cfg.read_text())["val_path"], img_size=LABELLED_IMG,
                          batch_size=4, rect=False, stride=32)
    serve = make_serving_fn(load_model(weights, nc=20, fuse=True, device="cpu"),
                            image_dtype=torch.float32, early_pipeline=False, device="cpu")
    same = YoloValidator(None, DataLoader(ds, batch_size=4, pad_final_batch=True),
                         cfg={"nc": 20}, detection_fn=serve, device="cpu").validation()
    for k in ("map50", "map50_95", "mp", "mr"):
        assert abs(art[k] - same[k]) <= 1e-6, k
    ckpt = val.main(["--weights", weights, "--data-cfg", str(data_cfg), "--device", "cpu",
                     "-iw", str(LABELLED_IMG), "--batch-size", "4", "--no-rect", "--no-half"])
    assert ckpt["seen"] == 9 and abs(art["map50"] - ckpt["map50"]) <= 0.02


def test_val_of_an_artifact_equals_jax_val_of_its_artifact(data_cfg, tmp_path):
    """The same golden checkpoint exported by each package (CPU, f32, bs 4,
    160) and validated as each package's ``cli/val.py`` validates an
    artifact (``rect=False``, the final batch padded): equal scores to
    1e-3."""
    from ayolov2_tpu.data import DataLoader as JaxLoader
    from ayolov2_tpu.data import DetectionDataset as JaxDataset
    from ayolov2_tpu.eval import YoloValidator as JaxValidator
    from ayolov2_tpu.export import export_serving as jax_export
    from ayolov2_tpu.export import load_exported as jax_load
    from ayolov2_tpu.utils.checkpoint import load_variables
    from ayolov2_torch.cli import export as cli_export
    from ayolov2_torch.cli import val

    weights = str(GOLDEN / "weights/best.ckpt")
    variables, meta = load_variables(weights)
    jp = jax_export(json.loads(meta["model_cfg"]), variables, str(tmp_path / "jax"),
                    batch_size=4, img_size=(LABELLED_IMG, LABELLED_IMG), nc=20, half=False,
                    platforms=("cpu",))
    ds = JaxDataset(json.loads(data_cfg.read_text())["val_path"], img_size=LABELLED_IMG,
                    batch_size=4, rect=False, stride=32)
    want = JaxValidator(None, {}, JaxLoader(ds, batch_size=4, shuffle=False,
                                            pad_final_batch=True),
                        cfg={"nc": 20}, detection_fn=jax_load(jp["jaxexp"])).validation()
    paths = cli_export.main(["--weights", weights, "--nc", "20", "--platforms", "cpu",
                             "--no-half", "-iw", str(LABELLED_IMG), "--batch-size", "4",
                             "--out", str(tmp_path / "port"), "--no-dry-run"])
    got = val.main(["--weights", paths["pt2"], "--data-cfg", str(data_cfg), "--device", "cpu"])
    assert got["seen"] == want["seen"] == 9
    for k in ("map50", "map50_95", "mp", "mr"):
        assert abs(got[k] - want[k]) <= 1e-3, (k, got[k], want[k])
