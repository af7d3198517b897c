"""Export of the serving graph against the JAX package's: ``cli.export``
writes a ``.pt2`` and its sidecar, a fresh interpreter without JAX reads the
artifact back, and its detections, decoded predictions and raw-frame
detections equal JAX's ``export_serving`` -> ``load_exported`` on the same
weights (the operators inside the graph: test_torch_port_export_ops.py)."""

import json
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from _torch_port_common import (
    GOLDEN,
    call_artifacts_fresh,
    images,
    jax_zoo_variables,
    port_zoo_model,
    rel_to_peak,
    seeded_head_variables,
    zoo_cfg,
)

torch.set_num_threads(1)
BS, IMG, RAW_HW = 2, 64, (96, 128)
JAX_SIDECAR_KEYS = {"batch_size", "img_width", "img_height", "conf_t", "iou_t", "keep_top_k",
                    "top_k", "include_nms", "half", "quant", "platforms", "on_device_letterbox",
                    "input", "outputs"}

def _write_checkpoint(path, name: str, variables):
    from ayolov2_torch.models.builder import parse_model_config
    from ayolov2_torch.utils.checkpoint import checkpoint_payload, write_checkpoint

    model = port_zoo_model(name, variables)
    state = types.SimpleNamespace(model=model, ema_model=model, ema_updates=1, step=1)
    write_checkpoint(path, checkpoint_payload(state, epoch=0, half=False,
                                              include_optimizer=False,
                                              model_cfg=parse_model_config(zoo_cfg(name))))


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """yolov5s (nc 80, seeded weights) exported by the port's ``cli.export``
    on the CPU in f32 three ways (NMS, decoded, raw frames) and by JAX's
    ``export_serving``; the port's artifacts called in a fresh interpreter,
    JAX's through its ``load_exported``, on the same uint8 batches."""
    from ayolov2_tpu.export import export_serving as jax_export
    from ayolov2_tpu.export import load_exported as jax_load
    from ayolov2_torch.cli import export as cli_export

    tmp = tmp_path_factory.mktemp("export")
    v = seeded_head_variables("yolov5s", 31)
    ckpt = tmp / "s.ckpt"
    _write_checkpoint(ckpt, "yolov5s", v)
    x = images((BS, IMG, IMG, 3), seed=32)
    x_raw = images((BS, *RAW_HW, 3), seed=33)
    np.save(tmp / "x.npy", x)
    np.save(tmp / "x_raw.npy", x_raw)
    common = ["--weights", str(ckpt), "--platforms", "cpu", "--no-half", "--batch-size",
              str(BS), "-iw", str(IMG)]
    cases = {"nms": (["--type", "tpu_nms"], {}, x), "decoded": (["--type", "tpu_raw"],
                                                                {"include_nms": False}, x),
             "raw": (["--type", "tpu_nms", "--raw-hw", *map(str, RAW_HW)],
                     {"raw_hw": RAW_HW}, x_raw)}
    paths, jobs, want = {}, {}, {}
    for name, (flags, jax_kw, inp) in cases.items():
        paths[name] = cli_export.main(common + flags + ["--out", str(tmp / f"port_{name}"),
                                                        "--no-dry-run"])
        jobs[name] = (paths[name]["pt2"], str(tmp / ("x_raw.npy" if "raw_hw" in jax_kw
                                                     else "x.npy")))
        jp = jax_export(zoo_cfg("yolov5s"), v, str(tmp / f"jax_{name}"), batch_size=BS,
                        img_size=(IMG, IMG), half=False, platforms=("cpu",), **jax_kw)
        res = jax_load(jp["jaxexp"])(inp)
        want[name] = tuple(np.asarray(r) for r in (res if isinstance(res, tuple) else (res,)))
    got = call_artifacts_fresh(jobs, tmp / "port_out.npz")
    return types.SimpleNamespace(paths=paths, got=got, want=want, tmp=tmp, ckpt=ckpt, v=v, x=x)


def _equal_detections(got_det, got_n, want_det, want_n):
    np.testing.assert_array_equal(got_n, want_n)
    assert got_n.sum() > 20  # the NMS had real work
    for i, n in enumerate(want_n):
        assert rel_to_peak(got_det[i, :n], want_det[i, :n]) < 1e-4
        np.testing.assert_array_equal(got_det[i, :n, 5], want_det[i, :n, 5])
        assert not got_det[i, n:].any()


def test_exported_detections_equal_jax(exported):
    """tpu_nms: (bs, 100, 6) detections and counts of the artifact read in
    a fresh interpreter: counts equal, boxes and scores within 1e-4 of the
    peak, classes equal."""
    det, n = exported.got["nms_0"], exported.got["nms_1"]
    assert det.shape == (BS, 100, 6) and n.shape == (BS,) and n.dtype == np.int32
    _equal_detections(det, n, *exported.want["nms"])


def test_exported_decoded_predictions_equal_jax(exported):
    """tpu_raw (``include_nms=False``): the decoded (bs, N, 5+nc) within
    1e-4 of the peak of JAX's."""
    got = exported.got["decoded_0"]
    assert got.shape == exported.want["decoded"][0].shape == (BS, 3 * (8 * 8 + 4 * 4 + 2 * 2), 85)
    assert rel_to_peak(got, exported.want["decoded"][0]) < 1e-4


def test_exported_raw_frames_equal_jax(exported):
    """``--raw-hw 96 128``: native frames letterboxed in the graph, boxes in
    the frames' coordinates, as JAX's ``make_raw_serving_fn``."""
    det, n = exported.got["raw_0"], exported.got["raw_1"]
    _equal_detections(det, n, *exported.want["raw"])
    assert det[..., [0, 2]].max() <= RAW_HW[1] and det[..., [1, 3]].max() <= RAW_HW[0]


def test_exported_graph_equals_make_serving_fn(exported):
    """The artifact is the serving module: ``make_serving_fn`` (and
    ``make_raw_serving_fn``) in f32 on the same weights give its outputs
    (without the early-network kernel, which a CPU artifact leaves out)."""
    from ayolov2_torch.export import make_raw_serving_fn, make_serving_fn

    model = port_zoo_model("yolov5s", exported.v).fuse()
    serve = make_serving_fn(model, image_dtype=torch.float32, early_pipeline=False,
                            device="cpu")
    det, n = serve(torch.from_numpy(exported.x))
    _equal_detections(det.numpy(), n.numpy(), exported.got["nms_0"], exported.got["nms_1"])
    decoded = make_serving_fn(model, image_dtype=torch.float32, include_nms=False,
                              early_pipeline=False, device="cpu")(torch.from_numpy(exported.x))
    assert rel_to_peak(decoded.numpy(), exported.got["decoded_0"]) < 1e-5
    raw_serve = make_raw_serving_fn(model, RAW_HW, (IMG, IMG), image_dtype=torch.float32,
                                    device="cpu")
    det, n = raw_serve(torch.from_numpy(np.load(exported.tmp / "x_raw.npy")))
    _equal_detections(det.numpy(), n.numpy(), exported.got["raw_0"], exported.got["raw_1"])


def test_sidecar_is_read_alike_by_yaml_and_the_port(exported):
    """The sidecar is JSON text: ``yaml.safe_load`` (what JAX's
    ``cli/val.py`` reads it with) and the port's reader give one dict with
    JAX's keys, plus ``early_pipeline``."""
    from ayolov2_torch.utils.config import load_yaml

    for name, paths in exported.paths.items():
        text = open(paths["yaml"]).read()
        meta = load_yaml(paths["yaml"])
        assert yaml.safe_load(text) == meta
        assert JAX_SIDECAR_KEYS <= set(meta)
        assert meta["platforms"] == ["cpu"] and meta["early_pipeline"] is False
        assert meta["include_nms"] is (name != "decoded") and meta["half"] is False
        h, w = RAW_HW if name == "raw" else (IMG, IMG)
        assert meta["input"] == {"shape": [BS, h, w, 3], "dtype": "uint8"}
        assert meta["on_device_letterbox"] is (name == "raw")


@pytest.mark.parametrize("raw_hw,img_hw,scale_up", [
    ((720, 1280), (640, 640), True), ((96, 128), (64, 64), True), ((480, 640), (640, 640), False),
    ((33, 57), (64, 96), True), ((1080, 1920), (384, 640), True), ((100, 20), (64, 64), False),
])
def test_letterbox_geometry_equals_jax(raw_hw, img_hw, scale_up):
    from ayolov2_tpu.export.exporter import letterbox_geometry as jax_geometry
    from ayolov2_torch.export import letterbox_geometry

    assert letterbox_geometry(raw_hw, img_hw, scale_up) == jax_geometry(raw_hw, img_hw, scale_up)


@pytest.mark.parametrize("raw_hw", [(96, 128), (40, 30), (64, 64)])
def test_device_letterbox_equals_jax(raw_hw):
    """The in-graph resize (shrink, enlarge, none) and pad, f32."""
    from ayolov2_tpu.export.exporter import device_letterbox as jax_letterbox
    from ayolov2_torch.export.exporter import device_letterbox

    x = images((2, *raw_hw, 3), seed=34)
    want = np.asarray(jax_letterbox(jnp.asarray(x), raw_hw, (64, 64)))
    got = device_letterbox(torch.from_numpy(x), raw_hw, (64, 64)).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() < 1e-3


def test_export_refuses_what_is_not_ported(tmp_path):
    """An artifact is made for one device; ``cli.export`` exits on
    ``--platforms tpu``, and int8 without a calibrator falls back to float
    as JAX's entry point does (int8 and decomposed export:
    test_torch_port_quant.py, test_torch_port_decompose.py)."""
    from ayolov2_torch.cli import export as cli_export
    from ayolov2_torch.export import export_serving

    _, v = jax_zoo_variables("yolov5n", seed=35)
    with pytest.raises(ValueError, match="one device"):
        export_serving(zoo_cfg("yolov5n"), v, str(tmp_path / "m"), platforms=("cpu", "cuda"))
    weights = str(GOLDEN / "weights/best.ckpt")
    with pytest.raises(SystemExit, match="--platforms tpu"):
        cli_export.main(["--weights", weights, "--platforms", "tpu"])
    paths = cli_export.main(["--weights", weights, "--platforms", "cpu", "--dtype", "int8",
                             "--nc", "20", "-iw", "64", "--batch-size", "1", "--out",
                             str(tmp_path / "fallback"), "--no-dry-run"])
    assert json.loads(open(paths["yaml"]).read())["half"] is True
