"""The measurement CLIs of the port (``cli.bench_matrix``,
``cli.profile_train``, ``cli.bench_loader``) on the CPU at small sizes:
their rows carry the names and keys of the JAX package's CLIs (written out
here from ``cli/bench_matrix.py``, ``cli/profile_train.py`` and
``cli/bench_loader.py``), the serve row runs the served graph, the
synthetic train batch equals JAX's, the FLOP count agrees with the model's
MACs, and none of them runs without a device or data."""

import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from _torch_port_common import ROOT, port_zoo_model, seeded_head_variables, train_files

torch.set_num_threads(1)
BATCH, SIZE = 2, 64
N_CFG = "res/configs/model/yolov5n.yaml"
BASE = {"metric", "value", "unit", "ms_per_batch"}
# (row names, keys) of each --configs entry of cli/bench_matrix.py, for model "yolov5n",
# the sweep at batch sizes 2 and 4 and the h2d rows at batch size 2
MATRIX_ROWS = {
    "serve": (["yolov5n_640_bs32_serve"], BASE),
    "int8": (["yolov5n_640_bs32_serve_int8"], BASE),
    "tta": (["yolov5n_640_bs32_tta_serve"], BASE),
    "decomposed": (["yolov5n_640_bs32_decomposed_serve"], BASE),
    "train": (["yolov5n_640_bs32_train_step"], BASE),
    "latency": (["yolov5n_640_bs1_p50_latency_ms"],
                {"metric", "value", "unit", "sync_rtt_ms", "p50_minus_rtt_ms"}),
    "sweep": ([f"yolov5n_640_bs{bs}_serve_{p}" for p in ("exact", "approx") for bs in (2, 4)],
              BASE | {"batch_size", "prefilter"}),
    "h2d": ([f"yolov5n_640_bs2_e2e_h2d_{t}" for t in ("overlap", "serial")],
            BASE | {"batch_size", "h2d", "caveat"}),
}


@pytest.fixture
def small_matrix(monkeypatch):
    from ayolov2_torch.cli import bench_matrix

    monkeypatch.setattr(bench_matrix, "BATCH", BATCH)
    monkeypatch.setattr(bench_matrix, "SIZE", SIZE)
    monkeypatch.setattr(bench_matrix, "H2D_BATCHES", (BATCH,))
    return bench_matrix


@pytest.mark.parametrize("config", sorted(MATRIX_ROWS))
def test_bench_matrix_rows_carry_the_jax_names_and_keys(small_matrix, config, tmp_path):
    """Each ``--configs`` entry emits the JAX CLI's rows, with its keys,
    finite, and ``--out`` writes them with the device they ran on."""
    names, keys = MATRIX_ROWS[config]
    out = tmp_path / "rows.json"
    assert small_matrix.main(["--device", "cpu", "--model-cfg", N_CFG, "--iters", "1",
                              "--configs", config, "--sweep-batch-sizes", "2", "4",
                              "--out", str(out)]) == 0
    rows = json.loads(out.read_text())
    assert rows["device"] == {"platform": "cpu", "name": "cpu", "count": 1}
    assert [r["metric"] for r in rows["rows"]] == names
    for row in rows["rows"]:
        assert keys <= set(row), row
        assert row["unit"] == ("ms" if config == "latency" else "images/sec/chip")
        assert row["value"] > 0
    assert small_matrix.rows_finite(rows["rows"])
    if config in ("serve", "tta", "decomposed"):
        assert all(r["early"] for r in rows["rows"])  # the early network's operator
    if config == "serve":  # on the CPU the operator runs its plain version: no launch
        assert rows["rows"][0]["k1_launches_per_call"] == 0
    if config == "sweep":
        assert all(("note" in r) == (r["prefilter"] == "approx") for r in rows["rows"])
        by_name = {r["metric"]: r["value"] for r in rows["rows"]}  # one timing per batch size
        assert all(by_name[n.replace("_approx", "_exact")] == v for n, v in by_name.items())


def test_bench_matrix_serve_equals_make_serving_fn(small_matrix, monkeypatch):
    """The serve row's function is ``make_serving_fn`` with the JAX CLI's
    NMS settings (conf 0.001, IoU 0.65, 512 candidates, 512 boxes to the
    NMS, 100 kept), the early network's operator in it (weights whose head
    gives detections: the row's ``init_model`` weights score below 0.001)."""
    from ayolov2_torch.export import make_serving_fn
    from ayolov2_torch.ops import early_pipeline as early

    dev = torch.device("cpu")
    model = port_zoo_model("yolov5n", seeded_head_variables("yolov5n", 7))
    x = torch.from_numpy(np.random.default_rng(0).integers(0, 255, (BATCH, SIZE, SIZE, 3),
                                                           dtype=np.uint8))
    serve = small_matrix._serving_fn(model.fuse(), dev)
    assert serve.early
    want = make_serving_fn(model.fuse(), conf_thres=0.001, iou_thres=0.65, top_k=512,
                           keep_top_k=100, nms_box=512, device="cpu")(x)
    calls = []
    real = early.early_pipeline_op

    def counted(*args):
        calls.append(args[2:])
        return real(*args)

    monkeypatch.setattr(early, "early_pipeline_op", counted)
    got = serve(x)
    assert calls == [(16, 1, 32, 16, 64)]  # c0, n, c1, ch, c2 of yolov5n
    assert got[1].sum() > 0
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=0)
    torch.testing.assert_close(got[1], want[1], rtol=0, atol=0)


def test_bench_matrix_train_e2e_rows(small_matrix, tmp_path, monkeypatch):
    """``train_e2e`` on a small labelled set: the host- and device-augmented
    loader feeding the step, the step alone and the renderer alone, with the
    JAX CLI's row names and keys."""
    _, data, _ = train_files(tmp_path)
    for k, v in {"SIZE": "64", "BS": "4", "EPOCHS": "2", "MODES": "host,device"}.items():
        monkeypatch.setenv(f"AYOLO_TRAIN_E2E_{k}", v)
    out = tmp_path / "rows.json"
    small_matrix.main(["--device", "cpu", "--model-cfg", N_CFG, "--iters", "1", "--configs",
                       "train_e2e", "--data", str(data), "--out", str(out)])
    rows = {r["metric"]: r for r in json.loads(out.read_text())["rows"]}
    assert set(rows) == {"yolov5n_64_bs4_train_e2e_host_aug", "yolov5n_64_bs4_train_e2e_device_aug",
                         "yolov5n_64_bs4_train_step_only", "yolov5n_64_bs4_render_only_bfloat16"}
    for mode in ("host", "device"):
        row = rows[f"yolov5n_64_bs4_train_e2e_{mode}_aug"]
        assert {"metric", "value", "unit", "epochs_timed", "note"} <= set(row)
        assert row["epochs_timed"] == 1 and row["value"] > 0 and row["finite"]
    assert BASE | {"note"} <= set(rows["yolov5n_64_bs4_train_step_only"])
    assert BASE | {"render_mode", "note"} <= set(rows["yolov5n_64_bs4_render_only_bfloat16"])


def test_bench_matrix_train_e2e_without_data_exits(small_matrix, tmp_path):
    """``train_e2e`` without its images exits non-zero naming the missing
    path (the data config, or its train_path), before any row is timed."""
    missing = tmp_path / "missing.yaml"
    with pytest.raises(SystemExit) as e:
        small_matrix.main(["--device", "cpu", "--configs", "serve", "train_e2e", "--data",
                           str(missing)])
    assert str(missing) in str(e.value.code)
    data = tmp_path / "data.yaml"
    data.write_text(f"train_path: {tmp_path / 'no_images'}\nnc: 3\n")
    with pytest.raises(SystemExit) as e:
        small_matrix.main(["--device", "cpu", "--configs", "train_e2e", "--data", str(data)])
    assert str(tmp_path / "no_images") in str(e.value.code)
    assert small_matrix.ROWS == []
    # the default data config (the JAX CLI's) names images the repository does not ship
    from ayolov2_torch.utils.config import load_yaml

    default = load_yaml(ROOT / "res/configs/data/voc_fixture.yaml")["train_path"]
    with pytest.raises(SystemExit) as e:
        small_matrix.main(["--device", "cpu", "--configs", "train_e2e"])
    assert default in str(e.value.code)


def _jax_profile_train():
    spec = importlib.util.spec_from_file_location("jax_profile_train",
                                                  ROOT / "cli" / "profile_train.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("bs,nc,size", [(2, 80, 64), (5, 3, 32), (8, 20, 0)])
def test_profile_train_make_batch_equals_jax(bs, nc, size):
    """``_make_batch`` gives JAX's synthetic batch: the same uint8 images
    from ``default_rng(0)``, one centred box per image, the same mask."""
    from ayolov2_torch.cli import profile_train

    jax_mod = _jax_profile_train()
    if size == 0:  # the modules' SIZE, both 640
        assert profile_train.SIZE == jax_mod.SIZE == 640
        size = 96
        jax_mod.SIZE = profile_train.SIZE = size
        try:
            want, got = jax_mod._make_batch(bs, nc), profile_train._make_batch(bs, nc)
        finally:
            jax_mod.SIZE = profile_train.SIZE = 640
    else:
        want, got = jax_mod._make_batch(bs, nc, size), profile_train._make_batch(bs, nc, size)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _macs(model, shape) -> int:
    """MACs of every conv and linear of one forward at ``shape`` (NCHW)."""
    total = [0]

    def conv(mod, inp, out):
        total[0] += out.numel() * mod.in_channels // mod.groups * mod.kernel_size[0] \
            * mod.kernel_size[1]

    def linear(mod, inp, out):
        total[0] += out.numel() * mod.in_features

    hooks = [m.register_forward_hook(conv if isinstance(m, torch.nn.Conv2d) else linear)
             for m in model.modules() if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear))]
    with torch.no_grad():
        model(torch.zeros(shape), training=True)
    for h in hooks:
        h.remove()
    return total[0]


def test_profile_train_flop_count_matches_the_model(monkeypatch):
    """One step's FLOPs from ``FlopCounterMode`` are within 5% of 2 x 3 x
    the conv and linear MACs of a forward (forward, input and weight
    gradients; the first conv has no input gradient)."""
    from ayolov2_torch.cli import profile_train

    monkeypatch.setattr(profile_train, "MODEL_CFG", N_CFG)
    dev = torch.device("cpu")
    state, loss_fn, _ = profile_train.build(BATCH, dev)
    flops = profile_train.step_flops(state, loss_fn, profile_train._make_batch(
        BATCH, state.model.nc, SIZE))
    macs = _macs(state.model, (BATCH, 3, SIZE, SIZE))
    assert flops is not None and abs(flops / (6 * macs) - 1) < 0.05, (flops, 6 * macs)
    assert profile_train.bf16_peak(dev) is None


def test_profile_train_rows_carry_the_jax_names_and_keys(monkeypatch, tmp_path):
    """The breakdown, the batch-size sweep, both remat modes and the
    donation row (with its note), with the JAX CLI's keys; with
    ``--skip-breakdown`` the full-step row."""
    from ayolov2_torch.cli import profile_train

    monkeypatch.setattr(profile_train, "MODEL_CFG", N_CFG)
    out = tmp_path / "rows.json"
    common = ["--device", "cpu", "--img-size", str(SIZE), "--batch-size", str(BATCH),
              "--iters", "1"]
    assert profile_train.main(common + ["--bs-sweep", "2", "4", "--out", str(out)]) == 0
    res = json.loads(out.read_text())
    assert res["img_size"] == SIZE and res["device"]["platform"] == "cpu"
    rows = res["rows"]
    assert [r["metric"] for r in rows] == ["train_stage_breakdown", "train_step_bs2",
                                           "train_step_bs4", "train_step_remat",
                                           "train_step_remat", "train_step_donated"]
    assert {"batch_size", "fwd_ms", "loss_ms", "bwd_ms", "opt_ema_ms", "opt_ema_direct_ms",
            "full_ms", "img_per_s", "mfu_pct", "flops_source"} <= set(rows[0])
    assert rows[0]["flops_source"] == "flop_counter" and rows[0]["mfu_pct"] is None
    for r in rows[1:3]:
        assert {"batch_size", "ms_per_step", "img_per_s", "mfu_pct"} <= set(r)
    assert [r["remat_mode"] for r in rows[3:5]] == ["True", "save_convs"]
    for r in rows[3:5]:
        assert {"remat_mode", "batch_size", "ms_per_step", "baseline_ms", "overhead_pct",
                "temp_mb", "baseline_temp_mb"} <= set(r)
    assert {"batch_size", "ms_per_step", "baseline_ms", "delta_pct", "note"} <= set(rows[5])
    assert "nothing to donate" in rows[5]["note"]
    for r in rows:
        assert all(v > 0 for k, v in r.items() if k in ("fwd_ms", "full_ms", "ms_per_step",
                                                         "img_per_s", "opt_ema_direct_ms"))
    profile_train.main(common + ["--bs-sweep", "--skip-breakdown", "--skip-remat",
                                 "--skip-donate", "--out", str(out)])
    rows = json.loads(out.read_text())["rows"]
    assert len(rows) == 1 and rows[0]["metric"] == "train_step_full"
    assert {"batch_size", "ms_per_step", "img_per_s", "mfu_pct"} <= set(rows[0])


@pytest.mark.parametrize("device_aug", [False, True])
def test_bench_loader_both_worker_modes(tmp_path, device_aug):
    """``cli.bench_loader`` on 8 images written here, thread and process
    workers (in a fresh interpreter: the process pool is forked, and this
    one has imported JAX), the step on the CPU: the JAX CLI's JSON line."""
    model, data, cfg = train_files(tmp_path)
    args = [sys.executable, "-m", "ayolov2_torch.cli.bench_loader", "--device", "cpu",
            "--data", str(data), "--cfg", str(cfg), "--model", str(model), "--batches", "2",
            "--workers", "2", "--batch-size", "4", "--img-size", "64"]
    r = subprocess.run(args + (["--device-aug"] if device_aug else []), cwd=ROOT,
                       capture_output=True, text=True, timeout=240,
                       env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert r.returncode == 0, r.stdout + r.stderr
    rep = json.loads(r.stdout.strip().splitlines()[-1])
    assert {"loader_img_s", "loader_cold_img_s", "loader_by_mode_img_s", "best_workers_mode",
            "cache", "device_aug", "workers", "batch_size", "img_size", "step_img_s",
            "bottleneck"} <= set(rep)
    assert set(rep["loader_by_mode_img_s"]) == {"thread", "process"}
    assert rep["device_aug"] is device_aug and rep["batch_size"] == 4 and rep["img_size"] == 64
    assert rep["loader_img_s"] > 0 and rep["step_img_s"] > 0
    assert rep["bottleneck"] in ("loader", "device") and rep["device"]["platform"] == "cpu"


@pytest.mark.parametrize("cli", ["bench_matrix", "profile_train", "bench_loader"])
def test_clis_need_a_device_without_cuda(cli, monkeypatch):
    """Without ``--device cpu`` each CLI asks for the card, and raises
    where CUDA is absent: none falls back to the CPU."""
    import importlib

    mod = importlib.import_module(f"ayolov2_torch.cli.{cli}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mod.main([])
