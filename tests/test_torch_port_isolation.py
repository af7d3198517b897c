"""The port stands alone: no JAX, no JAX package, configs equal the YAMLs,
and entry points never fall back to the CPU on their own."""

import re
import subprocess
import sys

import pytest
import torch
import yaml

from _torch_port_common import CFG, ROOT, train_files

torch.set_num_threads(1)

FORBIDDEN = re.compile(r"\b(jax|flax|ayolov2_tpu)\b")


def test_import_pulls_in_no_jax():
    code = (
        "import sys, ayolov2_torch, ayolov2_torch.models, ayolov2_torch.ops.nms, "
        "ayolov2_torch.ops.early_pipeline, ayolov2_torch.export, ayolov2_torch.parallel, "
        "ayolov2_torch.utils.weights, ayolov2_torch.data.image_ops, ayolov2_torch.data.augment, "
        "ayolov2_torch.data.datasets, ayolov2_torch.data.loader, ayolov2_torch.utils.plots, "
        "ayolov2_torch.utils.png, ayolov2_torch.utils.profiling, ayolov2_torch.ops.tta, "
        "ayolov2_torch.cli.export, ayolov2_torch.compress, ayolov2_torch.ops.int8_conv, "
        "ayolov2_torch.search, ayolov2_torch.cli.decompose_model, "
        "ayolov2_torch.cli.val_optimizer, ayolov2_torch.cli.create_swa_model, "
        "ayolov2_torch.cli.probe_int8_conv, ayolov2_torch.cli.artifact_sizes, "
        "ayolov2_torch.utils.torch_import, ayolov2_torch.loss.losses_repr, "
        "ayolov2_torch.data.datasets_repr, ayolov2_torch.train.repr_trainer, "
        "ayolov2_torch.train.kd_trainer, ayolov2_torch.cli.distillation, "
        "ayolov2_torch.cli.train_repr, ayolov2_torch.cli.crop_bboxes, "
        "ayolov2_torch.cli.import_torch_weights, ayolov2_torch.cli.bench_matrix, "
        "ayolov2_torch.cli.profile_train, ayolov2_torch.cli.bench_loader, "
        "ayolov2_torch.export.aoti\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'ayolov2_tpu', 'cv2', "
        "'PIL', 'matplotlib', 'scipy')]\n"
        "print(bad); sys.exit(1 if bad else 0)\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_every_module_imports_without_jax_opencv_pil_yaml_or_msgpack():
    """Each module imports with JAX, flax, the JAX package, cv2, PIL, PyYAML,
    msgpack and matplotlib blocked: the card's machine has none of them;
    and without scipy, which only the decomposition's and the auto-anchor's
    functions import."""
    code = (
        "import sys, pkgutil, importlib\n"
        "for name in ('jax', 'flax', 'ayolov2_tpu', 'cv2', 'PIL', 'yaml', 'msgpack', 'matplotlib',\n"
        "             'scipy'):\n"
        "    sys.modules[name] = None\n"
        "import ayolov2_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(ayolov2_torch.__path__, 'ayolov2_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "print(' '.join(names))\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    names = set(r.stdout.split())
    assert len(names) >= 67
    assert {"ayolov2_torch.cli.train", "ayolov2_torch.cli.export", "ayolov2_torch.train.optimizer",
            "ayolov2_torch.train.train_state", "ayolov2_torch.train.trainer",
            "ayolov2_torch.utils.anchors", "ayolov2_torch.data.augment",
            "ayolov2_torch.data.device_augment", "ayolov2_torch.data.image_ops",
            "ayolov2_torch.data.loader", "ayolov2_torch.data.datasets", "ayolov2_torch.utils.plots",
            "ayolov2_torch.utils.png", "ayolov2_torch.utils.profiling", "ayolov2_torch.ops.tta",
            "ayolov2_torch.compress.quantize", "ayolov2_torch.compress.decomposition",
            "ayolov2_torch.ops.int8_conv", "ayolov2_torch.search.study",
            "ayolov2_torch.cli.decompose_model", "ayolov2_torch.cli.val_optimizer",
            "ayolov2_torch.cli.create_swa_model", "ayolov2_torch.cli.probe_int8_conv",
            "ayolov2_torch.cli.artifact_sizes", "ayolov2_torch.utils.torch_import",
            "ayolov2_torch.loss.losses_repr", "ayolov2_torch.data.datasets_repr",
            "ayolov2_torch.train.repr_trainer", "ayolov2_torch.train.kd_trainer",
            "ayolov2_torch.cli.distillation", "ayolov2_torch.cli.train_repr",
            "ayolov2_torch.cli.crop_bboxes", "ayolov2_torch.cli.import_torch_weights",
            "ayolov2_torch.cli.bench_matrix", "ayolov2_torch.cli.profile_train",
            "ayolov2_torch.cli.bench_loader", "ayolov2_torch.export.aoti"} <= names


def test_no_file_names_jax():
    files = sorted((ROOT / "ayolov2_torch").rglob("*.py"))
    files += sorted((ROOT / "ayolov2_torch").rglob("*.cu")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    for f in files:
        for i, line in enumerate(f.read_text().splitlines(), 1):
            code = line.split("#")[0] if f.suffix == ".py" else line
            if re.match(r"\s*(import|from)\s", code):
                assert not FORBIDDEN.search(code), f"{f}:{i}: {line}"


@pytest.mark.parametrize("variant", list("nsmlx"))
def test_yolov5_cfg_equals_yaml(variant):
    from ayolov2_torch.models import yolov5_cfg

    with open(CFG[variant], encoding="utf-8") as f:
        want = yaml.safe_load(f)
    assert yolov5_cfg(variant) == want


def test_parse_model_config_reads_yaml_path():
    from ayolov2_torch.models.builder import parse_model_config
    from ayolov2_torch.models import yolov5_cfg

    assert parse_model_config(CFG["s"]) == yolov5_cfg("s")
    d = yolov5_cfg("m")
    assert parse_model_config(d) is d


def test_entry_points_need_a_device_without_cuda(monkeypatch):
    from ayolov2_torch.export import make_serving_fn
    from ayolov2_torch.models import build_model, yolov5_cfg
    from ayolov2_torch.parallel import serve_stream

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_model(yolov5_cfg("n"))
    model = build_model(yolov5_cfg("n"), device="cpu")
    assert next(model.parameters()).device.type == "cpu"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_serving_fn(model)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        next(serve_stream(lambda x: x, [torch.zeros(1)]))


def test_validation_entry_points_need_a_device_without_cuda(monkeypatch, tmp_path):
    from ayolov2_torch.cli import val, val2
    from ayolov2_torch.eval import YoloValidator
    from ayolov2_torch.models import build_model, yolov5_cfg

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = build_model(yolov5_cfg("n"), device="cpu").fuse()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        YoloValidator(model, None)
    assert YoloValidator(model, None, device="cpu").device.type == "cpu"
    for main in (val.main, val2.main):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main(["--weights", "runs/golden_r4_mem/train/2026_0818_runs/weights/best.ckpt"])


def test_training_entry_points_need_a_device_without_cuda(monkeypatch, tmp_path):
    from ayolov2_torch.cli import train
    from ayolov2_torch.data import DataLoader, DetectionDataset
    from ayolov2_torch.models import build_model, yolov5_cfg
    from ayolov2_torch.train.trainer import YoloTrainer
    from ayolov2_torch.utils.config import load_yaml

    model_cfg, data, cfg = train_files(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    loader = DataLoader(DetectionDataset(str(tmp_path / "images"), img_size=64), batch_size=4)
    model = build_model(yolov5_cfg("n", nc=3), device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        YoloTrainer(model, load_yaml(cfg), loader, log_dir=str(tmp_path / "run"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.main(["--model", str(model_cfg), "--data", str(data), "--cfg", str(cfg),
                    "--log-dir", str(tmp_path / "runs")])


def test_trainer_refuses_unported_options(tmp_path, monkeypatch):
    from ayolov2_torch.train.trainer import refuse_unported

    for key, value, slice_name in (("tp", 2, "parallelism"), ("fsdp", True, "parallelism")):
        with pytest.raises(NotImplementedError, match=f"not ported yet.*{slice_name} slice"):
            refuse_unported({key: value})
    monkeypatch.setenv("AYOLO_TRACE_DIR", str(tmp_path))
    refuse_unported({})  # plot (true by default) and the trace window are ported
    refuse_unported({"plot": True, "tp": 1, "fsdp": False, "remat": False})
    refuse_unported({"remat": True})  # ported with the model zoo
    refuse_unported({"remat": "save_convs"})


def test_train_cli_on_cpu_then_val_reads_its_checkpoints(tmp_path):
    """One epoch of ``cli.train --device cpu`` writes last.ckpt and best.ckpt;
    ``cli.val --device cpu`` reads best.ckpt; a resume runs one more epoch."""
    import json

    from ayolov2_torch.cli import train, val
    from ayolov2_torch.utils.checkpoint import load_checkpoint

    model_cfg, data, cfg = train_files(tmp_path)
    trainer = train.main(["--model", str(model_cfg), "--data", str(data), "--cfg", str(cfg),
                          "--log-dir", str(tmp_path / "runs"), "--device", "cpu"])
    wdir = trainer.wdir
    assert (wdir / "last.ckpt").exists() and (wdir / "best.ckpt").exists()
    assert (wdir.parent / "metrics.json").exists() and (wdir.parent / "args.json").exists()
    meta = load_checkpoint(wdir / "last.ckpt")["meta"]
    assert meta["epoch"] == 0 and meta["step"] == 2 == meta["ema_updates"]
    out = tmp_path / "val.json"
    result = val.main(["--weights", str(wdir / "best.ckpt"), "--data-cfg", str(data), "-iw", "64",
                       "--batch-size", "4", "--device", "cpu", "--json-path", str(out)])
    assert result["seen"] == 8 and json.loads(out.read_text())["seen"] == 8

    cfg.write_text(cfg.read_text().replace("epochs: 1\n", "epochs: 2\n"))
    resumed = train.main(["--model", str(model_cfg), "--data", str(data), "--cfg", str(cfg),
                          "--log-dir", str(tmp_path / "runs"), "--device", "cpu",
                          "--resume", str(wdir / "last.ckpt")])
    meta2 = load_checkpoint(resumed.wdir / "last.ckpt")["meta"]
    assert meta2["epoch"] == 1 and meta2["step"] == 4 and meta2["ema_updates"] == 4
    assert (resumed.log_dir / "backup_epoch_1" / "last.ckpt").exists()
