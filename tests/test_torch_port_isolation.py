"""The port stands alone: no JAX, no JAX package, configs equal the YAMLs,
and entry points never fall back to the CPU on their own."""

import re
import subprocess
import sys

import pytest
import torch
import yaml

from _torch_port_common import CFG, ROOT

torch.set_num_threads(1)

FORBIDDEN = re.compile(r"\b(jax|flax|ayolov2_tpu)\b")


def test_import_pulls_in_no_jax():
    code = (
        "import sys, ayolov2_torch, ayolov2_torch.models, ayolov2_torch.ops.nms, "
        "ayolov2_torch.ops.early_pipeline, ayolov2_torch.export, ayolov2_torch.parallel, "
        "ayolov2_torch.utils.weights\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'ayolov2_tpu')]\n"
        "print(bad); sys.exit(1 if bad else 0)\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_every_module_imports_without_jax_opencv_pil_yaml_or_msgpack():
    code = (
        "import sys, pkgutil, importlib\n"
        "for name in ('jax', 'flax', 'ayolov2_tpu', 'cv2', 'PIL', 'yaml', 'msgpack'):\n"
        "    sys.modules[name] = None\n"
        "import ayolov2_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(ayolov2_torch.__path__, 'ayolov2_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "print(len(names))\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert int(r.stdout.split()[-1]) >= 25


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
