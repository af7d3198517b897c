"""The port's validation entry points end to end on the CPU, on the golden
checkpoint and the synthetic labelled set: ``python -m ayolov2_torch.cli.val``
gives what the validator gives in-process, and ``cli.val2`` writes a COCO
answersheet that its evaluator scores."""

import json
import os
import subprocess
import sys

import pytest
import torch

from _torch_port_common import GOLDEN, LABELLED_IMG, ROOT, labelled_set, train_files

torch.set_num_threads(1)
WEIGHTS = str(GOLDEN / "weights/best.ckpt")


@pytest.fixture(scope="module")
def data_cfg(tmp_path_factory):
    root = tmp_path_factory.mktemp("labelled")
    img_dir = labelled_set(root)
    cfg = root / "data.json"
    cfg.write_text(json.dumps({"val_path": str(img_dir), "nc": 20, "dataset": "VOC",
                               "names": [f"class{i}" for i in range(20)]}))
    return cfg


def test_val_cli_equals_the_validator(data_cfg, tmp_path):
    from ayolov2_torch.data import DataLoader, DetectionDataset
    from ayolov2_torch.eval import YoloValidator
    from ayolov2_torch.utils.checkpoint import load_model

    out = tmp_path / "val.json"
    env = dict(os.environ, OMP_NUM_THREADS="1")
    r = subprocess.run(
        [sys.executable, "-m", "ayolov2_torch.cli.val", "--weights", WEIGHTS, "--data-cfg",
         str(data_cfg), "-iw", str(LABELLED_IMG), "--batch-size", "4", "--device", "cpu",
         "--json-path", str(out)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    assert "mAP@.5" in r.stdout and "Speed:" in r.stdout
    got = json.loads(out.read_text())

    model = load_model(WEIGHTS, nc=20, device="cpu")
    ds = DetectionDataset(json.loads(data_cfg.read_text())["val_path"], img_size=LABELLED_IMG,
                          batch_size=4, rect=True, pad=0.5)
    want = YoloValidator(model, DataLoader(ds, batch_size=4), device="cpu").validation()
    assert got["seen"] == want["seen"] == 9 and got["n_labels"] == want["n_labels"]
    for key in ("mp", "mr", "map50", "map50_95"):
        assert got[key] == pytest.approx(want[key], abs=1e-9), key
    assert got["map50"] >= 0.9


def test_val2_cli_writes_an_answersheet_its_evaluator_scores(data_cfg, tmp_path):
    from ayolov2_torch.cli import val2
    from ayolov2_torch.data import DetectionDataset
    from ayolov2_torch.utils.metrics import COCOmAPEvaluator
    from ayolov2_torch.utils.result_writer import yolo_labels_to_coco_json

    sheet = tmp_path / "answersheet.json"
    metrics = val2.main(["--weights", WEIGHTS, "--data-cfg", str(data_cfg), "-iw",
                         str(LABELLED_IMG), "--batch-size", "4", "--device", "cpu",
                         "--json-path", str(sheet), "--check-map", "0.5", "--verbose", "2"])
    preds = json.loads(sheet.read_text())
    assert preds and {p["image_id"] for p in preds} <= set(range(1, 10))
    assert all(p["category_id"] in range(1, 25) and len(p["bbox"]) == 4 for p in preds)
    ds = DetectionDataset(json.loads(data_cfg.read_text())["val_path"], img_size=LABELLED_IMG)
    gt = yolo_labels_to_coco_json(ds)
    assert COCOmAPEvaluator(gt).evaluate(preds) == metrics
    assert metrics["map50"] >= 0.5


@pytest.mark.parametrize("module,flags,match", [
    ("val", ["--weights", "m.jaxexp"], "JAX artifact is read by the JAX package .* reads "
                                       "the .pt2"),
    ("train", ["--n-devices", "2"], "^0$"),
])
def test_unported_flags_exit_with_a_message(module, flags, match, tmp_path):
    """A JAX artifact stops ``cli.val`` naming the package that reads it.
    ``cli.train --n-devices 2``, refused until the parallelism slice, now
    starts two ranks (gloo on the CPU) and leaves with their exit code, 0:
    rank 0 wrote the run's checkpoints and metrics (the parallel runs
    themselves: ``tests/test_torch_port_parallel_cli.py``)."""
    import importlib

    main = importlib.import_module(f"ayolov2_torch.cli.{module}").main
    if module == "train":
        model_cfg, data, cfg = train_files(tmp_path)
        flags = flags + ["--model", str(model_cfg), "--data", str(data), "--cfg", str(cfg),
                         "--log-dir", str(tmp_path / "runs")]
    with pytest.raises(SystemExit, match=match):
        main(flags + ["--device", "cpu"])
    if module == "train":
        (run,) = (tmp_path / "runs" / "train").iterdir()
        assert (run / "weights" / "last.ckpt").exists() and (run / "metrics.json").exists()


def _jax_option_strings(path) -> set:
    """Every option string JAX's entry point passes to ``add_argument``."""
    import ast

    opts = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "add_argument":
            opts |= {a.value for a in node.args if isinstance(a, ast.Constant)}
    return opts


@pytest.mark.parametrize("module", ["train", "val", "val2", "export", "decompose_model",
                                    "val_optimizer", "create_swa_model", "probe_int8_conv",
                                    "artifact_sizes", "distillation", "train_repr",
                                    "crop_bboxes", "import_torch_weights"])
def test_parsers_take_every_flag_of_jax(module):
    """The port's parser has each option of ``cli/{module}.py``, so a command
    line written for the JAX entry point parses (the refused ones stop it by
    name, above)."""
    import importlib

    parser = importlib.import_module(f"ayolov2_torch.cli.{module}").get_parser()
    port = {s for action in parser._actions for s in action.option_strings}
    jax_opts = _jax_option_strings(ROOT / "cli" / f"{module}.py")
    assert len(jax_opts) >= 3  # crop_bboxes has three
    assert jax_opts <= port, sorted(jax_opts - port)


def test_val2_reads_any_weights_as_a_checkpoint(data_cfg, tmp_path):
    """As JAX's ``cli/val2.py`` (no exported branch), ``--weights`` of any
    suffix goes to the checkpoint reader, which refuses what is not one."""
    from ayolov2_torch.cli import val2

    art = tmp_path / "m.pt2"
    art.write_bytes(b"PK\x03\x04 not a checkpoint")
    with pytest.raises(ValueError):
        val2.main(["--weights", str(art), "--data-cfg", str(data_cfg), "--device", "cpu"])
    with pytest.raises(FileNotFoundError):
        val2.main(["--weights", str(tmp_path / "m.jaxexp"), "--data-cfg", str(data_cfg),
                   "--device", "cpu"])
