"""The entry points on the CPU with the shipped width-1.05 config (stem 72,
conv1 136, C3 68 x 4, conv2 272), whose early network the kernel now takes
at any width: ``cli.val``, ``cli.val2`` and ``cli.export`` of a checkpoint
of it at 64 px (the early network's plain version on the CPU), the
artifact read back in a fresh interpreter against ``make_serving_fn``, and
``cli.distillation --device cpu`` with it as the teacher."""

import json

import numpy as np
import pytest
import torch

from _torch_port_common import ROOT, call_artifacts_fresh, images, train_files, zoo_cfg

torch.set_num_threads(1)
IMG, BS = 64, 4


@pytest.fixture(scope="module")
def wide(tmp_path_factory):
    """(the width-1.05 checkpoint, nc 3, the port's initialisation, params
    in bf16 as the trainer writes them; the 64 px data YAML and model config
    of ``train_files``)."""
    from ayolov2_torch.models import build_model, init_model
    from ayolov2_torch.utils.checkpoint import _variables, write_checkpoint
    from ayolov2_torch.utils.config import load_yaml

    root = tmp_path_factory.mktemp("wide")
    model_cfg, data, _ = train_files(root)
    cfg = load_yaml(zoo_cfg("yolov5_depth1.5_width1.05_800"))
    model = init_model(build_model(cfg, nc=3, device="cpu"), seed=1)
    ckpt = root / "wide.ckpt"
    meta = {"version": 1, "epoch": 0, "best_score": 0.0, "map50": -1.0, "ema_updates": 0,
            "step": 0, "model_cfg": json.dumps(cfg)}
    write_checkpoint(ckpt, {"meta": meta, "model": _variables(model, True)})
    return ckpt, data, model_cfg


def test_val_val2_and_export_of_the_wide_config(wide, tmp_path):
    from ayolov2_torch.cli import export as cli_export
    from ayolov2_torch.cli import val, val2
    from ayolov2_torch.export import make_serving_fn
    from ayolov2_torch.export.exporter import ServingModule
    from ayolov2_torch.ops import early_pipeline as early
    from ayolov2_torch.utils.checkpoint import load_model

    ckpt, data, _ = wide
    common = ["--weights", str(ckpt), "--data-cfg", str(data), "-iw", str(IMG),
              "--batch-size", str(BS), "--device", "cpu"]
    r = val.main(common + ["--json-path", str(tmp_path / "val.json")])
    assert r["seen"] == 8 and 0.0 <= r["map50"] <= 1.0
    metrics = val2.main(common + ["--json-path", str(tmp_path / "sheet.json")])
    assert 0.0 <= metrics["map50"] <= 1.0 and (tmp_path / "sheet.json").exists()

    paths = cli_export.main(["--weights", str(ckpt), "--platforms", "cpu", "--nc", "3", "-iw",
                             str(IMG), "--batch-size", str(BS), "--out", str(tmp_path / "wide")])
    # an artifact for the CPU holds the plain layers 0..3 (for any model); the
    # operator, with the widths, is in a graph of the early path exported here
    assert json.loads(open(paths["yaml"]).read())["early_pipeline"] is False
    model = load_model(ckpt, nc=3, device="cpu")
    serve = ServingModule(model, torch.device("cpu"), torch.bfloat16, 0.001, 0.65, 512, 100, 1000,
                          True, True, True, False, False, "nms", img_hw=(IMG, IMG),
                          graph_nms=True)
    x = images((BS, IMG, IMG, 3), seed=21)
    program = torch.export.export(serve, (torch.from_numpy(x),))
    calls = [n for n in program.graph.nodes
             if n.target == torch.ops.ayolov2.early_pipeline.default]
    assert len(calls) == 1 and list(calls[0].args[2:]) == [72, 4, 136, 68, 272]
    torch.export.save(program, str(tmp_path / "wide_k1.pt2"))
    np.save(tmp_path / "x.npy", x)
    got = call_artifacts_fresh({"cli": (paths["pt2"], str(tmp_path / "x.npy")),
                                "k1": (str(tmp_path / "wide_k1.pt2"), str(tmp_path / "x.npy"))},
                               tmp_path / "out.npz")
    before = early.early_pipeline.launches
    for name, on in (("cli", False), ("k1", True)):
        fn = make_serving_fn(model, device="cpu", early_pipeline=on)
        assert fn.early == on and (not on or fn.ep.widths == (72, 136, 68, 272, 4))
        det, n = fn(torch.from_numpy(x))
        np.testing.assert_array_equal(got[f"{name}_1"], n.numpy())
        np.testing.assert_allclose(got[f"{name}_0"], det.float().numpy(), rtol=0, atol=1e-4)
    assert early.early_pipeline.launches == before  # the plain version launches nothing


def test_distillation_takes_the_wide_config_as_teacher(wide, tmp_path):
    """``cli.distillation --device cpu`` with the width-1.05 checkpoint as
    the teacher: the teacher serves through the early network (its plain
    version here) and the run takes its steps."""
    from ayolov2_torch.cli import distillation

    ckpt, data, model_cfg = wide
    text = (ROOT / "res/configs/cfg/distillation.yaml").read_text()
    for a, b in (("epochs: 10", "epochs: 1"), ("batch_size: 16", f"batch_size: {BS}"),
                 ("image_size: 640", f"image_size: {IMG}"),
                 ("workers: 4", "workers: 1\n  half: false")):
        assert a in text
        text = text.replace(a, b)
    cfg = tmp_path / "kd.yaml"
    cfg.write_text(text)
    trainer = distillation.main(["--model", str(model_cfg), "--teacher", str(ckpt), "--data",
                                 str(data), "--cfg", str(cfg), "--log-dir", str(tmp_path / "runs"),
                                 "--device", "cpu"])
    assert trainer.teacher.early and trainer.teacher.ep.widths == (72, 136, 68, 272, 4)
    assert trainer.state.step == 2 and len(trainer.pseudo_counts) >= 2
    assert trainer._producer is None and (trainer.wdir / "last.ckpt").exists()
