"""The secondary trainers' and the preemption's wiring on 2 ranks (gloo, on
the CPU), each run in its own processes under a time limit:

- ``cli.distillation --n-devices 2`` with ``train.fsdp``: a teacher on each
  rank (K1's plain version on the CPU, one call a pseudo batch), the
  student's checkpoint on rank 0, read by the JAX package's
  ``load_variables``;
- ``cli.train_repr --n-devices 2``: rank 0's checkpoints; the repr step on
  2 ranks (SimpleRL, SGD, each rank computing its half of the global view
  batch) equal to the one-process step over two updates, in f32;
- SIGTERM to rank 1 of a 2-rank ``YoloTrainer``: both ranks stop at the
  same epoch through the validation's consensus (JAX's
  ``test_cluster_preempt_consensus``), and rank 0 checkpoints."""

import json
import re
import signal
import subprocess
import sys
import time

import numpy as np
import torch

from _torch_parallel_common import ROOT, WORKER, free_port, run_ranks
from _torch_port_common import train_files
from test_torch_port_parallel_cli import _flat, run_cli

torch.set_num_threads(1)


def test_distillation_cli_on_two_ranks(tmp_path):
    from ayolov2_tpu.utils.checkpoint import load_variables

    from ayolov2_torch.models import build_model, init_model
    from ayolov2_torch.utils.checkpoint import write_checkpoint
    from ayolov2_torch.utils.config import load_yaml
    from ayolov2_torch.utils.weights import flax_from_state_dict

    model_cfg, data, _ = train_files(tmp_path)
    mc = load_yaml(model_cfg)
    v = flax_from_state_dict(init_model(build_model(mc, nc=3, device="cpu"), seed=1).state_dict())
    teacher = tmp_path / "teacher.ckpt"
    write_checkpoint(teacher, {"meta": {"model_cfg": json.dumps(mc), "epoch": 0, "step": 0,
                                        "ema_updates": 0}, "model": v, "ema": v})
    text = (ROOT / "res/configs/cfg/distillation.yaml").read_text()
    for a, b in (("epochs: 10", "epochs: 1"), ("batch_size: 16", "batch_size: 4"),
                 ("image_size: 640", "image_size: 64"),
                 ("workers: 4", "workers: 1\n  half: false\n  fsdp: true\n  "
                                "fsdp_min_elems: 16384")):
        assert a in text
        text = text.replace(a, b)
    cfg = tmp_path / "kd.yaml"
    cfg.write_text(text)
    outs = run_cli("distillation", ["--model", str(model_cfg), "--teacher", str(teacher),
                                    "--data", str(data), "--cfg", str(cfg), "--log-dir",
                                    str(tmp_path / "runs")], world=2)
    (run,) = (tmp_path / "runs" / "distill").iterdir()
    got, meta = load_variables(run / "weights" / "last.ckpt", prefer_ema=True)
    # 8 images, a global batch of 4: two micro-steps on each rank
    assert meta["step"] == meta["ema_updates"] == 2 and meta["epoch"] == 0
    want = flax_from_state_dict(build_model(mc, nc=3, device="cpu").state_dict())
    assert {k: v.shape for k, v in _flat(got["params"]).items()} == \
        {k: v.shape for k, v in _flat(want["params"]).items()}
    assert all(np.isfinite(v).all() for v in _flat(got["params"]).values())
    assert "parallel fsdp: data axis 2" in outs[0]


def test_train_repr_cli_on_two_ranks(tmp_path):
    """``cli.train_repr --n-devices 2``: rank 0's checkpoints, read by JAX."""
    from ayolov2_tpu.utils.checkpoint import load_variables

    from ayolov2_torch.cli import crop_bboxes

    train_files(tmp_path)
    crops = tmp_path / "crops" / "images"
    assert crop_bboxes.main(["--img-dir", str(tmp_path / "images"), "--save-dir", str(crops),
                             "--min-size", "8"]) == 8
    data = tmp_path / "repr_data.yaml"
    data.write_text(f"train_path: {crops}\nval_path: {crops}\nnc: 1\n")
    model = tmp_path / "model.json"
    model.write_text(json.dumps(_repr_cfg()))
    text = (ROOT / "res/configs/cfg/train_config_repr.yaml").read_text()
    for a, b in (("epochs: 30", "epochs: 1"), ("epochs: 20", "epochs: 1"),
                 ("batch_size: 32", "batch_size: 4"), ("batch_size: 16", "batch_size: 4"),
                 ("image_size: 320", "image_size: 64"), ("n_skip: 2", "n_skip: 0")):
        text = text.replace(a, b)
    cfg = tmp_path / "repr.yaml"
    cfg.write_text(text)
    run_cli("train_repr", ["--model", str(model), "--data", str(data), "--cfg", str(cfg),
                           "--rl-type", "base", "--log-dir", str(tmp_path / "two")], world=2)
    (run,) = (tmp_path / "two" / "train_repr").iterdir()
    assert sorted(p.name for p in (run / "weights").iterdir()) == ["best_e000.ckpt", "last.ckpt"]
    got, meta = load_variables(run / "weights" / "last.ckpt", prefer_ema=False)
    assert meta["epoch"] == 0
    assert all(np.isfinite(v).all() for v in _flat(got["params"]).values())


def _repr_cfg():
    from ayolov2_torch.utils.config import load_yaml

    cfg = load_yaml(ROOT / "res/configs/model/simclr.yaml")
    cfg["width_multiple"] = 0.125
    return cfg


def test_repr_step_on_two_ranks_equals_one_process(tmp_path):
    """Two SimpleRL updates (SGD) over 2 ranks, each computing its half of the
    global view batch, against the one-process trainer: the loss, the
    weights and the BatchNorm statistics within 1e-4 of the peak (f32)."""
    from _torch_parallel_worker import repr_trainer

    from ayolov2_torch.utils.weights import flax_from_state_dict

    views = np.random.default_rng(3).integers(0, 256, (2, 16, 64, 64, 3), dtype=np.uint8)
    case = {"model_cfg": _repr_cfg(), "bs": 8, "steps": 2, "rl_type": "base"}
    tmp_path.mkdir(exist_ok=True)
    (tmp_path / "case.json").write_text(json.dumps(case))
    np.savez(tmp_path / "batches.npz", views=views)
    run_ranks("repr", 2, tmp_path)
    got = dict(np.load(tmp_path / "out.npz"))
    one = repr_trainer(dict(case, log_dir=tmp_path / "one"), "base")
    items = np.stack([one.train_step(torch.from_numpy(v)).numpy() for v in views])
    assert np.abs(got.pop("items") - items).max() <= 1e-4 * np.abs(items).max()
    want = _flat(flax_from_state_dict(one.model.state_dict()))
    assert got.keys() == want.keys()
    for group in ("params/", "batch_stats/"):
        keys = [k for k in want if k.startswith(group)]
        peak = max(np.abs(want[k]).max() for k in keys)
        assert max(np.abs(got[k] - want[k]).max() for k in keys) <= 1e-4 * peak, group


def test_sigterm_to_one_rank_stops_both_at_the_same_epoch(tmp_path):
    train_files(tmp_path / "files")
    port = str(free_port())
    procs = [subprocess.Popen([sys.executable, str(WORKER), "preempt", str(r), "2", port,
                               str(tmp_path)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True, cwd=ROOT, bufsize=1) for r in range(2)]
    lines1 = []
    deadline = time.time() + 180
    try:
        for line in procs[1].stdout:  # preempt rank 1 (not the main one) after an epoch
            lines1.append(line)
            if line.startswith("EPOCH_DONE"):
                procs[1].send_signal(signal.SIGTERM)
                break
            assert time.time() < deadline, "".join(lines1)[-3000:]
        out0, _ = procs[0].communicate(timeout=180)
        out1, _ = procs[1].communicate(timeout=60)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    full1 = "".join(lines1) + (out1 or "")
    assert procs[0].returncode == 0, out0[-3000:]
    assert procs[1].returncode == 0, full1[-3000:]
    assert "TRAIN_RETURNED preempted=True early_stop=True" in full1, full1[-2000:]
    assert "TRAIN_RETURNED preempted=False early_stop=True" in out0, out0[-2000:]
    epochs = [int(re.findall(r"TRAIN_RETURNED .* epoch=(\d+)", t)[-1]) for t in (out0, full1)]
    assert epochs[0] == epochs[1] < 10, epochs
    assert (tmp_path / "run" / "weights" / "last.ckpt").exists()
