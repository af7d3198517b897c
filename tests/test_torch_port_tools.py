"""The post-training tools: the validation-parameter search and SWA, the
port against the JAX package on the CPU.

The study draws JAX's sequence from the same seed and reads and resumes
JAX's storage; the objective's score is JAX's; ``cli.val_optimizer`` runs a
trial with ``--device cpu``; ``cli.create_swa_model`` writes leaves bit
for bit equal to JAX's on the same checkpoints."""

import importlib.util
import json
import shutil

import numpy as np
import pytest
import torch

from _torch_port_common import GOLDEN, ROOT, labelled_set, tree_leaves

torch.set_num_threads(1)
WEIGHTS = str(GOLDEN / "weights/best.ckpt")


def _jax_cli(name: str):
    """The JAX package's entry-point module ``cli/{name}.py``."""
    spec = importlib.util.spec_from_file_location(f"jax_cli_{name}", ROOT / "cli" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _objective(trial) -> float:
    w = trial.suggest_int("img_width", 512, 768, step=32)
    c = trial.suggest_float("conf_thr", 0.0, 1.0)
    i = trial.suggest_float("iou_thr", 0.0, 1.0)
    k = trial.suggest_categorical("nms", ["nms", "fast_nms", "matrix_nms"])
    s = trial.suggest_float("scale", 0.5, 1.5, step=0.25)
    return -((w - 640) / 128) ** 2 - (c - 0.3) ** 2 - (i - 0.6) ** 2 + 0.1 * len(k) + s


def _params(study):
    return [(t["number"], t["params"], t["value"], t["state"]) for t in study.trials]


def test_study_draws_jax_sequence():
    """30 trials (10 random, 20 TPE) from seed 0: the same suggestions and
    values, and the same best trial."""
    from ayolov2_torch.search import create_study
    from ayolov2_tpu.search import create_study as jax_create_study

    port, jax_study = create_study(), jax_create_study()
    port.optimize(_objective, n_trials=30)
    jax_study.optimize(_objective, n_trials=30)
    assert _params(port) == _params(jax_study)
    assert port.best_trial == jax_study.best_trial and len(port.completed) == 30


def test_study_reads_and_resumes_jax_storage(tmp_path):
    """A study stored by the JAX package is read with its trials, and both
    packages resume it with the same next draws; a storage of another study
    is backed up, as is any storage without ``load_if_exists``."""
    from ayolov2_torch.search import create_study
    from ayolov2_tpu.search import create_study as jax_create_study

    store = tmp_path / "study.json"
    jax_create_study(storage=store, study_name="s").optimize(_objective, n_trials=12)
    copy = tmp_path / "copy.json"
    shutil.copy(store, copy)
    port = create_study(storage=copy, study_name="s", load_if_exists=True)
    assert len(port.trials) == 12
    jax_resumed = jax_create_study(storage=store, study_name="s", load_if_exists=True)
    port.optimize(_objective, n_trials=5)
    jax_resumed.optimize(_objective, n_trials=5)
    assert _params(port) == _params(jax_resumed)
    assert json.loads(copy.read_text()) == json.loads(store.read_text())

    other = create_study(storage=copy, study_name="other", load_if_exists=True)
    assert other.trials == [] and not copy.exists()
    assert len(list(tmp_path.glob("copy.backup_*.json"))) == 1
    shutil.copy(store, copy)
    fresh = create_study(storage=copy, study_name="s", load_if_exists=False)
    assert fresh.trials == [] and not copy.exists()


def test_objective_score_equals_jax():
    """``calc_objective_fn`` and the punishment of JAX's objective."""
    from argparse import Namespace

    from ayolov2_torch.cli.val_optimizer import ObjectiveValidator

    jax_cls = _jax_cli("val_optimizer").ObjectiveValidator
    args = Namespace(alpha=0.5, beta=0.1, gamma=4.0)
    objs = []
    for cls in (ObjectiveValidator, jax_cls):
        obj = cls.__new__(cls)
        obj.args, obj.model_params, obj.baseline_params = args, 7_000_000, 7_000_000
        obj.baseline_t, obj.baseline_map50 = 3.7, 0.61
        objs.append(obj)
    assert ObjectiveValidator.PUNISHMENT == jax_cls.PUNISHMENT == 0.1
    for t, m in ((1.0, 0.6), (3.7, 0.61), (12.5, 0.2), (0.0, 0.0), (1e-12, 1.0)):
        assert objs[0].calc_objective_fn(t, m) == objs[1].calc_objective_fn(t, m)


@pytest.fixture(scope="module")
def data_cfg(tmp_path_factory):
    root = tmp_path_factory.mktemp("labelled")
    img_dir = labelled_set(root)
    cfg = root / "data.json"
    cfg.write_text(json.dumps({"val_path": str(img_dir), "nc": 20, "dataset": "VOC",
                               "names": [f"class{i}" for i in range(20)]}))
    return cfg


def test_val_optimizer_cli_runs_a_trial_on_the_cpu(data_cfg, tmp_path):
    from ayolov2_torch.cli import val_optimizer

    space = tmp_path / "space.json"
    space.write_text(json.dumps({"img_width": {"low": 128, "high": 160, "step": 32},
                                 "conf_thr": {"low": 0.001, "high": 0.01},
                                 "iou_thr": {"low": 0.5, "high": 0.7}}))
    store = tmp_path / "build" / "study.json"
    study = val_optimizer.main(["--weights", WEIGHTS, "--data-cfg", str(data_cfg),
                                "--optim-cfg", str(space), "--n-trials", "1", "--batch-size",
                                "4", "--device", "cpu", "--base-map50", "0.5", "--base-time",
                                "1.0", "--storage", str(store)])
    saved = json.loads(store.read_text())
    assert len(saved["trials"]) == len(study.trials) == 1
    trial = saved["trials"][0]
    assert trial["state"] == "complete" and trial["params"]["img_width"] in (128, 160)
    assert 0.5 <= trial["user_attrs"]["map50"] <= 1.0 and trial["user_attrs"]["time_s"] > 0
    assert trial["value"] == pytest.approx(0.5 + 0.1 / trial["user_attrs"]["time_s"]
                                           + 4.0 * trial["user_attrs"]["map50"] / 0.5)


def test_swa_equals_jax_bit_for_bit(tmp_path):
    """Three epoch checkpoints (bf16 params, f32 BN statistics, as the
    trainer writes them) and a stray file: the best two by mAP50 averaged,
    leaves and meta equal to JAX's ``create_swa_model``."""
    from ayolov2_torch.cli import create_swa_model as swa
    from ayolov2_torch.utils.checkpoint import (
        BF16Bits,
        load_checkpoint,
        load_variables,
        write_checkpoint,
    )

    variables, meta = load_variables(WEIGHTS)
    rng = np.random.default_rng(71)
    port_dir, jax_dir = tmp_path / "port", tmp_path / "jax"
    port_dir.mkdir()

    def jitter(tree, half):
        if isinstance(tree, dict):
            return {k: jitter(v, half) for k, v in tree.items()}
        arr = (tree * rng.uniform(0.9, 1.1, tree.shape)).astype(np.float32)
        return BF16Bits.from_f32(arr) if half else arr

    for epoch, map50 in ((1, 0.41), (2, 0.63), (3, 0.55)):
        branch = {"params": jitter(variables["params"], True),
                  "batch_stats": jitter(variables["batch_stats"], False)}
        write_checkpoint(port_dir / f"epoch_{epoch}.ckpt", {
            "meta": dict(meta, epoch=epoch, map50=map50), "model": branch, "ema": branch})
    (port_dir / "epoch_best.ckpt").write_bytes(b"not a checkpoint")
    shutil.copytree(port_dir, jax_dir)

    got_path = swa.main(["-d", str(port_dir), "-b", "2"])
    _jax_cli("create_swa_model").create_swa_model(str(jax_dir), "swa.ckpt", 2)
    got, want = load_checkpoint(got_path), load_checkpoint(jax_dir / "swa.ckpt")
    assert got["meta"] == want["meta"] and got["meta"]["map50"] == pytest.approx(0.59)
    for branch in ("model", "ema"):
        g, w = tree_leaves(got[branch]), tree_leaves(want[branch])
        assert g.keys() == w.keys() and len(g) > 250
        for key in w:
            assert g[key].dtype == w[key].dtype == np.float32, key
            np.testing.assert_array_equal(g[key], w[key], err_msg=str(key))
