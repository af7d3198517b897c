"""``cli.train`` on 2 ranks (gloo, on the CPU), each run in its own processes
under a time limit: ZeRO (``train.fsdp``) started by ``--n-devices 2``, and
tensor parallelism (``train.tp: 2``) started by the test under JAX's env
contract (``AYOLO_NUM_PROCS``). Each writes the one-device layout: the
JAX package's ``load_variables`` reads both checkpoints, and they equal a
one-process run's (f32 BatchNorm statistics within 1e-4 of the peak, the
bf16-stored weights within one bf16 step). The optimizers hold the
gradients summed so far (a batch of 4 accumulates to 64 over 16
micro-steps, more than the runs take), gathered like the weights: within
1e-2 of the peak, the tolerance of a step's change."""

import contextlib
import os
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

from _torch_parallel_common import ROOT, free_port
from _torch_port_common import train_files

torch.set_num_threads(1)

LIMIT_S = 240


def run_cli(module: str, args, world: int = 1, contract: str = "launch", timeout=LIMIT_S):
    """``python -m ayolov2_torch.cli.<module>`` as ``world`` ranks: started by
    its ``--n-devices`` ("launch") or by this test under JAX's contract
    ("ayolo"); every process must exit 0 within ``timeout``."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("AYOLO_NUM_PROCS", "WORLD_SIZE", "RANK", "LOCAL_RANK")}
    env["AYOLO_DIST_TIMEOUT_S"] = "120"
    cmd = [sys.executable, "-m", f"ayolov2_torch.cli.{module}", *args, "--device", "cpu"]
    if contract == "launch":
        envs = [env]
        cmd += ["--n-devices", str(world)]
    else:
        port = free_port()
        envs = [dict(env, AYOLO_NUM_PROCS=str(world), AYOLO_PROC_ID=str(r),
                     AYOLO_COORDINATOR=f"localhost:{port}") for r in range(world)]
    # each in a session of its own: a launcher's ranks are killed with it
    procs = [subprocess.Popen(cmd, cwd=ROOT, env=e, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, start_new_session=True)
             for e in envs]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=timeout)
            outs.append(out)
            assert p.returncode == 0, out[-5000:]
    finally:
        for p in procs:
            with contextlib.suppress(ProcessLookupError):
                os.killpg(p.pid, signal.SIGKILL)
    return outs


def _only_run(root):
    (run,) = (root / "train").iterdir()
    return run / "weights" / "last.ckpt"


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pcli")
    model_cfg, data, cfg = train_files(tmp, epochs=2)
    return tmp, model_cfg, data, cfg


@pytest.fixture(scope="module")
def one_process(files):
    from ayolov2_torch.cli import train

    tmp, model_cfg, data, cfg = files
    trainer = train.main(["--model", str(model_cfg), "--data", str(data), "--cfg", str(cfg),
                          "--log-dir", str(tmp / "one"), "--device", "cpu"])
    return trainer.wdir / "last.ckpt"


def _cfg_with(files, name: str, extra: str):
    tmp, model_cfg, data, cfg = files
    text = cfg.read_text().replace("  plot: false", f"  plot: false\n{extra}")
    out = tmp / name
    out.write_text(text)
    return ["--model", str(model_cfg), "--data", str(data), "--cfg", str(out)]


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v, np.float32)
    return out


def assert_same_checkpoint(got_path, want_path):
    from ayolov2_tpu.utils.checkpoint import load_variables

    from ayolov2_torch.utils.checkpoint import load_checkpoint

    for prefer_ema in (True, False):
        got, meta = load_variables(got_path, prefer_ema=prefer_ema)
        want, meta_w = load_variables(want_path, prefer_ema=prefer_ema)
        assert (meta["epoch"], meta["step"], meta["ema_updates"]) == \
            (meta_w["epoch"], meta_w["step"], meta_w["ema_updates"])
        stats_g, stats_w = _flat(got["batch_stats"]), _flat(want["batch_stats"])
        peak = max(np.abs(v).max() for v in stats_w.values())
        assert max(np.abs(stats_g[k] - stats_w[k]).max() for k in stats_w) <= 1e-4 * peak
        params_g, params_w = _flat(got["params"]), _flat(want["params"])
        assert params_g.keys() == params_w.keys()
        for k, w in params_w.items():  # stored as bf16: one step of its 8-bit mantissa
            assert params_g[k].shape == w.shape, k
            assert (np.abs(params_g[k] - w) <= 2.0 ** -7 * np.abs(w) + 1e-30).all(), k
    # 4 micro-steps of bs 4 sit inside the first window of accumulate 16: the
    # optimizer holds the gradients summed so far, gathered like the weights
    opt_g, opt_w = (load_checkpoint(p)["optimizer"] for p in (got_path, want_path))
    counts = (opt_g["updates"], opt_g["mini_step"])
    assert counts == (opt_w["updates"], opt_w["mini_step"]) == (0, 4)
    opt_g, opt_w = _flat(opt_g["grads"]), _flat(opt_w["grads"])
    assert opt_g.keys() == opt_w.keys() and opt_w
    peak = max(np.abs(v).max() for v in opt_w.values())
    # the tolerance of the steps' changes: a gradient is a sum over every
    # pixel, in another order on two ranks
    assert max(np.abs(opt_g[k] - opt_w[k]).max() for k in opt_w) <= 1e-2 * peak


def test_train_cli_fsdp_on_two_ranks(files, one_process):
    """``--n-devices 2`` with ``train.fsdp`` (yolov5n's large kernels split)."""
    tmp = files[0]
    run_cli("train", _cfg_with(files, "fsdp.yaml", "  fsdp: true\n  fsdp_min_elems: 16384")
            + ["--log-dir", str(tmp / "fsdp")], world=2)
    assert_same_checkpoint(_only_run(tmp / "fsdp"), one_process)


def test_train_cli_tp_under_the_env_contract(files, one_process):
    """``train.tp: 2`` on 2 ranks started under ``AYOLO_NUM_PROCS``: a (1, 2)
    mesh, every conv of yolov5n but the head split over the model axis."""
    tmp = files[0]
    outs = run_cli("train", _cfg_with(files, "tp.yaml", "  tp: 2\n  fsdp: true")
                   + ["--log-dir", str(tmp / "tp")], world=2, contract="ayolo")
    assert "overrides train.fsdp" in outs[0]
    assert_same_checkpoint(_only_run(tmp / "tp"), one_process)
