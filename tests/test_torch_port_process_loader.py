"""The loader's forked process pool, each case in a fresh interpreter.

A test process has started threads (JAX's, torch's, the thread-mode
loader's), and a child forked from a process with threads may deadlock. So
every case here runs its body in ``python -c`` that imports this file,
numpy, torch and the port, never JAX, under a time limit, and fails if JAX
was imported there. The files a case reads are written by the test process
first. The comparisons are the port against itself (process batches against
thread batches).

- the workers are other processes, a worker's error is raised in the
  consumer, an unknown ``workers_mode`` is refused;
- process batches equal thread batches under ``train_golden.yaml``'s recipe;
- ``cli.train --device cpu`` on worker processes with ``train_golden.yaml``'s
  augmentation, then ``cli.val``;
- a worker killed from outside raises; a worker that blocks makes the
  loader raise within its ``timeout``.
"""

import logging
import os
import re
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_port_common import ROOT, labelled_set, train_files

torch.set_num_threads(1)

HERE = Path(__file__).resolve().parent
CFGS = ROOT / "res/configs/cfg"


def _in_fresh_interpreter(case: str, *args, timeout: float = 240) -> str:
    """Run ``case(*args)`` of this file in a new interpreter; its stdout."""
    code = (
        f"import sys; sys.path[:0] = [{str(HERE)!r}, {str(ROOT)!r}]\n"
        f"import {Path(__file__).stem} as cases\n"
        f"cases.{case}(*{args!r})\n"
        "jax = [m for m in sys.modules if m.split('.')[0] in ('jax', 'ayolov2_tpu')]\n"
        "assert not jax, f'the case imported {jax[:3]}'\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                       timeout=timeout)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-6000:]
    return r.stdout


class _Pids:
    """Items whose path is the pid of the process that built them; item
    ``bad`` raises."""

    def __init__(self, n=12, bad=None):
        self.n, self.bad = n, bad

    def __len__(self):
        return self.n

    def get_item(self, i, salt=0):
        if i == self.bad:
            raise KeyError(f"item {i} is broken")
        return np.full((8, 8, 3), i, np.uint8), np.zeros((0, 5), np.float32), str(os.getpid()), None


class _Dies(_Pids):
    """A worker that builds item ``bad`` is killed from outside."""

    def get_item(self, i, salt=0):
        if i == self.bad:
            os.kill(os.getpid(), 9)
        return super().get_item(i, salt)


class _Stalls(_Pids):
    """A worker that builds item ``bad`` blocks forever."""

    def get_item(self, i, salt=0):
        if i == self.bad:
            threading.Event().wait()
        return super().get_item(i, salt)


# ---- the cases, run in the fresh interpreter ---------------------------------------


def case_workers_and_errors():
    from ayolov2_torch.data import DataLoader

    batches = list(DataLoader(_Pids(), batch_size=4, workers=3, workers_mode="process"))
    pids = {int(p) for b in batches for p in b.paths}
    assert os.getpid() not in pids and len(pids) >= 1
    assert [int(b.images[0, 0, 0, 0]) for b in batches] == [0, 4, 8]
    with pytest.raises(KeyError, match="item 5 is broken"):
        list(DataLoader(_Pids(bad=5), batch_size=4, workers=2, workers_mode="process"))
    with pytest.raises(ValueError, match="workers_mode must be 'thread' or 'process'"):
        DataLoader(_Pids(), workers_mode="fork")


def case_process_equals_threads(images: str):
    from ayolov2_torch.data import DataLoader, DetectionDataset
    from ayolov2_torch.utils.config import load_yaml
    from _torch_port_common import LABELLED_IMG

    cfg = load_yaml(str(CFGS / "train_golden.yaml"))
    ds = DetectionDataset(images, img_size=LABELLED_IMG, cache_images="mem",
                          yolo_augmentation=cfg["yolo_augmentation"],
                          augmentation=cfg.get("augmentation"))
    epochs = {}
    for mode in ("thread", "process"):
        loader = DataLoader(ds, batch_size=4, shuffle=True, drop_last=True, workers=2,
                            workers_mode=mode, seed=5)
        epochs[mode] = [list(loader), list(loader)]  # two epochs: the epoch reaches the workers
    for ea, eb in zip(epochs["thread"], epochs["process"]):
        assert len(ea) == len(eb) == 2
        for a, b in zip(ea, eb):
            np.testing.assert_array_equal(a.images, b.images)
            np.testing.assert_array_equal(a.targets, b.targets)
            np.testing.assert_array_equal(a.target_mask, b.target_mask)
            assert a.paths == b.paths
    assert not np.array_equal(epochs["thread"][0][0].images, epochs["thread"][1][0].images)


def case_train_cli(model_cfg: str, data: str, cfg: str, log_dir: str):
    import io

    from ayolov2_torch.cli import train, val
    from ayolov2_torch.utils.checkpoint import load_checkpoint

    log = io.StringIO()
    handler = logging.StreamHandler(log)
    logging.getLogger().addHandler(handler)
    logging.getLogger().setLevel(logging.INFO)
    args = ["--model", model_cfg, "--data", data, "--cfg", cfg, "--log-dir", log_dir,
            "--device", "cpu"]
    trainer = train.main(args)
    assert trainer.train_loader.workers_mode == "process"
    assert "augmented on the host by 2 worker processes" in log.getvalue()
    meta = load_checkpoint(trainer.wdir / "last.ckpt")["meta"]
    assert meta["epoch"] == 1 and meta["step"] == 4 == meta["ema_updates"]
    result = val.main(["--weights", str(trainer.wdir / "best.ckpt"), "--data-cfg", data,
                       "-iw", "64", "--batch-size", "4", "--device", "cpu"])
    assert result["seen"] == 8 and 0.0 <= result["map50"] <= 1.0

    Path(cfg).write_text(Path(cfg).read_text().replace("workers_mode: process",
                                                       "workers_mode: pool"))
    with pytest.raises(SystemExit, match="train.workers_mode 'pool'"):
        train.main(args)


def case_killed_worker():
    from ayolov2_torch.data import DataLoader

    with pytest.raises(RuntimeError, match="a loader worker died"):
        list(DataLoader(_Dies(bad=5), batch_size=4, workers=2, workers_mode="process"))


def case_stalled_worker(timeout: float):
    from ayolov2_torch.data import DataLoader

    loader = DataLoader(_Stalls(bad=5), batch_size=4, workers=2, workers_mode="process",
                        timeout=timeout)
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match=r"no batch from the loader's workers") as err:
        list(loader)
    elapsed = time.monotonic() - t0
    print(f"raised after {elapsed:.2f} s: {err.value}")
    assert timeout <= elapsed < timeout + 10
    msg = str(err.value)
    assert re.search(r"waited for batch 1 of 3", msg), msg
    pids = [int(p) for p in re.search(r"pids \[([\d, ]+)\]", msg).group(1).split(",")]
    assert len(pids) == 2
    for pid in pids:  # terminated and reaped
        with pytest.raises(ProcessLookupError):
            os.kill(pid, 0)
    with pytest.raises(ValueError, match="timeout must be non-negative"):
        DataLoader(_Pids(), timeout=-1)


# ---- the tests ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    """The shared labelled set: 9 BMPs of 76-200 px, one with polygon labels
    (segments), one without labels."""
    return labelled_set(tmp_path_factory.mktemp("process_loader"))


def test_process_workers_are_other_processes_and_pass_errors_up():
    _in_fresh_interpreter("case_workers_and_errors")


def test_process_batches_equal_thread_batches(images):
    _in_fresh_interpreter("case_process_equals_threads", str(images))


def test_train_cli_host_augmentation_on_cpu_then_val(tmp_path):
    """``cli.train --device cpu`` with train_golden.yaml's augmentation on
    worker processes: the log names the path, step and EMA count 2 micro-
    steps an epoch, and ``cli.val`` reads best.ckpt. An unknown
    ``workers_mode`` stops the entry point by name."""
    model_cfg, data, cfg = train_files(tmp_path, epochs=2)
    text = cfg.read_text().replace("  plot: false", "  plot: false\n  workers_mode: process")
    golden = (CFGS / "train_golden.yaml").read_text()
    cfg.write_text(text[: text.index("yolo_augmentation:")]
                   + golden[golden.index("yolo_augmentation:"):])
    _in_fresh_interpreter("case_train_cli", str(model_cfg), str(data), str(cfg),
                          str(tmp_path / "runs"))


def test_process_mode_raises_when_a_worker_is_killed():
    _in_fresh_interpreter("case_killed_worker")


def test_process_mode_raises_when_a_worker_stalls():
    """A worker blocked forever makes the consumer terminate the pool and
    raise within the loader's ``timeout`` (3 s here), naming the workers'
    pids and the batch it waited for."""
    out = _in_fresh_interpreter("case_stalled_worker", 3.0, timeout=60)
    assert "raised after" in out


class _Held(_Pids):
    """Item ``hold`` is held until ``release`` is set; item ``exit_at``
    raises ``SystemExit`` (which ends a thread without a word)."""

    def __init__(self, hold=None, exit_at=None):
        super().__init__()
        self.hold, self.exit_at = hold, exit_at
        self.release = threading.Event()

    def get_item(self, i, salt=0):
        if i == self.hold:
            self.release.wait(60)
        if i == self.exit_at:
            raise SystemExit(f"item {i} ended its thread")
        return super().get_item(i, salt)


def test_thread_mode_raises_when_a_worker_stalls_or_its_thread_ends():
    """The worker threads are held to the loader's ``timeout`` as the
    process pool is: a worker that builds nothing within it makes the
    consumer raise, naming the batch (it waited without a bound before); a
    worker whose item ends the thread (``SystemExit``) passes that up
    instead of leaving the consumer waiting."""
    from ayolov2_torch.data import DataLoader

    held = _Held(hold=4)
    t0 = time.monotonic()
    try:
        with pytest.raises(RuntimeError, match="waited for batch 1 of 3"):
            list(DataLoader(held, batch_size=4, workers=1, timeout=2.0))
        assert 2.0 <= time.monotonic() - t0 < 30.0
    finally:
        held.release.set()
    with pytest.raises(SystemExit, match="item 5 ended its thread"):
        list(DataLoader(_Held(exit_at=5), batch_size=4, workers=2, timeout=30.0))
