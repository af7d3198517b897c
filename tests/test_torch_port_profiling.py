"""Tracing on ``torch.profiler`` (CPU activities here): the port's
``utils/profiling.py`` with the JAX package's variables and window.

- ``StepWindowTracer`` opens at step 2 and closes after
  ``AYOLO_TRACE_STEPS`` steps, counted from the ``ProfilerStep#N`` ranges in
  the Chrome-trace JSON; a run shorter than the window is closed by
  ``close``; nothing is written when ``AYOLO_TRACE_DIR`` is unset;
- a profiler that cannot start is logged once and the run goes on;
- ``maybe_trace``, the validator's loop and ``cli.train`` write their
  traces under ``AYOLO_TRACE_DIR``; ``cli.val2 --trace-dir`` writes one;
- ``cli.val --profile --n-profile 2`` logs the forward in ms per image.
"""

import json
import logging

import pytest
import torch

from _torch_port_common import GOLDEN, LABELLED_IMG, labelled_set, train_files

torch.set_num_threads(1)


def _steps(trace_root, sub):
    """The ProfilerStep numbers of the one trace file under ``sub``."""
    (path,) = (trace_root / sub).glob("*.pt.trace.json")
    events = json.loads(path.read_text())["traceEvents"]
    return sorted(int(e["name"].split("#")[1]) for e in events
                  if e.get("cat") == "user_annotation" and e.get("name", "").startswith("ProfilerStep#"))


def _work():
    x = torch.randn(32, 32)
    return (x @ x).sum()


@pytest.mark.parametrize("window,run,want", [(3, 10, [2, 3, 4]), (4, 4, [2, 3]), (1, 5, [2])],
                         ids=["window-3", "cut-short", "window-1"])
def test_step_window_opens_at_step_2_for_the_window(tmp_path, monkeypatch, window, run, want):
    from ayolov2_torch.utils.profiling import StepWindowTracer

    monkeypatch.setenv("AYOLO_TRACE_DIR", str(tmp_path))
    monkeypatch.setenv("AYOLO_TRACE_STEPS", str(window))
    tracer = StepWindowTracer("train", device="cpu")
    for i in range(run):
        tracer.step(i)
        _work()
    tracer.close()
    assert _steps(tmp_path, "train") == want
    assert tracer.path and tracer.path.endswith(".pt.trace.json")
    tracer.step(run + 1)  # closed: a no-op
    assert len(list((tmp_path / "train").iterdir())) == 1


def test_nothing_is_written_when_unset(tmp_path, monkeypatch):
    from ayolov2_torch.utils.profiling import StepWindowTracer, maybe_trace, trace_dir

    monkeypatch.delenv("AYOLO_TRACE_DIR", raising=False)
    monkeypatch.chdir(tmp_path)
    assert trace_dir("val") is None
    tracer = StepWindowTracer("train")
    for i in range(6):
        tracer.step(i)
    tracer.close()
    with maybe_trace("val") as on:
        _work()
    assert on is False and tracer.path is None
    assert list(tmp_path.iterdir()) == []


def test_a_profiler_that_cannot_start_warns_once(tmp_path, monkeypatch, caplog):
    from ayolov2_torch.utils import profiling

    def broken(**kw):
        raise RuntimeError("no profiler here")

    monkeypatch.setenv("AYOLO_TRACE_DIR", str(tmp_path))
    monkeypatch.setattr(profiling, "_warned", False)
    monkeypatch.setattr(profiling.torch.profiler, "profile", broken)
    with caplog.at_level(logging.WARNING):
        with profiling.maybe_trace("val") as on:
            _work()
        tracer = profiling.StepWindowTracer("train")
        for i in range(5):
            tracer.step(i)
        tracer.close()
    assert on is False
    assert caplog.text.count("torch.profiler unavailable") == 1


def test_maybe_trace_writes_a_chrome_trace(tmp_path, monkeypatch):
    from ayolov2_torch.utils.profiling import maybe_trace

    monkeypatch.setenv("AYOLO_TRACE_DIR", str(tmp_path))
    with maybe_trace("val", "cpu") as on:
        _work()
    assert on is True
    (path,) = (tmp_path / "val").glob("*.pt.trace.json")
    names = {e.get("name") for e in json.loads(path.read_text())["traceEvents"]}
    assert "aten::mm" in names


def test_train_cli_writes_the_step_window(tmp_path, monkeypatch):
    """``cli.train --device cpu`` under AYOLO_TRACE_DIR, 2 epochs of 2
    steps and a window of 2: steps 2 and 3 (the second epoch) traced. The
    first epoch's validation writes its own val trace; the second's runs
    inside the open window and is part of the train trace."""
    from ayolov2_torch.cli import train

    model_cfg, data, cfg = train_files(tmp_path, epochs=2)
    monkeypatch.setenv("AYOLO_TRACE_DIR", str(tmp_path / "trace"))
    monkeypatch.setenv("AYOLO_TRACE_STEPS", "2")
    train.main(["--model", str(model_cfg), "--data", str(data), "--cfg", str(cfg),
                "--log-dir", str(tmp_path / "runs"), "--device", "cpu"])
    assert _steps(tmp_path / "trace", "train") == [2, 3]
    assert len(list((tmp_path / "trace" / "val").glob("*.pt.trace.json"))) == 1


@pytest.fixture(scope="module")
def data_cfg(tmp_path_factory):
    root = tmp_path_factory.mktemp("profiling_labelled")
    images = labelled_set(root)
    path = root / "data.json"
    path.write_text(json.dumps({"val_path": str(images), "nc": 20}))
    return path


def test_val_cli_profile_logs_ms_per_image(data_cfg, caplog):
    from ayolov2_torch.cli import val

    with caplog.at_level(logging.INFO):
        result = val.main(["--weights", str(GOLDEN / "weights/best.ckpt"), "--data-cfg",
                           str(data_cfg), "-iw", str(LABELLED_IMG), "--batch-size", "4",
                           "--device", "cpu", "--no-half", "--profile", "--n-profile", "2"])
    assert result["seen"] == 9
    line = next(r.getMessage() for r in caplog.records if r.getMessage().startswith("Profile:"))
    assert "ms/image (batch 4, 2 runs" in line and float(line.split()[1]) > 0


def test_val2_cli_trace_dir_writes_a_trace(data_cfg, tmp_path):
    from ayolov2_torch.cli import val2

    val2.main(["--weights", str(GOLDEN / "weights/best.ckpt"), "--data-cfg", str(data_cfg), "-iw",
               str(LABELLED_IMG), "--batch-size", "4", "--device", "cpu", "--no-half",
               "--json-path", str(tmp_path / "sheet.json"), "--trace-dir", str(tmp_path / "t")])
    (path,) = (tmp_path / "t").glob("*.pt.trace.json")
    names = {e.get("name") for e in json.loads(path.read_text())["traceEvents"]}
    assert any(n and n.startswith("aten::conv") for n in names)
