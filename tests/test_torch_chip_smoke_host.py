"""What ``chip_smoke.py`` holds without the card, on the CPU.

- ``cli.train`` with ``train_config.yaml``'s sections, run by
  ``chip_smoke.run_in_process`` as the script runs it once a fresh
  interpreter has: with ``plot: false`` and no trace window it writes no
  plot and no trace and logs neither; with ``plot: true`` and a window of 2
  steps it writes and logs both (the card's 11.1 checks that side at 640);
- ``run_in_process``: an entry point's log records and prints as its
  output, exit 0, 1 on an error and on a nonzero ``SystemExit``, the
  environment it was given unset again after;
- ``phase_done``: each phase's wall and CPU seconds, of the script and of
  its children (a child's counted in the phase that waits for it); the
  host line of phase 1, with the CPU's family, model and clock where
  /proc/cpuinfo names the model "unknown";
- phases 18 and 19 as the whole run drives them, at the small sizes of
  their own CPU rehearsals: 19.1 and 19.2 in the interpreters of 18.1 and
  18.2, which wait for phase 19 to start them, under every gate of both
  phases but K1's launch counts (on the CPU the wrappers launch nothing).
"""

import io
import os
import subprocess
import sys
import time

import pytest
import torch

from _torch_port_common import ROOT, train_files

torch.set_num_threads(1)
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402


@pytest.mark.parametrize("diagnostics", [False, True], ids=["plot_false", "plot_and_trace"])
def test_train_cli_writes_plots_and_trace_only_when_asked(tmp_path, diagnostics):
    model_cfg, data, _ = train_files(tmp_path)
    text = (ROOT / "res/configs/cfg/train_config.yaml").read_text()
    for a, b in (("epochs: 300", "epochs: 1"), ("batch_size: 64", "batch_size: 2"),
                 ("image_size: 640", "image_size: 64"), ('label_type: "segments"', "label_type: labels"),
                 ("  plot: true", f"  plot: {str(diagnostics).lower()}\n  half: false")):
        assert a in text
        text = text.replace(a, b, 1)
    cfg = tmp_path / "train_config.yaml"
    cfg.write_text(text)
    trace = tmp_path / "trace"
    env = dict(AYOLO_TRACE_DIR=str(trace), AYOLO_TRACE_STEPS="2") if diagnostics else None
    assert "AYOLO_TRACE_DIR" not in os.environ
    proc, wall = chip_smoke.run_in_process(
        ["-m", "ayolov2_torch.cli.train", "--model", str(model_cfg), "--data", str(data), "--cfg",
         str(cfg), "--log-dir", str(tmp_path / "runs"), "--device", "cpu"], env=env)
    assert proc.returncode == 0, proc.stdout[-2000:]
    assert "AYOLO_TRACE_DIR" not in os.environ and wall > 0
    (run,) = (tmp_path / "runs" / "train").iterdir()
    assert "epoch   0 done in" in proc.stdout and (run / "weights" / "best.ckpt").exists()
    pngs = sorted(p.name for p in run.glob("*.png"))
    traces = sorted(tmp_path.rglob("*.pt.trace.json"))
    logged = [ln for ln in proc.stdout.splitlines()
              if ln.startswith("profiler trace written to ")
              or (ln.startswith("plot ") and " written in " in ln)]
    if diagnostics:
        assert pngs == ["labels.png", "train_batch0.png", "train_batch1.png", "train_batch2.png"]
        assert [t.parent.name for t in traces] == ["train"] and len(logged) == 5
    else:
        assert pngs == [] and traces == [] and logged == [] and not trace.exists()


def test_run_in_process_output_status_and_environment(monkeypatch):
    monkeypatch.delenv("AYOLO_SMOKE_PROBE", raising=False)
    proc, _ = chip_smoke.run_in_process(["-m", "ayolov2_torch.cli.val", "--help"],
                                        env={"AYOLO_SMOKE_PROBE": "1"})
    assert proc.returncode == 0 and "--weights" in proc.stdout
    assert "AYOLO_SMOKE_PROBE" not in os.environ
    monkeypatch.setenv("AYOLO_SMOKE_PROBE", "kept")
    proc, _ = chip_smoke.run_in_process(["-m", "ayolov2_torch.cli.val", "--no-such-flag"],
                                        env={"AYOLO_SMOKE_PROBE": "2"})
    assert proc.returncode == 1 and "unrecognized arguments" in proc.stdout
    assert os.environ["AYOLO_SMOKE_PROBE"] == "kept"
    proc, _ = chip_smoke.run_in_process(["-m", "ayolov2_torch.cli.val", "--weights",
                                         "missing.ckpt", "--data-cfg", "missing.json"])
    assert proc.returncode == 1 and "Traceback" in proc.stdout


def test_phase_done_wall_and_cpu_of_script_and_children(monkeypatch):
    monkeypatch.setattr(chip_smoke, "PHASE_S", {})
    chip_smoke.phase_done("a")
    t0 = time.process_time()
    while time.process_time() - t0 < 0.2:  # the script's own CPU
        pass
    subprocess.run([sys.executable, "-c", "import time\nt = time.process_time()\n"
                    "while time.process_time() - t < 0.3: pass"], check=True)
    chip_smoke.phase_done("b")
    wall, own, kids = chip_smoke.PHASE_S["b"]
    assert wall >= 0.5 and 0.2 <= own < wall and 0.3 <= kids < wall
    total = [sum(p[i] for p in chip_smoke.PHASE_S.values()) for i in range(3)]
    now = (time.perf_counter() - chip_smoke.T_START, *chip_smoke.cpu_s())
    assert all(0 <= n - t < 0.5 for n, t in zip(now, total))
    line = chip_smoke.host_line()
    assert f"os.cpu_count() {os.cpu_count()}" in line and "load average (1 min)" in line
    # /proc/cpuinfo naming the model "unknown": its family, model and clock instead
    real_open = open
    cpuinfo = ("processor\t: 0\nvendor_id\t: GenuineIntel\ncpu family\t: 6\nmodel\t\t: 143\n"
               "model name\t: unknown\ncpu MHz\t\t: 2000.000\n\nprocessor\t: 1\n")
    monkeypatch.setattr("builtins.open", lambda path, *a, **k: io.StringIO(cpuinfo)
                        if path == "/proc/cpuinfo" else real_open(path, *a, **k))
    assert chip_smoke.host_line().startswith(
        "vendor_id GenuineIntel cpu family 6 model 143 cpu MHz 2000.000, os.cpu_count()")


def test_phase_19_runs_in_phase_18s_interpreters(tmp_path, monkeypatch):
    monkeypatch.setattr(chip_smoke, "PARALLEL_DIR", tmp_path / "parallel")
    monkeypatch.setattr(chip_smoke, "VAL_DIR", tmp_path / "no_val_set")
    latency = chip_smoke.latency_specs(0, device="cpu", variant="n", sizes=(64, 96), iters=2)
    ok, launches = chip_smoke.parallel_phase(
        "cpu", 0, device="cpu", variant="n", img=64, bs=4, steps=2, serve_bs=4, serve_img=64,
        cli_img=64, cli_bs=4, cli_drawn=8, probe=False, latency=latency)
    assert ok and launches == 0
    procs = [proc for ranks in latency["ranks"].values() for _, proc, _, _ in ranks]
    assert len(procs) == 3 and all(proc.poll() is None for proc in procs)  # waiting for 19
    ok, launches, entries = chip_smoke.latency_phase("cpu", 0, device="cpu", variant="n",
                                                     sizes=(64, 96), iters=2,
                                                     started=latency["ranks"])
    assert ok and launches == 0 and entries == [] and all(p.returncode == 0 for p in procs)
    names = {p.name for p in (tmp_path / "parallel").iterdir()}
    assert {"nccl_rank0.json", "gloo_rank1.json", "latency_nccl_rank0.json",
            "latency_gloo_rank0.json", "latency_gloo_rank1.json"} <= names
    assert not any(n.startswith("latency") and n.endswith(".log") for n in names)
