"""``chip_smoke.py``'s phase 18 driven on the CPU at a small size (yolov5n at
64 px, global bs 4, 2 steps; serving bs 4; ``cli.train`` on 8 drawn images):
its own code, over gloo, with every gate it applies on the card but K1's
launch counts (on the CPU the wrappers run K1's plain version, which launches
nothing; the teacher's and the serving's ``early`` stand for them)."""

import sys

import torch

from _torch_port_common import ROOT

torch.set_num_threads(1)


def test_phase_18_rehearsed_on_the_cpu(tmp_path, monkeypatch):
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    monkeypatch.setattr(chip_smoke, "PARALLEL_DIR", tmp_path / "parallel")
    monkeypatch.setattr(chip_smoke, "VAL_DIR", tmp_path / "no_val_set")
    ok, launches = chip_smoke.parallel_phase(
        "cpu", 0, device="cpu", variant="n", img=64, bs=4, steps=2, serve_bs=4, serve_img=64,
        cli_img=64, cli_bs=4, cli_drawn=8)
    assert ok and launches == 0
    logs = {p.name for p in (tmp_path / "parallel").iterdir()}
    assert {"nccl_rank0.json", "gloo_rank0.json", "gloo_rank1.json", "probe_rank1.json"} <= logs
