"""``chip_smoke.py``'s phase 19 driven on the CPU at a small size (yolov5n at
64 and 96 px, bs 1): its own code, one rank and then two over gloo, with
every gate it applies on the card but K1's launch counts and input heights
(on the CPU the wrappers run K1's plain version, which launches nothing) and
the card-only 19.3."""

import sys

import torch

from _torch_port_common import ROOT

torch.set_num_threads(1)


def test_phase_19_rehearsed_on_the_cpu(tmp_path, monkeypatch):
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    monkeypatch.setattr(chip_smoke, "PARALLEL_DIR", tmp_path / "parallel")
    ok, launches, entries = chip_smoke.latency_phase("cpu", 0, device="cpu", variant="n",
                                                     sizes=(64, 96), iters=2)
    assert ok and launches == 0 and entries == []
    logs = {p.name for p in (tmp_path / "parallel").iterdir()}
    assert {"latency_nccl_rank0.json", "latency_gloo_rank0.json",
            "latency_gloo_rank1.json"} <= logs
