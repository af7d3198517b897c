"""Create an SWA (stochastic weight averaging) model from epoch checkpoints.

The counterpart of ``cli/create_swa_model.py``: the ``epoch_*.ckpt`` files
of a model directory ranked by their stored mAP50, the best N averaged with
equal weights (params and BatchNorm statistics, each leaf accumulated in
f32 in the ranked order, then divided by N), written as ``swa.ckpt`` (or
``-n``) with the average under both ``model`` and ``ema``, f32, and the
best checkpoint's meta with ``map50`` the mean of the chosen. The file is in
the JAX package's format; ``cli.val`` reads it. Host-side numpy only.

Usage:
    python -m ayolov2_torch.cli.create_swa_model -d runs/train/xxx/weights -b 5
"""

from __future__ import annotations

import argparse
import logging
import re
import sys
from pathlib import Path
from typing import Any, List, Optional, Sequence

import numpy as np

from ayolov2_torch.utils.checkpoint import load_checkpoint, write_checkpoint

LOGGER = logging.getLogger("swa")


def average_trees(trees: List[Any]) -> Any:
    """Equal-weight average of nested dicts of arrays (f32 accumulation, in
    list order)."""
    if isinstance(trees[0], dict):
        return {k: average_trees([t[k] for t in trees]) for k in sorted(trees[0])}
    acc = np.zeros_like(np.asarray(trees[0], dtype=np.float32))
    for leaf in trees:
        acc += np.asarray(leaf, dtype=np.float32)
    return acc / len(trees)


def create_swa_model(model_dir: str, swa_model_name: str, best_num: int) -> str:
    """Average the best ``best_num`` epoch checkpoints by stored mAP50;
    returns the written path."""
    model_dir_p = Path(model_dir)
    candidates = []
    for f in sorted(model_dir_p.glob("epoch_*.ckpt")):
        if not re.match(r"epoch_\d+\.ckpt", f.name):
            continue
        raw = load_checkpoint(f)
        candidates.append((float(raw.get("meta", {}).get("map50", -1.0)), f, raw))
    if not candidates:
        raise FileNotFoundError(f"no epoch_*.ckpt files found in {model_dir}")
    candidates.sort(key=lambda c: -c[0])
    chosen = candidates[:best_num]
    LOGGER.info("SWA over %d ckpts: %s", len(chosen),
                [(c[1].name, round(c[0], 4)) for c in chosen])
    branches = [c[2].get("ema") or c[2]["model"] for c in chosen]
    avg_params = average_trees([b["params"] for b in branches])
    avg_stats = average_trees([b["batch_stats"] for b in branches])
    meta = dict(chosen[0][2]["meta"])
    meta["map50"] = float(np.mean([c[0] for c in chosen]))
    out_path = model_dir_p / swa_model_name
    write_checkpoint(out_path, {
        "meta": meta,
        "model": {"params": avg_params, "batch_stats": avg_stats},
        "ema": {"params": avg_params, "batch_stats": avg_stats},
    })
    LOGGER.info("SWA model written to %s", out_path)
    return str(out_path)


def get_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Create SWA model from epoch checkpoints.")
    parser.add_argument("--model_dir", "-d", type=str, required=True,
                        help="directory containing epoch_*.ckpt files")
    parser.add_argument("--swa_model_name", "-n", type=str, default="swa.ckpt")
    parser.add_argument("--best_num", "-b", type=int, default=5,
                        help="average over the best N checkpoints by mAP50")
    return parser


def main(argv: Optional[Sequence[str]] = None) -> str:
    args = get_parser().parse_args(argv)
    return create_swa_model(args.model_dir, args.swa_model_name, args.best_num)


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, format="%(message)s", stream=sys.stdout)
    main()
