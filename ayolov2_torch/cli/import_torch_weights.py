"""Convert a reference torch checkpoint (``.pt``) into a ``.ckpt``.

The counterpart of ``cli/import_torch_weights.py``: the tensors of the
``.pt`` (its ``ema`` branch unless ``--no-ema``) go by name and shape into
``--model-cfg``'s graph with ``--nc`` classes (``utils/torch_import.py``),
and the result is written in the JAX package's checkpoint format without
optimizer state (params stored in bfloat16, as every checkpoint of either
package), so both packages' ``load_variables`` read it. Runs on the host.

Usage:
    python -m ayolov2_torch.cli.import_torch_weights --weights yolov5s.pt \\
        --model-cfg res/configs/model/yolov5s.yaml --nc 80 --out yolov5s.ckpt
"""

from __future__ import annotations

import argparse
import json
import logging
import sys
from pathlib import Path
from typing import Optional, Sequence

from ayolov2_torch.models.builder import parse_model_config
from ayolov2_torch.utils.checkpoint import (
    CKPT_VERSION,
    _cast_tree,
    load_torch_variables,
    write_checkpoint,
)

LOGGER = logging.getLogger("import_torch")


def get_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="torch .pt -> .ckpt converter")
    parser.add_argument("--weights", type=str, required=True)
    parser.add_argument("--model-cfg", type=str, required=True)
    parser.add_argument("--nc", type=int, default=80)
    parser.add_argument("--img-size", type=int, default=640,
                        help="(the JAX entry point's template size; the port's needs none)")
    parser.add_argument("--no-ema", action="store_true", help="prefer model over ema branch")
    parser.add_argument("--out", type=str, default="")
    return parser


def main(argv: Optional[Sequence[str]] = None) -> str:
    args = get_parser().parse_args(argv)
    model_cfg = parse_model_config(args.model_cfg)
    variables, meta = load_torch_variables(args.weights, model_cfg, prefer_ema=not args.no_ema,
                                           nc=args.nc)
    LOGGER.info("matched %d tensors (%d unmatched)", meta["torch_matched"],
                meta["torch_unmatched"])
    out = args.out or str(Path(args.weights).with_suffix(".ckpt"))
    branch = {"params": _cast_tree(variables["params"], True),
              "batch_stats": _cast_tree(variables["batch_stats"], False)}
    write_checkpoint(out, {
        "meta": {"version": CKPT_VERSION, "epoch": 0, "best_score": 0.0, "map50": -1.0,
                 "model_cfg": json.dumps(model_cfg),
                 "ema_updates": 0, "step": 0},
        "model": branch,
        "ema": branch,
    })
    LOGGER.info("wrote %s", out)
    return out


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, format="%(message)s", stream=sys.stdout)
    main()
