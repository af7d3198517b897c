"""The YOLOv5 v6 graph as Python data, so serving needs no YAML parser.

The n/s/m/l/x model YAMLs (``res/configs/model/yolov5{n,s,m,l,x}.yaml``)
differ only in ``depth_multiple`` and ``width_multiple``; this module holds
the shared graph once and :func:`yolov5_cfg` fills in the two multiples.
"""

from __future__ import annotations

import copy
from typing import Any, Dict

_ANCHORS = [
    [10, 13, 16, 30, 33, 23],       # P3/8
    [30, 61, 62, 45, 59, 119],      # P4/16
    [116, 90, 156, 198, 373, 326],  # P5/32
]
_ACT = {"activation": "SiLU"}

YOLOV5_V6: Dict[str, Any] = {
    "input_size": [640, 640],
    "input_channel": 3,
    "anchors": _ANCHORS,
    "n_classes": 80,
    "activation": "SiLU",
    "backbone": [
        [-1, 1, "Conv", [64, 6, 2, 2], _ACT],
        [-1, 1, "Conv", [128, 3, 2], _ACT],
        [-1, 3, "C3", [128], _ACT],
        [-1, 1, "Conv", [256, 3, 2], _ACT],
        [-1, 6, "C3", [256], _ACT],
        [-1, 1, "Conv", [512, 3, 2], _ACT],
        [-1, 9, "C3", [512], _ACT],
        [-1, 1, "Conv", [1024, 3, 2], _ACT],
        [-1, 3, "C3", [1024], _ACT],
        [-1, 1, "SPPF", [1024, 5], _ACT],
        # PANet neck
        [-1, 1, "Conv", [512, 1, 1], _ACT],
        [-1, 1, "UpSample", [None, 2]],
        [[-1, 6], 1, "Concat", [1]],
        [-1, 3, "C3", [512, False], _ACT],
        [-1, 1, "Conv", [256, 1, 1], _ACT],
        [-1, 1, "UpSample", [None, 2]],
        [[-1, 4], 1, "Concat", [1]],
        [-1, 3, "C3", [256, False], _ACT],
        [-1, 1, "Conv", [256, 3, 2], _ACT],
        [[-1, 14], 1, "Concat", [1]],
        [-1, 3, "C3", [512, False], _ACT],
        [-1, 1, "Conv", [512, 3, 2], _ACT],
        [[-1, 10], 1, "Concat", [1]],
        [-1, 3, "C3", [1024, False], _ACT],
    ],
    "head": [
        [[17, 20, 23], 1, "YOLOHead", ["nc", "anchors"]],
    ],
}

# (depth_multiple, width_multiple) per variant
MULTIPLES = {
    "n": (0.33, 0.25),
    "s": (0.33, 0.5),
    "m": (0.67, 0.75),
    "l": (1.0, 1.0),
    "x": (1.33, 1.25),
}


def yolov5_cfg(variant: str, nc: int = 80) -> Dict[str, Any]:
    """The config dict of yolov5{variant}, as ``yaml.safe_load`` gives it."""
    if variant not in MULTIPLES:
        raise ValueError(f"unknown yolov5 variant {variant!r}; one of {sorted(MULTIPLES)}")
    cfg = copy.deepcopy(YOLOV5_V6)
    cfg["depth_multiple"], cfg["width_multiple"] = MULTIPLES[variant]
    cfg["n_classes"] = nc
    cfg["head"][0][3] = [nc, copy.deepcopy(_ANCHORS)]
    return cfg
