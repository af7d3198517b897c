"""Model layer: config-declared YOLOv5-family networks as torch modules."""

from ayolov2_torch.models.builder import (
    YOLOModel,
    build_model,
    count_params,
    fuse_params,
    init_model,
)
from ayolov2_torch.models.configs import yolov5_cfg

__all__ = ["YOLOModel", "build_model", "count_params", "fuse_params", "init_model",
           "yolov5_cfg"]
