"""Serving functions: uint8 images in, fixed-shape detections out."""

from ayolov2_torch.export.exporter import make_serving_fn

__all__ = ["make_serving_fn"]
