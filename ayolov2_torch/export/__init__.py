"""Serving functions and their export: uint8 images in, fixed-shape detections out."""

from ayolov2_torch.export.exporter import (
    ServingModule,
    export_serving,
    letterbox_geometry,
    load_exported,
    make_raw_serving_fn,
    make_serving_fn,
)

__all__ = ["ServingModule", "export_serving", "letterbox_geometry", "load_exported",
           "make_raw_serving_fn", "make_serving_fn"]
