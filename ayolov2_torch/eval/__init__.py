"""Validation: the mAP loop over a labelled data set."""

from ayolov2_torch.eval.validator import YoloValidator

__all__ = ["YoloValidator"]
