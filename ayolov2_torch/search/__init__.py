"""Hyperparameter search: a lightweight Optuna-like study engine."""

from ayolov2_torch.search.study import Study, Trial, create_study

__all__ = ["Study", "Trial", "create_study"]
