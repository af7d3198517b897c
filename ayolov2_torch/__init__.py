"""PyTorch/CUDA port of ayolov2: YOLOv5-family serving on one NVIDIA H100.

The package mirrors ``ayolov2_tpu``'s module names so each counterpart is
easy to find. It imports torch and numpy only; kernels under ``csrc/`` are
compiled with nvcc on first use (``ops/_build.py``), never at import time.
"""
