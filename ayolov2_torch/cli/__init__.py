"""Command-line entry points: ``python -m ayolov2_torch.cli.<name>``."""
