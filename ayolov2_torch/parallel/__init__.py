"""Feeding the card: the pipelined host-to-device serving stream."""

from ayolov2_torch.parallel.serve import serve_stream

__all__ = ["serve_stream"]
