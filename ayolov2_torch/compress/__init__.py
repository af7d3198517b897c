"""Model compression: int8 post-training quantization and Tucker-2
decomposition with EVBMF rank estimation."""

from ayolov2_torch.compress.decomposition import (
    EVBMF,
    decompose_model,
    estimate_ranks,
    tucker2,
)
from ayolov2_torch.compress.quantize import (
    collect_activation_stats,
    quantize_model,
    quantize_params,
)

__all__ = ["EVBMF", "collect_activation_stats", "decompose_model", "estimate_ranks",
           "quantize_model", "quantize_params", "tucker2"]
