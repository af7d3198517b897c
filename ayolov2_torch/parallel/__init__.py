"""The parallelism layer over ``torch.distributed``: ranks and the mesh
(``mesh``), differentiable collectives (``collectives``), data, ZeRO and
tensor parallelism in the train step (``sharded``), the entry points' ranks
(``launch``), sharded and spatially split serving and the host-to-device
stream (``serve``; the split's row plan and layer walk in ``spatial``).

The JAX package's BatchNorm over a sharded batch is SyncBN
(``models.layers.batchnorm_sync``); its per-host input sharding is the
loader's ``shard=(index, count)``.
"""

from ayolov2_torch.parallel.mesh import (
    batch_sharding,
    get_mesh,
    host_broadcast_max,
    initialize_distributed,
    is_main_process,
    make_global_batch,
    replicate,
    shard_batch,
    tp_sharding,
    zero_sharding,
)
from ayolov2_torch.parallel.serve import (
    make_latency_serving_fn,
    make_sharded_serving_fn,
    serve_stream,
)

__all__ = [
    "make_sharded_serving_fn",
    "make_latency_serving_fn",
    "serve_stream",
    "zero_sharding",
    "tp_sharding",
    "get_mesh",
    "batch_sharding",
    "replicate",
    "shard_batch",
    "initialize_distributed",
    "is_main_process",
    "make_global_batch",
    "host_broadcast_max",
]
