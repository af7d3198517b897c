"""The parallelism layer's rules and helpers without ranks: ``zero_sharding``
and ``tp_sharding`` over the port's state against the JAX package's
``PartitionSpec`` trees, leaf for leaf (the tiny model's state, and
yolov5s's by shapes only); ``make_global_batch``, ``batch_sharding`` and
``initialize_distributed``'s contracts; the logger's rank gating."""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parallel_common import tiny_cfg

torch.set_num_threads(1)


def _jax_key(name: str, ndim: int) -> str:
    """The JAX package's path of a port state name ('params/model_0/conv/kernel')."""
    from ayolov2_torch.utils.weights import _flax_path

    path, leaf = _flax_path(name)
    if leaf.startswith("running_"):
        return "/".join(("batch_stats",) + path + (leaf[len("running_"):],))
    if leaf == "weight":
        leaf = "kernel" if ndim in (2, 4) else "scale"
    return "/".join(("params",) + path + (leaf,))


def _jax_layout_dim(name: str, shape, dim):
    """A port leaf's split dim in the JAX package's layout of that leaf:
    OIHW -> HWIO, (out, in) -> (in, out)."""
    if dim is None or name.split(".")[-1] not in ("weight", "q_kernel") or len(shape) == 1:
        return dim
    return {4: (2, 3, 1, 0), 2: (1, 0)}[len(shape)].index(dim)


def _jax_dims(spec_tree, axis: str) -> dict:
    """{path: the dim ``axis`` splits, or None} of a tree of NamedShardings."""
    out = {}
    for path, s in jax.tree_util.tree_leaves_with_path(spec_tree):
        key = "/".join(getattr(p, "key", str(p)) for p in path)
        dims = [d for d, a in enumerate(s.spec) if a == axis]
        out[key] = dims[0] if dims else None
    return out


def _states(variant: str):
    """(the port's state_dict shapes, JAX's {params, batch_stats} shapes)."""
    from ayolov2_tpu.models import build_model as jax_build

    from ayolov2_torch.models import build_model
    from ayolov2_torch.models.builder import parse_model_config

    cfg = tiny_cfg() if variant == "tiny" else parse_model_config(
        f"res/configs/model/yolov5{variant}.yaml")
    port = {k: tuple(v.shape) for k, v in build_model(cfg, device="meta").state_dict().items()
            if not k.endswith("num_batches_tracked")}
    model = jax_build(cfg, dtype=jnp.float32)
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0),
                                               jnp.zeros((1, 64, 64, 3)), training=True))
    return port, {"params": shapes["params"], "batch_stats": shapes["batch_stats"]}


@pytest.mark.parametrize("variant,n,min_elems", [("tiny", 2, 2048), ("tiny", 4, 2048),
                                                 ("s", 8, 65536), ("s", 2, 4096)])
def test_zero_sharding_equals_jax(variant, n, min_elems):
    from ayolov2_tpu.parallel import get_mesh, zero_sharding as jax_zero

    from ayolov2_torch.parallel.mesh import zero_sharding

    port, shapes = _states(variant)
    want = _jax_dims(jax_zero(get_mesh(jax.devices()[:n]), shapes, min_elems=min_elems), "data")
    got = zero_sharding({"data": n}, port, min_elems=min_elems)
    assert len(got) == len(want) == len(port)
    split = 0
    for name, d in got.items():
        key = _jax_key(name, len(port[name]))
        assert _jax_layout_dim(name, port[name], d) == want[key], (name, d, want[key])
        split += d is not None
    assert split > 3


@pytest.mark.parametrize("variant,shape", [("tiny", (1, 2)), ("tiny", (2, 2)), ("s", (2, 4)),
                                           ("s", (1, 8))])
def test_tp_sharding_equals_jax(variant, shape):
    from ayolov2_tpu.parallel import get_mesh, tp_sharding as jax_tp

    from ayolov2_torch.parallel.mesh import tp_sharding

    port, shapes = _states(variant)
    mesh = get_mesh(jax.devices()[:int(np.prod(shape))], axis_names=("data", "model"),
                    shape=shape)
    want = _jax_dims(jax_tp(mesh, shapes), "model")
    got = tp_sharding({"data": shape[0], "model": shape[1]}, port)
    assert len(got) == len(want)
    split = 0
    for name, d in got.items():
        key = _jax_key(name, len(port[name]))
        assert _jax_layout_dim(name, port[name], d) == want[key], (name, d, want[key])
        split += d is not None
    assert split > 10
    if variant == "s":  # the 255-wide head stays replicated
        assert got["model.24.m.0.weight"] is None and got["model.24.m.0.bias"] is None


def test_global_batch_and_batch_slices():
    from ayolov2_torch.parallel.mesh import batch_sharding, make_global_batch, shard_batch

    class Mesh:  # a (2, 2) mesh seen from rank 3: data index 1
        mesh_dim_names = ("data", "model")
        shape = (2, 2)

        def get_local_rank(self, axis):
            return 1

    images = np.zeros((3, 8, 8, 3), np.uint8)
    targets = np.array([[0, 1, .5, .5, .1, .1], [2, 0, .5, .5, .1, .1]], np.float32)
    lb = make_global_batch(Mesh(), images, targets, np.ones(2, bool))
    assert lb.offset == 3 and lb.global_size == 6
    np.testing.assert_array_equal(lb.global_targets()[:, 0], [3, 5])
    assert make_global_batch(None, images, targets, None).offset == 0
    assert batch_sharding(Mesh(), 8) == slice(4, 8)
    np.testing.assert_array_equal(shard_batch(Mesh(), {"x": np.arange(6)})["x"], [3, 4, 5])
    with pytest.raises(ValueError, match="not divisible by data-axis size 2"):
        batch_sharding(Mesh(), 5)


def test_initialize_distributed_contracts(monkeypatch):
    """No ranks named: nothing to join. Ranks named on a node with fewer
    cards than local ranks: raise naming both counts (before any rendezvous)."""
    from ayolov2_torch.parallel import mesh

    for key in ("AYOLO_NUM_PROCS", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(key, raising=False)
    assert mesh.initialize_distributed() is None
    assert mesh.world_size() == 1 and mesh.is_main_process()
    assert mesh.host_broadcast_max(None, 0.25) == 0.25 and mesh.broadcast_object(7) == 7
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setenv("AYOLO_NUM_PROCS", "2")
    monkeypatch.setenv("AYOLO_PROC_ID", "1")
    with pytest.raises(ValueError, match="rank 1 .* of 2 ranks has no card: this node has 1"):
        mesh.initialize_distributed()
    monkeypatch.delenv("AYOLO_NUM_PROCS")
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("RANK", "3")
    monkeypatch.setenv("LOCAL_RANK", "3")
    with pytest.raises(ValueError, match="local rank 3.* this node has 1 card"):
        mesh.initialize_distributed()


def test_logger_gates_ranks(monkeypatch):
    """Rank 0 logs at the level asked for, every other rank at WARNING, under
    either env contract."""
    from ayolov2_tpu.utils.logger import get_logger as jax_logger

    from ayolov2_torch.utils.logger import colorstr, get_logger, process_index, rank_level

    for key in ("AYOLO_NUM_PROCS", "AYOLO_PROC_ID", "RANK", "JAX_PROCESS_INDEX"):
        monkeypatch.delenv(key, raising=False)
    assert process_index() == 0 and rank_level(logging.INFO) == logging.INFO
    assert get_logger("port_rank0").level == logging.INFO
    monkeypatch.setenv("RANK", "1")
    assert get_logger("port_rank1").level == logging.WARNING
    assert jax_logger("jax_rank1").level == logging.WARNING  # the JAX package's gate agrees
    assert rank_level(logging.DEBUG) == logging.WARNING
    assert rank_level(logging.ERROR) == logging.ERROR
    monkeypatch.delenv("RANK")
    monkeypatch.setenv("AYOLO_NUM_PROCS", "4")
    monkeypatch.setenv("AYOLO_PROC_ID", "2")
    assert process_index() == 2 and get_logger("port_rank2").level == logging.WARNING
    monkeypatch.setenv("AYOLO_PROC_ID", "0")
    assert get_logger("port_rank0b").level == logging.INFO
    assert colorstr("red", "x") == "\033[31mx\033[0m"
