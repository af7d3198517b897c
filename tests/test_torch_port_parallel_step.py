"""The train step on N ranks (gloo, on the CPU) against JAX's step over a
mesh of the same shape on the same global batch, and against the port's
one-rank step: data parallelism on 2 and 4 ranks, ZeRO (``fsdp``) on 2,
tensor parallelism on a (1, 2) and a (2, 2) mesh. The JAX tests' tiny
model, f32, 64 px, a global batch of 4, two steps (each an update).

Tolerances as ``test_torch_port_train_step.py``'s: loss items 1e-4
relative; params, BN statistics and EMA 1e-4 of the tree's peak; the
steps' changes 1e-2. Leaves each rank holds whole are bit-equal across the
ranks; a ZeRO leaf holds 1/N of the whole on each rank."""

import numpy as np
import pytest
import torch

from _torch_parallel_common import (
    HYP,
    OPT,
    delta_rel,
    flat,
    global_batches,
    jax_setup,
    jax_steps,
    rel,
    run_ranks,
    tiny_cfg,
    tree_rel,
    write_case,
)

torch.set_num_threads(1)

FSDP_MIN = 2048  # small enough that the tiny model's kernels are split


@pytest.fixture(scope="module")
def setup():
    return jax_setup()


@pytest.fixture(scope="module")
def one_rank(setup):
    """The port's step on one process without ranks: items, final state."""
    from ayolov2_torch.loss.yolo_loss import ComputeLoss
    from ayolov2_torch.models import build_model
    from ayolov2_torch.train.optimizer import build_optimizer
    from ayolov2_torch.train.train_state import create_train_state, make_train_step
    from ayolov2_torch.utils.weights import flax_from_state_dict, load_flax_variables

    model = load_flax_variables(build_model(tiny_cfg(), device="cpu"), setup[1])
    loss = ComputeLoss.from_hyp(model.head.stride_anchors(), model.nc, HYP)
    state = create_train_state(model, build_optimizer(model, HYP, epochs=3, **OPT))
    step = make_train_step(loss, image_dtype=torch.float32)
    items = [step(state, *(torch.from_numpy(a) for a in b)).numpy() for b in global_batches()]
    return np.stack(items), flat(flax_from_state_dict(state.model.state_dict())), \
        flat(flax_from_state_dict(state.ema_model.state_dict()))


def run_port(tmp_path, setup, mesh, mode):
    write_case(tmp_path, setup[1], global_batches(), mesh=list(mesh), mode=mode,
               fsdp_min_elems=FSDP_MIN)
    world = int(np.prod(mesh))
    run_ranks("step", world, tmp_path)
    out = dict(np.load(tmp_path / "out.npz"))
    ranks = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(world)]
    model = {k[len("model/"):]: v for k, v in out.items() if k.startswith("model/")}
    ema = {k[len("ema/"):]: v for k, v in out.items() if k.startswith("ema/")}
    return out["items"], model, ema, ranks


def check(items, model, ema, items_j, state_j, start):
    want = flat({"params": state_j.params, "batch_stats": state_j.batch_stats})
    want_ema = flat({"params": state_j.ema_params, "batch_stats": state_j.ema_batch_stats})
    for k, (a, b) in enumerate(zip(items, items_j)):
        assert rel(a, b) < 1e-4, (k, a, b)
    assert tree_rel(model, want) < 1e-4
    assert tree_rel(ema, want_ema) < 1e-4
    p = [k for k in want if k.startswith("params/")]
    sub = lambda d: {k: d[k] for k in p}  # noqa: E731
    assert delta_rel(sub(model), sub(want), sub(start)) < 1e-2
    assert delta_rel(sub(ema), sub(want_ema), sub(start)) < 1e-2
    assert tree_rel(sub(model), sub(start)) > 1e-4  # the steps moved the weights


def replicas_bit_equal(ranks):
    for r in ranks[1:]:
        for k, v in ranks[0].items():
            if k.startswith(("rep/", "rep_ema/")):
                np.testing.assert_array_equal(r[k], v, err_msg=k)
    assert all((r["counters"] == [2, 2, 2]).all() for r in ranks)


@pytest.mark.parametrize("world", [2, 4])
def test_data_parallel_step_matches_jax_mesh_and_one_rank(tmp_path, setup, one_rank, world):
    """DP on 2 and 4 ranks: JAX's step over a 2- and a 4-device mesh, and the
    port's one-rank step, on the same global batch."""
    items_j, state_j = jax_steps(setup, global_batches(), shape=(world,))
    items, model, ema, ranks = run_port(tmp_path, setup, (world,), "dp")
    start = flat(setup[1])
    check(items, model, ema, items_j, state_j, start)
    items_1, model_1, ema_1 = one_rank
    for a, b in zip(items, items_1):
        assert rel(a, b) < 1e-4
    assert tree_rel(model, model_1) < 1e-4 and tree_rel(ema, ema_1) < 1e-4
    replicas_bit_equal(ranks)


def test_fsdp_step_matches_replicated_and_jax(tmp_path, setup, one_rank):
    """ZeRO on 2 ranks: JAX's fsdp step (``zero_sharding``, the same
    min_elems) and the replicated step; each split leaf holds half."""
    items_j, state_j = jax_steps(setup, global_batches(), shape=(2,), mode="fsdp",
                                 min_elems=FSDP_MIN)
    items, model, ema, ranks = run_port(tmp_path, setup, (2,), "fsdp")
    check(items, model, ema, items_j, state_j, flat(setup[1]))
    items_1, model_1, ema_1 = one_rank
    assert rel(items, items_1) < 1e-4
    assert tree_rel(model, model_1) < 1e-4 and tree_rel(ema, ema_1) < 1e-4
    replicas_bit_equal(ranks)
    from ayolov2_torch.models import build_model

    whole = build_model(tiny_cfg(), device="meta").state_dict()
    split = {k[len("split/"):]: int(v[0]) for k, v in ranks[0].items() if k.startswith("split/")}
    assert len(split) >= 3
    for k, n in split.items():
        assert n * 2 == whole[k].numel(), k
    assert ranks[0]["bytes"][1] * 2 > ranks[0]["bytes"][0] * 0.5  # the big leaves are split


@pytest.mark.parametrize("mesh", [(1, 2), (2, 2)])
def test_tensor_parallel_step_matches_jax(tmp_path, setup, one_rank, mesh):
    """TP on a (1, 2) and a (2, 2) (data, model) mesh against JAX's TP step
    over the same mesh shape; the second step advances the weights."""
    items_j, state_j = jax_steps(setup, global_batches(), shape=mesh, mode="tp")
    items, model, ema, ranks = run_port(tmp_path, setup, mesh, "tp")
    check(items, model, ema, items_j, state_j, flat(setup[1]))
    items_1, model_1, _ = one_rank
    assert rel(items, items_1) < 1e-4 and tree_rel(model, model_1) < 1e-4
    assert not np.array_equal(items[0], items[1])
    replicas_bit_equal(ranks)
    assert sum(k.startswith("split/") for k in ranks[0]) > 10  # the convs really are split
