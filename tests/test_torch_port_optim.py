"""The optimizer's groups, schedules, accumulation, freezing and the EMA
rate: the port against the JAX package (optax) on the same numpy weights
and gradients."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_port_common import random_variables, to_numpy_tree

torch.set_num_threads(1)

HYP = {"optimizer_params": {"lr": 0.01, "momentum": 0.937, "nesterov": True,
                            "betas": [0.9, 0.99]},
       "lrf": 0.1, "weight_decay": 0.0005, "warmup_epochs": 0.0, "warmup_momentum": 0.8,
       "warmup_bias_lr": 0.1, "warmup_min_iters": 2}


def tiny_cfg(nc: int = 4):
    from ayolov2_torch.models import yolov5_cfg

    cfg = yolov5_cfg("s", nc=nc)
    cfg["width_multiple"] = 0.125
    return cfg


@pytest.fixture(scope="module")
def weights():
    """(flax numpy variables, 4 micro-batches of flax-layout gradients)."""
    from ayolov2_tpu.models import build_model

    model = build_model(tiny_cfg(), dtype=jnp.float32)
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3), jnp.float32), training=False))
    variables = random_variables(shapes, 0)
    rng = np.random.default_rng(1)
    grads = [jax.tree_util.tree_map(lambda p: rng.normal(0, 0.1, p.shape).astype(np.float32),
                                    variables["params"]) for _ in range(4)]
    return variables, grads


def port_model(variables):
    from ayolov2_torch.models import build_model
    from ayolov2_torch.utils.weights import load_flax_variables

    return load_flax_variables(build_model(tiny_cfg(), device="cpu"), variables)


def torch_grads(tree):
    from ayolov2_torch.utils.weights import state_dict_from_flax

    return state_dict_from_flax({"params": tree})


def run_jax(tx, params, grads):
    update = jax.jit(tx.update)
    state = tx.init(params)
    for g in grads:
        upd, state = update(g, state, params)
        params = optax.apply_updates(params, upd)
    return to_numpy_tree(params)


def run_port(opt, model, grads):
    named = dict(model.named_parameters())
    for g in grads:
        for name, t in torch_grads(g).items():
            p = named[name]
            p.grad = t.clone() if p.grad is None else p.grad + t  # autograd sums micro-batches
        opt.step()
    return model


def assert_params_equal(model, params, tol):
    from ayolov2_torch.utils.weights import flax_from_state_dict

    got = flax_from_state_dict(model.state_dict())["params"]
    flat_g = jax.tree_util.tree_leaves_with_path(got)
    flat_w = dict(jax.tree_util.tree_leaves_with_path(params))
    assert len(flat_g) == len(flat_w)
    for path, g in flat_g:
        np.testing.assert_allclose(g, flat_w[path], rtol=0, atol=tol, err_msg=str(path))


@pytest.mark.parametrize("kind", ["SGD", "Adam"])
def test_build_optimizer_matches_optax(weights, kind):
    """Two updates at accumulate 2 (four micro-batches): the first in
    warmup (weights at lr 0, biases at warmup_bias_lr), the second at lr0."""
    from ayolov2_tpu.train.optimizer import build_optimizer as jax_build

    from ayolov2_torch.train.optimizer import build_optimizer

    variables, grads = weights
    kw = dict(epochs=3, steps_per_epoch=4, batch_size=16, accumulate=2, optimizer=kind)
    want = run_jax(jax_build(variables["params"], HYP, **kw), variables["params"], grads)
    model = port_model(variables)
    opt = build_optimizer(model, HYP, **kw)
    run_port(opt, model, grads)
    assert opt.updates == 2 and opt.mini_step == 0
    assert_params_equal(model, want, 1e-6)
    before = to_numpy_tree(variables["params"])
    moved = max(float(np.abs(a - b).max()) for a, b in zip(
        jax.tree_util.tree_leaves(want), jax.tree_util.tree_leaves(before)))
    assert moved > 1e-4


def test_freeze_layers_matches_jax(weights):
    from ayolov2_tpu.train.optimizer import build_optimizer as jax_build
    from ayolov2_tpu.train.trainer import _freeze_layers

    from ayolov2_torch.train.optimizer import build_optimizer

    variables, grads = weights
    kw = dict(epochs=3, steps_per_epoch=4, batch_size=16, accumulate=2)
    tx = _freeze_layers(jax_build(variables["params"], HYP, **kw), 3)
    want = run_jax(tx, variables["params"], grads)
    model = port_model(variables)
    opt = build_optimizer(model, HYP, freeze=3, **kw)
    run_port(opt, model, grads)
    assert_params_equal(model, want, 1e-6)
    frozen = [n for n, _ in model.named_parameters() if int(n.split(".")[1]) < 3]
    assert frozen and len(opt.frozen) == len(frozen)
    named = dict(model.named_parameters())
    start = dict(port_model(variables).named_parameters())
    for n in frozen:
        assert torch.equal(named[n], start[n])
        assert opt.opt.state[named[n]]["momentum_buffer"].abs().max() > 0  # state advanced


def test_param_labels_match_jax(weights):
    from ayolov2_tpu.train.optimizer import _param_labels as jax_labels

    from ayolov2_torch.train.optimizer import _param_labels
    from ayolov2_torch.utils.weights import state_dict_from_flax

    variables, _ = weights
    labels = jax_labels(variables["params"])
    codes = {"bn_scale": 1.0, "weight": 2.0, "bias": 3.0}
    coded = jax.tree_util.tree_map(lambda s, p: np.full(p.shape, codes[s], np.float32),
                                   labels, variables["params"])
    want = {k: int(v.flatten()[0]) for k, v in state_dict_from_flax({"params": coded}).items()}
    model = port_model(variables)
    got = _param_labels(n for n, _ in model.named_parameters())
    assert set(got) == set(want)
    assert {k: int(codes[v]) for k, v in got.items()} == want
    assert set(got.values()) == {"bn_scale", "weight", "bias"}


@pytest.mark.parametrize("linear", [False, True])
def test_schedules_and_ema_rate_match_jax(linear):
    from ayolov2_tpu.train.optimizer import make_group_schedules as jax_sched
    from ayolov2_tpu.train.train_state import EMA as JaxEMA

    from ayolov2_torch.train.optimizer import make_group_schedules
    from ayolov2_torch.train.train_state import EMA

    kw = dict(lr0=0.01, lrf=0.1, epochs=7, steps_per_epoch=5, warmup_epochs=2.0,
              warmup_bias_lr=0.1, warmup_momentum=0.8, momentum=0.937, linear_lr=linear,
              warmup_min_iters=4)
    jlr, jmom = jax_sched(**kw)
    lr, mom = make_group_schedules(**kw)
    nw = 10
    steps = np.arange(0, 3 * nw + 6)
    for g in ("bn_scale", "weight", "bias"):
        want = np.asarray([float(jlr(jnp.float32(s), g)) for s in steps])
        got = np.asarray([float(lr(int(s), g)) for s in steps])
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose([float(mom(int(s))) for s in steps],
                               [float(jmom(jnp.float32(s))) for s in steps], rtol=1e-6)
    # 1 - exp(-n / 2000) in f32: the two exp implementations may differ by
    # one ulp, which is 6e-8 absolute in the rate
    np.testing.assert_allclose([float(EMA().rate(int(s))) for s in steps],
                               [float(JaxEMA().rate(jnp.int32(s))) for s in steps], rtol=0,
                               atol=1.2e-7)
