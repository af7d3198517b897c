"""Training the rest of the model zoo against the JAX package: yolov5_v5
(Focus, SPP) and yolov5_mobilevit (MV2Block, MobileViTBlock) in training
mode, activation rematerialisation, and BN folding into grouped convs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_common import (
    as_np,
    images,
    jax_zoo_variables,
    nchw,
    port_zoo_model,
    rel_to_peak,
    to_numpy_tree,
    tree_leaves,
    zoo_cfg,
)

torch.set_num_threads(1)


def _scale_err(got: dict, want: dict) -> float:
    """max |got - want| over a tree / max |want| over the tree."""
    assert set(got) == set(want)
    scale = max(float(np.abs(w).max()) for w in want.values())
    return max(float(np.abs(got[k] - want[k]).max()) for k in want) / scale


def _probes(seed: int, bs: int, sizes, no: int = 85):
    rng = np.random.default_rng(seed)
    return [rng.normal(0, 1, (bs, s, s, 3, no)) for s in sizes]


@pytest.mark.parametrize("name", ["yolov5_v5", "yolov5_mobilevit"])
def test_train_forward_gradients_and_bn_statistics_equal_jax(name):
    """Training mode (batch statistics): raw maps, the gradients of a loss
    over them (sum of mean(raw * fixed noise)) and the moved BN statistics,
    each tree within 1e-4 of its scale. Both sides in f64: in f32 both
    drift about 1e-4 from the exact result on these random weights (BN over
    2 x 2 maps of a batch of 2; JAX's f32 raw maps lie 2-3x further from the
    f64 ones than the port's), which would hide a real difference; in f64
    they agree to about 1e-13."""
    from ayolov2_tpu.models import build_model as jax_build
    from ayolov2_torch.utils.weights import flax_from_state_dict

    _, v = jax_zoo_variables(name, seed=13)
    x = images((2, 64, 64, 3), seed=14).astype(np.float64) / 255.0
    probes = _probes(26, 2, (8, 4, 2))
    with jax.enable_x64(True):
        jm = jax_build(zoo_cfg(name), dtype=jnp.float64)
        v64 = {k: jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), t)
               for k, t in v.items()}

        def loss(params, stats, x):
            raw, upd = jm.apply({"params": params, "batch_stats": stats}, x, training=True,
                                mutable=["batch_stats"])
            return sum(jnp.mean(r * p) for r, p in zip(raw, probes)), (raw, upd["batch_stats"])

        grads, (raw_j, stats_j) = jax.jit(jax.grad(loss, has_aux=True))(
            v64["params"], v64["batch_stats"], jnp.asarray(x))
        grads, stats_j = to_numpy_tree(grads), to_numpy_tree(stats_j)
        raw_j = [np.asarray(r) for r in raw_j]

    model = port_zoo_model(name, v).double().train()
    raw = model(nchw(x), training=True)
    sum((r * torch.from_numpy(p)).mean() for r, p in zip(raw, probes)).backward()
    for g, w in zip(raw, raw_j):
        assert rel_to_peak(g.detach().numpy(), w) < 1e-4
    got = flax_from_state_dict({k: p.grad for k, p in model.named_parameters()})["params"]
    assert _scale_err(tree_leaves(got), tree_leaves(grads)) < 1e-4
    stats = flax_from_state_dict(model.state_dict())["batch_stats"]
    assert _scale_err(tree_leaves(stats), tree_leaves(stats_j)) < 1e-4
    assert _scale_err(tree_leaves(stats), tree_leaves(v["batch_stats"])) > 1e-3  # they moved


def _grads_and_stats(name: str, v, remat):
    model = port_zoo_model(name, v, remat=remat).train()
    x = nchw(images((2, 64, 64, 3), seed=16).astype(np.float32) / 255.0)
    probes = _probes(27, 2, (8, 4, 2))
    raw = model(x, training=True)
    sum((r * torch.from_numpy(p).float()).mean() for r, p in zip(raw, probes)).backward()
    grads = {k: p.grad.clone() for k, p in model.named_parameters()}
    stats = {k: b.clone() for k, b in model.state_dict().items() if "running" in k}
    return grads, stats


@pytest.mark.parametrize("name", ["yolov5_v5", "yolov5_mobilevit"])
@pytest.mark.parametrize("remat", [True, "save_convs"])
def test_remat_equals_no_remat(name, remat):
    """Each layer an activation checkpoint: gradients and BN running
    statistics (moved once, not again by the recomputation) equal the
    plain step's to 1e-6, as JAX's remat does (tests/test_models.py)."""
    _, v = jax_zoo_variables(name, seed=15)
    g0, s0 = _grads_and_stats(name, v, False)
    g1, s1 = _grads_and_stats(name, v, remat)
    assert set(g0) == set(g1) and set(s0) == set(s1)
    for k in g0:
        assert torch.allclose(g1[k], g0[k], rtol=0, atol=1e-6), k
    for k in s0:
        assert torch.allclose(s1[k], s0[k], rtol=0, atol=1e-6), k
    start = port_zoo_model(name, v).state_dict()
    assert all(not torch.equal(s0[k], start[k]) for k in s0)  # every statistic moved


def test_remat_recomputation_would_move_the_statistics_twice(monkeypatch):
    """The guard is what keeps them equal: without it the recomputation in
    the backward pass moves the running statistics a second time."""
    import contextlib

    from ayolov2_torch.models import builder

    _, v = jax_zoo_variables("yolov5_mobilevit", seed=15)
    _, s0 = _grads_and_stats("yolov5_mobilevit", v, False)
    monkeypatch.setattr(builder, "_frozen_batch_stats", lambda mod: contextlib.nullcontext())
    _, s1 = _grads_and_stats("yolov5_mobilevit", v, True)
    assert max((s1[k] - s0[k]).abs().max().item() for k in s0) > 1e-4


def test_remat_rejects_unknown_modes():
    from ayolov2_torch.models import build_model, yolov5_cfg

    with pytest.raises(ValueError, match="remat"):
        build_model(yolov5_cfg("n"), device="meta", remat="everything")


def test_fuse_params_of_mobilevit_equals_jax():
    """BN folded into the depthwise and grouped convs; LayerNorm, attention
    and Linear left as they are; the fused model's forward unchanged."""
    from ayolov2_tpu.models import fuse_params as jax_fuse
    from ayolov2_torch.models.builder import fuse_params
    from ayolov2_torch.utils.weights import state_dict_from_flax

    _, v = jax_zoo_variables("yolov5_mobilevit", seed=19)
    want = state_dict_from_flax({"params": to_numpy_tree(jax_fuse(v)["params"])})
    got = fuse_params(state_dict_from_flax(v))
    assert set(got) == set(want)
    assert any(".depthwise.conv.bias" in k for k in got) and any(".ln1." in k for k in got)
    for k in got:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=1e-5, atol=1e-5)
    model = port_zoo_model("yolov5_mobilevit", v)
    x = nchw(images((1, 64, 64, 3), seed=20).astype(np.float32) / 255.0)
    with torch.no_grad():
        a, b = model(x, training=True), model.fuse()(x, training=True)
    for p, q in zip(a, b):
        assert rel_to_peak(as_np(q), as_np(p)) < 1e-4


def test_train_cli_takes_remat(tmp_path):
    """``train.remat`` in a train config reaches the model ``cli.train``
    trains (refused before the zoo slice)."""
    from _torch_port_common import train_files
    from ayolov2_torch.cli import train

    model_cfg, data, cfg = train_files(tmp_path)
    cfg.write_text(cfg.read_text().replace("train:\n", "train:\n  remat: save_convs\n", 1))
    trainer = train.main(["--model", str(model_cfg), "--data", str(data), "--cfg", str(cfg),
                          "--log-dir", str(tmp_path / "runs"), "--device", "cpu"])
    assert trainer.state.model.remat == "save_convs"
    assert (trainer.wdir / "last.ckpt").exists()
