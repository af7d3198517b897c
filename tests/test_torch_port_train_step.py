"""The train step, the BatchNorm update and the checkpoints: the port
against the JAX package on the same weights (JAX's ``init_model``, bridged)
and batches, f32, yolov5s's graph at width 0.125, 64 px, bs 2."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_common import to_numpy_tree

torch.set_num_threads(1)

HYP = {"optimizer_params": {"lr": 0.01, "momentum": 0.937, "nesterov": True}, "lrf": 0.1,
       "weight_decay": 0.0005, "warmup_epochs": 0.0, "warmup_momentum": 0.8,
       "warmup_bias_lr": 0.1, "warmup_min_iters": 2, "box": 0.05, "cls": 0.5, "obj": 1.0,
       "anchor_t": 4.0}
NC, BS, IMG, STEPS = 4, 2, 64, 4


def tiny_cfg():
    from ayolov2_torch.models import yolov5_cfg

    cfg = yolov5_cfg("s", nc=NC)
    cfg["width_multiple"] = 0.125
    return cfg


def batches():
    """STEPS micro-batches: uint8 images, label rows with padding."""
    rng = np.random.default_rng(5)
    out = []
    for _ in range(STEPS):
        images = rng.integers(0, 256, (BS, IMG, IMG, 3), dtype=np.uint8)
        targets = np.zeros((BS * 4, 6), np.float32)
        mask = np.zeros(BS * 4, bool)
        for k in range(5):
            targets[k] = [k % BS, rng.integers(0, NC), *rng.uniform(0.2, 0.8, 2),
                          *rng.uniform(0.05, 0.5, 2)]
            mask[k] = True
        out.append((images, targets, mask))
    return out


def port_state(variables):
    from ayolov2_torch.loss.yolo_loss import ComputeLoss
    from ayolov2_torch.models import build_model
    from ayolov2_torch.train.optimizer import build_optimizer
    from ayolov2_torch.train.train_state import create_train_state, make_train_step
    from ayolov2_torch.utils.weights import load_flax_variables

    model = load_flax_variables(build_model(tiny_cfg(), device="cpu"), variables)
    loss = ComputeLoss.from_hyp(model.head.stride_anchors(), NC, HYP)
    opt = build_optimizer(model, HYP, epochs=3, steps_per_epoch=8, batch_size=32, accumulate=2)
    return create_train_state(model, opt), make_train_step(loss, image_dtype=torch.float32)


def run_port(state, step, data):
    return [step(state, torch.from_numpy(i), torch.from_numpy(t), torch.from_numpy(m)).numpy()
            for i, t, m in data]


@pytest.fixture(scope="module")
def jax_run():
    """JAX's init_model variables, and per micro-step (loss items, state)."""
    from ayolov2_tpu.loss.yolo_loss import ComputeLoss
    from ayolov2_tpu.models import build_model, init_model
    from ayolov2_tpu.models.yolo_head import YOLOHead
    from ayolov2_tpu.train.optimizer import build_optimizer
    from ayolov2_tpu.train.train_state import create_train_state, make_train_step

    model = build_model(tiny_cfg(), dtype=jnp.float32)
    variables = init_model(model, jax.random.PRNGKey(0), img_size=IMG)
    variables = {"params": to_numpy_tree(variables["params"]),
                 "batch_stats": to_numpy_tree(variables["batch_stats"])}
    head = YOLOHead(nc=model.nc, anchors=model.anchors, strides=model.strides)
    loss = ComputeLoss.from_hyp(head.stride_anchors(), NC, HYP)
    tx = build_optimizer(variables["params"], HYP, epochs=3, steps_per_epoch=8, batch_size=32,
                         accumulate=2)
    step = jax.jit(make_train_step(model, loss, tx, image_dtype=jnp.float32))
    state = create_train_state(variables, tx)
    items, states = [], []
    for images, targets, mask in batches():
        state, it = step(state, images, targets, mask)
        items.append(np.asarray(it))
        states.append(state)
    return variables, items, states


def rel(got, want) -> float:
    g, w = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(g - w).max() / max(np.abs(w).max(), 1e-6))


def tree_rel(got, want) -> float:
    """max |got - want| over a tree, relative to the tree's largest |want|.
    (Per leaf, a BN bias that starts at 0 carries the f32 noise of its
    gradient, a sum over every pixel: 4e-4 relative between f32 and f64
    after one step at this size.)"""
    g = jax.tree_util.tree_leaves(got)
    w = jax.tree_util.tree_leaves(want)
    assert len(g) == len(w)
    return max(float(np.abs(a - b).max()) for a, b in zip(g, w)) / max(
        float(np.abs(b).max()) for b in w)


def delta_rel(got, want, start) -> float:
    """The step's change against JAX's change: max |d_got - d_want| /
    max |d_want| over the tree."""
    sub = lambda a, b: jax.tree_util.tree_map(lambda x, y: np.asarray(x) - np.asarray(y), a, b)  # noqa: E731
    return tree_rel(sub(got, start), sub(want, start))


def test_train_step_matches_jax(jax_run):
    """Four micro-steps at accumulate 2 (two updates): loss items at every
    step, then params, BN running statistics and their EMAs within 1e-4."""
    from ayolov2_torch.utils.weights import flax_from_state_dict

    variables, items_j, states_j = jax_run
    state, step = port_state(variables)
    items = run_port(state, step, batches())
    for k, (a, b) in enumerate(zip(items, items_j)):
        assert rel(a, b) < 1e-4, (k, a, b)
    assert state.step == STEPS and state.ema_updates == STEPS and state.optimizer.updates == 2
    final = states_j[-1]
    got = flax_from_state_dict(state.model.state_dict())
    ema = flax_from_state_dict(state.ema_model.state_dict())
    assert tree_rel(got["params"], to_numpy_tree(final.params)) < 1e-4
    assert tree_rel(got["batch_stats"], to_numpy_tree(final.batch_stats)) < 1e-4
    assert tree_rel(ema["params"], to_numpy_tree(final.ema_params)) < 1e-4
    assert tree_rel(ema["batch_stats"], to_numpy_tree(final.ema_batch_stats)) < 1e-4
    # the changes themselves agree, and the run moved weights and statistics
    assert delta_rel(got["params"], to_numpy_tree(final.params), variables["params"]) < 1e-2
    assert delta_rel(ema["params"], to_numpy_tree(final.ema_params), variables["params"]) < 1e-2
    assert tree_rel(got["params"], variables["params"]) > 1e-3
    assert tree_rel(got["batch_stats"], variables["batch_stats"]) > 1e-2


def test_batchnorm_update_is_flax(jax_run):
    """One forward in train mode: the running variance moves with the
    biased batch variance (n = 8 at the 2x2 map of bs 2), as in flax."""
    from ayolov2_torch.utils.weights import flax_from_state_dict

    variables, _, states_j = jax_run
    state, step = port_state(variables)
    run_port(state, step, batches()[:1])
    got = flax_from_state_dict(state.model.state_dict())["batch_stats"]
    want = to_numpy_tree(states_j[0].batch_stats)
    deepest = got["model_23"]["cv3"]["bn"]["var"]  # the 2x2 map
    assert rel(deepest, want["model_23"]["cv3"]["bn"]["var"]) < 1e-5
    assert tree_rel(got, want) < 1e-4


def test_port_checkpoint_reads_in_jax(jax_run, tmp_path):
    """save_checkpoint's file, read by JAX's load_variables leaf for leaf:
    f32 exactly, bf16 as the port's weights rounded to bf16."""
    from ayolov2_tpu.utils.checkpoint import load_variables as jax_load

    from ayolov2_torch.utils.checkpoint import save_checkpoint
    from ayolov2_torch.utils.weights import flax_from_state_dict

    variables, _, _ = jax_run
    state, step = port_state(variables)
    run_port(state, step, batches()[:3])
    cfg = tiny_cfg()
    for half in (False, True):
        path = tmp_path / f"half{int(half)}.ckpt"
        save_checkpoint(path, state, epoch=4, best_score=0.25, map50=0.5, model_cfg=cfg,
                        half=half)
        for prefer_ema, model in ((True, state.ema_model), (False, state.model)):
            loaded, meta = jax_load(path, prefer_ema=prefer_ema)
            want = flax_from_state_dict(model.state_dict())
            if half:
                want["params"] = jax.tree_util.tree_map(
                    lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32),
                    want["params"])
            for key in ("params", "batch_stats"):
                flat_w = dict(jax.tree_util.tree_leaves_with_path(want[key]))
                flat_g = jax.tree_util.tree_leaves_with_path(loaded[key])
                assert len(flat_g) == len(flat_w)
                for path_, leaf in flat_g:
                    np.testing.assert_array_equal(np.asarray(leaf), flat_w[path_])
        assert meta["epoch"] == 4 and meta["step"] == 3 and meta["ema_updates"] == 3
        assert meta["map50"] == 0.5 and meta["best_score"] == 0.25
        import json

        assert json.loads(meta["model_cfg"]) == cfg


def test_restore_continues_identically(jax_run, tmp_path):
    """Save mid-accumulation (3 micro-steps), restore into a fresh state,
    run one more: equal to the run that never stopped."""
    from ayolov2_torch.utils.checkpoint import restore_train_state, save_checkpoint

    variables, _, _ = jax_run
    data = batches()
    straight, step = port_state(variables)
    run_port(straight, step, data)

    first, step1 = port_state(variables)
    run_port(first, step1, data[:3])
    save_checkpoint(tmp_path / "mid.ckpt", first, epoch=0, half=False)
    resumed, step2 = port_state(variables)
    _, meta = restore_train_state(tmp_path / "mid.ckpt", resumed)
    assert resumed.step == 3 and resumed.optimizer.mini_step == 1
    run_port(resumed, step2, data[3:])
    for a, b in ((resumed.model, straight.model), (resumed.ema_model, straight.ema_model)):
        sa, sb = a.state_dict(), b.state_dict()
        for k in sb:
            if k.endswith("num_batches_tracked"):
                continue
            torch.testing.assert_close(sa[k], sb[k], rtol=0, atol=1e-7)
    assert resumed.step == straight.step and resumed.ema_updates == straight.ema_updates


def test_eval_step_decodes_the_ema_model(jax_run):
    """make_eval_step: the EMA copy's decoded predictions in eval mode,
    equal to the JAX eval step on the same EMA weights (f32)."""
    from ayolov2_tpu.models import build_model
    from ayolov2_tpu.train.train_state import make_eval_step as jax_eval_step

    from ayolov2_torch.train.train_state import make_eval_step
    from ayolov2_torch.utils.weights import flax_from_state_dict

    variables, _, states_j = jax_run
    state, step = port_state(variables)
    data = batches()
    run_port(state, step, data)
    state.model.train()
    got = make_eval_step(image_dtype=torch.float32)(state, torch.from_numpy(data[0][0]))
    assert state.model.training and not state.ema_model.training
    ema = flax_from_state_dict(state.ema_model.state_dict())
    jstate = states_j[-1].replace(ema_params=ema["params"], ema_batch_stats=ema["batch_stats"])
    want = jax.jit(jax_eval_step(build_model(tiny_cfg(), dtype=jnp.float32),
                                 image_dtype=jnp.float32))(jstate, data[0][0])
    assert got.shape == want.shape == (BS, 3 * (8 * 8 + 4 * 4 + 2 * 2), 5 + NC)
    assert rel(got.numpy(), np.asarray(want)) < 1e-4
