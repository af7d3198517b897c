"""Helpers of the port's parallel tests: ranks of ``_torch_parallel_worker.py``
started over gloo on the CPU, each under a time limit, and JAX's train
step over a mesh of the suite's virtual CPU devices on the same inputs.

JAX is imported inside the helpers that run it."""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

from ayolov2_torch.parallel.launch import free_port

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
WORKER = HERE / "_torch_parallel_worker.py"

HYP = {"optimizer_params": {"lr": 0.01, "momentum": 0.937, "nesterov": True}, "lrf": 0.1,
       "weight_decay": 0.0005, "warmup_epochs": 0.0, "warmup_momentum": 0.8,
       "warmup_bias_lr": 0.1, "warmup_min_iters": 2, "box": 0.05, "cls": 0.5, "obj": 1.0,
       "anchor_t": 4.0}
IMG, GLOBAL_BS, STEPS = 64, 4, 2
OPT = dict(steps_per_epoch=8, batch_size=32, accumulate=1)


def run_ranks(case: str, world: int, out: Path, timeout: float = 180, env=None) -> list:
    """Run ``case`` on ``world`` ranks; every rank must exit 0 within
    ``timeout`` seconds. Returns each rank's stdout."""
    port = str(free_port())
    env = dict(os.environ, AYOLO_TEST_CASE_TIMEOUT_S=str(timeout - 10), **(env or {}))
    for key in ("AYOLO_NUM_PROCS", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        env.pop(key, None)
    procs = [subprocess.Popen([sys.executable, str(WORKER), case, str(r), str(world), port,
                               str(out)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True, cwd=str(ROOT), env=env) for r in range(world)]
    outs = []
    try:
        for p in procs:
            text, _ = p.communicate(timeout=timeout)
            outs.append(text)
            assert p.returncode == 0, f"rank {len(outs) - 1} of {case}:\n{text[-4000:]}"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return outs


def tiny_cfg() -> dict:
    """The JAX tests' ``TINY_CFG`` (``tests/test_train_step.py``)."""
    from tests.test_train_step import TINY_CFG

    return json.loads(json.dumps(TINY_CFG))


def flat(tree, prefix="") -> dict:
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v, np.float32)
    return out


def global_batches(seed: int = 5, steps: int = STEPS, bs: int = GLOBAL_BS, nc: int = 6) -> list:
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(steps):
        images = rng.integers(0, 256, (bs, IMG, IMG, 3), dtype=np.uint8)
        targets = np.zeros((bs * 4, 6), np.float32)
        mask = np.zeros(bs * 4, bool)
        for k in range(2 * bs):
            targets[k] = [k % bs, rng.integers(0, nc), *rng.uniform(0.2, 0.8, 2),
                          *rng.uniform(0.05, 0.5, 2)]
            mask[k] = True
        out.append((images, targets, mask))
    return out


def write_case(out: Path, variables: dict, batches: list, **case) -> None:
    out.mkdir(parents=True, exist_ok=True)
    case = dict(model_cfg=tiny_cfg(), hyp=HYP, steps=len(batches), **OPT, **case)
    (out / "case.json").write_text(json.dumps(case))
    np.savez(out / "vars.npz", **flat(variables))
    np.savez(out / "batches.npz", **{f"{k}{i}": a for i, b in enumerate(batches)
                                     for k, a in zip(("images", "targets", "mask"), b)})


def jax_setup():
    """JAX's tiny model, its initial variables (numpy) and optimizer."""
    import jax
    import jax.numpy as jnp

    from ayolov2_tpu.loss.yolo_loss import ComputeLoss
    from ayolov2_tpu.models import build_model
    from ayolov2_tpu.train.optimizer import build_optimizer

    model = build_model(tiny_cfg(), dtype=jnp.float32)
    v = model.init(jax.random.PRNGKey(0), jnp.zeros((1, IMG, IMG, 3)), training=True)
    variables = {"params": jax.tree_util.tree_map(np.asarray, v["params"]),
                 "batch_stats": jax.tree_util.tree_map(np.asarray, v["batch_stats"])}
    loss = ComputeLoss.from_hyp(np.asarray(model.head.stride_anchors()), model.nc, HYP)
    tx = build_optimizer(variables["params"], HYP, epochs=3, **OPT)
    return model, variables, loss, tx


def jax_steps(setup, batches, shape=(1,), mode="dp", min_elems=65536):
    """JAX's step over the first prod(shape) devices as a ``("data",)`` or
    ``("data", "model")`` mesh: (items per step, final state as numpy)."""
    import jax
    import jax.numpy as jnp

    from ayolov2_tpu.parallel import (batch_sharding, get_mesh, replicate, tp_sharding,
                                      zero_sharding)
    from ayolov2_tpu.train.train_state import create_train_state, make_train_step

    model, variables, loss, tx = setup
    devices = jax.devices()[:int(np.prod(shape))]
    names = ("data", "model")[:len(shape)]
    mesh = get_mesh(devices, axis_names=names, shape=tuple(shape))
    state = create_train_state(variables, tx)
    if mode == "tp":
        sharding = tp_sharding(mesh, state)
    elif mode == "fsdp":
        sharding = zero_sharding(mesh, state, min_elems=min_elems)
    else:
        sharding = replicate(mesh)
    state = jax.device_put(state, sharding)
    rep = replicate(mesh)
    step = jax.jit(make_train_step(model, loss, tx, image_dtype=jnp.float32,
                                   tp=mesh if mode == "tp" else None),
                   in_shardings=(sharding, batch_sharding(mesh, 4), rep, rep),
                   out_shardings=(sharding, rep))
    items = []
    for images, targets, mask in batches:
        state, it = step(state, images, targets, mask)
        items.append(np.asarray(it))
    return np.stack(items), jax.device_get(state)


def tree_rel(got: dict, want: dict) -> float:
    """max |got - want| over the leaves, relative to the largest |want|."""
    assert set(got) == set(want), sorted(set(got) ^ set(want))[:5]
    return max(float(np.abs(got[k] - want[k]).max()) for k in want) / max(
        float(np.abs(want[k]).max()) for k in want)


def delta_rel(got: dict, want: dict, start: dict) -> float:
    return tree_rel({k: got[k] - start[k] for k in want}, {k: want[k] - start[k] for k in want})


def rel(got, want) -> float:
    g, w = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(g - w).max() / max(np.abs(w).max(), 1e-6))
