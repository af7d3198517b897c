"""Shared fixtures of the port's parity tests: the same numpy weights and
inputs go through the JAX package and through ayolov2_torch."""

from __future__ import annotations

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
GOLDEN = ROOT / "runs/golden_r4_mem/train/2026_0818_runs"
CFG = {v: str(ROOT / f"res/configs/model/yolov5{v}.yaml") for v in "nsmlx"}


def to_numpy_tree(tree):
    """A (possibly frozen) flax tree as nested dicts of f32 numpy arrays."""
    if hasattr(tree, "items"):
        return {k: to_numpy_tree(v) for k, v in tree.items()}
    return np.asarray(tree, dtype=np.float32)


def random_variables(shapes, seed: int):
    """Numpy weights for a tree of shapes: He-scaled kernels, biases
    ~ N(0, 0.1), BN gamma in [0.8, 1.2] and statistics drawn so that folding
    matters (var in [0.5, 1.5], mean ~ N(0, 0.1))."""
    rng = np.random.default_rng(seed)

    def walk(tree, stats):
        out = {}
        for k in sorted(tree):
            v = tree[k]
            if hasattr(v, "items"):
                out[k] = walk(v, stats)
                continue
            shape = tuple(v.shape)
            if stats:
                draw = rng.normal(0, 0.1, shape) if k == "mean" else rng.uniform(0.5, 1.5, shape)
            elif k == "kernel":
                draw = rng.normal(0, np.sqrt(2.0 / np.prod(shape[:-1])), shape)
            elif k == "scale":
                draw = rng.uniform(0.8, 1.2, shape)
            else:
                draw = rng.normal(0, 0.1, shape)
            out[k] = draw.astype(np.float32)
        return out

    return {"params": walk(shapes["params"], False),
            "batch_stats": walk(shapes.get("batch_stats", {}), True)}


def jax_init(variant: str, seed: int = 0, img: int = 64, nc=None):
    """(JAX model, unfused numpy variables from ``seed``)."""
    from ayolov2_tpu.models import build_model

    model = build_model(CFG[variant], dtype=jnp.float32, nc=nc)
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, img, img, 3), jnp.float32), training=False))
    return model, random_variables(shapes, seed)


def jax_apply(model, variables, x, **kw):
    """model.apply under jit (far quicker on the CPU than op by op)."""
    fn = jax.jit(lambda v, x: model.apply(v, x, **kw))
    return fn(variables, jnp.asarray(x))


def golden_variables():
    """The committed trained yolov5s checkpoint (nc=20), EMA weights."""
    from ayolov2_tpu.utils.checkpoint import load_checkpoint

    ck = load_checkpoint(GOLDEN / "weights/best.ckpt")
    ema = ck["ema"]
    return {"params": to_numpy_tree(ema["params"]),
            "batch_stats": to_numpy_tree(ema["batch_stats"])}


def jax_model(variant_or_path: str, fused: bool = False, nc=None, dtype=jnp.float32):
    from ayolov2_tpu.models import build_model
    from ayolov2_tpu.models.builder import parse_model_config

    cfg = CFG.get(variant_or_path, variant_or_path)
    return build_model(parse_model_config(cfg), dtype=dtype, fused=fused, nc=nc)


def port_model(variant: str, variables, nc=None):
    """The port's unfused model on the CPU with the JAX variables loaded."""
    from ayolov2_torch.models import build_model, yolov5_cfg
    from ayolov2_torch.utils.weights import load_flax_variables

    model = build_model(yolov5_cfg(variant, nc=nc or 80), device="cpu")
    return load_flax_variables(model, variables)


def images(shape, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


def nchw(x: np.ndarray) -> torch.Tensor:
    """NHWC numpy -> NCHW torch view (channels_last)."""
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def rel_to_peak(got, want) -> float:
    g = np.asarray(got, np.float32)
    w = np.asarray(want, np.float32)
    assert g.shape == w.shape, (g.shape, w.shape)
    return float(np.abs(g - w).max() / max(np.abs(w).max(), 1e-3))


def p999_to_peak(got, want) -> float:
    g = np.asarray(got, np.float32)
    w = np.asarray(want, np.float32)
    return float(np.quantile(np.abs(g - w), 0.999) / max(np.abs(w).max(), 1e-3))


def as_np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().float().cpu().numpy()
    return np.asarray(t, np.float32)
