"""Shared fixtures of the port's parity tests: the same numpy weights and
inputs go through the JAX package and through ayolov2_torch.

JAX is imported inside the helpers that run it, so that a fresh interpreter
can import the file helpers without it (the tests that fork)."""

from __future__ import annotations

import functools
from pathlib import Path

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
    import jax
    import jax.numpy as jnp

    from ayolov2_tpu.models import build_model

    model = build_model(CFG[variant], dtype=jnp.float32, nc=nc)
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, img, img, 3), jnp.float32), training=False))
    return model, random_variables(shapes, seed)


def jax_apply(model, variables, x, **kw):
    """model.apply under jit (far quicker on the CPU than op by op)."""
    import jax
    import jax.numpy as jnp

    fn = jax.jit(lambda v, x: model.apply(v, x, **kw))
    return fn(variables, jnp.asarray(x))


def golden_variables():
    """The committed trained yolov5s checkpoint (nc=20), EMA weights."""
    from ayolov2_tpu.utils.checkpoint import load_checkpoint

    ck = load_checkpoint(GOLDEN / "weights/best.ckpt")
    ema = ck["ema"]
    return {"params": to_numpy_tree(ema["params"]),
            "batch_stats": to_numpy_tree(ema["batch_stats"])}


def jax_model(variant_or_path: str, fused: bool = False, nc=None, dtype=None):
    """The JAX model of a variant or config path, f32 unless ``dtype``."""
    import jax.numpy as jnp

    from ayolov2_tpu.models import build_model
    from ayolov2_tpu.models.builder import parse_model_config

    cfg = CFG.get(variant_or_path, variant_or_path)
    return build_model(parse_model_config(cfg), dtype=dtype or jnp.float32, fused=fused, nc=nc)


def port_model(variant: str, variables, nc=None):
    """The port's unfused model on the CPU with the JAX variables loaded."""
    from ayolov2_torch.models import build_model, yolov5_cfg
    from ayolov2_torch.utils.weights import load_flax_variables

    model = build_model(yolov5_cfg(variant, nc=nc or 80), device="cpu")
    return load_flax_variables(model, variables)


def zoo_cfg(name: str) -> str:
    """The path of a shipped model config (``res/configs/model/{name}.yaml``)."""
    return str(ROOT / f"res/configs/model/{name}.yaml")


@functools.lru_cache(maxsize=None)
def jax_zoo_shapes(name: str):
    """(JAX f32 model of a shipped config, its variables' shapes at 64x64),
    traced once per config and process."""
    import jax
    import jax.numpy as jnp

    from ayolov2_tpu.models import build_model

    model = build_model(zoo_cfg(name), dtype=jnp.float32)
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3), jnp.float32), training=False))
    return model, shapes


def jax_zoo_variables(name: str, seed: int):
    """(JAX f32 model of a shipped config, numpy variables drawn from ``seed``)."""
    model, shapes = jax_zoo_shapes(name)
    return model, random_variables(shapes, seed)


def port_zoo_model(name: str, variables, **kw):
    """The port's unfused model of a shipped config on the CPU, with the JAX
    variables loaded (``kw``: ``build_model``'s options)."""
    from ayolov2_torch.models import build_model
    from ayolov2_torch.utils.weights import load_flax_variables

    return load_flax_variables(build_model(zoo_cfg(name), device="cpu", **kw), variables)


# run in a fresh interpreter: read each artifact, call it, save the outputs
_RELOAD = """
import sys, numpy as np
sys.path.insert(0, {root!r})
from ayolov2_torch.export import load_exported
out = {{}}
for name, (path, x) in {jobs!r}.items():
    res = load_exported(path)(np.load(x))
    res = res if isinstance(res, tuple) else (res,)
    for i, r in enumerate(res):
        out[f"{{name}}_{{i}}"] = r.numpy()
np.savez({dst!r}, **out)
bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'ayolov2_tpu')]
print('modules', bad)
"""


def call_artifacts_fresh(jobs: dict, dst) -> dict:
    """Call each ``.pt2`` of ``jobs`` ({name: (artifact, input .npy)}) in a
    fresh interpreter that must not import JAX; returns {f"{name}_{i}":
    output i}."""
    import subprocess
    import sys

    code = _RELOAD.format(root=str(ROOT), jobs=jobs, dst=str(dst))
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "modules []" in r.stdout, r.stdout
    return dict(np.load(dst))


# run in a fresh interpreter: JAX's early_pipeline in the Mosaic TPU interpreter
_INTERPRET = """
import faulthandler, pickle, sys
faulthandler.dump_traceback_later({limit}, exit=True)
sys.path.insert(0, {root!r})
import numpy as np
import jax
import jax.numpy as jnp
from ayolov2_tpu.ops.early_pipeline import early_pipeline, extract_early_params
with open({src!r}, "rb") as f:
    jobs = pickle.load(f)
out = {{}}
for name, (tree, imgs, strip_h) in jobs.items():
    ep = extract_early_params(jax.tree_util.tree_map(jnp.asarray, tree))
    y = early_pipeline(jnp.asarray(imgs), ep, strip_h=strip_h, interpret=True)
    out[name] = np.asarray(y.astype(jnp.float32))
np.savez({dst!r}, **out)
"""
INTERPRET_LIMIT_S = 300


def jax_interpreted(jobs: dict, tmp) -> dict:
    """JAX's Pallas kernel ``early_pipeline(..., interpret=True)`` for each
    of ``jobs`` ({name: (fused numpy tree, uint8 images, strip_h)}), in a
    fresh interpreter with its own time limit: the Mosaic TPU interpreter
    runs the kernel through host callbacks and was seen to stall a test
    worker for good, so a stall here fails with every thread's stack
    (faulthandler) instead. Returns {name: f32 output}."""
    import pickle
    import subprocess
    import sys

    src, dst = Path(tmp) / "interpret_jobs.pkl", Path(tmp) / "interpreted.npz"
    src.write_bytes(pickle.dumps(jobs))
    code = _INTERPRET.format(limit=INTERPRET_LIMIT_S - 20, root=str(ROOT), src=str(src),
                             dst=str(dst))
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                       timeout=INTERPRET_LIMIT_S)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-6000:]
    return dict(np.load(dst))


def seeded_head_variables(name: str, seed: int):
    """Drawn weights whose head gives logits of a few units (no score ties
    at a saturated sigmoid, so the detections' order is defined)."""
    _, v = jax_zoo_variables(name, seed=seed)
    head = max((k for k in v["params"] if k.startswith("model_")), key=lambda k: int(k[6:]))
    for conv in v["params"][head].values():
        conv["kernel"] = conv["kernel"] * 0.1
    return v


def tree_leaves(tree, prefix=()) -> dict:
    """{path tuple: numpy array} of a nested dict."""
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out.update(tree_leaves(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


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


def synthetic_image(rng: np.random.Generator, h: int, w: int) -> np.ndarray:
    """A smooth colour gradient with a few filled rectangles and ellipses,
    BGR uint8: content with edges a detector responds to."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = rng.uniform(40, 200, 3)
    slope = rng.uniform(-0.3, 0.3, (2, 3)) * 160 / max(h, w)
    img = base + yy[..., None] * slope[0] + xx[..., None] * slope[1]
    for _ in range(int(rng.integers(2, 6))):
        color = rng.uniform(0, 255, 3)
        cy, cx = rng.uniform(0.1, 0.9) * h, rng.uniform(0.1, 0.9) * w
        ry, rx = rng.uniform(0.05, 0.3) * h, rng.uniform(0.05, 0.3) * w
        if rng.random() < 0.5:
            inside = (np.abs(yy - cy) < ry) & (np.abs(xx - cx) < rx)
        else:
            inside = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 < 1
        img[inside] = color
    return np.clip(img, 0, 255).astype(np.uint8)


def write_image_set(root: Path, sizes, seed: int) -> list:
    """``images/`` under ``root`` with one BMP per (h, w) in ``sizes``
    (cv2.imwrite, numeric stems), drawn from ``seed``; returns the paths."""
    import cv2

    img_dir = root / "images"
    img_dir.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    paths = []
    for i, (h, w) in enumerate(sizes):
        path = img_dir / f"{i + 1:06d}.bmp"
        assert cv2.imwrite(str(path), synthetic_image(rng, h, w))
        paths.append(path)
    return paths


def self_label(validator, dataset, loader, per_image: int) -> int:
    """Write YOLO label files from the validator's own detections: for each
    image its top ``per_image`` detections that score above every detection
    left unlabelled anywhere (so no unlabelled one outranks a label), in
    native normalised xywh. Returns the number of labels written."""
    from ayolov2_torch.utils.boxes import scale_coords

    found = []
    for imgs, metas, indices, n_real in loader:
        det, n = validator.detect(imgs)
        det, n = det.cpu().numpy(), n.cpu().numpy()
        for j in range(n_real):
            (h0, w0), ratio_pad = metas[j]
            d = det[j, : int(n[j])].astype(np.float64)
            d[:, :4] = scale_coords(imgs.shape[1:3], d[:, :4], (h0, w0), ratio_pad)
            found.append((Path(dataset.img_files[indices[j]]), (h0, w0), d))
    cut = max([d[per_image, 4] for _, _, d in found if len(d) > per_image] + [0.0])
    written = 0
    for path, (h0, w0), d in found:
        keep = d[(d[:, 4] > cut)][:per_image]
        rows = [f"{int(c)} {(x1 + x2) / 2 / w0:.6f} {(y1 + y2) / 2 / h0:.6f} "
                f"{(x2 - x1) / w0:.6f} {(y2 - y1) / h0:.6f}"
                for x1, y1, x2, y2, _, c in keep]
        label = path.parent.parent / "labels" / (path.stem + ".txt")
        label.parent.mkdir(exist_ok=True)
        label.write_text("\n".join(rows) + "\n" if rows else "")
        written += len(rows)
    return written


# (h, w) of the shared labelled set at img_size 160: four aspect ratios, one
# image shrunk (INTER_AREA) and two enlarged (INTER_LINEAR) by load_image,
# widths whose BMP rows are padded
LABELLED_SIZES = [(160, 160), (120, 160), (160, 120), (96, 160), (200, 150), (76, 100),
                  (160, 96), (130, 157), (160, 160)]
LABELLED_IMG = 160


def labelled_set(root: Path, seed: int = 0) -> Path:
    """The shared synthetic val set under ``root``: ``images/`` (BMPs from
    :func:`write_image_set`) and ``labels/`` self-labelled by the port's f32
    plain path on the golden checkpoint (at most 10 a image, rect batches of
    4 as the tests validate them). The labels of the image with the most are
    rewritten as segment polygons (8 points around each box), and the image
    with the fewest has no label file. Returns the images dir."""
    from ayolov2_torch.data import DataLoader, ImageFolderDataset
    from ayolov2_torch.eval import YoloValidator
    from ayolov2_torch.utils.checkpoint import load_model

    write_image_set(root, LABELLED_SIZES, seed)
    model = load_model(GOLDEN / "weights/best.ckpt", nc=20, device="cpu")
    validator = YoloValidator(model, None, cfg={"half": False, "fused": False,
                                                "early_pipeline": False}, device="cpu")
    ds = ImageFolderDataset(str(root / "images"), img_size=LABELLED_IMG, batch_size=4,
                            rect=True, pad=0.5, stride=32)
    assert self_label(validator, ds, DataLoader(ds, batch_size=4, detection=False), 10) > 10
    labels = sorted((root / "labels").glob("*.txt"), key=lambda f: len(f.read_text().split()))
    labels[0].unlink()
    first = labels[-1]
    rows = []
    for line in first.read_text().split("\n"):
        if line:
            c, x, y, w, h = line.split()
            x, y, w, h = (float(v) for v in (x, y, w, h))
            pts = [(x - w / 2, y - h / 2), (x, y - h / 2), (x + w / 2, y - h / 2), (x + w / 2, y),
                   (x + w / 2, y + h / 2), (x, y + h / 2), (x - w / 2, y + h / 2), (x - w / 2, y)]
            rows.append(c + " " + " ".join(f"{v:.6f}" for p in pts for v in p))
    assert rows
    first.write_text("\n".join(rows) + "\n")
    return root / "images"


def train_files(tmp_path, epochs: int = 1, device_aug: bool = False):
    """A labelled BMP set, a data YAML, a small model config and a train
    cfg YAML (the memorisation recipe at 64 px, f32; with ``device_aug``
    the reference recipe's mosaic, HSV, translate, scale and a horizontal
    flip, rendered by the device renderer)."""
    import json

    from ayolov2_torch.models import yolov5_cfg

    write_image_set(tmp_path, [(64, 64), (48, 64), (64, 48), (64, 64)] * 2, seed=9)
    (tmp_path / "labels").mkdir()
    rng = np.random.default_rng(9)
    for i in range(8):
        (tmp_path / "labels" / f"{i + 1:06d}.txt").write_text(
            f"{i % 3} {rng.uniform(0.3, 0.7):.4f} {rng.uniform(0.3, 0.7):.4f} 0.3 0.4\n")
    data = tmp_path / "data.yaml"
    data.write_text(f"train_path: {tmp_path / 'images'}\nval_path: {tmp_path / 'images'}\n"
                    "nc: 3\nnames: [a, b, c]  # three classes\n")
    cfg = yolov5_cfg("n", nc=3)  # the narrowest width the early-network kernel takes
    model = tmp_path / "model.yaml"
    model.write_text(json.dumps(cfg))
    text = (ROOT / "res/configs/cfg/train_golden_memorize.yaml").read_text()
    for a, b in (("epochs: 1500", f"epochs: {epochs}"), ("batch_size: 16", "batch_size: 4"),
                 ("image_size: 320", "image_size: 64"), ("validate_period: 100",
                                                         "validate_period: 1"),
                 ("  plot: false", "  plot: false\n  half: false")):
        assert a in text
        text = text.replace(a, b)
    if device_aug:
        for a, b in (("  augment: false", "  augment: true"), ("  mosaic: 0.0", "  mosaic: 1.0"),
                     ("  translate: 0.0", "  translate: 0.1"), ("  scale: 0.0", "  scale: 0.5"),
                     ("augmentation: []", "augmentation:\n  - policy:\n      HorizontalFlip: "
                                          "{p: 0.5}\n    prob: 1.0"),
                     ("  plot: false", "  plot: false\n  device_aug: true")):
            assert a in text
            text = text.replace(a, b, 1)
    train_cfg = tmp_path / "cfg.yaml"
    train_cfg.write_text(text)
    return model, data, train_cfg
