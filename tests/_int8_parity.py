"""The int8 post-training quantization of the two packages on the CPU, on
one self-labelled image set: where do their int8 maps part, and why?

    JAX_PLATFORMS=cpu python tests/_int8_parity.py [--root build/int8_parity]

The set is chip_smoke's phase-7 set (128 synthetic BMPs at four native
sizes, seed 0), labelled by the port's f32 plain path on the golden
checkpoint as phase 7 labels it. On it, in this order:

1. both CLIs (``cli/val.py`` of the JAX package, ``python -m
   ayolov2_torch.cli.val --device cpu``) in bf16 and with ``--int8
   --calib-batches 4 --calib-method absmax``: mAP50 and mAP50-95 each;
2. the calibration batches each CLI reads (uint8, before the /255): equal?
3. the calibration range (``in_scale``) of every int8 conv, JAX against the
   port, each package calibrated in bf16 on its own batches;
4. the int8 models' outputs on the first batch, module by module (each
   package end to end), and each module replayed in the port, holding JAX's
   own int8 tree (the same kernels and scales), on JAX's own input to that
   module: a module that equals JAX's output bit for bit then adds no fault
   of its own; the difference it shows end to end comes from its input and
   its calibration range.

Prints one line per finding and writes them to ``<root>/int8_parity.json``.
Imports both packages (like the parity tests); the port's code never does.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
GOLDEN = ROOT / "runs/golden_r4_mem/train/2026_0818_runs/weights/best.ckpt"


def log(msg: str) -> None:
    print(msg, flush=True)


def write_set(root: Path, seed: int, bs: int, per_size: int) -> Path:
    """chip_smoke's phase-7 images and labels, made on the CPU."""
    import torch

    import chip_smoke as cs
    from ayolov2_torch.data import DataLoader, ImageFolderDataset
    from ayolov2_torch.eval import YoloValidator
    from ayolov2_torch.utils.checkpoint import load_model

    data = cs.write_val_set(root, seed, per_size=per_size)
    model = load_model(GOLDEN, nc=20, device="cpu")
    folder = ImageFolderDataset(str(root / "images"), img_size=640, batch_size=bs, rect=True,
                                pad=0.5)
    labeller = YoloValidator(model, None, cfg=dict(half=False, early_pipeline=False,
                                                   fused=False), device="cpu")
    with torch.no_grad():
        found = cs.native_detections(labeller, DataLoader(folder, batch_size=bs,
                                                          detection=False), folder)
    n, most = cs.write_labels(found, cs.label_cut(found))
    folder._cache_path().with_suffix(".labels").unlink(missing_ok=True)
    log(f"[set] {len(found)} images under {root}, {n} labels (at most {most} an image)")
    return data


def run_clis(root: Path, data: Path, bs: int, calib: int, method: str) -> dict:
    out = {}
    common = ["--weights", str(GOLDEN), "--data-cfg", str(data), "-iw", "640",
              "--batch-size", str(bs)]
    int8 = ["--int8", "--calib-batches", str(calib), "--calib-method", method]
    for pkg, cmd in (("jax", [sys.executable, str(ROOT / "cli/val.py")]),
                     ("port", [sys.executable, "-m", "ayolov2_torch.cli.val", "--device", "cpu"])):
        for mode, extra in (("bf16", []), ("int8", int8)):
            path = root / f"{pkg}_{mode}.json"
            t0 = time.perf_counter()
            proc = subprocess.run(cmd + common + extra + ["--json-path", str(path)], cwd=ROOT,
                                  capture_output=True, text=True, timeout=3600)
            if proc.returncode != 0:
                raise RuntimeError(f"{pkg} {mode}: exit {proc.returncode}\n{proc.stderr[-3000:]}")
            r = json.loads(path.read_text())
            out[f"{pkg} {mode}"] = {k: r.get(k) for k in ("seen", "n_labels", "map50",
                                                          "map50_95")}
            log(f"[cli] {pkg} {mode}: seen {r['seen']} labels {r.get('n_labels')} mAP50 "
                f"{r['map50']:.5f} mAP50-95 {r['map50_95']:.5f} "
                f"({time.perf_counter() - t0:.0f} s)")
    return out


def calibration_batches(data: Path, bs: int, calib: int):
    """The uint8 batches each CLI calibrates on, read as each CLI reads them."""
    from ayolov2_torch.data import DataLoader as PortLoader
    from ayolov2_torch.data import DetectionDataset as PortDataset
    from ayolov2_torch.utils.config import load_yaml
    from ayolov2_tpu.data import DataLoader, DetectionDataset

    path = load_yaml(str(data))["val_path"]
    jax_loader = DataLoader(DetectionDataset(path, img_size=640, batch_size=bs, rect=True, pad=0.5,
                                             stride=32), batch_size=bs, shuffle=False,
                            pad_final_batch=True)
    port_loader = PortLoader(PortDataset(path, img_size=640, batch_size=bs, rect=True, pad=0.5,
                                         stride=32), batch_size=bs)
    out = []
    for loader in (jax_loader, port_loader):
        got = []
        for batch in loader:
            got.append(np.asarray(batch.images))
            if len(got) >= calib:
                break
        out.append(got)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(ROOT / "build/int8_parity"))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--bs", type=int, default=32)
    ap.add_argument("--per-size", type=int, default=32, help="images of each of the 4 sizes")
    ap.add_argument("--calib-batches", type=int, default=4)
    ap.add_argument("--calib-method", default="absmax")
    ap.add_argument("--skip-clis", action="store_true")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    import torch

    from ayolov2_torch.compress.quantize import quantize_model as port_quantize
    from ayolov2_torch.models import build_model
    from ayolov2_torch.utils.checkpoint import load_model
    from ayolov2_torch.utils.weights import flax_from_state_dict, load_flax_variables
    from ayolov2_tpu.compress.quantize import quantize_model as jax_quantize
    from ayolov2_tpu.models import fuse_params
    from ayolov2_tpu.utils.checkpoint import load_variables

    torch.set_num_threads(8)
    root = Path(args.root)
    report: dict = {}
    data = root / "data.json"
    if not (root / "labels").is_dir() or not any((root / "labels").iterdir()):
        data = write_set(root, args.seed, args.bs, args.per_size)
    if not args.skip_clis:
        report["clis"] = run_clis(root, data, args.bs, args.calib_batches, args.calib_method)

    jax_b, port_b = calibration_batches(data, args.bs, args.calib_batches)
    same = [bool(np.array_equal(a, b)) for a, b in zip(jax_b, port_b)]
    report["calibration_batches_equal"] = same
    log(f"[calib] the {len(same)} calibration batches, uint8, JAX's loader vs the port's: "
        f"shapes {[a.shape for a in jax_b]} vs {[b.shape for b in port_b]}, equal {same}")

    variables, meta = load_variables(str(GOLDEN), prefer_ema=True, nc=20)
    cfg = json.loads(meta["model_cfg"])
    fused = jax.tree_util.tree_map(np.asarray, fuse_params(variables))
    jmodel, jvars = jax_quantize(cfg, fused, [jnp.asarray(b).astype(jnp.bfloat16) / 255.0
                                              for b in jax_b], dtype=jnp.bfloat16,
                                 nc=20, method=args.calib_method)
    jvars = jax.tree_util.tree_map(np.asarray, jvars)
    pmodel_f = load_model(GOLDEN, nc=20, device="cpu")
    pmodel, pvars = port_quantize(
        pmodel_f.cfg, flax_from_state_dict(pmodel_f.state_dict()),
        [torch.from_numpy(b).permute(0, 3, 1, 2).to(torch.bfloat16) / 255.0 for b in port_b],
        dtype=torch.bfloat16, nc=20, method=args.calib_method, device="cpu")

    # 3. the calibration range of every int8 conv
    def scales(tree, path=()):
        out = {}
        for k, v in tree.items():
            if hasattr(v, "items"):
                out.update(scales(v, path + (k,)))
            elif k == "in_scale":
                out["/".join(path)] = float(np.asarray(v, np.float32))
        return out

    js, ps = scales(jvars["params"]), scales(pvars["params"])
    rows = [(k, js[k], ps[k], abs(ps[k] - js[k]) / js[k]) for k in js]
    report["in_scale"] = {k: [a, b, d] for k, a, b, d in rows}
    worst = sorted(rows, key=lambda r: -r[3])[:5]
    first = next((r for r in rows if r[3] > 0), None)
    log(f"[scales] {len(rows)} int8 convs; in_scale equal in "
        f"{sum(r[3] == 0 for r in rows)}; the first that differs: "
        f"{first[0] if first else '-'}; largest relative differences: "
        + ", ".join(f"{k} {d:.2e}" for k, _, _, d in worst))

    # 4. the int8 models on the first batch, module by module
    x = jax_b[0]
    ones = jnp.asarray(x).astype(jnp.bfloat16) / 255.0
    jraw, inter = jax.jit(lambda v, x: jmodel.apply(
        v, x, training=True, capture_intermediates=lambda m, name: name == "__call__",
        mutable=["intermediates"]))(jvars, ones)
    jout = {k: np.asarray(v["__call__"][0].astype(jnp.float32))
            for k, v in inter["intermediates"].items()
            if k.startswith("model_") and hasattr(v["__call__"][0], "astype")}
    outs = {}
    hooks = [m.register_forward_hook(
        lambda mod, inp, out, i=i: outs.__setitem__(i, out)) for i, m in enumerate(pmodel.model)]
    with torch.no_grad():
        xp = torch.from_numpy(x).permute(0, 3, 1, 2).to(torch.bfloat16) / 255.0
        praw = pmodel(xp, training=True)
    for h in hooks:
        h.remove()

    def jax_input(spec):
        """JAX's own input to this spec's module (concats rebuilt exactly)."""
        def out_of(f):
            s = pmodel.specs[f]
            if s.module == "Concat":
                return np.concatenate([out_of(g if g >= 0 else f + g) for g in s.from_idx], -1)
            return jout[f"model_{f}"]
        if spec.index == 0:
            return np.asarray(ones.astype(jnp.float32))
        f = spec.from_idx[0]
        return out_of(spec.index - 1 if f == -1 else f if f >= 0 else spec.index + f)

    # the port's model holding JAX's int8 tree: the same kernels and scales
    same_q = load_flax_variables(build_model(cfg, nc=20, fused=True, quant=True,
                                             dtype=torch.bfloat16, device="cpu"), jvars)
    layers = []
    for spec in pmodel.specs:
        key = f"model_{spec.index}"
        if key not in jout or spec.module in ("YOLOHead", "Concat") or len(spec.from_idx) != 1:
            continue
        want = jout[key]
        got = outs[spec.index].float().permute(0, 2, 3, 1).numpy()
        peak = max(float(np.abs(want).max()), 1e-6)
        with torch.no_grad():
            inp = torch.from_numpy(jax_input(spec)).permute(0, 3, 1, 2).to(torch.bfloat16)
            replay = same_q.model[spec.index](inp).float().permute(0, 2, 3, 1).numpy()
        quant = any(type(m).__name__ == "QuantConv" for m in pmodel.model[spec.index].modules())
        row = dict(layer=spec.index, module=spec.module, int8=quant,
                   max_d_peak=float(np.abs(got - want).max() / peak),
                   frac_differ=float((got != want).mean()),
                   replay_equal=bool(np.array_equal(replay, want)),
                   replay_frac_differ=float((replay != want).mean()),
                   replay_max_d_peak=float(np.abs(replay - want).max() / peak))
        layers.append(row)
        log(f"[layers] {key:9s} {spec.module:10s} int8 {str(quant):5s} end to end: max|d|/peak "
            f"{row['max_d_peak']:.5f}, {row['frac_differ'] * 100:.2f}% of values differ; "
            f"JAX's int8 tree in the port on JAX's input: equal {row['replay_equal']} "
            f"({row['replay_frac_differ'] * 100:.3f}% differ, max|d|/peak "
            f"{row['replay_max_d_peak']:.2e})")
    report["layers"] = layers

    # where a Conv module parts: its conv (before SiLU) or its SiLU. The port's
    # conv and SiLU replayed on JAX's input, and on JAX's conv output
    convs = []
    for spec in pmodel.specs:
        key = f"model_{spec.index}"
        mod = same_q.model[spec.index]
        if spec.module != "Conv" or key not in jout:
            continue
        jconv = np.asarray(inter["intermediates"][key]["conv"]["__call__"][0]
                           .astype(jnp.float32))
        with torch.no_grad():
            inp = torch.from_numpy(jax_input(spec)).permute(0, 3, 1, 2).to(torch.bfloat16)
            pconv = mod.conv(inp)
            act = mod.act(torch.from_numpy(jconv).permute(0, 3, 1, 2).to(pconv.dtype))
        pconv = pconv.float().permute(0, 2, 3, 1).numpy()
        act = act.float().permute(0, 2, 3, 1).numpy()
        want = jout[key]
        # JAX's bf16 SiLU on the CPU: x * (1 / (1 + exp(-x))), each step rounded to bf16
        x = torch.from_numpy(jconv).to(torch.bfloat16)
        four = (x * (1 / (1 + torch.exp(-x)))).float().numpy()
        row = dict(layer=spec.index, conv_equal=bool(np.array_equal(pconv, jconv)),
                   conv_frac_differ=float((pconv != jconv).mean()),
                   silu_frac_differ=float((act != want).mean()),
                   silu_max_d_peak=float(np.abs(act - want).max() / np.abs(want).max()),
                   jax_silu_equal=bool(np.array_equal(four, want)))
        convs.append(row)
        log(f"[convs] {key:9s} conv on JAX's input: equal {row['conv_equal']} "
            f"({row['conv_frac_differ'] * 100:.3f}% differ); the port's SiLU on JAX's conv "
            f"output: {row['silu_frac_differ'] * 100:.2f}% differ (max|d|/peak "
            f"{row['silu_max_d_peak']:.2e}); x * (1 / (1 + exp(-x))) with each step rounded "
            f"to bf16 on JAX's conv output equal to JAX's: {row['jax_silu_equal']}")
    report["convs"] = convs
    raw = []
    for lvl, (g, w) in enumerate(zip(praw, jraw)):
        g, w = g.float().numpy(), np.asarray(w.astype(jnp.float32))
        peak = float(np.abs(w).max())
        raw.append([float(np.abs(g - w).max() / peak),
                    float(np.quantile(np.abs(g - w), 0.999) / peak)])
        log(f"[raw] level {lvl} {g.shape}: max|d|/peak {raw[-1][0]:.5f} p99.9 {raw[-1][1]:.5f}")
    report["raw_maps"] = raw
    (root / "int8_parity.json").write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
