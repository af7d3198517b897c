#!/usr/bin/env python3
"""On-card check of the PyTorch/CUDA port (ayolov2_torch) on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, each printing its own lines; any failure exits non-zero:

1. environment: torch/CUDA versions, the card's name and power limit; TF32
   is switched off for every comparison;
2. build: nvcc compiles every ``ayolov2_torch/csrc/*.cu`` (in parallel; the
   early-network kernel once per stem width);
3. kernel: the fused early-network kernel against its plain torch version
   (``early_pipeline_ref``) on seeded full-width weights: yolov5s at bs 4,
   640x640 and 384x640, yolov5m at bs 2, 640x640, l and x at bs 1, 640x640,
   plus shapes that leave a ragged last tile in each direction at each
   model's tile, an image smaller than one tile, and yolov5m (depth 2) at a
   ragged size; gate max|d|/peak < 0.03 and p99.9 < 0.015;
4. slice: yolov5s (nc=80, full width) served at bs 32, 640x640 through
   ``make_serving_fn``: detections (32, 100, 6) and counts (32,), finite,
   one kernel launch per call; raw maps of the kernel path against the
   cuDNN path per level;
5. requests: 8 host batches through ``serve_stream`` (pinned, depth 2),
   each equal to serving the same batch directly;
6. the kernel against its plain version at the served shapes, bs 32 and
   bs 128 at 640x640 (same gate), and the cuDNN chain of the same layers
   against the plain version at bs 32 (max|d|/peak < 0.03); times (CUDA
   events, after warm-up): the kernel, its plain version and the cuDNN
   chain at bs 32 (the chain with cuDNN's default heuristics and with
   ``cudnn.benchmark``, and each of its convs); the kernel for yolov5m, l
   and x at bs 8, each beside its own bound and tile; the serve rate at
   bs 32 and bs 128;
7. validation: 128 synthetic BMPs (32 at each native size 640x640,
   480x640, 640x480, 360x640) written under ``build/chip_smoke_val/``; the
   kernel against its plain version at bs 32 at the four rect shapes the
   validator gives them (pad 0.5: 672x672, 512x672, 672x512, 384x672; same
   gate), timed beside each shape's bound; the golden checkpoint (yolov5s,
   nc 20) read by the port's own reader; each image labelled with its top
   50 detections of the f32 plain path above one score cut for all images
   (what each image's top 50 alone would score is printed beside it, not
   gated); the validator at bs 32, rect, in f32 and
   bf16 on cuDNN and in bf16 with the kernel (the default), gated (128 seen,
   equal label counts, f32 mAP50 >= 0.99, the kernel's mAP50 and mAP50-95
   within 0.02 of bf16 cuDNN's and mAP50 >= 0.9, one launch per batch);
   ``python -m ayolov2_torch.cli.val`` (equal to the kernel run) and
   ``cli.val2`` (an answersheet its evaluator scores) as subprocesses; the
   val loop's images/s over a warm pass, the validator's pre/inference/NMS
   ms per image and the loader's ms per batch.

``--profile`` adds where the serve call's device time goes (torch.profiler)
and where the kernel's own time goes (clock stamps at its layer boundaries,
from a second build of the same source with ``-DEARLY_PROFILE``).

The line before the last is one JSON object with the kernels' numbers; the
last line is ``{"ok": true, "device": {...}}``. Weights are random, made
from ``--seed``, except phase 7's, which are the committed golden
checkpoint's; its images are made from ``--seed`` too.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import struct
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

ROOT = Path(__file__).resolve().parent
GOLDEN = ROOT / "runs/golden_r4_mem/train/2026_0818_runs/weights/best.ckpt"
VAL_DIR = ROOT / "build/chip_smoke_val"
VAL_SIZES = ((640, 640), (480, 640), (640, 480), (360, 640))  # native (h, w), 32 images each
PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16 tensor-core rate
PEAK_HBM_BYTES = 3.35e12   # H100 SXM HBM3 rate
TOL_PEAK, TOL_P999 = 0.03, 0.015


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        )
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "nvidia-smi: no output"
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable: {e}"


def rel_err(got, want):
    """(max |d| / peak, p99.9 |d| / peak, max |d|) in f32."""
    import torch

    g, w = got.float(), want.float()
    d = (g - w).abs().flatten()
    scale = max(w.abs().max().item(), 1e-3)
    if d.numel() > 16_000_000:  # quantile's input limit
        d_q = d[torch.randperm(d.numel(), device=d.device)[:16_000_000]]
    else:
        d_q = d
    return d.max().item() / scale, torch.quantile(d_q, 0.999).item() / scale, d.max().item()


def seeded_model(variant: str, seed: int, nc: int = 80):
    """yolov5{variant} with random weights from numpy: He-scaled convs, BN
    statistics that make folding matter, the head's prior bias; fused.

    The features entering the head have an rms near 0.1 with these weights,
    so the head's 1x1 weights are drawn with std 16/sqrt(fan_in): its logits
    then spread by a few units around the prior bias, hundreds of candidates
    per image pass the 0.001 confidence threshold, and the NMS has real
    work to do."""
    import torch

    from ayolov2_torch.models import build_model, yolov5_cfg
    from ayolov2_torch.models.layers import ConvBnAct

    model = build_model(yolov5_cfg(variant, nc=nc), device="cuda")
    rng = np.random.default_rng(seed)

    def put(t, arr):
        t.copy_(torch.from_numpy(np.asarray(arr, np.float32)))

    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, ConvBnAct):
                w = mod.conv.weight
                fan_in = w.shape[1] * w.shape[2] * w.shape[3]
                put(w, rng.normal(0, np.sqrt(2.0 / fan_in), w.shape))
                c = w.shape[0]
                put(mod.bn.weight, rng.uniform(0.8, 1.2, c))
                put(mod.bn.bias, rng.normal(0, 0.1, c))
                put(mod.bn.running_mean, rng.normal(0, 0.1, c))
                put(mod.bn.running_var, rng.uniform(0.5, 1.5, c))
        for conv in model.head.m:
            put(conv.weight, rng.normal(0, 16.0 / np.sqrt(conv.weight.shape[1]), conv.weight.shape))
    return model.fuse()


def images_on_card(shape, seed):
    import torch

    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8)).cuda()


def time_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of fn() over iters launches, CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def early_work(ep, bs, h, w):
    """(flops, bytes) the early network needs: each conv's true MACs x 2
    (no halo recompute); the uint8 input and bf16 output once, weights once."""
    c0, c1, ch, c2, n = ep.c0, ep.c1, ep.ch, ep.c2, ep.n
    p2, p4, p8 = (h // 2) * (w // 2), (h // 4) * (w // 4), (h // 8) * (w // 8)
    macs = (p2 * c0 * 108 + p4 * c1 * 9 * c0 + p4 * ch * c1
            + n * (p4 * ch * ch + p4 * ch * 9 * ch) + p4 * ch * c1 + p4 * c1 * 2 * ch
            + p8 * c2 * 9 * c1)
    weights = sum(t.numel() * 2 for t in ep.segments())
    return 2.0 * bs * macs, bs * h * w * 3 + bs * p8 * c2 * 2 + weights


def bound_of(ep, shape):
    """(ms, "operations" or "bytes", flops, bytes): the larger of the tensor
    cores' time and the memory's for the early network at this shape."""
    flops, nbytes = early_work(ep, *shape)
    t_o, t_b = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_HBM_BYTES * 1e3
    return max(t_o, t_b), "operations" if t_o >= t_b else "bytes", flops, nbytes


def cudnn_chain(fused_state, stem_channels: int = 3):
    """Layers 0..3 as 8 cuDNN convs in bf16 channels_last (the yardstick;
    the port never calls this): uint8 pixels in, /255 folded into the stem.
    ``stem_channels=8`` pads the pixels and the stem's weights with zero
    channels, the width cuDNN's tensor-core kernels want.

    ``run(images, convs=None)``; with a list as ``convs``, each conv appends
    (name, its input, weight, bias, stride, padding) to it."""
    import torch
    import torch.nn.functional as F

    def wb(name, scale=1.0):
        w = (fused_state[f"{name}.conv.weight"].float() * scale).to(torch.bfloat16)
        return (w.contiguous(memory_format=torch.channels_last),
                fused_state[f"{name}.conv.bias"].to(torch.bfloat16))

    p = {k: wb(k) for k in ("model.1", "model.2.cv1", "model.2.cv2", "model.2.cv3", "model.3")}
    w0, b0 = wb("model.0", 1.0 / 255.0)
    w0 = F.pad(w0, (0, 0, 0, 0, 0, stem_channels - 3))
    p["model.0"] = (w0.contiguous(memory_format=torch.channels_last), b0)
    n = 0
    while f"model.2.m.{n}.cv1.conv.weight" in fused_state:
        p[f"model.2.m.{n}.cv1"] = wb(f"model.2.m.{n}.cv1")
        p[f"model.2.m.{n}.cv2"] = wb(f"model.2.m.{n}.cv2")
        n += 1

    def run(images, convs=None):
        def conv(x, key, s=1, pad=0):
            w, b = p[key]
            if convs is not None:
                convs.append((key, x, w, b, s, pad))
            return F.silu(F.conv2d(x, w, b, s, pad))

        if stem_channels > 3:
            images = F.pad(images, (0, stem_channels - 3))
        x = images.permute(0, 3, 1, 2).to(torch.bfloat16)
        x = conv(x, "model.0", 2, 2)
        x = conv(x, "model.1", 2, 1)
        m = conv(x, "model.2.cv1")
        for i in range(n):
            m = m + conv(conv(m, f"model.2.m.{i}.cv1"), f"model.2.m.{i}.cv2", 1, 1)
        y = conv(torch.cat([m, conv(x, "model.2.cv2")], 1), "model.2.cv3")
        return conv(y, "model.3", 2, 1)

    return run


def time_chain(chain, imgs, card: str) -> float:
    """The cuDNN chain's time with cudnn.benchmark on (each conv's algorithm
    chosen by timing, during warm-up) and one time per conv, conv alone and
    conv + SiLU; returns the whole chain's ms."""
    import torch
    import torch.nn.functional as F

    torch.backends.cudnn.benchmark = True
    try:
        total = time_ms(lambda: chain(imgs), 20)
        convs = []
        chain(imgs, convs)
        parts = []
        for key, x, w, b, s, pad in convs:
            alone = time_ms(lambda: F.conv2d(x, w, b, s, pad), 20)
            with_act = time_ms(lambda: F.silu(F.conv2d(x, w, b, s, pad)), 20)
            parts.append(f"{key} {tuple(x.shape[1:])}->{w.shape[0]} k{w.shape[2]}s{s} "
                         f"{alone:.4f}/{with_act:.4f}")
    finally:
        torch.backends.cudnn.benchmark = False
    log(f"[time] {card}: cuDNN chain bs{imgs.shape[0]} stem cin {convs[0][1].shape[1]} "
        f"with cudnn.benchmark: {total:.4f} ms; "
        f"per conv, ms conv alone/conv+SiLU: {'; '.join(parts)}")
    return total


def profile_serve(serve, imgs, card: str) -> None:
    """Where a bs32 serve call spends its time: stage times with CUDA events
    and the device time of each kernel name over 3 calls (torch.profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    t_raw = time_ms(lambda: serve.raw_maps(imgs), 10)
    t_serve = time_ms(lambda: serve(imgs), 10)
    log(f"[profile] {card}: serve {t_serve:.3f} ms = forward to raw maps {t_raw:.3f} ms "
        f"+ flatten/decode/NMS {t_serve - t_raw:.3f} ms")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(3):
            serve(imgs)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    from torch.autograd import DeviceType

    rows = []  # device-side events only (kernels, copies, memsets)
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        dev = getattr(e, "self_device_time_total", None)
        if dev is None:
            dev = getattr(e, "self_cuda_time_total", 0.0)
        if dev > 0:
            rows.append((dev / 1e3, e.count, e.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    log(f"[profile] 3 calls: wall {wall_ms:.3f} ms, device busy {busy:.3f} ms "
        f"({100 * busy / wall_ms:.1f}%; idle {100 - 100 * busy / wall_ms:.1f}%)")
    for ms, count, key in rows[:15]:
        log(f"[profile]   {ms / 3:8.3f} ms/call {100 * ms / busy:5.1f}%  x{count // 3:<4d} {key[:90]}")

def synthetic_image(rng, h: int, w: int) -> np.ndarray:
    """A smooth colour gradient with 2-5 filled rectangles and ellipses, BGR
    uint8: edges and flat regions a detector responds to (noise gives it no
    peaks)."""
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


def write_bmp(path: Path, img: np.ndarray) -> None:
    """(h, w, 3) BGR uint8 as a 24-bit bottom-up BMP (rows padded to 4 bytes)."""
    h, w, _ = img.shape
    pitch = (w * 3 + 3) // 4 * 4
    rows = np.zeros((h, pitch), np.uint8)
    rows[:, : w * 3] = img[::-1].reshape(h, w * 3)
    head = struct.pack("<2sIHHI", b"BM", 54 + pitch * h, 0, 0, 54)
    head += struct.pack("<IiiHHIIiiII", 40, w, h, 1, 24, 0, pitch * h, 2835, 2835, 0, 0)
    path.write_bytes(head + rows.tobytes())


def write_val_set(root: Path, seed: int, sizes=VAL_SIZES, per_size: int = 32) -> Path:
    """``root/images`` (the sizes in a seeded order, numeric stems, so the
    rect sort has work to do), an empty ``root/labels`` and ``root/data.json``."""
    shutil.rmtree(root, ignore_errors=True)
    (root / "images").mkdir(parents=True)
    (root / "labels").mkdir()
    rng = np.random.default_rng(seed)
    order = rng.permutation(np.repeat(np.arange(len(sizes)), per_size))
    for i, k in enumerate(order):
        write_bmp(root / "images" / f"{i + 1:06d}.bmp", synthetic_image(rng, *sizes[k]))
    cfg = root / "data.json"
    cfg.write_text(json.dumps({"val_path": str(root / "images"), "nc": 20, "dataset": "VOC",
                               "names": [f"class{i}" for i in range(20)]}))
    return cfg


def native_detections(validator, loader, dataset):
    """[(image path, native (h, w), its detections in native pixels, best
    first)] of every image, from the validator's device path."""
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
    return found


def label_cut(found, score_cut: float = 0.05) -> float:
    """One score cut for all images, so that no unlabelled detection
    outranks a label anywhere (a per-image top-k alone lets one image's
    unlabelled detections outrank another's labels). A detection clipped to
    under 0.1 pixel (it lies in the letterbox's padding) can never match a
    label, so the cut rises above the best of those."""
    cut = score_cut
    for _, _, d in found:
        thin = (d[:, 2] - d[:, 0] < 0.1) | (d[:, 3] - d[:, 1] < 0.1)
        cut = max([cut, *d[thin, 4]])
    return cut


def write_labels(found, cut: float, top: int = 50):
    """Each image's label file: its top ``top`` detections that score above
    ``cut``, in native normalised xywh. Returns (labels written, the most on
    one image)."""
    written, most = 0, 0
    for path, (h0, w0), d in found:
        d = d[np.argsort(-d[:, 4], kind="stable")]
        d = d[d[:, 4] > cut][:top]
        (path.parent.parent / "labels" / f"{path.stem}.txt").write_text("".join(
            f"{int(c)} {(x1 + x2) / 2 / w0:.6f} {(y1 + y2) / 2 / h0:.6f} "
            f"{(x2 - x1) / w0:.6f} {(y2 - y1) / h0:.6f}\n" for x1, y1, x2, y2, _, c in d))
        written += len(d)
        most = max(most, len(d))
    return written, most


def validation_phase(seed: int, card: str, device: str = "cuda", img_size: int = 640,
                     sizes=VAL_SIZES, per_size: int = 32, bs: int = 32):
    """Phase 7 (see the module docstring). Returns (early_pipeline launches
    in the kernel's validation run, max |kernel - plain| at the rect shapes),
    or None when a gate failed."""
    import torch

    from ayolov2_torch.data import DataLoader, DetectionDataset, ImageFolderDataset
    from ayolov2_torch.eval import YoloValidator
    from ayolov2_torch.ops import early_pipeline as early
    from ayolov2_torch.utils.checkpoint import load_model

    t0 = time.perf_counter()
    data_cfg = write_val_set(VAL_DIR, seed, sizes, per_size)
    log(f"[val] wrote {len(sizes) * per_size} BMPs ({per_size} at each of {list(sizes)}) "
        f"in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    model = load_model(GOLDEN, nc=20, device=device)
    log(f"[val] golden checkpoint read by the port's reader, loaded strict, BN folded: "
        f"yolov5s nc {model.nc}, {sum(p.numel() for p in model.parameters()):,} params, "
        f"{time.perf_counter() - t0:.1f} s")

    # the kernel at the rect shapes the validator feeds it, bs 32
    ep = early.extract_early_params(model.state_dict()).to(device)
    images_dir = str(VAL_DIR / "images")
    folder = ImageFolderDataset(images_dir, img_size=img_size, batch_size=bs, rect=True, pad=0.5)
    shapes = sorted({tuple(int(v) for v in s) for s in folder.batch_shapes}, reverse=True)
    max_abs = 0.0
    for h, w in shapes:
        imgs = torch.from_numpy(np.random.default_rng(seed + h + w).integers(
            0, 256, (bs, h, w, 3), dtype=np.uint8)).to(device)
        got = early.early_pipeline(imgs, ep)
        want = early.early_pipeline_ref(imgs, ep)
        peak, p999, mx = rel_err(got, want)
        max_abs = max(max_abs, mx)
        ok = (got.shape == want.shape and bool(torch.isfinite(got.float()).all())
              and peak < TOL_PEAK and p999 < TOL_P999)
        ms = time_ms(lambda: early.early_pipeline(imgs, ep), 20)
        bound, by, _, _ = bound_of(ep, (bs, h, w))
        plan = early.plan_early(ep.c0, ep.n)
        log(f"[val] {card}: early_pipeline yolov5s bs{bs} {h}x{w} (/8: {h // 8}x{w // 8}, tile "
            f"{plan.th}x{plan.tw}) vs plain: max|d|/peak {peak:.5f} p99.9 {p999:.5f} max|d| "
            f"{mx:.4f} (gate {TOL_PEAK}/{TOL_P999}) {'ok' if ok else 'FAIL'}; kernel {ms:.4f} ms, "
            f"bound {bound:.4f} ms ({by}), {ms / bound:.1f}x")
        if not ok:
            return None

    def run(cfg):
        ds = DetectionDataset(images_dir, img_size=img_size, batch_size=bs, rect=True, pad=0.5)
        v = YoloValidator(model, DataLoader(ds, batch_size=bs), class_names=None, cfg=cfg,
                          device=device)
        return v, ds

    # labels: the f32 plain path's own detections
    f32_cfg = dict(half=False, early_pipeline=False)
    torch.backends.cudnn.deterministic = True
    labeller = YoloValidator(model, None, cfg=dict(f32_cfg, fused=False), device=device)
    t0 = time.perf_counter()
    found = native_detections(labeller, DataLoader(folder, batch_size=bs, detection=False),
                              folder)
    torch.backends.cudnn.deterministic = False
    del labeller
    # for the record, not a gate: each image's top 50 alone as its labels
    n_top, _ = write_labels(found, cut=-1.0)
    r = run(f32_cfg)[0].validation()
    log(f"[val] labels = each image's top 50 alone ({n_top} labels): f32 cuDNN scores its own "
        f"labels at mAP50 {r['map50']:.5f} mAP50-95 {r['map50_95']:.5f} (not gated: "
        f"other images' unlabelled detections outrank labels)")
    cut = label_cut(found)
    n_written, most = write_labels(found, cut)
    # the label cache's key covers the images only: read the new labels anew
    folder._cache_path().with_suffix(".labels").unlink(missing_ok=True)
    log(f"[val] labelled {len(folder)} images with the {n_written} detections of the f32 plain "
        f"path that score above {cut:.5f}, at most 50 an image (at most {most} on an image; "
        f"{time.perf_counter() - t0:.1f} s)")

    results = {}
    runs = {"f32 cuDNN": f32_cfg, "bf16 cuDNN": dict(early_pipeline=False), "bf16 kernel": {}}
    for name, cfg in runs.items():
        v, ds = run(cfg)
        early.early_pipeline.launches = 0  # main path (the kernel's run): counts from here
        t0 = time.perf_counter()
        r = v.validation()
        wall = time.perf_counter() - t0
        r["launches"] = early.early_pipeline.launches
        r["batches"] = len(ds.batch_shapes)
        results[name] = r
        log(f"[val] {name}: seen {r['seen']} labels {r['n_labels']} P {r['mp']:.5f} "
            f"R {r['mr']:.5f} mAP50 {r['map50']:.5f} mAP50-95 {r['map50_95']:.5f} "
            f"({wall:.2f} s with the first call's set-up; early_pipeline launches "
            f"{r['launches']} in {r['batches']} batches of shapes "
            f"{sorted({tuple(int(x) for x in b) for b in ds.batch_shapes})})")
    f32, cud, ker = results["f32 cuDNN"], results["bf16 cuDNN"], results["bf16 kernel"]
    gates = {
        "128 seen, equal label counts": all(r["seen"] == len(sizes) * per_size and
                                            r["n_labels"] == f32["n_labels"] > 0
                                            for r in results.values()),
        "f32 mAP50 >= 0.99": f32["map50"] >= 0.99,
        "kernel within 0.02 of bf16 cuDNN": all(abs(ker[k] - cud[k]) <= 0.02
                                                for k in ("map50", "map50_95")),
        "kernel mAP50 >= 0.9": ker["map50"] >= 0.9,
        "one launch per batch at each shape": (ker["launches"] == ker["batches"] == len(shapes)
                                               and cud["launches"] == 0),
    }
    log("[val] gates: " + "; ".join(f"{k} {'ok' if v else 'FAIL'}" for k, v in gates.items()))
    if not all(gates.values()):
        return None
    launches = ker["launches"]

    # the entry points, as a user runs them
    out = VAL_DIR / "val.json"
    sheet = VAL_DIR / "answersheet.json"
    common = ["--weights", str(GOLDEN), "--data-cfg", str(data_cfg), "-iw", str(img_size),
              "--batch-size", str(bs)] + (["--device", device] if device != "cuda" else [])
    for module, extra in (("val", ["--json-path", str(out)]),
                          ("val2", ["--json-path", str(sheet), "--check-map", "0.5"])):
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", f"ayolov2_torch.cli.{module}", *common, *extra],
                              cwd=ROOT, capture_output=True, text=True, timeout=600)
        tail = [ln for ln in (proc.stdout + proc.stderr).splitlines() if ln.strip()][-3:]
        log(f"[val] python -m ayolov2_torch.cli.{module}: exit {proc.returncode} in "
            f"{time.perf_counter() - t0:.1f} s; " + " | ".join(ln.strip()[:160] for ln in tail))
        if proc.returncode != 0:
            return None
    cli = json.loads(out.read_text())
    same = (cli["seen"] == ker["seen"] and cli["n_labels"] == ker["n_labels"]
            and all(abs(cli[k] - ker[k]) <= 1e-9 for k in ("mp", "mr", "map50", "map50_95")))
    log(f"[val] cli.val result vs the kernel run: mAP50 {cli['map50']:.6f} vs {ker['map50']:.6f}, "
        f"mAP50-95 {cli['map50_95']:.6f} vs {ker['map50_95']:.6f} {'equal' if same else 'FAIL'}")
    from ayolov2_torch.utils.metrics import COCOmAPEvaluator
    from ayolov2_torch.utils.result_writer import yolo_labels_to_coco_json

    preds = json.loads(sheet.read_text())
    coco = COCOmAPEvaluator(yolo_labels_to_coco_json(DetectionDataset(
        images_dir, img_size=img_size))).evaluate(preds)
    log(f"[val] cli.val2 answersheet: {len(preds)} predictions, COCO eval "
        + ", ".join(f"{k} {v:.5f}" for k, v in coco.items()))
    if not same or not preds or not np.isfinite(list(coco.values())).all():
        return None

    # times: a second, warm pass of the kernel's run; the loader alone
    v, ds = run({})
    v.validation()
    t0 = time.perf_counter()
    r = v.validation()
    wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    n_batches = sum(1 for _ in DataLoader(ds, batch_size=bs))
    loader_ms = (time.perf_counter() - t0) / n_batches * 1e3
    log(f"[time] {card}: validation yolov5s bs{bs} rect, kernel path, warm pass: "
        f"{r['seen'] / wall:.1f} img/s ({wall:.3f} s for {r['seen']} images); validator "
        f"pre/inference/NMS {r['t'][0]:.3f}/{r['t'][1]:.3f}/{r['t'][2]:.3f} ms per image; "
        f"f32 cuDNN run (its first pass) {f32['t'][0]:.3f}/{f32['t'][1]:.3f}/{f32['t'][2]:.3f}; "
        f"loader alone "
        f"{loader_ms:.2f} ms per batch of {bs} ({n_batches} batches, 2 threads)")
    return launches, max_abs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--check-only", action="store_true",
                    help="phases 1-3 only: build the kernels and check them")
    ap.add_argument("--profile", action="store_true",
                    help="also break the bs32 serve call down by stage and by kernel "
                         "(torch.profiler)")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this check needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    try:
        from ayolov2_torch.export import make_serving_fn
        from ayolov2_torch.ops import _build, nms
        from ayolov2_torch.ops import early_pipeline as early
        from ayolov2_torch.parallel import serve_stream
    except ImportError as e:
        print(f"chip_smoke: the ayolov2_torch package is missing ({e}); run it from "
              "the repository root", file=sys.stderr)
        return 2

    # ---- 1. environment -------------------------------------------------
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {kind} x{torch.cuda.device_count()}")
    log(f"[env] card: {card}")
    log("[env] TF32 off: matmul.allow_tf32=False cudnn.allow_tf32=False")

    # ---- 2. build -------------------------------------------------------
    t0 = time.perf_counter()
    extra = [("early_pipeline", ("EARLY_C0=32", "EARLY_PROFILE"))] if args.profile else []
    built = _build.build_all(variants=extra)
    log(f"[build] {', '.join(f'{k}: {v:.1f} s' for k, v in built.items())} "
        f"(wall {time.perf_counter() - t0:.1f} s)")
    for name, text in _build.BUILD_LOG.items():
        for line in text.splitlines():
            if ("registers" in line or "spill" in line or "error" in line.lower()
                    or "Performance Loss" in line):
                log(f"[build] {name}: {line.strip()[:240]}")

    # ---- 3. the kernel against its plain version -------------------------
    # full-size shapes, then the risky ones: a ragged last tile in each direction
    # at each model's tile (s 8x8, n 8x16, m 4x8, l 4x4, x 2x2), an image
    # smaller than one tile, and yolov5m (depth 2) ragged. Every tile's conv1
    # rows split into bands whose last one is shorter (19 = 10 + 9 for s).
    cases = [("s", 4, 640, 640), ("s", 4, 384, 640), ("m", 2, 640, 640),
             ("l", 1, 640, 640), ("x", 1, 640, 640),
             ("s", 2, 72, 136), ("s", 3, 200, 104), ("s", 1, 40, 56), ("n", 2, 136, 200),
             ("m", 2, 104, 184), ("l", 1, 264, 328), ("x", 1, 136, 264)]
    models, eps = {}, {}
    for variant, bs, h, w in cases:
        if variant not in models:
            models[variant] = seeded_model(variant, args.seed)
            eps[variant] = early.extract_early_params(models[variant].state_dict()).to("cuda")
        ep = eps[variant]
        imgs = images_on_card((bs, h, w, 3), args.seed + h + w)
        before = early.early_pipeline.launches
        got = early.early_pipeline(imgs, ep)
        torch.cuda.synchronize()
        want = early.early_pipeline_ref(imgs, ep)
        peak, p999, mx = rel_err(got, want)
        ok = (got.shape == want.shape and bool(torch.isfinite(got.float()).all())
              and peak < TOL_PEAK and p999 < TOL_P999
              and early.early_pipeline.launches == before + 1)
        plan = early.plan_early(ep.c0, ep.n)
        log(f"[kernel] yolov5{variant} bs{bs} {h}x{w} tile {plan.th}x{plan.tw} bands of "
            f"{plan.rb} ring {plan.stages}x{plan.stage_bytes} B smem {plan.total} B: "
            f"max|d|/peak {peak:.5f} p99.9 {p999:.5f} max|d| {mx:.4f} "
            f"(gate {TOL_PEAK}/{TOL_P999}) {'ok' if ok else 'FAIL'}")
        if not ok:
            return 1
    if args.check_only:
        log(card)
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                                 "count": torch.cuda.device_count()}}))
        return 0
    wide_states = {v: models[v].state_dict() for v in "mlx"}  # phase 6's cuDNN chains
    del models

    # ---- 4. the slice: serve yolov5s at bs 32, 640x640 -------------------
    model = seeded_model("s", args.seed)
    serve_k = make_serving_fn(model)
    serve_c = make_serving_fn(model, early_pipeline=False)
    assert serve_k.early and not serve_c.early
    imgs = images_on_card((32, 640, 640, 3), args.seed + 1)

    early.early_pipeline.launches = 0  # main path: counts from here
    calls = 3
    for _ in range(calls):
        det, cnt = serve_k(imgs)
    torch.cuda.synchronize()
    launches = early.early_pipeline.launches
    sweeps = nms._greedy_suppress.last_sweeps
    log(f"[slice] yolov5s bs32 640x640: det {tuple(det.shape)} counts {tuple(cnt.shape)} "
        f"mean count {cnt.float().mean().item():.2f} early_pipeline launches {launches} "
        f"in {calls} calls, NMS sweeps {sweeps}")
    if (tuple(det.shape) != (32, 100, 6) or tuple(cnt.shape) != (32,)
            or not bool(torch.isfinite(det).all()) or launches != calls or cnt.sum() == 0):
        log("[slice] FAIL")
        return 1
    raw_k, raw_c = serve_k.raw_maps(imgs), serve_c.raw_maps(imgs)
    for lvl, (a, b) in enumerate(zip(raw_k, raw_c)):
        peak, p999, mx = rel_err(a, b)
        ok = a.shape == b.shape and bool(torch.isfinite(a.float()).all()) and peak < TOL_PEAK
        log(f"[slice] raw level {lvl} {tuple(a.shape)} kernel vs cuDNN path: "
            f"max|d|/peak {peak:.5f} p99.9 {p999:.5f} {'ok' if ok else 'FAIL'}")
        if not ok:
            return 1
    det_c, cnt_c = serve_c(imgs)
    log(f"[slice] cuDNN path mean count {cnt_c.float().mean().item():.2f}; "
        f"images with equal counts {(cnt_c == cnt).sum().item()}/32")
    # decode + NMS on the card against the same code on the CPU, same inputs
    flat = nms.flatten_raw_maps([r[:4].float() for r in raw_k])
    meta = nms.flat_grid_meta(serve_k.model.strides, serve_k.model.head.anchor_grid(), (640, 640))
    kw = dict(conf_thres=0.001, iou_thres=0.65, nms_box=1000, pre_top_k=512, keep_top_k=100)
    d_gpu, n_gpu = nms.fused_decode_nms(flat, *(torch.from_numpy(m).cuda() for m in meta), **kw)
    d_cpu, n_cpu = nms.fused_decode_nms(flat.cpu(), *(torch.from_numpy(m) for m in meta), **kw)
    nms_ok = torch.equal(n_gpu.cpu(), n_cpu) and torch.allclose(d_gpu.cpu(), d_cpu, atol=1e-2)
    log(f"[slice] decode+NMS card vs CPU on 4 images: counts {n_gpu.tolist()} vs "
        f"{n_cpu.tolist()}, max|d| {(d_gpu.cpu() - d_cpu).abs().max().item():.2e} "
        f"{'ok' if nms_ok else 'FAIL'}")
    if not nms_ok:
        return 1

    # ---- 5. requests through serve_stream -------------------------------
    torch.backends.cudnn.deterministic = True
    rng = np.random.default_rng(args.seed + 7)
    hosts = [rng.integers(0, 256, (32, 640, 640, 3), dtype=np.uint8) for _ in range(8)]
    outs = [(d.clone(), n.clone()) for d, n in serve_stream(serve_k, hosts, depth=2)]
    torch.cuda.synchronize()
    same = 0
    for h, (d, n) in zip(hosts, outs):
        dw, nw = serve_k(torch.from_numpy(h).cuda())
        same += int(torch.equal(d, dw) and torch.equal(n, nw))
    torch.backends.cudnn.deterministic = False
    log(f"[stream] {len(outs)} batches of 32 through serve_stream (depth 2): "
        f"{same}/{len(hosts)} equal to direct serving")
    if len(outs) != len(hosts) or same != len(hosts):
        return 1

    # ---- 6. times, and the kernel against its plain version at bs 32 and 128
    ep = serve_k.ep
    fused_state = {k: v.cuda() for k, v in model.state_dict().items()}
    chains = {c: cudnn_chain(fused_state, c) for c in (3, 8)}
    got = early.early_pipeline(imgs, ep)
    want = early.early_pipeline_ref(imgs, ep)
    peak, p999, max_abs = rel_err(got, want)
    ok = peak < TOL_PEAK and p999 < TOL_P999 and bool(torch.isfinite(got.float()).all())
    line = (f"[check] yolov5s bs32 640x640: kernel vs plain max|d|/peak {peak:.5f} "
            f"p99.9 {p999:.5f} max|d| {max_abs:.4f}")
    for c, chain in chains.items():
        chain_peak, chain_p999, _ = rel_err(chain(imgs).permute(0, 2, 3, 1), want)
        ok = ok and chain_peak < TOL_PEAK
        line += (f"; cuDNN chain (stem cin {c}) vs plain max|d|/peak {chain_peak:.5f} "
                 f"p99.9 {chain_p999:.5f}")
    log(f"{line} (gate {TOL_PEAK}/{TOL_P999}) {'ok' if ok else 'FAIL'}")
    if not ok:
        return 1
    batch128 = images_on_card((128, 640, 640, 3), args.seed + 2)
    got = early.early_pipeline(batch128, ep)
    want = torch.cat([early.early_pipeline_ref(batch128[i:i + 32], ep)
                      for i in range(0, 128, 32)])
    peak, p999, mx = rel_err(got, want)
    ok = peak < TOL_PEAK and p999 < TOL_P999 and bool(torch.isfinite(got.float()).all())
    log(f"[check] yolov5s bs128 640x640: kernel vs plain max|d|/peak {peak:.5f} "
        f"p99.9 {p999:.5f} max|d| {mx:.4f} (gate {TOL_PEAK}/{TOL_P999}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        return 1
    max_abs = max(max_abs, mx)
    del got, want

    kernel_ms = time_ms(lambda: early.early_pipeline(imgs, ep), 20)
    plain_ms = time_ms(lambda: early.early_pipeline_ref(imgs, ep), 5, warmup=1)
    default_chain_ms = time_ms(lambda: chains[3](imgs), 20)
    library_ms = min(time_chain(chain, imgs, card) for chain in chains.values())

    bound_ms, bound_by, flops, nbytes = bound_of(ep, imgs.shape[:3])
    plan = early.plan_early(ep.c0, ep.n)
    log(f"[time] {card}: early_pipeline bs32 640x640 tile {plan.th}x{plan.tw} "
        f"(halo factor {plan.halo:.3f}) kernel {kernel_ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, cuDNN chain {library_ms:.4f} ms (the faster stem width, "
        f"cudnn.benchmark; {default_chain_ms:.4f} ms with cin 3 and cuDNN's default "
        f"heuristics), bound {bound_ms:.4f} ms "
        f"({bound_by}: {flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.1f} MB)")

    kernel128_ms = time_ms(lambda: early.early_pipeline(batch128, ep), 10)
    b128, by128, _, _ = bound_of(ep, (128, 640, 640))
    log(f"[time] {card}: early_pipeline yolov5s bs128 640x640 kernel {kernel128_ms:.4f} ms, "
        f"bound {b128:.4f} ms ({by128})")
    batch8 = images_on_card((8, 640, 640, 3), args.seed + 3)
    for variant in "mlx":
        ep_v = eps[variant]
        plan = early.plan_early(ep_v.c0, ep_v.n)
        ms_v = time_ms(lambda: early.early_pipeline(batch8, ep_v), 10)
        b_v, by_v, flops_v, bytes_v = bound_of(ep_v, (8, 640, 640))
        torch.backends.cudnn.benchmark = True
        try:
            chain_v = min(time_ms(lambda: chain(batch8), 10) for chain in
                          (cudnn_chain(wide_states[variant], c) for c in (3, 8)))
        finally:
            torch.backends.cudnn.benchmark = False
        log(f"[time] {card}: early_pipeline yolov5{variant} bs8 640x640 tile {plan.th}x{plan.tw} "
            f"(halo factor {plan.halo:.3f}, bands of {plan.rb}, ring {plan.stages} stages): "
            f"kernel {ms_v:.4f} ms, bound {b_v:.4f} ms ({by_v}: {flops_v / 1e9:.1f} GFLOP, "
            f"{bytes_v / 1e6:.1f} MB), {ms_v / b_v:.1f}x; cuDNN chain {chain_v:.4f} ms "
            f"(the faster stem width, cudnn.benchmark)")
    del wide_states

    rates = {}
    for bs in (32, 128):
        batch = imgs if bs == 32 else batch128
        for _ in range(3):
            serve_k(batch)
        torch.cuda.synchronize()
        iters = 20 if bs == 32 else 8
        t0 = time.perf_counter()
        for _ in range(iters):
            det, cnt = serve_k(batch)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        rates[bs] = bs * iters / dt
        log(f"[time] {card}: serve yolov5s bs{bs} 640x640 uint8 -> (bs, 100, 6): "
            f"{rates[bs]:.1f} img/s ({dt / iters * 1e3:.3f} ms/batch), NMS sweeps "
            f"{nms._greedy_suppress.last_sweeps}")

    if args.profile:
        profile_serve(serve_k, imgs, card)
        shares = early.early_pipeline_profile(imgs, ep)
        log(f"[profile] {card}: inside early_pipeline (yolov5s bs32, clock stamps of a "
            f"-DEARLY_PROFILE build; shares of the stamped clocks): "
            + "; ".join(f"{k} {v}" if isinstance(v, list) else f"{k} {v:.3f}" if v < 1.5
                        else f"{k} {v:.0f}" for k, v in shares.items()))

    # ---- 7. validation on the golden checkpoint --------------------------
    del batch128, batch8, model, serve_k, serve_c, chains, fused_state
    torch.cuda.empty_cache()
    val = validation_phase(args.seed, card)
    if val is None:
        log("[val] FAIL")
        return 1
    launches += val[0]
    max_abs = max(max_abs, val[1])

    print(json.dumps({"kernels": [{
        "name": "early_pipeline",
        "route": "cuda",
        "source": "ayolov2_torch/csrc/early_pipeline.cu",
        "replaces": "ayolov2_tpu/ops/early_pipeline.py:496",
        "launches": launches,
        "max_abs_err": max_abs,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": library_ms,
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
