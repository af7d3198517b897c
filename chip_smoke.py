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
   bs 32 and bs 128.

``--profile`` adds where the serve call's device time goes (torch.profiler)
and where the kernel's own time goes (clock stamps at its layer boundaries,
from a second build of the same source with ``-DEARLY_PROFILE``).

The line before the last is one JSON object with the kernels' numbers; the
last line is ``{"ok": true, "device": {...}}``. Weights are random, made
from ``--seed``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

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

    def bound_of(ep_v, shape):
        """(ms, "operations" or "bytes", flops, bytes): the larger of the tensor
        cores' time and the memory's for the early network at this shape."""
        flops_v, bytes_v = early_work(ep_v, *shape)
        t_o, t_b = flops_v / PEAK_BF16_FLOPS * 1e3, bytes_v / PEAK_HBM_BYTES * 1e3
        return max(t_o, t_b), "operations" if t_o >= t_b else "bytes", flops_v, bytes_v

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
        log(f"[time] {card}: early_pipeline yolov5{variant} bs8 640x640 tile {plan.th}x{plan.tw} "
            f"(halo factor {plan.halo:.3f}, bands of {plan.rb}, ring {plan.stages} stages): "
            f"kernel {ms_v:.4f} ms, bound {b_v:.4f} ms ({by_v}: {flops_v / 1e9:.1f} GFLOP, "
            f"{bytes_v / 1e6:.1f} MB), {ms_v / b_v:.1f}x")

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
