#!/usr/bin/env python3
"""On-card check of the PyTorch/CUDA port (ayolov2_torch) on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, each printing its own lines; any failure exits non-zero:

1. environment: torch/CUDA versions, the card's name and power limit; TF32
   is switched off for every comparison;
2. build: nvcc compiles every ``ayolov2_torch/csrc/*.cu`` (in parallel; the
   early-network kernel once per padded width set of the shipped configs
   and the stem-8 one, ``ops/_build.EARLY_SETS``), and the host compiler the
   image codecs (``csrc/image_codec.cpp``) beside them;
3. kernel: the fused early-network kernel against its plain torch version
   (``early_pipeline_ref``) on seeded full-width weights: yolov5s at bs 4,
   640x640 and 384x640, yolov5m at bs 2, 640x640, l and x at bs 1, 640x640,
   plus shapes that leave a ragged last tile in each direction at each
   model's tile, an image smaller than one tile, and yolov5m (depth 2) at a
   ragged size; yolov5l_0.5 and the width-1.05 config at bs 1, 640x640 and
   the stem-8 model at bs 2, 320x320; gate max|d|/peak < 0.03 and p99.9 <
   0.015;
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

8. training: yolov5s (full width, nc 20, ``init_model`` weights from
   ``--seed``) at bs 8, 320x320 on drawn images (filled rectangles coloured
   by class): 4 micro-steps at accumulate 2 in f32 (TF32 off) on the card
   and on the CPU, gated on equal loss items (1e-4) and equal step-4 deltas
   of the params, BN statistics and EMA (max|card - cpu| / max|delta| <
   1e-2); the first micro-step in bf16 against f32 (2%); the train step
   timed (CUDA events: forward + loss, backward, optimizer + EMA; peak
   memory; the convs' MACs x 3 at the bf16 peak as its bound) for nc 80 at
   640, bs 64 and nc 20 at 320, bs 16, accumulate 4; 300 micro-steps from
   scratch on 16 drawn images at 320 (the memorisation recipe), gated on the
   last 20 steps' mean loss <= 0.7 x the first 20's; and the entry point:
   ``python -m ayolov2_torch.cli.train`` from the golden checkpoint on
   phase 7's set (train = val, YAML configs read by the port's reader, 2
   epochs, under ``build/chip_smoke_train/``), ``cli.val`` on its
   ``best.ckpt`` through K1 within 0.02 mAP50 of the trainer's own
   validation of that epoch, and ``--resume`` to 3 epochs, which must run
   one epoch and advance ``step`` and ``ema_updates`` by its micro-steps.

9. device augmentation: phase 7's 128 BMPs at 640 as a resident store,
   planned under two recipes cut to what the renderer takes (copy_paste 0,
   flip policies only): (a) ``train_config.yaml``'s (mosaic, HSV,
   translate, scale; axis-aligned) and (b) ``finetune.yaml``'s (rotation,
   shear, mixup, both flips). Gates on a batch of 16: 9.1 the card's
   gather renderer in f32 against the port's CPU renderer on the same plans
   (max|d| <= 1, at most 1e-4 of the pixels differ), both recipes; 9.2 the
   separable renderer in f32 against gather (max|d| <= 2 before the HSV
   jitter, under 1e-3 of the output's pixels differ); 9.3 separable bf16
   against f32 (max|d| <= 8 before the HSV jitter, at most 2e-3 of the
   output's pixels by more than 3); 9.4 ``auto`` picks separable for (a) and
   gather for (b); 9.5 streamed frames render the resident store's pixels
   bit for bit. Times at 640, bs 64: render ms a batch and peak memory of
   each mode and dtype (CUDA events, warm), the host's plan ms a batch and
   the share of phase 8's step. The entry point: ``cli.train`` with
   ``device_aug: true`` (recipe (a)) from the golden checkpoint on phase
   7's set at 640, bs 32, 2 epochs (under ``build/chip_smoke_aug/``), gated
   on finite losses, ``step`` and ``ema_updates`` of 8, both checkpoints
   and resident frames, then ``cli.val`` (K1) on its ``best.ckpt``.

10. host augmentation: phase 7's BMPs linked under ``build/chip_smoke_host/``
   with its labels, every other image's boxes written as 12-point polygons
   (segments), so that copy-paste pastes. 10.1: one shuffled epoch of
   ``train_config.yaml``'s augmentation at 640, bs 8, through the loader
   with 4 threads and with 4 forked processes, gated on equal batches bit
   for bit. 10.2: ``get_item`` ms per item on one host thread for
   ``train_config.yaml`` (a) and ``finetune.yaml`` (b, mixup, rotation,
   shear) and each pixel policy and ``Affine`` forced to p = 1 on one 640
   item. 10.3: ``cli.train`` from the golden checkpoint with
   ``train_golden.yaml`` (320 px, bs 16, thread workers) and with
   ``train_config.yaml`` (640 px, bs 32, ``workers_mode: process``), each
   for 2 epochs with its augmentation sections byte for byte as shipped
   (only epochs, validate_period, the batch, workers_mode and, for
   ``train_golden.yaml``, plot change), gated on finite losses, ``step`` =
   ``ema_updates`` = the micro-steps, the log naming the host path, and
   ``cli.val`` (K1) on each ``best.ckpt`` with mAP50 in [0, 1].

11. the shipped surface, riding on phase 10's ``train_config.yaml`` run
   (under ``build/chip_smoke_surface/``): 11.1 that run keeps ``plot: true``
   as shipped, with ``AYOLO_TRACE_DIR`` set and ``AYOLO_TRACE_STEPS=2``:
   ``labels.png`` (600x1440) and ``train_batch0-2.png`` (4 x 4 tiles of 640)
   decode at their sizes, the train trace holds exactly ``ProfilerStep#2``
   and ``#3`` and names the card's kernels; then the same run again
   without plots and trace window, and what the diagnostics cost: the two
   runs' wall times and epochs against each other, the plots' and the
   trace's writing seconds. 11.2 its ``cli.val`` runs with ``--plot
   --profile --n-profile 20 --tta --dst``: the four curves and the
   confusion matrix decode at matplotlib's sizes, the profile is logged in
   ms per image, and the val trace names K1's kernel. 11.3 phase 7's 128
   images at 640, bf16, bs 32: the validator with TTA and K1 on its first
   branch within 0.02 mAP50 of TTA on cuDNN (one launch a batch), printed
   beside the non-TTA mAP50, each with its warm pass's img/s. 11.4 TTA's
   decoded predictions on 8 of those images at 320, f32, card against CPU
   within 1e-3 of the peak. 11.5 ``cli.val2 --tta --plot --trace-dir`` on
   11.1's ``best.ckpt``: an answersheet, the plots, and a trace of the serve
   loop naming K1's kernel.

12. the rest of the model zoo and the exported serving graph: 12.1
   ``yolov5_v5.yaml`` (Focus, SPP) and ``yolov5_mobilevit.yaml`` (MV2Block,
   MobileViTBlock; nc 80, seeded weights, widths as shipped) served at bs
   32, 640 through ``make_serving_fn`` on the cuDNN path (no K1 launch),
   (32, 100, 6) detections, bf16 raw maps against the f32 forward (max|d| /
   peak < 0.03), their img/s beside yolov5s's; 12.2 yolov5s with the
   space-to-depth stem in each mode against the plain stem in f32 (1e-4 of
   the peak), the stem timed both ways at bs 32; 12.3 both zoo models
   trained 2 micro-steps at 320, bs 8, f32, card = CPU (phase 8's gate), and
   yolov5s at 640, bs 64 with ``remat`` off, True and "save_convs" (equal
   first-step losses, gradients and BN statistics to 1e-2 of each delta;
   each mode's step ms and peak memory); 12.4 the NMS loop's two forms
   (Python loop, ``while_loop`` operator) equal and timed at bs 32 and 128;
   ``python -m ayolov2_torch.cli.export`` of the golden checkpoint (bs 32,
   640, tpu_nms, and ``--raw-hw 720 1280``) under ``build/chip_smoke_export/``,
   the artifacts read back in a fresh interpreter against
   ``make_serving_fn`` / ``make_raw_serving_fn`` (counts equal, max|d| /
   peak < 1e-3, one K1 launch per exported call, both img/s), and ``cli.val
   --weights`` the ``.pt2`` on phase 7's set against the validator with
   ``make_serving_fn`` on the same square batches (1e-3), phase 7's rect
   K1 run printed beside; 12.5 the ``simclr.yaml`` embedding at bs 8, 320,
   card against CPU in f32 (1e-4 of the peak). ``--zoo-only`` runs phases
   1, 2, 3, 7 and 12.

13. compression and the post-training tools, under
   ``build/chip_smoke_compress/``; ``cli.export --dtype int8``,
   ``cli.artifact_sizes``, ``cli.decompose_model`` and ``cli.train
   --use-swa`` run as background jobs from the phase's start. 13.1 the int8
   product (``ops/int8_conv.py``: NHWC im2col, ``torch._int_mm``) at every
   distinct quantizable conv shape of yolov5s at bs 32, 640 and at
   yolov5_v5's Focus conv (cin 12) equal to its plain version (an f64
   product on the card) exactly; the probe's forms (3x3, 256 -> 256, 80x80,
   bs 32) timed against the bf16 cuDNN conv. 13.2 the golden checkpoint
   calibrated on 4 batches of phase 7's set in f32 on the card and on the
   CPU: stats (absmax 1e-4 relative, p99.9 1e-3), the same quantized convs,
   int8 raw maps card vs CPU (1e-2 of the peak). 13.3 ``cli.val --int8``
   (absmax, p999) on phase 7's set: no K1 launch, absmax mAP50 >= bf16
   cuDNN's - 0.05; serve img/s of int8, bf16 cuDNN and bf16 K1 at bs 32 and
   128. 13.4 the int8 ``.pt2`` read in a fresh interpreter equal bit for bit
   to ``make_serving_fn`` of the int8 model rebuilt from its weights,
   ``cli.val`` of it, and the artifact sizes (int8 < 0.7 x f32). 13.5
   ``cli.decompose_model`` of the golden checkpoint with rank-8 kernels
   planted at model_4/m0/cv2, model_6/m0/cv2 and model_8/m0/cv2: the map
   equal to the port's ``decompose_model`` run in this process, planted and
   decomposed mAP50 within 0.01, the decomposed checkpoint validated through
   K1 (one launch a batch), its f32 raw maps card vs CPU (1e-4), ``cli.export``
   of it; a plant at model_1 serves without K1; the unplanted checkpoint
   decomposes nothing at the defaults. 13.6 ``cli.val_optimizer`` for 3
   trials through K1, then ``--load-if-exists`` for a fourth;
   ``cli.create_swa_model -b 2`` on the 2-epoch ``--use-swa`` run's
   ``epoch_N.ckpt`` and ``cli.val`` of ``swa.ckpt`` through K1.
   ``--compress-only`` runs phases 1, 2, 3, 7 and 13.

14. the secondary trainers and tools, under ``build/chip_smoke_secondary/``:
   14.1 the golden checkpoint saved as the reference's ``.pt`` (a bare
   kindle state_dict and ``{"ema": sd, "model": sd}``), ``cli.
   import_torch_weights`` of each equal to the golden variables bit for bit,
   ``cli.val --weights x.pt --model-cfg model.yaml`` on phase 7's set
   through K1 (one launch a batch) to the golden checkpoint's mAP50; 14.2
   the golden checkpoint's optax state (a JAX run) resumed into the port's
   TrainState (update 2250, step 9000, nonzero momentum, the schedule's lr),
   then 2 micro-steps at 320, bs 8, f32, card vs CPU (phase 8's gate); 14.3
   phase 7's validation with ``cache_images: disk`` twice, detections equal
   to the uncached pass's, each pass's wall time; 14.4 ``cli.crop_bboxes``
   of phase 7's labelled BMPs, ``cli.train_repr`` 1 epoch with
   ``train_config_simclr.yaml`` on ``simclr.yaml`` and
   ``train_config_repr.yaml`` on ``yolov5s_repr.yaml`` (finite losses,
   ``best_e000.ckpt``, ``last.ckpt``, views/s), one step of each loss card vs
   CPU; 14.5 ``cli.distillation`` with ``distillation.yaml`` (1 epoch) from
   the golden teacher to a yolov5s student at 640, bs 16 on phase 7's set
   (unlabeled: the same images, or, when the teacher keeps no box above 0.9
   there, synthetic images moved by gradient ascent on the pixels until the
   f32 teacher is sure of them): finite losses, step = ema_updates = the
   micro-steps, one K1 launch per pseudo batch, pseudo-labels above 0.9, the
   K1 teacher's pseudo-labels against cuDNN's (IoU >= 0.9, same class,
   except within 0.01 of the score cut or 1 px of the size cut), ``cli.val``
   of its ``best.ckpt`` through K1, one KD step card vs CPU, and the
   teacher's pseudo batch with and without K1, the KD micro-step and the
   run's img/s timed. ``--secondary-only`` runs phases 1, 2, 3, 7 and 14.
15. K1 at every width, under ``build/chip_smoke_widths/``: the shipped
   ``yolov5_depth1.5_width1.05_800.yaml`` (stem 72, conv1 136, C3 68 x 4,
   conv2 272, padded in the kernel to 80/144/80/288) and yolov5s at width
   0.125 (stem 8: 8/16/8/32, padded to 16/16/16/32), nc 80, seeded weights
   with the residual branches damped (:func:`damp_residuals`) and the head
   shaped as a trained detector's (:func:`shape_head`).
   15.1 K1 against its plain version (phase 3's gate): the 1.05 config at
   bs 4, 800 and 640 and ragged at its tile, the stem-8 model at bs 4, 640
   and ragged; 15.2 ``make_serving_fn`` of the 1.05 config at bs 16,
   800x800 and of the stem-8 model at bs 4, 640: (bs, 100, 6) and counts,
   one launch a call, the raw maps per level against the cuDNN path in
   bf16 and with the rest of the network in f32 (max|d|/peak < 0.03 each;
   each bf16 path's distance from the f32 path printed beside); 15.3 phase 7's 128 BMPs validated at -iw 800
   on a checkpoint of the 1.05 model, labelled by its f32 plain path, under
   phase 7's gates, and ``python -m ayolov2_torch.cli.val`` equal to the
   in-process run; 15.4 ``cli.export`` of that checkpoint (bs 16, 800): the
   operator in the ``.pt2`` with the widths, read back in a fresh
   interpreter equal bit for bit to ``make_serving_fn`` of the model the
   exporter builds, one launch a call; 15.5 K1 timed at bs 16, 800 and bs
   8, 640 (the 1.05 set) and bs 8, 640 (stem 8), each beside its bound,
   tile, plain version and cuDNN chain, and the 1.05 config's serve rate at
   bs 16, 800. ``--widths-only`` runs phases 1, 2, 3 and 15.
16. image files without OpenCV, under ``build/chip_smoke_images/``: 16.1
   each fixture of ``tests/res/torch_codec/`` read by the port equal to the
   digest of ``cv2.imread``'s array in its manifest, and each JPEG
   fixture's source encoded by the port equal to the digest of
   ``cv2.imencode``'s bytes; 16.2 phase 7's 128 images written as JPEG by
   the port's encoder (quality 95, 4:2:0), every eighth as PNG and every
   sixteenth as a JPEG stored turned with EXIF orientation 6 or 8, labelled
   by the f32 plain path on the decoded pixels and validated under phase
   7's gates (bs 32, 640, rect, K1 one launch a batch), ``python -m
   ayolov2_torch.cli.val`` equal to the in-process run; 16.3 ``cli.train``
   from the golden checkpoint on that set with ``train_config.yaml`` as
   shipped (``workers_mode: process``, 1 epoch, 640, bs 32): finite losses,
   step = ema_updates = the micro-steps, ``cli.val`` of its ``best.ckpt``
   through K1; 16.4 on the host clock, decode ms per 640x480 image (baseline
   and progressive JPEG, PNG, BMP), encode ms, the val loader's ms per batch
   of 32 on JPEG and on BMP with 2 and 4 threads, and the warm validation
   pass's img/s on JPEG against phase 7's BMPs. ``--images-only`` runs
   phases 1, 2, 3, 7 and 16.
17. the native runner and the measurement CLIs, under
   ``build/chip_smoke_tools/``: 17.1, started in the background right after
   phase 2, ``cli.export --aoti`` of seeded yolov5s (nc 80, bf16, bs 32,
   640, K1 in the graph: an AOTInductor package) and the build of the C++
   registration of ``ayolov2::early_pipeline`` and the runner; 17.2 the
   runner (no Python) on phase 7's first 32 images at 640 (137 timed calls
   after 3 warm-up and 1 verification call) against ``load_exported`` of
   the same ``.pt2``: equal counts in at least 31 of 32 images, a runner
   detection of the same class at IoU >= 0.99 for at least 99% of the
   artifact's detections of score >= 0.25, the registration's K1 launches
   equal to the runner's calls; its img/s beside the ``.pt2``'s and
   ``make_serving_fn``'s on the same batch, in turns of as many calls; then
   the registration's CUDA body in a fresh interpreter that never imports
   the Python operator, configured from the sidecar, on the same batch
   against ``early_pipeline_ref`` at phase 3's tolerance, its launches
   counted by the registration (its time, the plain version's and the cuDNN
   chain's make the runner's entry of the kernels line); 17.3
   ``cli.bench_matrix --configs serve int8 tta decomposed train latency sweep
   h2d --iters 5 --sweep-prefilters exact`` (every row finite, the serve
   row's K1 launches 1 a call); 17.4
   ``cli.profile_train`` at 640 with ``--bs-sweep 16 64`` (every number
   finite, every time, rate and MFU positive) and ``cli.bench_loader`` on
   phase 7's images and labels with ``train_config.yaml`` (``--batches
   5``). ``--tools-only`` runs phases 1, 2, 3, 7 and 17.

``--profile`` adds where the serve call's (yolov5s, and in 12.1 the two zoo
models') and the augmentation render's device time goes (torch.profiler) and where the kernel's own time goes
(clock stamps at its layer boundaries, from a second build of the same
source with ``-DEARLY_PROFILE``).

The line before the last is one JSON object with the kernels' numbers; the
last line is ``{"ok": true, "device": {...}}``. Weights are random, made
from ``--seed``, except phase 7's, which are the committed golden
checkpoint's (phase 7, and phase 8's entry point run); its images are made
from ``--seed`` too.
"""

from __future__ import annotations

import argparse
import atexit
import concurrent.futures
import contextlib
import json
import os
import shutil
import signal
import struct
import subprocess
import sys
import time
from pathlib import Path
from typing import Optional

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

T_START = time.perf_counter()
ROOT = Path(__file__).resolve().parent
GOLDEN = ROOT / "runs/golden_r4_mem/train/2026_0818_runs/weights/best.ckpt"
VAL_DIR = ROOT / "build/chip_smoke_val"
VAL_SIZES = ((640, 640), (480, 640), (640, 480), (360, 640))  # native (h, w), 32 images each
PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16 tensor-core rate
PEAK_HBM_BYTES = 3.35e12   # H100 SXM HBM3 rate
TOL_PEAK, TOL_P999 = 0.03, 0.015
# models by the short names the phases use, beside yolov5 n/s/m/l/x
NAMED_CFGS = {"l_0.5": "res/configs/model/yolov5l_0.5.yaml",
              "1.05": "res/configs/model/yolov5_depth1.5_width1.05_800.yaml"}
STEM8 = "w0.125"  # yolov5s at width_multiple 0.125: stem 8, conv1 16, C3 8, conv2 32


def model_name(variant: str) -> str:
    if variant in NAMED_CFGS:
        return Path(NAMED_CFGS[variant]).stem
    return "yolov5s at width 0.125 (stem 8)" if variant == STEM8 else f"yolov5{variant}"


def named_cfg(variant: str, nc: int = 80):
    """The model config of a short name (yolov5 n/s/m/l/x, ``l_0.5``,
    ``1.05``, ``w0.125``), or ``variant`` itself (a config path)."""
    from ayolov2_torch.models import yolov5_cfg
    from ayolov2_torch.models.configs import MULTIPLES
    from ayolov2_torch.utils.config import load_yaml

    if variant in MULTIPLES:
        return yolov5_cfg(variant, nc=nc)
    if variant in NAMED_CFGS:
        return load_yaml(ROOT / NAMED_CFGS[variant])
    if variant == STEM8:
        cfg = yolov5_cfg("s", nc=nc)
        cfg["width_multiple"] = 0.125
        return cfg
    return variant


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


def seeded_model(variant: str, seed: int, nc: int = 80, fuse: bool = True):
    """The model of a short name (:func:`named_cfg`) or of the config at the
    path ``variant``, with random weights from numpy: He-scaled convs, BN statistics that make
    folding matter, dense layers with variance 1/fan_in, the head's prior
    bias; fused unless ``fuse`` is false.

    The features entering the head have an rms near 0.1 with these weights,
    so the head's 1x1 weights are drawn with std 16/sqrt(fan_in): its logits
    then spread by a few units around the prior bias, hundreds of candidates
    per image pass the 0.001 confidence threshold, and the NMS has real
    work to do."""
    import torch

    from ayolov2_torch.models import build_model
    from ayolov2_torch.models.layers import ConvBnAct

    model = build_model(named_cfg(variant, nc), nc=nc, device="cuda")
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
            elif isinstance(mod, torch.nn.Linear):
                put(mod.weight, rng.normal(0, np.sqrt(1.0 / mod.in_features), mod.weight.shape))
                put(mod.bias, np.zeros(mod.out_features))
        if model.head is not None:
            for conv in model.head.m:
                put(conv.weight, rng.normal(0, 16.0 / np.sqrt(conv.weight.shape[1]),
                                            conv.weight.shape))
    return model.fuse() if fuse else model


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
    """(flops, bytes) the early network needs at its true widths (the JAX
    function's work; the kernel's padding counts as lost time, not work):
    each conv's MACs x 2 (no halo recompute); the uint8 input and bf16
    output once, the bf16 weights and biases once."""
    c0, c1, ch, c2, n = ep.widths
    p2, p4, p8 = (h // 2) * (w // 2), (h // 4) * (w // 4), (h // 8) * (w // 8)
    macs = (p2 * c0 * 108 + p4 * c1 * 9 * c0 + p4 * ch * c1
            + n * (p4 * ch * ch + p4 * ch * 9 * ch) + p4 * ch * c1 + p4 * c1 * 2 * ch
            + p8 * c2 * 9 * c1)
    params = (c0 * 109 + c1 * (9 * c0 + 1) + 2 * ch * (c1 + 1) + n * ch * (10 * ch + 2)
              + c1 * (2 * ch + 1) + c2 * (9 * c1 + 1))
    return 2.0 * bs * macs, bs * h * w * 3 + bs * p8 * c2 * 2 + 2 * params


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


def codec_source(seed: int, h: int, w: int, gray: bool = False) -> np.ndarray:
    """A codec fixture's source image (``tests/res/torch_codec``): a colour
    gradient with noise, BGR uint8 ((h, w) with ``gray``), from integer
    draws only, so any numpy makes the same array from ``seed``."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base, dx, dy = rng.integers(0, 256, 3), rng.integers(-255, 256, 3), rng.integers(-255, 256, 3)
    img = (base + x[..., None] * dx // max(w, 1) + y[..., None] * dy // max(h, 1)
           + rng.integers(-12, 13, (h, w, 3)))
    img = np.clip(img, 0, 255).astype(np.uint8)
    return np.ascontiguousarray(img[..., 1]) if gray else img


def exif_app1(orientation: int, little: bool = True) -> bytes:
    """A JPEG APP1 segment holding a TIFF IFD0 with the orientation tag only."""
    e = "<" if little else ">"
    tiff = ((b"II" if little else b"MM") + struct.pack(e + "HI", 42, 8) + struct.pack(e + "H", 1)
            + struct.pack(e + "HHIHH", 0x0112, 3, 1, orientation, 0) + struct.pack(e + "I", 0))
    body = b"Exif\0\0" + tiff
    return b"\xff\xe1" + struct.pack(">H", len(body) + 2) + body


def with_exif(jpeg: bytes, orientation: int, little: bool = True) -> bytes:
    """``jpeg`` (a JFIF file) with an EXIF APP1 after its APP0."""
    if jpeg[2:4] != b"\xff\xe0":
        raise ValueError("not a JFIF file")
    at = 4 + struct.unpack(">H", jpeg[4:6])[0]
    return jpeg[:at] + exif_app1(orientation, little) + jpeg[at:]


def write_bmp(path: Path, img: np.ndarray) -> None:
    """(h, w, 3) BGR uint8 as a 24-bit bottom-up BMP (rows padded to 4 bytes)."""
    h, w, _ = img.shape
    pitch = (w * 3 + 3) // 4 * 4
    rows = np.zeros((h, pitch), np.uint8)
    rows[:, : w * 3] = img[::-1].reshape(h, w * 3)
    head = struct.pack("<2sIHHI", b"BM", 54 + pitch * h, 0, 0, 54)
    head += struct.pack("<IiiHHIIiiII", 40, w, h, 1, 24, 0, pitch * h, 2835, 2835, 0, 0)
    path.write_bytes(head + rows.tobytes())


def write_image_file(images: Path, stem: str, img: np.ndarray, i: int) -> None:
    """Phase 16's file for image ``i``: a JPEG from the port's encoder
    (quality 95, 4:2:0); every eighth a PNG instead, and every sixteenth a
    JPEG stored turned and tagged with EXIF orientation 6 or 8, which reads
    upright."""
    from ayolov2_torch.data.codecs import encode_jpeg
    from ayolov2_torch.utils.png import write_png

    if i % 16 == 15:
        o = 6 if (i // 16) % 2 == 0 else 8
        stored = np.ascontiguousarray(np.rot90(img, 1 if o == 6 else -1))
        (images / f"{stem}.jpg").write_bytes(with_exif(encode_jpeg(stored), o, little=o == 6))
    elif i % 8 == 7:
        write_png(images / f"{stem}.png", img)
    else:
        (images / f"{stem}.jpg").write_bytes(encode_jpeg(img))


def write_val_set(root: Path, seed: int, sizes=VAL_SIZES, per_size: int = 32,
                  nc: int = 20, files: bool = False) -> Path:
    """``root/images`` (the sizes in a seeded order, numeric stems, so the
    rect sort has work to do; BMPs, or with ``files`` the same images as
    phase 16's JPEG and PNG files, :func:`write_image_file`), an empty
    ``root/labels`` and ``root/data.json`` (``nc`` classes)."""
    shutil.rmtree(root, ignore_errors=True)
    (root / "images").mkdir(parents=True)
    (root / "labels").mkdir()
    rng = np.random.default_rng(seed)
    order = rng.permutation(np.repeat(np.arange(len(sizes)), per_size))
    for i, k in enumerate(order):
        img = synthetic_image(rng, *sizes[k])
        if files:
            write_image_file(root / "images", f"{i + 1:06d}", img, i)
        else:
            write_bmp(root / "images" / f"{i + 1:06d}.bmp", img)
    cfg = root / "data.json"
    cfg.write_text(json.dumps({"val_path": str(root / "images"), "nc": nc, "dataset": "VOC",
                               "names": [f"class{i}" for i in range(nc)]}))
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
                     sizes=VAL_SIZES, per_size: int = 32, bs: int = 32, weights: Path = GOLDEN,
                     nc: int = 20, root: Path = VAL_DIR, name: str = "yolov5s",
                     tag: str = "val", entry_points=("val", "val2"), files: bool = False):
    """Phase 7 (see the module docstring), on the golden checkpoint; phase
    15.3 runs it on another checkpoint (``weights``, ``nc``, ``name``) under
    ``root`` with only ``cli.val`` as its entry point, its lines tagged
    ``tag``; phase 16.2 on the same images written as JPEG and PNG files
    (``files``). Returns (early_pipeline launches in the kernel's validation
    run, max |kernel - plain| at the rect shapes, the kernel run's mAP50,
    bf16 cuDNN's mAP50, the warm pass's img/s), or None when a gate
    failed."""
    import torch

    from ayolov2_torch.data import DataLoader, DetectionDataset, ImageFolderDataset
    from ayolov2_torch.eval import YoloValidator
    from ayolov2_torch.ops import early_pipeline as early
    from ayolov2_torch.utils.checkpoint import load_model

    def log(msg: str) -> None:
        print(msg.replace("[val]", f"[{tag}]", 1), flush=True)

    t0 = time.perf_counter()
    data_cfg = write_val_set(root, seed, sizes, per_size, nc, files)
    kinds = {}
    for f in (root / "images").iterdir():
        kinds[f.suffix] = kinds.get(f.suffix, 0) + 1
    log(f"[val] wrote {len(sizes) * per_size} images ({per_size} at each of {list(sizes)}; "
        + ", ".join(f"{n} {k}" for k, n in sorted(kinds.items()))
        + f") in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    model = load_model(weights, nc=nc, device=device)
    log(f"[val] {weights.name} read by the port's reader, loaded strict, BN folded: "
        f"{name} nc {model.nc}, {sum(p.numel() for p in model.parameters()):,} params, "
        f"{time.perf_counter() - t0:.1f} s")

    # the kernel at the rect shapes the validator feeds it, bs 32
    ep = early.extract_early_params(model.state_dict()).to(device)
    images_dir = str(root / "images")
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
        plan = early.kernel_plan(ep)
        log(f"[val] {card}: early_pipeline {name} bs{bs} {h}x{w} (/8: {h // 8}x{w // 8}, tile "
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
    out = root / "val.json"
    sheet = root / "answersheet.json"
    common = ["--weights", str(weights), "--data-cfg", str(data_cfg), "-iw", str(img_size),
              "--batch-size", str(bs)] + (["--device", device] if device != "cuda" else [])
    pool = concurrent.futures.ThreadPoolExecutor(2)  # both entry points at once
    runs = {module: pool.submit(run_logged, ["-m", f"ayolov2_torch.cli.{module}", *common,
                                             *extra], 600)
            for module, extra in (("val", ["--json-path", str(out)]),
                                  ("val2", ["--json-path", str(sheet), "--check-map", "0.5"]))
            if module in entry_points}
    for module, run_ in runs.items():
        proc, wall = run_.result()
        tail = [ln for ln in (proc.stdout + proc.stderr).splitlines() if ln.strip()][-3:]
        log(f"[val] python -m ayolov2_torch.cli.{module}: exit {proc.returncode} in {wall:.1f} s "
            f"(the entry points at once); " + " | ".join(ln.strip()[:160] for ln in tail))
        if proc.returncode != 0:
            return None
    cli = json.loads(out.read_text())
    same = (cli["seen"] == ker["seen"] and cli["n_labels"] == ker["n_labels"]
            and all(abs(cli[k] - ker[k]) <= 1e-9 for k in ("mp", "mr", "map50", "map50_95")))
    log(f"[val] cli.val result vs the kernel run: mAP50 {cli['map50']:.6f} vs {ker['map50']:.6f}, "
        f"mAP50-95 {cli['map50_95']:.6f} vs {ker['map50_95']:.6f} {'equal' if same else 'FAIL'}")
    if not same:
        return None
    if "val2" in entry_points:
        from ayolov2_torch.utils.metrics import COCOmAPEvaluator
        from ayolov2_torch.utils.result_writer import yolo_labels_to_coco_json

        preds = json.loads(sheet.read_text())
        coco = COCOmAPEvaluator(yolo_labels_to_coco_json(DetectionDataset(
            images_dir, img_size=img_size))).evaluate(preds)
        log(f"[val] cli.val2 answersheet: {len(preds)} predictions, COCO eval "
            + ", ".join(f"{k} {v:.5f}" for k, v in coco.items()))
        if not preds or not np.isfinite(list(coco.values())).all():
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
    log(f"[time] {card}: validation {name} bs{bs} rect at {img_size}, kernel path, warm pass: "
        f"{r['seen'] / wall:.1f} img/s ({wall:.3f} s for {r['seen']} images); validator "
        f"pre/inference/NMS {r['t'][0]:.3f}/{r['t'][1]:.3f}/{r['t'][2]:.3f} ms per image; "
        f"f32 cuDNN run (its first pass) {f32['t'][0]:.3f}/{f32['t'][1]:.3f}/{f32['t'][2]:.3f}; "
        f"loader alone "
        f"{loader_ms:.2f} ms per batch of {bs} ({n_batches} batches, 2 threads)")
    return launches, max_abs, ker["map50"], cud["map50"], r["seen"] / wall



# ---- phase 8: training ------------------------------------------------------

PALETTE_SEED = 1234
MEMORIZE_CFG = ROOT / "res/configs/cfg/train_golden_memorize.yaml"
TRAIN_DIR = ROOT / "build/chip_smoke_train"


def drawn_batch(rng, n: int, size: int, nc: int, per_image: int = 4, max_labels: int = 64):
    """n synthetic (size, size) BGR images: a grey background with a little
    noise and ``per_image`` filled rectangles whose colour is their class's
    (nothing unlabelled looks like an object), and their label rows:
    (images uint8 (n, size, size, 3), targets (n * max_labels, 6), mask)."""
    from ayolov2_torch.loss.yolo_loss import pad_targets

    palette = np.random.default_rng(PALETTE_SEED).uniform(0, 255, (nc, 3))
    imgs = np.empty((n, size, size, 3), np.uint8)
    labels = []
    for i in range(n):
        img = rng.normal(114, 8, (size, size, 3))
        rows = []
        for _ in range(per_image):
            c = int(rng.integers(0, nc))
            w, h = rng.uniform(0.12, 0.45, 2)
            cx, cy = rng.uniform(w / 2, 1 - w / 2), rng.uniform(h / 2, 1 - h / 2)
            x1, x2 = int((cx - w / 2) * size), int((cx + w / 2) * size)
            y1, y2 = int((cy - h / 2) * size), int((cy + h / 2) * size)
            img[y1:y2, x1:x2] = palette[c]
            rows.append([c, (x1 + x2) / 2 / size, (y1 + y2) / 2 / size, (x2 - x1) / size,
                         (y2 - y1) / size])
        imgs[i] = np.clip(img, 0, 255).astype(np.uint8)
        labels.append(np.asarray(rows, np.float32))
    targets, mask = pad_targets(labels, n, n * max_labels)
    return imgs, targets, mask


def memorize_hyp(nc: int, img_size: int):
    """The memorisation recipe's hyper-parameters (read by the port's YAML
    reader) with the loss gains scaled for yolov5s at ``img_size``."""
    from ayolov2_torch.train.trainer import scale_hyp_gains
    from ayolov2_torch.utils.config import load_yaml

    cfg = load_yaml(MEMORIZE_CFG)
    return cfg, scale_hyp_gains(dict(cfg["hyper_params"], label_smoothing=0.0), 3, nc, img_size)


def train_setup(model, hyp, nc: int, bs: int, accumulate: int, epochs: int,
                steps_per_epoch: int):
    """(TrainState, ComputeLoss) for ``model`` as the trainer builds them."""
    from ayolov2_torch.loss.yolo_loss import ComputeLoss
    from ayolov2_torch.train.optimizer import build_optimizer
    from ayolov2_torch.train.train_state import create_train_state

    opt = build_optimizer(model, hyp, epochs=epochs, steps_per_epoch=steps_per_epoch,
                          batch_size=bs, accumulate=accumulate)
    return create_train_state(model, opt), ComputeLoss.from_hyp(model.head.stride_anchors(),
                                                                 nc, hyp)


def tree_delta_err(a, b, start) -> float:
    """max |(a - start) - (b - start)| / max |b - start| over tensors."""
    num = max((x.detach().double().cpu() - y.detach().double().cpu()).abs().max().item()
              for x, y in zip(a, b))
    den = max((y.detach().double().cpu() - s.double()).abs().max().item()
              for y, s in zip(b, start))
    return num / max(den, 1e-30)


def conv_macs(model, shape) -> int:
    """MACs of every conv of one forward at ``shape`` (NCHW), from hooks."""
    import torch

    total = [0]

    def hook(mod, inp, out):
        total[0] += out.numel() * mod.in_channels // mod.groups * mod.kernel_size[0] * mod.kernel_size[1]

    hooks = [m.register_forward_hook(hook) for m in model.modules()
             if isinstance(m, torch.nn.Conv2d)]
    was = model.training
    model.eval()  # leaves the BatchNorm statistics as they are
    with torch.no_grad():
        model(torch.zeros(shape, device=next(model.parameters()).device), training=True)
    model.train(was)
    for h in hooks:
        h.remove()
    return total[0]


def time_train_step(card: str, nc: int, img: int, bs: int, accumulate: int, seed: int,
                    iters: int = 12, device: str = "cuda") -> dict:
    """The train step (forward + loss, backward, optimizer + EMA) in bf16
    autocast, channels_last, timed with CUDA events per part after warm-up;
    peak memory; the step's FLOP bound from the convs' MACs x 3."""
    import torch

    from ayolov2_torch.models import build_model, init_model, yolov5_cfg
    from ayolov2_torch.train.train_state import EMA, finish_step, train_forward

    _, hyp = memorize_hyp(nc, img)
    model = init_model(build_model(yolov5_cfg("s", nc=nc), device="cpu"), seed).to(device)
    model = model.to(memory_format=torch.channels_last)
    state, loss = train_setup(model, hyp, nc, bs, accumulate, epochs=300, steps_per_epoch=100)
    rng = np.random.default_rng(seed)
    imgs, targets, mask = (torch.from_numpy(a).to(device)
                           for a in drawn_batch(rng, bs, img, nc))
    ema = EMA()
    torch.cuda.reset_peak_memory_stats()
    ev = [[torch.cuda.Event(enable_timing=True) for _ in range(4)] for _ in range(iters)]
    for k in range(3 + iters):
        e = ev[k - 3] if k >= 3 else None
        if k == 3:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        if e:
            e[0].record()
        total, items = train_forward(state.model, loss, imgs, targets, mask, torch.bfloat16)
        if e:
            e[1].record()
        total.backward()
        if e:
            e[2].record()
        finish_step(state, ema)
        if e:
            e[3].record()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) / iters * 1e3
    parts = np.array([[e[i].elapsed_time(e[i + 1]) for i in range(3)] for e in ev]).mean(0)
    peak = torch.cuda.max_memory_allocated()
    macs = conv_macs(state.model, (1, 3, img, img)) * bs
    bound_ms = 3 * 2 * macs / PEAK_BF16_FLOPS * 1e3
    step_ms = float(parts.sum())
    r = dict(step_ms=step_ms, host_ms=host_ms, parts=parts.tolist(), img_s=bs / step_ms * 1e3,
             peak_gb=peak / 1e9, macs=macs, bound_ms=bound_ms, share=bound_ms / step_ms,
             finite=bool(np.isfinite(items.cpu().numpy()).all()))
    # a checkpoint write of this state (host clock): device copies, bf16
    # cast, msgpack encoding, the file
    from ayolov2_torch.utils.checkpoint import save_checkpoint

    path = TRAIN_DIR / "timing.ckpt"
    t0 = time.perf_counter()
    save_checkpoint(path, state, epoch=0, model_cfg=yolov5_cfg("s", nc=nc))
    ckpt_ms = (time.perf_counter() - t0) * 1e3
    ckpt_mb = path.stat().st_size / 1e6
    path.unlink()
    log(f"[train] {card}: train step yolov5s nc {nc} {img}x{img} bs {bs} accumulate {accumulate} "
        f"bf16 autocast channels_last: {step_ms:.3f} ms per micro-step on the device "
        f"(forward+loss {parts[0]:.3f}, backward {parts[1]:.3f}, optimizer+EMA {parts[2]:.3f}); "
        f"host clock {host_ms:.3f} ms; {r['img_s']:.1f} img/s; peak memory {r['peak_gb']:.2f} GB; "
        f"bound {bound_ms:.3f} ms (conv MACs {macs / 1e9:.1f} G x 3 x 2 FLOP at 989 TFLOP/s "
        f"bf16), {100 * r['share']:.1f}% of it; a checkpoint write {ckpt_ms:.1f} ms "
        f"({ckpt_mb:.1f} MB)")
    del state, model, imgs
    torch.cuda.empty_cache()
    return r


def falling_loss(card: str, seed: int, steps: int = 300, img: int = 320, n: int = 16,
                 variant: str = "s", device: str = "cuda", image_dtype=None,
                 per_image: int = 4) -> dict:
    """yolov5s nc 20 from scratch (init_model) on ``n`` drawn images at
    ``img``, bs ``n``, the memorisation recipe (accumulate 64/bs), ``steps``
    micro-steps: the mean total loss of the last 20 against the first 20."""
    import torch

    from ayolov2_torch.models import build_model, init_model, yolov5_cfg
    from ayolov2_torch.train.optimizer import NBS_NOMINAL
    from ayolov2_torch.train.train_state import make_train_step

    nc = 20
    image_dtype = torch.bfloat16 if image_dtype is None else image_dtype
    _, hyp = memorize_hyp(nc, img)
    accumulate = max(round(NBS_NOMINAL / n), 1)
    model = init_model(build_model(yolov5_cfg(variant, nc=nc), device="cpu"), seed).to(device)
    if device == "cuda":
        model = model.to(memory_format=torch.channels_last)
    # one batch is the whole set: an epoch is one micro-step
    state, loss = train_setup(model, hyp, nc, n, accumulate, epochs=steps, steps_per_epoch=1)
    step = make_train_step(loss, image_dtype=image_dtype)
    imgs, targets, mask = (torch.from_numpy(a).to(device)
                           for a in drawn_batch(np.random.default_rng(seed + 5), n, img, nc,
                                                per_image))
    t0 = time.perf_counter()
    items = torch.stack([step(state, imgs, targets, mask) for _ in range(steps)]).cpu().numpy()
    wall = time.perf_counter() - t0
    first, last = items[:20, 3].mean(), items[-20:, 3].mean()
    ratio = last / first
    ok = bool(np.isfinite(items).all()) and ratio <= 0.7
    log(f"[train] {card}: from scratch, yolov5{variant} nc {nc}, {n} drawn images at {img}, bs {n} "
        f"accumulate {accumulate}, {steps} micro-steps ({state.optimizer.updates} updates) in "
        f"{wall:.1f} s: mean total loss of the first 20 {first:.5f} (box {items[:20, 0].mean():.5f} "
        f"obj {items[:20, 1].mean():.5f} cls {items[:20, 2].mean():.5f}), of the last 20 "
        f"{last:.5f} (box {items[-20:, 0].mean():.5f} obj {items[-20:, 1].mean():.5f} "
        f"cls {items[-20:, 2].mean():.5f}), ratio {ratio:.4f} (gate <= 0.7) "
        f"{'ok' if ok else 'FAIL'}")
    return dict(ok=ok, ratio=float(ratio), first=float(first), last=float(last))


def card_vs_cpu(card: str, seed: int, card_device: str = "cuda", cfg: str = "",
                steps: int = 4, bf16: bool = True) -> bool:
    """8.1 and 8.2: ``steps`` micro-steps at accumulate 2 in f32 (TF32 off)
    on the card and on the CPU from the same weights and batch; then the
    first micro-step in bf16 against f32 on the card (``card_device`` "cpu"
    for a rehearsal). ``cfg``: a model config's path instead of yolov5s
    (12.3); ``bf16=False`` leaves 8.2 out."""
    import copy

    import torch

    from ayolov2_torch.models import build_model, init_model, yolov5_cfg
    from ayolov2_torch.train.train_state import make_train_step

    def parts(model):
        """(params, BN running statistics) as lists, in state-dict order."""
        sd = model.state_dict(keep_vars=True)
        stats = [k for k in sd if k.endswith(("running_mean", "running_var"))]
        return ([t for k, t in sd.items() if t.is_floating_point() and k not in stats],
                [sd[k] for k in stats])

    nc, img, bs = 20, 320, 8
    name = Path(cfg).stem if cfg else "yolov5s"
    _, hyp = memorize_hyp(nc, img)
    base = init_model(build_model(cfg or yolov5_cfg("s", nc=nc), nc=nc, device="cpu"), seed)
    start = [[t.detach().clone() for t in group] for group in parts(base)]
    batch = drawn_batch(np.random.default_rng(seed + 3), bs, img, nc)
    runs = {}
    for dev in (card_device, "cpu"):
        model = copy.deepcopy(base).to(dev)
        if dev == "cuda":
            model = model.to(memory_format=torch.channels_last)
        state, loss = train_setup(model, hyp, nc, bs, 2, epochs=300, steps_per_epoch=100)
        step = make_train_step(loss, image_dtype=torch.float32)
        data = [torch.from_numpy(a).to(dev) for a in batch]
        t0 = time.perf_counter()
        items = [step(state, *data).cpu().numpy() for _ in range(steps)]
        runs[dev] = (state, items, time.perf_counter() - t0)
    (sg, ig, tg), (sc, ic, tc) = runs[card_device], runs["cpu"]
    item_err = max(float(np.abs(a - b).max() / np.abs(b).max()) for a, b in zip(ig, ic))
    (pg, bg), (pc, bc) = parts(sg.model), parts(sc.model)
    (eg, ebg), (ec, ebc) = parts(sg.ema_model), parts(sc.ema_model)
    errs = {
        "params": tree_delta_err(pg, pc, start[0]),
        "BN statistics": tree_delta_err(bg, bc, start[1]),
        "EMA": tree_delta_err(eg + ebg, ec + ebc, start[0] + start[1]),
    }
    ok = (item_err < 1e-4 and all(e < 1e-2 for e in errs.values())
          and sg.optimizer.updates == sc.optimizer.updates == steps // 2 and sg.step == steps)
    log(f"[train] {name} nc {nc} full width, bs {bs} at {img}, f32 (TF32 off), {steps} micro-steps "
        f"at accumulate 2 ({steps // 2} updates, in warmup), card vs CPU from the same "
        f"init_model({seed}) weights: loss items max rel {item_err:.2e} (gate 1e-4); step-{steps} "
        f"deltas max|card - cpu| / "
        f"max|delta|: " + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
        + f" (gate 1e-2); card {tg:.1f} s, CPU {tc:.1f} s {'ok' if ok else 'FAIL'}")
    log(f"[train] loss items per micro-step, card: "
        + "; ".join(" ".join(f"{v:.6f}" for v in it) for it in ig))
    del runs, sg, sc
    if not bf16:
        return ok
    # 8.2: bf16 against f32 on the card, the first micro-step from the same start
    first = {}
    for dt in (torch.float32, torch.bfloat16):
        model = copy.deepcopy(base).to(card_device).to(memory_format=torch.channels_last)
        state, loss = train_setup(model, hyp, nc, bs, 2, epochs=300, steps_per_epoch=100)
        first[dt] = make_train_step(loss, image_dtype=dt)(
            state, *(torch.from_numpy(a).to(card_device) for a in batch)).cpu().numpy()
    rel = np.abs(first[torch.bfloat16] - first[torch.float32]) / np.abs(first[torch.float32])
    ok2 = bool((rel < 0.02).all())
    log(f"[train] first micro-step bf16 vs f32 on the card: items "
        f"{' '.join(f'{v:.6f}' for v in first[torch.bfloat16])} vs "
        f"{' '.join(f'{v:.6f}' for v in first[torch.float32])}, rel {' '.join(f'{v:.4f}' for v in rel)} "
        f"(gate 0.02) {'ok' if ok2 else 'FAIL'}")
    if card_device == "cuda":
        torch.cuda.empty_cache()
    return ok and ok2


def write_train_files(root: Path, images: Path, epochs: int, img: int = 320,
                      bs: int = 16) -> tuple:
    """A YAML data config (train and val = ``images``) and a YAML train cfg
    with the memorisation recipe's values (320 px, bs 16 unless given),
    ``epochs`` and validate_period 1."""
    root.mkdir(parents=True, exist_ok=True)
    names = ", ".join(f"class{i}" for i in range(20))
    data = root / "data.yaml"
    data.write_text(f"# phase 7's self-labelled set, as train and val path\n"
                    f"train_path: {images}\nval_path: {images}\nnc: 20\nnames: [{names}]\n")
    text = MEMORIZE_CFG.read_text()
    for a, b in (("epochs: 1500", f"epochs: {epochs}"), ("validate_period: 100",
                                                         "validate_period: 1"),
                 ("image_size: 320", f"image_size: {img}"), ("batch_size: 16",
                                                            f"batch_size: {bs}")):
        if a not in text:
            raise ValueError(f"{MEMORIZE_CFG} has no {a!r}")
        text = text.replace(a, b)
    cfg = root / f"cfg_{epochs}.yaml"
    cfg.write_text(text)
    return data, cfg


EPOCH_ROW = (r"epoch +(\d+) done in ([\d.]+)s \((\S+) img/s\): (\d+) steps, mean loss "
             r"box (\S+) obj (\S+) cls (\S+) total (\S+)")


def run_logged(args, timeout: int = 900, env: Optional[dict] = None):
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, *args], cwd=ROOT, capture_output=True, text=True,
                          timeout=timeout, env=env)
    return proc, time.perf_counter() - t0


def entry_point_run(card: str, device: str = "cuda", img: int = 320, bs: int = 16) -> tuple:
    """8.5: ``cli.train`` from the golden checkpoint on phase 7's set for 3
    epochs, ``cli.val`` on its best.ckpt (K1), then ``--resume`` to 4
    epochs. Returns (ok, early_pipeline launches of the in-process cli.val).
    ``device``, ``img`` and ``bs`` shrink it for a rehearsal on the CPU."""
    import re

    from ayolov2_torch.cli import val
    from ayolov2_torch.ops import early_pipeline as early
    from ayolov2_torch.utils.checkpoint import load_checkpoint

    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    data, cfg2 = write_train_files(TRAIN_DIR, VAL_DIR / "images", 2, img, bs)
    _, cfg3 = write_train_files(TRAIN_DIR, VAL_DIR / "images", 3, img, bs)
    dev = [] if device == "cuda" else ["--device", device]
    common = ["-m", "ayolov2_torch.cli.train", "--data", str(data), "--log-dir",
              str(TRAIN_DIR / "runs"), *dev]
    proc, wall = run_logged([*common, "--model", str(GOLDEN), "--cfg", str(cfg2)])
    out = proc.stdout + proc.stderr
    (TRAIN_DIR / "train.log").write_text(out)
    epochs = re.findall(r"epoch +(\d+) done in ([\d.]+)s \(([\d.]+) img/s\): \d+ steps, mean loss "
                        r"box ([\d.]+) obj ([\d.]+) cls ([\d.]+) total ([\d.]+)", out)
    vals = re.findall(r"epoch +(\d+) validation: mAP50 ([\d.]+) mAP50-95 ([\d.]+)", out)
    run_dir = re.search(r"Run dir: (\S+)", out)
    log(f"[train] python -m ayolov2_torch.cli.train --model best.ckpt (golden) --cfg "
        f"{cfg2.name} (memorisation recipe, 2 epochs): exit {proc.returncode} in {wall:.1f} s")
    for e, v in zip(epochs, vals):
        log(f"[train]   epoch {e[0]}: {e[2]} img/s, mean loss box {e[3]} obj {e[4]} cls {e[5]} "
            f"total {e[6]}; validation mAP50 {v[1]} mAP50-95 {v[2]}")
    if proc.returncode != 0 or not run_dir:
        log("[train] " + " | ".join(out.strip().splitlines()[-8:]))
        return False, 0
    wdir = Path(run_dir.group(1)) / "weights"
    best, last = wdir / "best.ckpt", wdir / "last.ckpt"
    ok = best.exists() and last.exists() and len(epochs) == 2 and len(vals) == 2
    meta_best, meta_last = load_checkpoint(best)["meta"], load_checkpoint(last)["meta"]

    # the resume reads last.ckpt and writes a run of its own: it runs beside cli.val
    resume = concurrent.futures.ThreadPoolExecutor(1).submit(
        run_logged, [*common, "--model", str(GOLDEN), "--cfg", str(cfg3), "--resume", str(last)])
    val_json = TRAIN_DIR / "val.json"
    vargs = ["--weights", str(best), "--data-cfg", str(data), "-iw", str(img), "--batch-size",
             str(bs), "--no-rect", *dev, "--json-path", str(val_json)]
    proc, wall = run_logged(["-m", "ayolov2_torch.cli.val", *vargs])
    if proc.returncode != 0:
        log("[train] cli.val: " + " | ".join((proc.stdout + proc.stderr).strip().splitlines()[-5:]))
        return False, 0
    cli = json.loads(val_json.read_text())
    early.early_pipeline.launches = 0  # main path (cli.val in this process): counts from here
    inproc = val.main(vargs[:-2])
    launches = early.early_pipeline.launches
    d = abs(cli["map50"] - meta_best["map50"])
    ok = ok and d <= 0.02 and launches > 0 and abs(inproc["map50"] - cli["map50"]) <= 1e-9
    log(f"[train] python -m ayolov2_torch.cli.val on best.ckpt (epoch {meta_best['epoch']}, K1 path, "
        f"bf16, square {img}): mAP50 {cli['map50']:.5f} mAP50-95 {cli['map50_95']:.5f} in "
        f"{wall:.1f} s vs the trainer's validation of that epoch (plain path, bf16 compute, f32 EMA "
        f"weights) mAP50 {meta_best['map50']:.5f}: |d| {d:.5f} (gate 0.02); in-process cli.val "
        f"mAP50 {inproc['map50']:.5f}, early_pipeline launches {launches} "
        f"{'ok' if ok else 'FAIL'}")

    proc, wall = resume.result()
    out2 = proc.stdout + proc.stderr
    (TRAIN_DIR / "resume.log").write_text(out2)
    epochs2 = re.findall(r"epoch +(\d+) done in .*?: (\d+) steps", out2)
    run2 = re.search(r"Run dir: (\S+)", out2)
    if proc.returncode != 0 or not run2:
        log("[train] resume: " + " | ".join(out2.strip().splitlines()[-8:]))
        return False, launches
    meta2 = load_checkpoint(Path(run2.group(1)) / "weights/last.ckpt")["meta"]
    n_steps = int(epochs2[0][1]) if len(epochs2) == 1 else -1
    ok_resume = (len(epochs2) == 1 and epochs2[0][0] == "2"
                 and meta2["step"] == meta_last["step"] + n_steps
                 and meta2["ema_updates"] == meta_last["ema_updates"] + n_steps)
    log(f"[train] --resume last.ckpt (epoch {meta_last['epoch']}, step {meta_last['step']}, "
        f"ema_updates {meta_last['ema_updates']}) to 3 epochs: exit {proc.returncode} in "
        f"{wall:.1f} s (beside cli.val), ran epochs {[e[0] for e in epochs2]} of {n_steps} "
        f"micro-steps; the new "
        f"last.ckpt: epoch {meta2['epoch']}, step {meta2['step']}, ema_updates "
        f"{meta2['ema_updates']} {'ok' if ok_resume else 'FAIL'}")
    return ok and ok_resume, launches


def train_phase(card: str, seed: int) -> tuple:
    """Phase 8 (see the module docstring). Returns (ok, K1 launches, the
    640 bs 64 step's ms and img/s)."""
    import torch

    ok = card_vs_cpu(card, seed)
    times = [time_train_step(card, 80, 640, 64, 1, seed),
             time_train_step(card, 20, 320, 16, 4, seed)]
    ok = ok and all(t["finite"] for t in times)
    torch.backends.cudnn.benchmark = False
    fall = falling_loss(card, seed)
    ok = ok and fall["ok"]
    ok_entry, launches = entry_point_run(card)
    return ok and ok_entry, launches, times[0]["step_ms"], times[0]["img_s"]


# ---- phase 9: device augmentation ---------------------------------------------

AUG_DIR = ROOT / "build/chip_smoke_aug"
RECIPES = {"a": ROOT / "res/configs/cfg/train_config.yaml",
           "b": ROOT / "res/configs/cfg/finetune.yaml"}


def eligible_recipe(cfg_path: Path) -> tuple:
    """(yolo_augmentation, policies) of a train config cut to what the
    device renderer takes: copy_paste 0 and the flip policies only (the cut
    ``cli/heldout_sweep.py`` makes for ``--device-aug``)."""
    from ayolov2_torch.utils.config import load_yaml

    cfg = load_yaml(cfg_path)
    policies = []
    for pol in cfg.get("augmentation") or []:
        flips = {k: v for k, v in pol.get("policy", {}).items()
                 if k in ("HorizontalFlip", "VerticalFlip")}
        if flips:
            policies.append(dict(pol, policy=flips))
    return dict(cfg["yolo_augmentation"], copy_paste=0.0), policies


def aug_dataset(recipe: str, img: int, resident: bool = True):
    """Phase 7's images in plan mode under a recipe, cached in memory."""
    from ayolov2_torch.data import DetectionDataset

    ya, policies = eligible_recipe(RECIPES[recipe])
    ds = DetectionDataset(str(VAL_DIR / "images"), img_size=img, cache_images="mem",
                          yolo_augmentation=ya, augmentation=policies)
    ds.enable_device_aug(resident=resident)
    return ds


def plan_batch(ds, n: int, salt: int = 0):
    """(PlanBatch of items 0..n-1, host ms to plan and collate them)."""
    from ayolov2_torch.data.device_augment import collate_plans

    t0 = time.perf_counter()
    batch = collate_plans([ds.plan_item(i % len(ds), salt + i // len(ds)) for i in range(n)], n,
                          64)
    return batch, (time.perf_counter() - t0) * 1e3


def pixel_diff(a, b) -> tuple:
    """(max |d|, share of pixels with d > 0, share with d > 3) of two uint8
    batches."""
    d = (a.int() - b.int()).abs()
    return d.max().item(), (d > 0).float().mean().item(), (d > 3).float().mean().item()


def unit_hsv(batch):
    """The batch with HSV gains 1: its render is the renderer's rounded
    pixels (after mixup and the flips) before the HSV jitter."""
    from ayolov2_torch.data.device_augment import PlanBatch

    kw = {k: getattr(batch, k) for k in PlanBatch.__slots__}
    kw["hsv"] = np.ones_like(batch.hsv)
    return PlanBatch(**kw)


def render_checks(card: str, img: int, bs: int, device: str = "cuda") -> bool:
    """9.1-9.5 on a batch of ``bs`` of each recipe (see the module
    docstring)."""
    import torch

    from ayolov2_torch.data.device_augment import DeviceAugmenter

    ok = True

    def gate(name, passed, detail):
        nonlocal ok
        ok = ok and passed
        log(f"[aug] {name}: {detail} {'ok' if passed else 'FAIL'}")

    outs = {}
    for recipe in "ab":
        ds = aug_dataset(recipe, img)
        batch, _ = plan_batch(ds, bs)
        pairs = int(batch.minv.shape[1])

        def aug(mode, dtype="float32", dev=device, frames=ds.resident_frames):
            return DeviceAugmenter(img, img, pairs, frames, mode=mode, dtype=dtype, device=dev)

        t0 = time.perf_counter()
        cpu = aug("gather", dev="cpu")(batch)
        cpu_s = time.perf_counter() - t0
        card_g = aug("gather")(batch)
        mx, share, _ = pixel_diff(card_g.cpu(), cpu)
        gate(f"9.1 recipe ({recipe}) {RECIPES[recipe].name} P={pairs}: card gather f32 vs CPU "
             f"gather f32, bs {bs} at {img}", tuple(card_g.shape) == (bs, img, img, 3)
             and card_g.dtype == torch.uint8 and mx <= 1 and share <= 1e-4,
             f"max|d| {mx} share(d>0) {share:.2e} (gate 1 / 1e-4; CPU {cpu_s:.1f} s)")
        auto = aug("auto")
        auto(batch)
        outs[recipe] = (ds, batch, card_g, set(auto._render_fns))
        if recipe == "a":
            # the max is bounded on the pixels before the HSV jitter: cv2's
            # hue scale (h * gain mod 180) jumps where a hue near 180
            # wraps, so one level of input moves a saturated pixel by up to
            # ~20 levels after it; the shares are bounded on the output
            flat = unit_hsv(batch)
            g1 = aug("gather")(flat)
            sep32, sep32_1 = aug("separable")(batch), aug("separable")(flat)
            mx1, _, _ = pixel_diff(sep32_1, g1)
            mx, share, _ = pixel_diff(sep32, card_g)
            gate("9.2 recipe (a): card separable f32 vs card gather f32",
                 mx1 <= 2 and share < 1e-3,
                 f"before HSV max|d| {mx1}; output share(d>0) {share:.2e}, max|d| {mx} "
                 f"(gate 2 before HSV / 1e-3)")
            sep16, sep16_1 = aug("separable", "bfloat16")(batch), aug("separable", "bfloat16")(flat)
            mx1, _, _ = pixel_diff(sep16_1, sep32_1)
            mx, _, share3 = pixel_diff(sep16, sep32)
            gate("9.3 recipe (a): card separable bf16 vs separable f32", mx1 <= 8 and share3 <= 2e-3,
                 f"before HSV max|d| {mx1}; output share(d>3) {share3:.2e}, max|d| {mx} "
                 f"(gate 8 before HSV / 2e-3)")
    picks = {r: outs[r][3] for r in "ab"}
    gate("9.4 auto", picks == {"a": {"separable"}, "b": {"gather"}},
         f"recipe (a) {sorted(picks['a'])}, recipe (b) {sorted(picks['b'])} "
         "(want separable, gather)")
    ds_b, batch_b, card_b, _ = outs["b"]
    stream = aug_dataset("b", img, resident=False)
    batch_s, _ = plan_batch(stream, bs)
    same_labels = (np.array_equal(batch_s.targets, batch_b.targets)
                   and np.array_equal(batch_s.minv, batch_b.minv))
    out_s = DeviceAugmenter(img, img, int(batch_s.minv.shape[1]), mode="gather", dtype="float32",
                            device=device)(batch_s)
    gate("9.5 recipe (b): streaming vs resident", same_labels and torch.equal(out_s, card_b),
         f"plans equal {same_labels}, images equal {torch.equal(out_s, card_b)} "
         f"(streamed frames {tuple(batch_s.src.shape)})")
    return ok


def time_renders(card: str, img: int, bs: int, step_ms: float) -> None:
    """Render ms a batch (CUDA events, warm, plan arrays' copies included)
    and peak memory for each mode and dtype of both recipes, beside the
    host's plan time of the batch and phase 8's step."""
    import torch

    from ayolov2_torch.data.device_augment import DeviceAugmenter

    S = img
    sep_macs = 4 * (img * S * S * 3 + img * img * S * 3) * bs
    log(f"[aug] {card}: the separable products need {sep_macs / 1e9:.1f} GMAC a batch of {bs} at "
        f"{img} (4 slots x (h S S 3 + h w S 3)): {2 * sep_macs / PEAK_BF16_FLOPS * 1e3:.3f} ms at "
        f"989 TFLOP/s bf16")
    for recipe, runs in (("a", (("gather", "float32"), ("separable", "float32"),
                                ("separable", "bfloat16"))),
                         ("b", (("gather", "float32"),))):
        ds = aug_dataset(recipe, img)
        batch, _ = plan_batch(ds, bs, salt=1)
        _, plan_ms = plan_batch(ds, bs, salt=2)  # warm: the image cache and the labels
        pairs = int(batch.minv.shape[1])
        for mode, dtype in runs:
            aug = DeviceAugmenter(img, img, pairs, ds.resident_frames, mode=mode, dtype=dtype)
            aug(batch)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            ms = time_ms(lambda: aug(batch), 10, warmup=2)
            peak = (torch.cuda.max_memory_allocated() - base) / 1e9
            log(f"[aug] {card}: render recipe ({recipe}) P={pairs} {mode} {dtype} bs {bs} at "
                f"{img}: {ms:.3f} ms a batch, {ms / step_ms * 100:.1f}% of phase 8's "
                f"{step_ms:.3f} ms step; peak memory above the frames {peak:.2f} GB; host plan "
                f"{plan_ms:.1f} ms a batch ({plan_ms / bs:.2f} ms an item, one thread)")
            del aug
        del ds
        torch.cuda.empty_cache()


def aug_entry_point(card: str, step_img_s: float, device: str = "cuda", img: int = 640,
                    bs: int = 32, epochs: int = 2) -> tuple:
    """``cli.train`` with ``device_aug: true`` (recipe (a)) from the golden
    checkpoint on phase 7's set, then ``cli.val`` (K1) on its best.ckpt.
    Returns (ok, early_pipeline launches of cli.val)."""
    import re

    from ayolov2_torch.cli import val
    from ayolov2_torch.ops import early_pipeline as early
    from ayolov2_torch.utils.checkpoint import load_checkpoint
    from ayolov2_torch.utils.config import load_yaml

    shutil.rmtree(AUG_DIR, ignore_errors=True)
    AUG_DIR.mkdir(parents=True)
    cfg = load_yaml(MEMORIZE_CFG)
    cfg["train"].update(epochs=epochs, batch_size=bs, image_size=img, validate_period=1,
                        device_aug=True, plot=False)
    cfg["yolo_augmentation"], cfg["augmentation"] = eligible_recipe(RECIPES["a"])
    cfg_path, data = AUG_DIR / "cfg.json", AUG_DIR / "data.json"
    cfg_path.write_text(json.dumps(cfg))
    images = str(VAL_DIR / "images")
    data.write_text(json.dumps({"train_path": images, "val_path": images, "nc": 20,
                                "names": [f"class{i}" for i in range(20)]}))
    dev = [] if device == "cuda" else ["--device", device]
    proc, wall = run_logged(["-m", "ayolov2_torch.cli.train", "--model", str(GOLDEN), "--data",
                             str(data), "--cfg", str(cfg_path), "--log-dir", str(AUG_DIR / "runs"),
                             *dev])
    out = proc.stdout + proc.stderr
    (AUG_DIR / "train.log").write_text(out)
    rows = re.findall(EPOCH_ROW, out)
    run_dir = re.search(r"Run dir: (\S+)", out)
    log(f"[aug] python -m ayolov2_torch.cli.train --model best.ckpt (golden) device_aug (recipe "
        f"(a), {img} px, bs {bs}, {epochs} epochs): exit {proc.returncode} in {wall:.1f} s; "
        f"{'resident' if 'resident source frames' in out else 'NOT resident'}")
    for r in rows:
        log(f"[aug]   epoch {r[0]}: {r[1]} s, {r[2]} img/s (phase 8's step alone at 640 bs 64: "
            f"{step_img_s:.1f} img/s), {r[3]} steps, mean loss box {r[4]} obj {r[5]} cls {r[6]} "
            f"total {r[7]}")
    if proc.returncode != 0 or not run_dir:
        log("[aug] " + " | ".join(out.strip().splitlines()[-8:]))
        return False, 0
    wdir = Path(run_dir.group(1)) / "weights"
    n_images = len(list((VAL_DIR / "images").glob("*.bmp")))
    n_steps = n_images // bs
    meta = load_checkpoint(wdir / "last.ckpt")["meta"]
    finite = all(np.isfinite(float(v)) for r in rows for v in r[4:])
    ok = (len(rows) == epochs and finite and (wdir / "best.ckpt").exists()
          and meta["step"] == meta["ema_updates"] == epochs * n_steps
          and "resident source frames" in out)
    if not ok:
        log(f"[aug] FAIL: epochs {len(rows)}, finite {finite}, best.ckpt "
            f"{(wdir / 'best.ckpt').exists()}, step {meta['step']}, ema_updates "
            f"{meta['ema_updates']} (want {epochs * n_steps})")
        return False, 0
    vargs = ["--weights", str(wdir / "best.ckpt"), "--data-cfg", str(data), "-iw", str(img),
             "--batch-size", str(bs), *dev]
    early.early_pipeline.launches = 0  # main path (cli.val in this process): counts from here
    t0 = time.perf_counter()
    result = val.main(vargs)
    launches = early.early_pipeline.launches
    ok = (ok and launches > 0 and result["seen"] == n_images
          and np.isfinite(result["map50"]))
    log(f"[aug] last.ckpt: epoch {meta['epoch']}, step {meta['step']}, ema_updates "
        f"{meta['ema_updates']} (want {epochs * n_steps}); python -m ayolov2_torch.cli.val on "
        f"best.ckpt (K1, rect): seen {result['seen']} mAP50 {result['map50']:.5f} mAP50-95 "
        f"{result['map50_95']:.5f} in {time.perf_counter() - t0:.1f} s, early_pipeline launches "
        f"{launches} {'ok' if ok else 'FAIL'}")
    return ok, launches


def profile_render(card: str, img: int = 640, bs: int = 64) -> None:
    """Device time of one render by kernel name (torch.profiler) for each
    mode, recipe (a)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from ayolov2_torch.data.device_augment import DeviceAugmenter

    ds = aug_dataset("a", img)
    batch, _ = plan_batch(ds, bs)
    for mode, dtype in (("separable", "bfloat16"), ("separable", "float32"),
                        ("gather", "float32")):
        aug = DeviceAugmenter(img, img, 1, ds.resident_frames, mode=mode, dtype=dtype)
        aug(batch)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            aug(batch)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        rows = []
        for e in prof.key_averages():
            dev = getattr(e, "self_device_time_total", 0.0)
            if e.device_type == DeviceType.CUDA and dev > 0:
                rows.append((dev / 1e3, e.count, e.key))
        rows.sort(reverse=True)
        busy = sum(r[0] for r in rows)
        log(f"[profile] {card}: render recipe (a) {mode} {dtype} bs {bs} at {img}: wall {wall:.3f} "
            f"ms, device busy {busy:.3f} ms, {sum(r[1] for r in rows)} kernels")
        for ms, count, key in rows[:12]:
            log(f"[profile]   {ms:8.3f} ms {100 * ms / busy:5.1f}%  x{count:<4d} {key[:90]}")


def augment_phase(card: str, step_ms: float, step_img_s: float, profile: bool = False) -> tuple:
    """Phase 9 (see the module docstring). Returns (ok, K1 launches)."""
    t0 = time.perf_counter()
    ok = render_checks(card, 640, 16)
    time_renders(card, 640, 64, step_ms)
    if profile:
        profile_render(card)
    ok_entry, launches = aug_entry_point(card, step_img_s)
    log(f"[aug] phase 9 in {time.perf_counter() - t0:.1f} s")
    return ok and ok_entry, launches


# ---- phase 10: host augmentation ------------------------------------------------

HOST_DIR = ROOT / "build/chip_smoke_host"
HOST_RECIPES = {"golden": ROOT / "res/configs/cfg/train_golden.yaml",
                "a": RECIPES["a"], "b": RECIPES["b"]}


def write_host_set(root: Path, src: Path) -> Path:
    """``root/images``: links to phase 7's BMPs; ``root/labels`` and
    ``root/segments`` (the two label types of the shipped configs): phase 7's
    boxes, every other image's as polygons (a 12-point ellipse in each box),
    so that copy-paste has segments to paste."""
    shutil.rmtree(root, ignore_errors=True)
    (root / "images").mkdir(parents=True)
    images = sorted((src / "images").glob("*.bmp"))
    for img in images:
        (root / "images" / img.name).symlink_to(img)
    write_segments(src / "labels", [img.stem for img in images],
                   [root / "labels", root / "segments"])
    return root / "images"


def write_segments(labels: Path, stems, out_dirs) -> None:
    """Each of ``stems``' box labels from ``labels`` into every dir of
    ``out_dirs``, every other image's boxes as polygons (a 12-point ellipse
    in each box)."""
    t = np.linspace(0, 2 * np.pi, 12, endpoint=False)
    for d in out_dirs:
        d.mkdir(parents=True, exist_ok=True)
    for k, stem in enumerate(stems):
        rows = []
        for line in (labels / f"{stem}.txt").read_text().splitlines():
            c, x, y, w, h = (float(v) for v in line.split())
            if k % 2:
                poly = np.stack([x + w / 2 * np.cos(t), y + h / 2 * np.sin(t)], 1).clip(0, 1)
                rows.append(f"{int(c)} " + " ".join(f"{v:.6f}" for v in poly.ravel()))
            else:
                rows.append(line)
        for d in out_dirs:
            (d / f"{stem}.txt").write_text("".join(r + "\n" for r in rows))


def shipped_cfg(recipe: str, epochs: int, workers_mode: str, bs: Optional[int] = None,
                img: Optional[int] = None, keep_plot: bool = False,
                out_dir: Path = HOST_DIR) -> Path:
    """The shipped train config with only run-length fields changed: epochs,
    validate_period 1, ``workers_mode``, the batch where given and ``plot:
    false`` unless ``keep_plot`` (and the image size for a rehearsal on the
    CPU); its augmentation sections stay byte for byte as shipped."""
    import re

    from ayolov2_torch.utils.config import load_yaml

    src = HOST_RECIPES[recipe]
    text = src.read_text()
    edits = [(r"(?m)^  epochs: \d+", f"  epochs: {epochs}"),
             (r"(?m)^  validate_period: \d+", "  validate_period: 1"),
             (r"(?m)^  workers: (\d+)", f"  workers: \\1\n  workers_mode: {workers_mode}")]
    if not keep_plot:
        edits.append((r"(?m)^  plot: \w+", "  plot: false"))
    if bs:
        edits.append((r"(?m)^  batch_size: \d+", f"  batch_size: {bs}"))
    if img:
        edits.append((r"(?m)^  image_size: \d+", f"  image_size: {img}"))
    for pattern, repl in edits:
        text, n = re.subn(pattern, repl, text, count=1)
        if n != 1:
            raise ValueError(f"{src} has no line {pattern!r}")
    out = out_dir / f"cfg_{recipe}_{workers_mode}.yaml"
    out.write_text(text)
    new, old = load_yaml(out), load_yaml(src)
    for section in ("yolo_augmentation", "augmentation"):
        if new.get(section) != old.get(section):
            raise ValueError(f"{out}: section {section} differs from {src}")
    return out


def host_dataset(recipe: str, img: int, images: Path, **kw):
    """Phase 10's set under a shipped recipe's augmentation sections."""
    from ayolov2_torch.data import DetectionDataset
    from ayolov2_torch.utils.config import load_yaml

    cfg = load_yaml(HOST_RECIPES[recipe])
    return DetectionDataset(str(images), img_size=img, batch_size=32,
                            label_type=cfg["train"].get("label_type", "labels"),
                            yolo_augmentation=cfg["yolo_augmentation"],
                            augmentation=cfg.get("augmentation"), **kw)


def thread_equals_process(images: Path, img: int, bs: int, workers: int) -> bool:
    """10.1: one shuffled epoch of recipe (a)'s host items through the loader
    with threads and with processes: the same bytes, batch for batch."""
    from ayolov2_torch.data import DataLoader

    ds = host_dataset("a", img, images)
    epochs, times = {}, {}
    for mode in ("thread", "process"):
        loader = DataLoader(ds, batch_size=bs, shuffle=True, drop_last=True, workers=workers,
                            workers_mode=mode, seed=3)
        t0 = time.perf_counter()
        epochs[mode] = list(loader)
        times[mode] = time.perf_counter() - t0
    same = len(epochs["thread"]) == len(epochs["process"]) > 0 and all(
        np.array_equal(a.images, b.images) and np.array_equal(a.targets, b.targets)
        and np.array_equal(a.target_mask, b.target_mask)
        for a, b in zip(epochs["thread"], epochs["process"]))
    n = sum(len(b.paths) for b in epochs["thread"])
    log(f"[host] 10.1 recipe (a) at {img}, bs {bs}, one epoch ({n} items) with {workers} worker "
        f"threads and {workers} worker processes: batches equal bit for bit {same}; "
        f"{n / times['thread']:.1f} img/s on threads, {n / times['process']:.1f} img/s on "
        f"processes (host, os.cpu_count() {os.cpu_count()}) {'ok' if same else 'FAIL'}")
    return same


def item_profile(ds, n: int, top: int = 8) -> list:
    """The functions that take the most own time over ``n`` items:
    [(name, ms per item)]."""
    import cProfile
    import pstats

    prof = cProfile.Profile()
    prof.enable()
    for i in range(n):
        ds.get_item(i % len(ds), 7 + i // len(ds))
    prof.disable()
    rows = [(f"{Path(f).stem}.{name}" if f != "~" else name.strip("<>{}"), tt / n * 1e3)
            for (f, _, name), (_, _, tt, _, _) in pstats.Stats(prof).stats.items()]
    return sorted(rows, key=lambda r: -r[1])[:top]


def time_host_items(images: Path, img: int, n: int = 32) -> None:
    """10.2: get_item ms per item on one host thread, recipes (a) and (b),
    and each pixel policy forced to p = 1 on a 640 item of recipe (a)."""
    from ayolov2_torch.data import augment

    for recipe in ("a", "b"):
        ds = host_dataset(recipe, img, images, cache_images="mem")
        ds.get_item(0, 0)
        t0 = time.perf_counter()
        for i in range(n):
            ds.get_item(i % len(ds), i // len(ds))
        ms = (time.perf_counter() - t0) / n * 1e3
        log(f"[host] 10.2 get_item recipe ({recipe}) at {img}: {ms:.1f} ms per item (host, one "
            f"thread, mean of {n})")
        log(f"[host] 10.2 recipe ({recipe}) where an item's time goes (cProfile, own time, ms "
            f"per item): " + ", ".join(f"{k} {v:.1f}" for k, v in item_profile(ds, n)))
    im = host_dataset("a", img, images, cache_images="mem").get_item(0, 0)[0]
    labels = np.array([[0, 0.5, 0.5, 0.2, 0.3]], np.float32)
    times = []
    for name, fn in [*augment.PIXEL_TRANSFORMS.items(),
                     ("Affine", lambda x, rng: augment._affine(x, labels.copy(), rng, rotate=[-10, 10],
                                                              shear=[-5, 5])[0])]:
        rng = np.random.default_rng(0)
        fn(im.copy(), rng)
        t0 = time.perf_counter()
        for _ in range(3):
            fn(im.copy(), rng)
        times.append(f"{name} {(time.perf_counter() - t0) / 3 * 1e3:.1f}")
    log(f"[host] 10.2 pixel policies at p = 1 on a {im.shape[1]}x{im.shape[0]} image, ms (host, "
        f"one thread, mean of 3): " + ", ".join(times))


def host_entry_point(recipe: str, workers_mode: str, images: Path, step_img_s: float,
                     device: str = "cuda", bs: Optional[int] = None, epochs: int = 2,
                     img: Optional[int] = None, surface: bool = False) -> tuple:
    """10.3: ``cli.train`` with a shipped recipe on phase 10's set from the
    golden checkpoint, then ``cli.val`` (K1) on its best.ckpt. With
    ``surface`` (phase 11.1, 11.2, 11.5) the run keeps ``plot`` as shipped
    and traces a window of 2 steps, and ``cli.val`` runs with ``--plot
    --profile --tta``, then ``cli.val2 --tta --plot --trace-dir``. Returns
    (ok, early_pipeline launches of the entry points' runs)."""
    import re

    from ayolov2_torch.cli import val
    from ayolov2_torch.ops import early_pipeline as early
    from ayolov2_torch.utils.checkpoint import load_checkpoint
    from ayolov2_torch.utils.config import load_yaml

    cfg_path = shipped_cfg(recipe, epochs, workers_mode, bs, img, keep_plot=surface)
    tcfg = load_yaml(cfg_path)["train"]
    img, bs = int(tcfg["image_size"]), int(tcfg["batch_size"])
    data = HOST_DIR / "data.json"
    data.write_text(json.dumps({"train_path": str(images), "val_path": str(images), "nc": 20,
                                "names": [f"class{i}" for i in range(20)]}))
    dev = [] if device == "cuda" else ["--device", device]
    runs = HOST_DIR / f"runs_{recipe}_{workers_mode}"
    env = None
    if surface:
        shutil.rmtree(SURFACE_DIR, ignore_errors=True)
        env = dict(os.environ, AYOLO_TRACE_DIR=str(SURFACE_DIR / "train_trace"),
                   AYOLO_TRACE_STEPS="2")
    proc, wall = run_logged(["-m", "ayolov2_torch.cli.train", "--model", str(GOLDEN), "--data",
                             str(data), "--cfg", str(cfg_path), "--log-dir", str(runs), *dev],
                            env=env)
    out = proc.stdout + proc.stderr
    (HOST_DIR / f"train_{recipe}_{workers_mode}.log").write_text(out)
    rows = re.findall(EPOCH_ROW, out)
    path = re.search(r"training images: (.*)", out)
    run_dir = re.search(r"Run dir: (\S+)", out)
    log(f"[host] python -m ayolov2_torch.cli.train --model best.ckpt (golden) --cfg "
        f"{HOST_RECIPES[recipe].name} as shipped ({img} px, bs {bs}, {epochs} epochs, "
        f"workers_mode {workers_mode}{', plot as shipped, a trace window' if surface else ''}): "
        f"exit {proc.returncode} in {wall:.1f} s; training images "
        f"{path.group(1) if path else '?'}")
    for r in rows:
        log(f"[host]   epoch {r[0]}: {r[1]} s, {r[2]} img/s (phase 8's step alone at 640 bs 64: "
            f"{step_img_s:.1f} img/s), {r[3]} steps, mean loss box {r[4]} obj {r[5]} cls {r[6]} "
            f"total {r[7]}")
    if proc.returncode != 0 or not run_dir:
        log("[host] " + " | ".join(out.strip().splitlines()[-8:]))
        return False, 0
    wdir = Path(run_dir.group(1)) / "weights"
    n_steps = len(list(images.glob("*.bmp"))) // bs
    meta = load_checkpoint(wdir / "last.ckpt")["meta"]
    finite = all(np.isfinite(float(v)) for r in rows for v in r[4:])
    mode_word = "processes" if workers_mode == "process" else "threads"
    ok = (len(rows) == epochs and finite and (wdir / "best.ckpt").exists()
          and meta["step"] == meta["ema_updates"] == epochs * n_steps
          and path is not None and "on the host by" in path.group(1)
          and mode_word in path.group(1))
    if not ok:
        log(f"[host] FAIL: epochs {len(rows)}, finite {finite}, best.ckpt "
            f"{(wdir / 'best.ckpt').exists()}, step {meta['step']}, ema_updates "
            f"{meta['ema_updates']} (want {epochs * n_steps}), host {mode_word}")
        return False, 0
    if surface:
        ok = surface_train_outputs(Path(run_dir.group(1)), bs, img, device) and ok
        ok = diagnostics_cost(recipe, workers_mode, images, dev, bs, epochs, img, wall, rows,
                              out) and ok
    vargs = ["--weights", str(wdir / "best.ckpt"), "--data-cfg", str(data), "-iw", str(img),
             "--batch-size", str(bs), *dev]
    if surface:
        vargs += ["--plot", "--profile", "--n-profile", "20", "--tta", "--dst",
                  str(SURFACE_DIR / "dst")]
    with captured_log() as captured, traced_env(SURFACE_DIR / "val_trace" if surface else None):
        early.early_pipeline.launches = 0  # main path (cli.val in this process): counts from here
        t0 = time.perf_counter()
        result = val.main(vargs)
        launches = early.early_pipeline.launches
    ok = ok and launches > 0 and 0.0 <= result["map50"] <= 1.0
    log(f"[host] last.ckpt: epoch {meta['epoch']}, step {meta['step']}, ema_updates "
        f"{meta['ema_updates']}; python -m ayolov2_torch.cli.val {' '.join(vargs[8:])} on "
        f"best.ckpt (K1, rect): seen {result['seen']} mAP50 {result['map50']:.5f} mAP50-95 "
        f"{result['map50_95']:.5f} in {time.perf_counter() - t0:.1f} s, early_pipeline launches "
        f"{launches} {'ok' if ok else 'FAIL'}")
    if surface:
        ok = surface_val_outputs(captured.getvalue(), device) and ok
        ok2, n = surface_val2(wdir / "best.ckpt", data, img, bs, dev)
        ok, launches = ok and ok2, launches + n
    return ok, launches


def host_aug_phase(step_img_s: float, device: str = "cuda", img: int = 640, bs: int = 32,
                   train_img: Optional[int] = None) -> tuple:
    """Phase 10 (see the module docstring). Returns (ok, K1 launches).
    ``device``, ``img``, ``bs`` and ``train_img`` (the configs' image size)
    shrink it for a rehearsal on the CPU."""
    t0 = time.perf_counter()
    images = write_host_set(HOST_DIR, VAL_DIR)
    ok = thread_equals_process(images, img, 8, workers=4)  # 16 batches: the workers pipeline
    time_host_items(images, img)
    launches = 0
    for recipe, mode, run_bs in (("golden", "thread", None), ("a", "process", bs)):
        ok_run, n = host_entry_point(recipe, mode, images, step_img_s, device, run_bs,
                                     img=train_img, surface=recipe == "a")
        ok, launches = ok and ok_run, launches + n
    log(f"[host] phase 10 in {time.perf_counter() - t0:.1f} s")
    return ok, launches

# ---- phase 11: the shipped surface ----------------------------------------------

SURFACE_DIR = ROOT / "build/chip_smoke_surface"
K1_KERNEL = "early_pipeline_kernel"


@contextlib.contextmanager
def captured_log():
    """The port's log records of the block (level INFO), as text."""
    import io
    import logging

    text = io.StringIO()
    handler = logging.StreamHandler(text)
    root = logging.getLogger()
    level = root.level
    root.addHandler(handler)
    root.setLevel(logging.INFO)
    try:
        yield text
    finally:
        root.removeHandler(handler)
        root.setLevel(level)


@contextlib.contextmanager
def traced_env(target: Optional[Path]):
    """AYOLO_TRACE_DIR set to ``target`` for the block (unset again after)."""
    if target is None:
        yield
        return
    os.environ["AYOLO_TRACE_DIR"] = str(target)
    try:
        yield
    finally:
        del os.environ["AYOLO_TRACE_DIR"]


def trace_events(path: Path) -> list:
    return json.loads(path.read_text())["traceEvents"]


def one_trace(root: Path) -> Optional[Path]:
    found = sorted(root.glob("*.pt.trace.json"))
    return found[0] if len(found) == 1 else None


def kernel_names(path: Path) -> set:
    return {e.get("name", "") for e in trace_events(path) if e.get("cat") == "kernel"}


def png_hw(path: Path) -> Optional[tuple]:
    """(h, w) of a PNG decoded by the port's reader, or None."""
    from ayolov2_torch.utils.png import read_png

    try:
        return tuple(read_png(path).shape[:2])
    except (OSError, ValueError):
        return None


def surface_train_outputs(run_dir: Path, bs: int, img: int, device: str) -> bool:
    """11.1: the plots of a run with ``plot: true`` (labels.png 600x1440, the
    first three batches as mosaics of min(bs, 16) tiles) and its trace
    window of exactly 2 ProfilerStep ranges."""
    ns = int(np.ceil(min(bs, 16) ** 0.5))
    want = {"labels.png": (600, 1440), **{f"train_batch{i}.png": (ns * img, ns * img)
                                          for i in range(3)}}
    got = {name: png_hw(run_dir / name) for name in want}
    trace = one_trace(SURFACE_DIR / "train_trace" / "train")
    steps = sorted(e["name"] for e in trace_events(trace)  # the host's ranges (the card's
                   if e.get("cat") == "user_annotation"    # copies are gpu_user_annotation)
                   and e.get("name", "").startswith("ProfilerStep#")) if trace else []
    kernels = len(kernel_names(trace)) if trace else 0
    ok = got == want and steps == ["ProfilerStep#2", "ProfilerStep#3"] and (
        kernels > 0 or device != "cuda")
    size = trace.stat().st_size / 1e6 if trace else 0.0
    log(f"[surface] 11.1 cli.train with plot: true as shipped: "
        + ", ".join(f"{k} {v}" for k, v in got.items())
        + f"; train trace {trace.name if trace else None} ({size:.1f} MB): {steps}, "
        f"{kernels} kernel names {'ok' if ok else 'FAIL'}")
    return ok


def diagnostics_cost(recipe: str, workers_mode: str, images: Path, dev: list, bs: int,
                     epochs: int, img: int, wall: float, rows: list, out: str) -> bool:
    """11.1's cost: the run of ``host_entry_point`` (``wall`` s, its epoch
    ``rows`` and log ``out``) made again right after it without plots and
    trace window. labels.png is drawn before epoch 0, the mosaics inside
    it; the profiler runs over steps 2-3 and the validation after epoch 0
    (outside the epochs' times), and its trace is written at step 4, epoch
    1's first at 4 steps an epoch. So the two runs' walls and epoch sums
    are compared, not one epoch against another."""
    import re

    cfg_path = shipped_cfg(recipe, epochs, workers_mode, bs, img)  # plot: false
    env = {k: v for k, v in os.environ.items() if not k.startswith("AYOLO_TRACE")}
    proc, plain_wall = run_logged(
        ["-m", "ayolov2_torch.cli.train", "--model", str(GOLDEN), "--data",
         str(HOST_DIR / "data.json"), "--cfg", str(cfg_path), "--log-dir",
         str(HOST_DIR / f"runs_{recipe}_{workers_mode}_plain"), *dev], env=env)
    plain_out = proc.stdout + proc.stderr
    (HOST_DIR / f"train_{recipe}_{workers_mode}_plain.log").write_text(plain_out)
    plain = re.findall(EPOCH_ROW, plain_out)
    plot_s = sum(float(v) for v in re.findall(r"plot \S+ written in ([\d.]+) s", out))
    write_s = sum(float(v) for v in re.findall(r"profiler trace written to \S+ in ([\d.]+) s", out))
    ok = proc.returncode == 0 and len(plain) == len(rows) == epochs and not re.search(
        r"plot \S+ written|profiler trace written", plain_out)
    diag_epochs = [float(r[1]) for r in rows]
    plain_epochs = [float(r[1]) for r in plain]
    added = wall - plain_wall
    log(f"[surface] 11.1 cost: the same cli.train run without plots and trace window, after it: "
        f"exit {proc.returncode} in {plain_wall:.1f} s against {wall:.1f} s; epochs "
        f"{plain_epochs} s against {diag_epochs} s; the diagnostics add {added:.1f} s to the run "
        f"({added / plain_wall * 100:.1f}%) and "
        f"{sum(diag_epochs) - sum(plain_epochs):.1f} s to its epochs; of the run's, plots "
        f"{plot_s:.3f} s, the trace's writing {write_s:.3f} s, the rest (the profiler's slowdown "
        f"of steps 2-3 and epoch 0's validation, and the runs' spread) "
        f"{added - plot_s - write_s:.1f} s {'ok' if ok else 'FAIL'}")
    if not ok:
        log("[surface] " + " | ".join(plain_out.strip().splitlines()[-8:]))
    return ok


def surface_val_outputs(text: str, device: str) -> bool:
    """11.2: ``cli.val --plot --profile --tta --dst`` wrote the curves and the
    confusion matrix under {dst}/val/{DATE}_runs, logged the profile, and
    its val trace names K1's kernel (on the card)."""
    import re

    runs = sorted((SURFACE_DIR / "dst" / "val").glob("*_runs*"))
    want = {"PR_curve.png": (1200, 1800), "F1_curve.png": (1200, 1800),
            "P_curve.png": (1200, 1800), "R_curve.png": (1200, 1800),
            "confusion_matrix.png": (1600, 2000)}
    got = {name: png_hw(runs[-1] / name) if runs else None for name in want}
    profile = re.search(r"Profile: ([\d.]+) ms/image \(batch (\d+), (\d+) runs([^)]*)\)", text)
    trace = one_trace(SURFACE_DIR / "val_trace" / "val")
    names = kernel_names(trace) if trace else set()
    k1 = sorted(n for n in names if K1_KERNEL in n)
    ok = (len(runs) == 1 and got == want and profile is not None
          and trace is not None and (bool(k1) or device != "cuda"))
    log(f"[surface] 11.2 cli.val --plot --profile --tta: {runs[-1].relative_to(ROOT) if runs else None}: "
        + ", ".join(f"{k} {v}" for k, v in got.items())
        + f"; profile {profile.group(0) if profile else None}; val trace "
        f"{trace.name if trace else None}: {len(names)} kernel names, K1's {k1[:1]} "
        f"{'ok' if ok else 'FAIL'}")
    return ok


def surface_val2(weights: Path, data: Path, img: int, bs: int, dev: list) -> tuple:
    """11.5: ``cli.val2 --tta --plot --trace-dir``: its answersheet, the
    per-class report's plots and a trace of the serve loop naming K1's
    kernel. Returns (ok, early_pipeline launches)."""
    from ayolov2_torch.cli import val2
    from ayolov2_torch.ops import early_pipeline as early

    sheet = SURFACE_DIR / "answersheet_tta.json"
    args = ["--weights", str(weights), "--data-cfg", str(data), "-iw", str(img), "--batch-size",
            str(bs), "--tta", "--plot", "--dst", str(SURFACE_DIR / "dst"), "--trace-dir",
            str(SURFACE_DIR / "val2_trace"), "--json-path", str(sheet), *dev]
    early.early_pipeline.launches = 0  # main path (cli.val2 in this process): counts from here
    t0 = time.perf_counter()
    metrics = val2.main(args)
    launches = early.early_pipeline.launches
    wall = time.perf_counter() - t0
    runs = sorted((SURFACE_DIR / "dst" / "val2").glob("*_runs*"))
    pngs = [png_hw(runs[-1] / f"{n}.png") if runs else None
            for n in ("PR_curve", "F1_curve", "P_curve", "R_curve", "confusion_matrix")]
    trace = one_trace(SURFACE_DIR / "val2_trace")
    k1 = sorted(n for n in kernel_names(trace) if K1_KERNEL in n) if trace else []
    preds = json.loads(sheet.read_text()) if sheet.exists() else []
    ok = (bool(preds) and all(pngs) and trace is not None and np.isfinite(metrics["map50"])
          and ((bool(k1) and launches > 0) or "--device" in dev))
    log(f"[surface] 11.5 cli.val2 --tta --plot --trace-dir: {len(preds)} predictions, COCO "
        f"mAP50 {metrics['map50']:.5f} mAP50-95 {metrics['map50_95']:.5f} in {wall:.1f} s; plots "
        f"{pngs}; trace {trace.name if trace else None} names K1's {k1[:1]}; early_pipeline "
        f"launches {launches} {'ok' if ok else 'FAIL'}")
    return ok, launches


def tta_validation(card: str, device: str = "cuda", img_size: int = 640, bs: int = 32) -> tuple:
    """11.3: phase 7's set, bf16: the validator with TTA and K1 on its first
    branch, with TTA on cuDNN, and without TTA (K1), each on a warm pass
    (img/s). Gate: TTA with K1 within 0.02 mAP50 of TTA on cuDNN, one launch
    a batch. Returns (ok, early_pipeline launches of the TTA run)."""
    from ayolov2_torch.data import DataLoader, DetectionDataset
    from ayolov2_torch.eval import YoloValidator
    from ayolov2_torch.ops import early_pipeline as early
    from ayolov2_torch.utils.checkpoint import load_model

    model = load_model(GOLDEN, nc=20, device=device)
    results = {}
    for name, cfg in (("TTA, K1 on the first branch", dict(tta=True)),
                      ("TTA, cuDNN", dict(tta=True, early_pipeline=False)),
                      ("no TTA, K1", {})):
        ds = DetectionDataset(str(VAL_DIR / "images"), img_size=img_size, batch_size=bs,
                              rect=True, pad=0.5)
        v = YoloValidator(model, DataLoader(ds, batch_size=bs), cfg=cfg, device=device)
        v.validation()  # the first pass's set-up (cuDNN plans, grids)
        early.early_pipeline.launches = 0  # main path (this run): counts from here
        t0 = time.perf_counter()
        r = v.validation()
        wall = time.perf_counter() - t0
        r["launches"], r["batches"], r["img_s"] = (early.early_pipeline.launches,
                                                   len(ds.batch_shapes), r["seen"] / wall)
        results[name] = r
    tk, tc, _ = results.values()
    ok = (all(r["seen"] == len(ds) for r in results.values())
          and abs(tk["map50"] - tc["map50"]) <= 0.02 and tk["launches"] == tk["batches"]
          and tc["launches"] == 0)
    log(f"[surface] 11.3 {card}: validation yolov5s bs{bs} rect bf16 on phase 7's "
        f"{tk['seen']} images, warm pass: " + "; ".join(
            f"{k}: mAP50 {r['map50']:.5f} mAP50-95 {r['map50_95']:.5f}, {r['img_s']:.1f} img/s, "
            f"inference {r['t'][1]:.3f} ms per image, early_pipeline launches {r['launches']}"
            for k, r in results.items())
        + f"; TTA with K1 - TTA on cuDNN mAP50 {tk['map50'] - tc['map50']:+.5f} (gate 0.02) "
        f"{'ok' if ok else 'FAIL'}")
    return ok, tk["launches"]


def tta_card_vs_cpu(seed: int, n: int = 8, img: int = 320, card_device: str = "cuda") -> bool:
    """11.4: TTA's decoded predictions of the golden model on the card
    against the CPU, f32 (TF32 off), on ``n`` of phase 7's images
    letterboxed to ``img``: max |d| within 1e-3 of the peak."""
    import torch

    from ayolov2_torch.data import ImageFolderDataset
    from ayolov2_torch.export import make_serving_fn
    from ayolov2_torch.ops.tta import tta_decode
    from ayolov2_torch.utils.checkpoint import load_model

    folder = ImageFolderDataset(str(VAL_DIR / "images"), img_size=img, batch_size=n)
    order = np.random.default_rng(seed).permutation(len(folder))[:n]
    batch = torch.from_numpy(np.stack([folder[int(i)][0] for i in order]))
    card, cpu = (tta_decode(make_serving_fn(load_model(GOLDEN, nc=20, device=device),
                                            image_dtype=torch.float32, early_pipeline=False,
                                            device=device),
                            batch.to(device), torch.float32).cpu()
                 for device in (card_device, "cpu"))
    err = float((card - cpu).abs().max()) / float(cpu.abs().max())
    ok = card.shape == cpu.shape and bool(torch.isfinite(card).all()) and err <= 1e-3
    log(f"[surface] 11.4 TTA decode, golden yolov5s f32, {n} images at {img}: card vs CPU "
        f"{tuple(card.shape)} max|d|/peak {err:.2e} (gate 1e-3) {'ok' if ok else 'FAIL'}")
    return ok


def surface_phase(card: str, seed: int) -> tuple:
    """Phase 11's parts outside phase 10's recipe (a) run (see the module
    docstring). Returns (ok, K1 launches)."""
    t0 = time.perf_counter()
    ok, launches = tta_validation(card)
    ok = tta_card_vs_cpu(seed) and ok
    log(f"[surface] 11.3-11.4 in {time.perf_counter() - t0:.1f} s")
    return ok, launches



# ---- phase 12: the rest of the model zoo and the exported serving graph -------

EXPORT_DIR = ROOT / "build/chip_smoke_export"
ZOO = ("yolov5_v5", "yolov5_mobilevit")


def zoo_cfg(name: str) -> str:
    return str(ROOT / f"res/configs/model/{name}.yaml")


def serve_rate(fn, batch, iters: int = 10) -> float:
    """img/s of ``fn(batch)`` on the host clock after 3 warm calls, the card
    synchronised at both ends."""
    import torch

    for _ in range(3):
        fn(batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(batch)
    torch.cuda.synchronize()
    return batch.shape[0] * iters / (time.perf_counter() - t0)


def zoo_serving(card: str, seed: int, s_rate: float, profile: bool = False) -> bool:
    """12.1: yolov5_v5 and yolov5_mobilevit (nc 80, seeded) served at bs 32,
    640 through ``make_serving_fn``: the cuDNN path (no early-network
    kernel: their layers 0..3 are not the v6 pattern), (32, 100, 6)
    detections, bf16 raw maps against the f32 forward on the card;
    ``profile``: each serve call's breakdown by kernel."""
    import torch

    from ayolov2_torch.export import make_serving_fn
    from ayolov2_torch.ops import early_pipeline as early

    imgs = images_on_card((32, 640, 640, 3), seed + 40)
    ok = True
    for name in ZOO:
        model = seeded_model(zoo_cfg(name), seed)
        serve = make_serving_fn(model)
        early.early_pipeline.launches = 0
        det, cnt = serve(imgs)
        torch.cuda.synchronize()
        launches = early.early_pipeline.launches
        with torch.no_grad():
            want = model(imgs.permute(0, 3, 1, 2).float() / 255.0, training=True)
        errs = [rel_err(a, b)[0] for a, b in zip(serve.raw_maps(imgs), want)]
        rate = serve_rate(serve, imgs)
        ok_m = (not serve.early and launches == 0 and tuple(det.shape) == (32, 100, 6)
                and tuple(cnt.shape) == (32,) and bool(torch.isfinite(det).all())
                and max(errs) < TOL_PEAK)
        log(f"[zoo] {card}: {name} nc 80 ({sum(p.numel() for p in model.parameters()):,} "
            f"params, fused) served bs32 640x640 uint8 -> {tuple(det.shape)}, mean count "
            f"{cnt.float().mean().item():.2f}, early_pipeline launches {launches} (cuDNN path); "
            f"bf16 raw maps vs f32 forward max|d|/peak "
            f"{' '.join(f'{e:.5f}' for e in errs)} (gate {TOL_PEAK}); {rate:.1f} img/s "
            f"(yolov5s with K1: {s_rate:.1f}, phase 6) {'ok' if ok_m else 'FAIL'}")
        ok = ok and ok_m
        if profile:
            profile_serve(serve, imgs, f"{card} {name}")
        del model, serve, want
        torch.cuda.empty_cache()
    return ok


def s2d_stems(card: str, seed: int) -> bool:
    """12.2: yolov5s with its 6x6/s2 stem computed by space-to-depth in each
    mode: raw maps in f32 (TF32 off) at bs 8, 640 within 1e-4 of the peak of
    the plain stem's; the stem (layer 0, bf16 channels_last, BN folded) at
    bs 32, 640 timed each way."""
    import copy

    import torch

    from ayolov2_torch.models import build_model, yolov5_cfg

    model = seeded_model("s", seed)
    sd = model.state_dict()
    x = images_on_card((8, 640, 640, 3), seed + 41).permute(0, 3, 1, 2).float() / 255.0
    xb = (images_on_card((32, 640, 640, 3), seed + 42).permute(0, 3, 1, 2)
          .to(torch.bfloat16) / 255.0).contiguous(memory_format=torch.channels_last)
    ok, times = True, {}
    with torch.no_grad():
        want = model(x, training=True)
        stem = copy.deepcopy(model.model[0]).to(torch.bfloat16, memory_format=torch.channels_last)
        times["plain 6x6/s2 conv"] = time_ms(lambda: stem(xb), 20)
        errs = {}
        for mode in ("reshape", "slice", "im2col"):
            m = build_model(yolov5_cfg("s"), fused=True, s2d_stem=mode, device="cuda")
            m.load_state_dict(sd)
            errs[mode] = max(rel_err(a, b)[0] for a, b in zip(m(x, training=True), want))
            stem = copy.deepcopy(m.model[0]).to(torch.bfloat16,
                                                memory_format=torch.channels_last)
            times[f"s2d {mode}"] = time_ms(lambda: stem(xb), 20)
            ok = ok and errs[mode] < 1e-4
            del m
    log(f"[zoo] yolov5s s2d stem vs the plain stem, f32 bs8 640x640, raw maps max|d|/peak: "
        + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()) + f" (gate 1e-4) "
        f"{'ok' if ok else 'FAIL'}")
    log(f"[time] {card}: yolov5s stem (layer 0: conv + bias + SiLU, bf16 channels_last) bs32 "
        f"640x640: " + ", ".join(f"{k} {v:.4f} ms" for k, v in times.items()))
    torch.cuda.empty_cache()
    return ok


def remat_steps(card: str, seed: int, img: int = 640, bs: int = 64, nc: int = 80,
                iters: int = 4) -> bool:
    """12.3: yolov5s at ``train_config.yaml``'s 640, bs 64, bf16 autocast,
    with ``remat`` off, True and "save_convs": the first micro-step's loss
    items, gradients and BN statistics of each mode against remat off
    (gate: 1e-2 of each delta, as phase 8), then the step's device time and
    peak memory per mode."""
    import torch

    from ayolov2_torch.models import build_model, init_model, yolov5_cfg
    from ayolov2_torch.train.train_state import EMA, finish_step, train_forward

    _, hyp = memorize_hyp(nc, img)
    base = init_model(build_model(yolov5_cfg("s", nc=nc), device="cpu"), seed).state_dict()
    data = [torch.from_numpy(a).cuda()
            for a in drawn_batch(np.random.default_rng(seed + 43), bs, img, nc)]
    runs = {}
    for mode in (False, True, "save_convs"):
        model = build_model(yolov5_cfg("s", nc=nc), device="cpu", remat=mode)
        model.load_state_dict(base)
        model = model.cuda().to(memory_format=torch.channels_last)
        state, loss = train_setup(model, hyp, nc, bs, 1, epochs=300, steps_per_epoch=100)
        sd = state.model.state_dict()
        stat_keys = [k for k in sd if k.endswith(("running_mean", "running_var"))]
        start = [sd[k].detach().clone() for k in stat_keys]
        total, items = train_forward(state.model, loss, *data, torch.bfloat16)
        total.backward()
        grads = [p.grad.detach().clone() for p in state.model.parameters()]
        stats = [state.model.state_dict()[k].detach().clone() for k in stat_keys]
        ema = EMA()
        finish_step(state, ema)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        for _ in range(iters):
            total, _ = train_forward(state.model, loss, *data, torch.bfloat16)
            total.backward()
            finish_step(state, ema)
        ev[1].record()
        torch.cuda.synchronize()
        runs[mode] = dict(items=items.detach().cpu().numpy(), grads=grads, stats=stats,
                          start=start, ms=ev[0].elapsed_time(ev[1]) / iters,
                          peak=torch.cuda.max_memory_allocated() / 1e9)
        del state, model, loss, total
        torch.cuda.empty_cache()
    ref, ok = runs[False], True
    for mode in (True, "save_convs"):
        r = runs[mode]
        item_err = float(np.abs(r["items"] - ref["items"]).max() / np.abs(ref["items"]).max())
        zeros = [torch.zeros_like(g) for g in ref["grads"]]
        g_err = tree_delta_err(r["grads"], ref["grads"], [z.cpu() for z in zeros])
        s_err = tree_delta_err(r["stats"], ref["stats"], [t.cpu() for t in ref["start"]])
        ok_m = item_err < 1e-3 and g_err < 1e-2 and s_err < 1e-2
        ok = ok and ok_m
        log(f"[zoo] remat={mode!r} vs off, yolov5s {img} bs {bs} bf16, first micro-step: loss "
            f"items max rel {item_err:.2e} (gate 1e-3), gradients {g_err:.2e}, BN statistics' "
            f"deltas {s_err:.2e} (gate 1e-2) {'ok' if ok_m else 'FAIL'}")
    log(f"[time] {card}: train micro-step yolov5s {img}x{img} bs {bs} bf16 (forward+loss, "
        f"backward, optimizer+EMA; CUDA events, {iters} steps) and peak memory: "
        + "; ".join(f"remat={m!r} {r['ms']:.3f} ms {r['peak']:.2f} GB" for m, r in runs.items())
        + f"; save_convs / True / off memory {runs['save_convs']['peak'] / ref['peak']:.3f} / "
        f"{runs[True]['peak'] / ref['peak']:.3f}, time {runs['save_convs']['ms'] / ref['ms']:.3f}"
        f" / {runs[True]['ms'] / ref['ms']:.3f}")
    return ok


def nms_forms(card: str, seed: int) -> bool:
    """12.4 (NMS): the greedy suppression as the Python loop (the eager
    default) and as the ``while_loop`` operator (the exported graph's), in
    the yolov5s serve call at bs 32 and bs 128: equal outputs, and each
    form's img/s in turns (loop, operator, operator, loop)."""
    import torch

    from ayolov2_torch.export import make_serving_fn
    from ayolov2_torch.ops import nms

    serve = make_serving_fn(seeded_model("s", seed))
    ok, line = True, []
    for bs in (32, 128):
        imgs = images_on_card((bs, 640, 640, 3), seed + 44 + bs)
        serve.graph_nms = False
        det, cnt = serve(imgs)
        sweeps = nms._greedy_suppress.last_sweeps
        serve.graph_nms = True
        det_g, cnt_g = serve(imgs)
        same = torch.equal(cnt, cnt_g) and torch.equal(det, det_g)
        rates = {False: [], True: []}
        for form in (False, True, True, False):
            serve.graph_nms = form
            rates[form].append(serve_rate(serve, imgs, 8 if bs == 128 else 20))
        ok = ok and same
        line.append(f"bs{bs} ({sweeps} sweeps) equal {'yes' if same else 'NO'}, loop "
                    f"{np.mean(rates[False]):.1f} img/s ({' '.join(f'{r:.1f}' for r in rates[False])}), "
                    f"while_loop {np.mean(rates[True]):.1f} ({' '.join(f'{r:.1f}' for r in rates[True])})")
    serve.graph_nms = False
    log(f"[time] {card}: serve yolov5s 640 with K1, the NMS loop's two forms: " + "; ".join(line)
        + f" {'ok' if ok else 'FAIL'}")
    return ok


def artifact_check(pt2: str, raw_pt2: str, seed: int) -> int:
    """12.4, run as ``python3 -c`` in a fresh interpreter: the exported
    golden checkpoint's artifacts read back by ``load_exported`` against
    ``make_serving_fn`` / ``make_raw_serving_fn`` of the same checkpoint on
    the same batch (counts equal, boxes and scores within 1e-3 of the
    peak), the early-network kernel's launches per artifact call, and both
    calls' img/s at bs 32 in turns. Prints one ``ARTIFACT {json}`` line."""
    import torch

    from ayolov2_torch.export import load_exported, make_raw_serving_fn, make_serving_fn
    from ayolov2_torch.ops import early_pipeline as early
    from ayolov2_torch.utils.checkpoint import load_model

    def det_err(a, b):
        (da, na), (db, nb) = a, b
        if not torch.equal(na, nb):
            return float("inf")
        peak = max(db.abs().max().item(), 1e-3)
        return max((da[i, :n] - db[i, :n]).abs().max().item() if n else 0.0
                   for i, n in enumerate(nb.tolist())) / peak

    out = {}
    early.early_pipeline.launches = 0
    t0 = time.perf_counter()
    call = load_exported(pt2)
    out["load_s"] = time.perf_counter() - t0
    imgs = images_on_card((32, 640, 640, 3), seed + 50)
    got = call(imgs)
    torch.cuda.synchronize()
    out["first_call_launches"] = early.early_pipeline.launches
    model = load_model(GOLDEN, nc=20, device="cuda")
    serve = make_serving_fn(model)
    want = serve(imgs)
    out["counts_equal"] = bool(torch.equal(got[1], want[1]))
    out["mean_count"] = got[1].float().mean().item()
    out["det_err"] = det_err(got, want)
    early.early_pipeline.launches = 0
    for _ in range(5):
        call(imgs)
    torch.cuda.synchronize()
    out["launches_per_call"] = early.early_pipeline.launches / 5
    rates = {"artifact": [], "make_serving_fn": []}
    for name in ("artifact", "make_serving_fn", "make_serving_fn", "artifact"):
        rates[name].append(serve_rate(call if name == "artifact" else serve, imgs, 20))
    out["rates"] = rates
    raw_call = load_exported(raw_pt2)
    frames = images_on_card((32, 720, 1280, 3), seed + 51)
    raw_serve = make_raw_serving_fn(model, (720, 1280), (640, 640))
    out["raw_err"] = det_err(raw_call(frames), raw_serve(frames))
    out["launches"] = early.early_pipeline.launches
    print("ARTIFACT " + json.dumps(out), flush=True)
    return 0


def export_phase(card: str, seed: int, k1_map50: float) -> tuple:
    """12.4: ``python -m ayolov2_torch.cli.export`` of the golden checkpoint
    (bs 32, 640, tpu_nms; and ``--raw-hw 720 1280``), both in parallel;
    :func:`artifact_check` in a fresh interpreter; ``cli.val --weights`` the
    artifact on phase 7's set (square 640 batches of 32, the last padded)
    against the validator over the same loader with ``make_serving_fn`` of
    the checkpoint as its detection function (within 1e-3), phase 7's rect
    run printed beside. Returns (ok, the kernel's launches)."""
    import torch

    from ayolov2_torch.data import DataLoader, DetectionDataset
    from ayolov2_torch.eval import YoloValidator
    from ayolov2_torch.export import make_serving_fn
    from ayolov2_torch.ops import early_pipeline as early
    from ayolov2_torch.utils.checkpoint import load_model

    shutil.rmtree(EXPORT_DIR, ignore_errors=True)
    EXPORT_DIR.mkdir(parents=True)
    common = [sys.executable, "-m", "ayolov2_torch.cli.export", "--weights", str(GOLDEN),
              "--nc", "20", "--batch-size", "32", "-iw", "640", "--type", "tpu_nms"]
    jobs = {"nms": common + ["--out", str(EXPORT_DIR / "golden_tpu_nms")],
            "raw": common + ["--raw-hw", "720", "1280", "--out", str(EXPORT_DIR / "golden_raw")]}
    t0 = time.perf_counter()
    procs = {k: subprocess.Popen(c, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                 text=True) for k, c in jobs.items()}
    ok = True
    for k, proc in procs.items():
        text, _ = proc.communicate(timeout=600)
        tail = [ln for ln in text.splitlines() if ln.strip()][-2:]
        log(f"[export] cli.export {k}: exit {proc.returncode} ({time.perf_counter() - t0:.1f} s "
            f"since both started); " + " | ".join(ln.strip()[:200] for ln in tail))
        ok = ok and proc.returncode == 0
    if not ok:
        return False, 0
    pt2, raw_pt2 = EXPORT_DIR / "golden_tpu_nms.pt2", EXPORT_DIR / "golden_raw.pt2"
    side = json.loads((EXPORT_DIR / "golden_tpu_nms.yaml").read_text())
    log(f"[export] {pt2.name} {pt2.stat().st_size / 1e6:.1f} MB, {raw_pt2.name} "
        f"{raw_pt2.stat().st_size / 1e6:.1f} MB; sidecar platforms {side['platforms']}, "
        f"early_pipeline {side['early_pipeline']}, input {side['input']['shape']}")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", "import sys, chip_smoke; sys.exit(chip_smoke."
                           f"artifact_check({str(pt2)!r}, {str(raw_pt2)!r}, {seed}))"],
                          cwd=ROOT, capture_output=True, text=True, timeout=600)
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("ARTIFACT ")]
    if proc.returncode != 0 or not lines:
        log(f"[export] artifact check: exit {proc.returncode}; "
            + " | ".join((proc.stdout + proc.stderr).splitlines()[-6:]))
        return False, 0
    a = json.loads(lines[-1][len("ARTIFACT "):])
    ok_a = (side["early_pipeline"] and a["counts_equal"] and a["det_err"] < 1e-3
            and a["first_call_launches"] == 1 and a["launches_per_call"] == 1
            and a["raw_err"] < 1e-3)
    rates = {k: float(np.mean(v)) for k, v in a["rates"].items()}
    log(f"[export] {card}: the .pt2 read in a fresh interpreter ({a['load_s']:.1f} s) vs "
        f"make_serving_fn of the checkpoint, bs32 640: counts equal "
        f"{'yes' if a['counts_equal'] else 'NO'} (mean {a['mean_count']:.2f}), max|d|/peak "
        f"{a['det_err']:.2e} (gate 1e-3); early_pipeline launches on the first call "
        f"{a['first_call_launches']}, per call {a['launches_per_call']:.1f} (gate 1); raw frames "
        f"720x1280 vs make_raw_serving_fn max|d|/peak {a['raw_err']:.2e} (gate 1e-3); "
        f"{time.perf_counter() - t0:.1f} s {'ok' if ok_a else 'FAIL'}")
    log(f"[time] {card}: the exported call {rates['artifact']:.1f} img/s "
        f"({' '.join(f'{r:.1f}' for r in a['rates']['artifact'])}) vs make_serving_fn "
        f"{rates['make_serving_fn']:.1f} ({' '.join(f'{r:.1f}' for r in a['rates']['make_serving_fn'])}),"
        f" yolov5s golden bs32 640, K1 in both, in turns")
    launches = int(a["launches"])

    out = EXPORT_DIR / "val.json"
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "ayolov2_torch.cli.val", "--weights", str(pt2),
                           "--data-cfg", str(VAL_DIR / "data.json"), "--json-path", str(out)],
                          cwd=ROOT, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        log(f"[export] cli.val of the artifact: exit {proc.returncode}; "
            + " | ".join((proc.stdout + proc.stderr).splitlines()[-4:]))
        return False, launches
    art = json.loads(out.read_text())
    ds = DetectionDataset(str(VAL_DIR / "images"), img_size=640, batch_size=32, rect=False,
                          stride=32)
    serve = make_serving_fn(load_model(GOLDEN, nc=20, device="cuda"))
    early.early_pipeline.launches = 0  # the in-process run: counts from here
    same = YoloValidator(None, DataLoader(ds, batch_size=32, pad_final_batch=True),
                         cfg={"nc": 20}, detection_fn=serve, device="cuda").validation()
    launches += early.early_pipeline.launches
    ok_v = (art["seen"] == same["seen"] == len(VAL_SIZES) * 32
            and abs(art["map50"] - same["map50"]) <= 1e-3
            and abs(art["map50_95"] - same["map50_95"]) <= 1e-3)
    log(f"[export] cli.val --weights {pt2.name} on phase 7's set ({time.perf_counter() - t0:.1f} "
        f"s): seen {art['seen']}, mAP50 {art['map50']:.5f} mAP50-95 {art['map50_95']:.5f}; the "
        f"validator over the same square batches with make_serving_fn (K1) as detection_fn: "
        f"{same['map50']:.5f} / {same['map50_95']:.5f} (gate 1e-3); phase 7's K1 run (rect "
        f"batches, every class of a box) {k1_map50:.5f}, {art['map50'] - k1_map50:+.5f} "
        f"{'ok' if ok_v else 'FAIL'}")
    del serve
    torch.cuda.empty_cache()
    return ok and ok_a and ok_v, launches


def simclr_embedding(seed: int) -> bool:
    """12.5: the classification graph (``simclr.yaml``: GAP, Flatten, two
    Linear) at bs 8, 320, f32, card against CPU (1e-4 of the peak)."""
    import copy

    import torch

    model = seeded_model(zoo_cfg("simclr"), seed)
    cpu = copy.deepcopy(model).cpu()
    x = np.random.default_rng(seed + 45).integers(0, 256, (8, 320, 320, 3), dtype=np.uint8)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).float() / 255.0
    with torch.no_grad():
        got, want = model(xt.cuda()), cpu(xt)
    peak, _, _ = rel_err(got.cpu(), want)
    ok = tuple(got.shape) == (8, 128) and bool(torch.isfinite(got).all()) and peak < 1e-4
    log(f"[zoo] simclr.yaml embedding {tuple(got.shape)} bs8 320x320 f32, card vs CPU "
        f"max|d|/peak {peak:.2e} (gate 1e-4) {'ok' if ok else 'FAIL'}")
    return ok


def zoo_phase(card: str, seed: int, s_rate: float, k1_map50: float,
              profile: bool = False) -> tuple:
    """Phase 12 (see the module docstring). Returns (ok, early_pipeline
    launches of the export path)."""
    import torch

    t0 = time.perf_counter()
    checks = [("12.1 zoo serving", lambda: zoo_serving(card, seed, s_rate, profile)),
              ("12.2 s2d stem", lambda: s2d_stems(card, seed)),
              ("12.3 zoo training", lambda: all(card_vs_cpu(card, seed, cfg=zoo_cfg(n), steps=2,
                                                            bf16=False) for n in ZOO)),
              ("12.3 remat", lambda: remat_steps(card, seed)),
              ("12.4 NMS forms", lambda: nms_forms(card, seed))]
    for name, check in checks:
        t1 = time.perf_counter()
        ok = check()
        torch.cuda.empty_cache()
        log(f"[zoo] {name}: {'ok' if ok else 'FAIL'} ({time.perf_counter() - t1:.1f} s)")
        if not ok:
            return False, 0
    t1 = time.perf_counter()
    ok, launches = export_phase(card, seed, k1_map50)
    log(f"[zoo] 12.4 export: {'ok' if ok else 'FAIL'} ({time.perf_counter() - t1:.1f} s)")
    if not ok:
        return False, launches
    ok = simclr_embedding(seed)
    log(f"[zoo] phase 12 {'ok' if ok else 'FAIL'} in {time.perf_counter() - t0:.1f} s")
    return ok, launches


# ---- phase 13: compression and the post-training tools -------------------------

COMPRESS_DIR = ROOT / "build/chip_smoke_compress"
PLANTED = ("model_4/m0/cv2", "model_6/m0/cv2", "model_8/m0/cv2")


def plant_low_rank(params, paths, rank: int = 8, seed: int = 0) -> None:
    """Rank-``rank`` kernels (seeded) at the JAX module ``paths`` of a
    parameter tree, in place: trained kernels have the low-rank structure
    that the golden checkpoint's memorised ones lack (EVBMF ranks those at
    0-1, and rank 2 misses the loss gate)."""
    rng = np.random.default_rng(seed)
    for path in paths:
        sub = params
        for p in path.split("/"):
            sub = sub[p]
        kh, kw, cin, cout = sub["conv"]["kernel"].shape
        core = rng.standard_normal((kh, kw, rank, rank)) * 0.1
        u_in = np.linalg.qr(rng.standard_normal((cin, rank)))[0]
        u_out = np.linalg.qr(rng.standard_normal((cout, rank)))[0]
        sub["conv"]["kernel"] = np.einsum("hwrs,cr,os->hwco", core, u_in,
                                          u_out).astype(np.float32)


def start_job(name: str, args: list, root: Path = COMPRESS_DIR, tag: str = "compress",
              group: bool = False) -> tuple:
    """A ``python -m`` subprocess in the background, its output to
    ``root/{name}.log``; returns (name, Popen, log path, start, tag). With
    ``group`` it leads a process group of its own (see :func:`stop_jobs`)."""
    path = root / f"{name}.log"
    fh = open(path, "w")
    proc = subprocess.Popen([sys.executable, *args], cwd=ROOT, stdout=fh,
                            stderr=subprocess.STDOUT, text=True, start_new_session=group)
    fh.close()
    return name, proc, path, time.perf_counter(), tag


def finish_job(job, timeout: int = 600) -> tuple:
    """(ok, log text) of a job from :func:`start_job`, waited for."""
    name, proc, path, t0, tag = job
    rc = proc.wait(timeout=timeout)
    text = path.read_text()
    tail = [ln for ln in text.splitlines() if ln.strip()][-2:]
    log(f"[{tag}] job {name}: exit {rc}, waited for {time.perf_counter() - t0:.1f} s from its "
        f"start; "
        + " | ".join(ln.strip()[:200] for ln in tail))
    return rc == 0, text


def phase7_batches(n: int, bs: int = 32) -> list:
    """The first ``n`` rect batches (uint8 NHWC) of phase 7's set at 640."""
    from ayolov2_torch.data import DataLoader, DetectionDataset

    ds = DetectionDataset(str(VAL_DIR / "images"), img_size=640, batch_size=bs, rect=True,
                          pad=0.5)
    out = []
    for batch in DataLoader(ds, batch_size=bs):
        out.append(batch.images)
        if len(out) == n:
            break
    return out


def int8_route(card: str, seed: int) -> bool:
    """13.1: the int8 product (``ops/int8_conv.py``: im2col and ``_int_mm``)
    at every distinct quantizable conv of yolov5s at bs 32, 640 and at
    yolov5_v5's Focus conv: the card's int32 accumulators equal the plain
    version's (f64 product on the card) exactly. The epilogue's fma on the
    card against the CPU's (printed)."""
    import torch

    from ayolov2_torch.models import build_model, yolov5_cfg
    from ayolov2_torch.models.layers import QuantConv
    from ayolov2_torch.ops import int8_conv as i8

    shapes = set()

    def record(mod, inp) -> None:
        shapes.add((tuple(inp[0].shape[1:]), tuple(mod.q_kernel.shape), mod.stride, mod.pad))

    for name, cfg in (("yolov5s", yolov5_cfg("s", nc=80)), ("yolov5_v5", zoo_cfg("yolov5_v5"))):
        model = build_model(cfg, fused=True, quant=True, device="cuda")
        hooks = [m.register_forward_pre_hook(record) for mname, m in model.named_modules()
                 if isinstance(m, QuantConv) and (name == "yolov5s" or mname == "model.0.conv.conv")]
        with torch.no_grad():
            model(torch.zeros((1, 3, 640, 640), device="cuda"), training=True)
        for h in hooks:
            h.remove()
        del model
    rng = np.random.default_rng(seed + 70)
    ok = True
    before = i8.int8_matmul.launches
    for chw, kshape, s, p in sorted(shapes):
        c, h, w = chw
        x = torch.from_numpy(rng.integers(-127, 128, (32, h, w, c), dtype=np.int8)).cuda()
        wq = torch.from_numpy(rng.integers(-127, 128, kshape, dtype=np.int8)).cuda()
        got = i8.int8_conv(x, wq, s, p)
        want = i8.int8_conv(x, wq, s, p, matmul=i8.int8_matmul_ref)
        ok = ok and got.dtype == torch.int32 and torch.equal(got, want)
        del x, want, got
    n_launch = i8.int8_matmul.launches - before
    log(f"[compress] 13.1 int8 route at {len(shapes)} distinct conv shapes (yolov5s's "
        f"quantizable convs at bs32 640 and yolov5_v5's Focus conv, cin 12 -> K 108 padded "
        f"to 112): _int_mm accumulators == the plain f64 product exactly "
        f"{'ok' if ok and n_launch == len(shapes) else 'FAIL'} ({n_launch} _int_mm calls)")
    acc = torch.from_numpy(rng.integers(-2 ** 22, 2 ** 22, (4096, 256), dtype=np.int32))
    scale = torch.from_numpy(rng.uniform(1e-5, 1e-3, 256).astype(np.float32))
    bias = torch.from_numpy(rng.normal(size=256).astype(np.float32))
    same = (i8.dequantize(acc.cuda(), scale.cuda(), bias.cuda()).cpu()
            == i8.dequantize(acc, scale, bias)).float().mean().item()
    log(f"[compress] 13.1 dequantize epilogue: card addcmul vs CPU fma, {same * 100:.4f}% "
        f"of 1048576 values bit-equal (printed, not gated)")
    return ok and n_launch == len(shapes)


def ptq_card_vs_cpu() -> bool:
    """13.2: the golden checkpoint calibrated on 4 batches of phase 7's set
    in f32 (TF32 off) on the card and on the CPU: stats (absmax within 1e-4
    relative, p99.9 within 1e-3) and the same quantized convs. Then the
    card's int8 model (the card's int8 tree) on 8 images: each int8 conv's
    output equal bit for bit to the same conv on the CPU given the card's
    input to it, and the raw maps card vs CPU end to end, gated on 1e-2 of
    the peak or twice what a one-ulp change of the input moves them on the
    CPU, whichever is larger: the int8 net turns float rounding into
    whole-step flips, which grow through its depth."""
    import torch

    from ayolov2_torch.compress.quantize import (
        collect_activation_stats,
        fuse_variables,
        quantize_params,
    )
    from ayolov2_torch.models import build_model
    from ayolov2_torch.models.layers import QuantConv
    from ayolov2_torch.utils.checkpoint import load_variables
    from ayolov2_torch.utils.weights import load_flax_variables

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    variables, meta = load_variables(GOLDEN)
    cfg = json.loads(meta["model_cfg"])
    fused = fuse_variables(variables)
    batches = phase7_batches(4)
    stats, qvars, t = {}, {}, {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        calib = build_model(cfg, nc=20, fused=True, quant="calib", device=dev)
        xs = [torch.from_numpy(b).to(dev).permute(0, 3, 1, 2).float() / 255.0 for b in batches]
        stats[dev] = collect_activation_stats(calib, fused, xs)
        qvars[dev] = quantize_params(fused, stats[dev])
        t[dev] = time.perf_counter() - t0
        del calib, xs

    def leaves(tree, prefix=()):
        out = {}
        for k, v in tree.items():
            out.update(leaves(v, prefix + (k,)) if isinstance(v, dict) else {prefix + (k,): v})
        return out

    g, w = leaves(stats["cuda"]), leaves(stats["cpu"])
    err = {"in_absmax": 0.0, "in_p999": 0.0}
    for key in w:
        err[key[-1]] = max(err[key[-1]], abs(float(g[key]) - float(w[key])) / float(w[key]))
    quant = [{k[:-1] for k in leaves(q["params"]) if k[-1] == "q_kernel"} for q in qvars.values()]
    ok_stats = (g.keys() == w.keys() and err["in_absmax"] <= 1e-4 and err["in_p999"] <= 1e-3
                and quant[0] == quant[1] and len(quant[0]) > 40)
    log(f"[compress] 13.2 PTQ of the golden checkpoint on 4 batches of 32 of phase 7's set, "
        f"f32: {len(w) // 2} convs' stats card vs CPU, max rel |d| absmax "
        f"{err['in_absmax']:.2e} (gate 1e-4) p99.9 {err['in_p999']:.2e} (gate 1e-3); "
        f"quantized convs {len(quant[0])} card / {len(quant[1])} CPU, same set "
        f"{'yes' if quant[0] == quant[1] else 'NO'}; calibration {t['cuda']:.1f} s card, "
        f"{t['cpu']:.1f} s CPU {'ok' if ok_stats else 'FAIL'}")

    models = {dev: load_flax_variables(build_model(cfg, nc=20, fused=True, quant=True,
                                                   device=dev), qvars["cuda"])
              for dev in ("cuda", "cpu")}
    floats = {dev: load_flax_variables(build_model(cfg, nc=20, fused=True, device=dev), fused)
              for dev in ("cuda", "cpu")}
    seen = {}

    def keep(name):
        def hook(mod, inp, out) -> None:
            seen[name] = (inp[0].cpu(), out.cpu())
        return hook

    hooks = [m.register_forward_hook(keep(n)) for n, m in models["cuda"].named_modules()
             if isinstance(m, QuantConv)]
    x = torch.from_numpy(batches[0][:8]).permute(0, 3, 1, 2).float() / 255.0
    x_ulp = torch.nextafter(x, torch.full_like(x, 2.0))
    with torch.no_grad():
        raw_c = [r.cpu() for r in models["cuda"](x.cuda(), training=True)]
        for h in hooks:
            h.remove()
        cpu_mods = dict(models["cpu"].named_modules())
        exact, odd = 0, []
        for n, (inp, out) in seen.items():
            got = cpu_mods[n](inp)
            if torch.equal(got, out):
                exact += 1
            else:
                d = got != out
                odd.append(f"{n}: {int(d.sum())} of {d.numel()} differ, max|d| "
                           f"{(got - out).abs().max().item():.3e}")
        raw_h = models["cpu"](x, training=True)
        raw_u = models["cpu"](x_ulp, training=True)
        f_err = max(rel_err(a.cpu(), b)[0] for a, b in zip(
            floats["cuda"](x.cuda(), training=True), floats["cpu"](x, training=True)))
    card = [rel_err(a, b) for a, b in zip(raw_c, raw_h)]
    ulp = [rel_err(a, b) for a, b in zip(raw_u, raw_h)]
    bound = max(1e-2, 2 * max(u[0] for u in ulp))
    ok_raw = exact == len(seen) == len(quant[0]) and max(c[0] for c in card) <= bound
    log(f"[compress] 13.2 int8 convs given the card's inputs: {exact} of {len(seen)} outputs "
        f"on the CPU equal to the card's bit for bit; int8 raw maps of 8 images card vs CPU "
        f"max|d|/peak {' '.join(f'{c[0]:.2e}' for c in card)} p99.9 "
        f"{' '.join(f'{c[1]:.2e}' for c in card)} (gate {bound:.2e}); the CPU against itself "
        f"with the input one ulp up: max|d|/peak {' '.join(f'{u[0]:.2e}' for u in ulp)} p99.9 "
        f"{' '.join(f'{u[1]:.2e}' for u in ulp)}; the f32 float model card vs CPU "
        f"{f_err:.2e} {'ok' if ok_raw else 'FAIL'}" + "".join(f"; {o}" for o in odd))
    return ok_stats and ok_raw


INT8_MAP50_LOSS = 0.30  # bf16 cuDNN's mAP50 less int8 absmax's on phase 7's set, at most


def int8_validation(card: str, cudnn_map50: float) -> bool:
    """13.3: ``cli.val --int8`` (absmax, p999) on phase 7's set in-process:
    no early-network launch (``serve.early`` False), the int8 product
    launched, absmax mAP50 >= bf16 cuDNN's - INT8_MAP50_LOSS (the JAX
    package's own int8 loses 0.26 of its bf16 mAP50 on this set: its labels
    are the f32 model's detections above one score cut, and this
    memorised checkpoint's int8 scores move across it)."""
    from ayolov2_torch.cli import val
    from ayolov2_torch.ops import early_pipeline as early
    from ayolov2_torch.ops import int8_conv as i8

    ok = True
    for method in ("absmax", "p999"):
        early.early_pipeline.launches = 0
        i8.int8_matmul.launches = 0
        t0 = time.perf_counter()
        r = val.main(["--weights", str(GOLDEN), "--data-cfg", str(VAL_DIR / "data.json"), "-iw",
                      "640", "--batch-size", "32", "--int8", "--calib-method", method])
        k1, n8 = early.early_pipeline.launches, i8.int8_matmul.launches
        ok_m = k1 == 0 and n8 > 0 and r["seen"] == len(VAL_SIZES) * 32
        if method == "absmax":
            ok_m = ok_m and r["map50"] >= cudnn_map50 - INT8_MAP50_LOSS
        log(f"[compress] 13.3 cli.val --int8 --calib-method {method} on phase 7's set: mAP50 "
            f"{r['map50']:.5f} mAP50-95 {r['map50_95']:.5f} (bf16 cuDNN {cudnn_map50:.5f}, "
            f"{r['map50'] - cudnn_map50:+.5f}; gate -{INT8_MAP50_LOSS} for absmax); "
            f"early_pipeline launches {k1} (serve.early False), _int_mm calls {n8}; "
            f"{time.perf_counter() - t0:.1f} s "
            f"{'ok' if ok_m else 'FAIL'}")
        ok = ok and ok_m
    return ok


def int8_times(card: str) -> bool:
    """13.7, after every other part of the phase (nothing else on the card
    or the host): the probe's forms (3x3, 256 -> 256, 80x80, bs 32; CUDA
    events) and the serve img/s of int8, bf16 cuDNN and bf16 K1 at bs 32
    and 128, 640 (host clock)."""
    import torch

    from ayolov2_torch.cli.probe_int8_conv import probe
    from ayolov2_torch.compress.quantize import quantize_model
    from ayolov2_torch.export import make_serving_fn
    from ayolov2_torch.utils.checkpoint import load_model
    from ayolov2_torch.utils.weights import flax_from_state_dict

    rows = probe(device="cuda")
    ms = {r["metric"]: r["ms"] for r in rows}
    log(f"[time] {card}: int8 probe 3x3 cin=cout=256 80x80 bs32: bf16 cuDNN "
        f"{ms['conv_bf16xbf16_cudnn']:.4f} ms; s8 im2col + _int_mm "
        f"{ms['conv_s8xs8_s32acc_im2col_int_mm']:.4f} ms (the product alone "
        f"{ms['int_mm_s8xs8_s32acc_product_only']:.4f}); the int8 layer (quantize, conv, "
        f"dequantize) {ms['conv_ptq_chain_quant_conv_dequant']:.4f} ms")
    model = load_model(GOLDEN, nc=20, device="cuda")
    xs = [torch.from_numpy(b).cuda().permute(0, 3, 1, 2).to(torch.bfloat16) / 255.0
          for b in phase7_batches(4)]
    qmodel, _ = quantize_model(model.cfg, flax_from_state_dict(model.state_dict()), xs, nc=20,
                               device="cuda")
    serves = {"int8": make_serving_fn(qmodel), "bf16 cuDNN": make_serving_fn(
        model, early_pipeline=False), "bf16 K1": make_serving_fn(model)}
    ok = not serves["int8"].early and serves["bf16 K1"].early
    line = []
    for bs in (32, 128):
        batch = images_on_card((bs, 640, 640, 3), 80 + bs)
        rates = {k: serve_rate(s, batch, 10 if bs == 32 else 4) for k, s in serves.items()}
        line.append(f"bs{bs}: " + ", ".join(f"{k} {v:.1f}" for k, v in rates.items()))
        del batch
    log(f"[time] {card}: serve yolov5s golden 640 uint8 -> (bs, 100, 6), img/s, " +
        "; ".join(line))
    del serves, model, qmodel, xs
    torch.cuda.empty_cache()
    return ok


def int8_artifact_check(pt2: str, seed: int) -> int:
    """13.4, run as ``python3 -c`` in a fresh interpreter: the int8 ``.pt2``
    on a batch against ``make_serving_fn`` of the int8 model rebuilt from
    the artifact's own weights (bit for bit), and the ``_int_mm`` calls in
    its graph. Prints one ``ARTIFACT {json}`` line."""
    import torch

    from ayolov2_torch.export import load_exported, make_serving_fn
    from ayolov2_torch.models import build_model
    from ayolov2_torch.utils.checkpoint import load_variables

    program = torch.export.load(pt2)
    call = load_exported(pt2)
    imgs = images_on_card((32, 640, 640, 3), seed + 60)
    got = call(imgs)
    _, meta = load_variables(GOLDEN)
    model = build_model(json.loads(meta["model_cfg"]), nc=20, fused=True, quant=True,
                        device="cuda")
    state = {k[len("model."):]: v for k, v in program.state_dict.items()
             if k.startswith("model.")}
    model.load_state_dict(state, strict=True)
    serve = make_serving_fn(model)
    want = serve(imgs)
    out = {"equal": bool(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])),
           "mean_count": got[1].float().mean().item(),
           "int_mm_nodes": sum(1 for n in program.graph.nodes if "_int_mm" in str(n.target)),
           "int8_tensors": sum(1 for t in program.state_dict.values() if t.dtype == torch.int8),
           "rate": serve_rate(call, imgs, 10), "rate_in_process": serve_rate(serve, imgs, 10)}
    print("ARTIFACT " + json.dumps(out), flush=True)
    return 0


def int8_export(card: str, seed: int, export_job, sizes_job) -> bool:
    """13.4: ``cli.export --dtype int8 --calib-dir`` (bs 32, 640, phase 7's
    images; run in the background since the phase began), its artifact
    checked in a fresh interpreter, ``cli.val`` of the ``.pt2``, and
    ``cli.artifact_sizes`` (int8 < 0.7 x f32)."""
    ok, _ = finish_job(export_job)
    pt2 = COMPRESS_DIR / "golden_int8.pt2"
    if not ok:
        return False
    side = json.loads(pt2.with_suffix(".yaml").read_text())
    out = COMPRESS_DIR / "val_int8_pt2.json"
    check = start_job("int8_artifact_check", [
        "-c", f"import sys, chip_smoke; sys.exit(chip_smoke.int8_artifact_check({str(pt2)!r}, "
              f"{seed}))"])
    val_job = start_job("val_int8_pt2", [
        "-m", "ayolov2_torch.cli.val", "--weights", str(pt2), "--data-cfg",
        str(VAL_DIR / "data.json"), "--json-path", str(out)])
    ok_c, text = finish_job(check)
    lines = [ln for ln in text.splitlines() if ln.startswith("ARTIFACT ")]
    if not ok_c or not lines:
        return False
    a = json.loads(lines[-1][len("ARTIFACT "):])
    ok_a = (a["equal"] and side["quant"] is True and not side["early_pipeline"]
            and a["int_mm_nodes"] > 40 and a["int8_tensors"] > 40)
    log(f"[compress] 13.4 {pt2.name} ({pt2.stat().st_size / 1e6:.2f} MB, sidecar quant "
        f"{side['quant']}, early_pipeline {side['early_pipeline']}) read in a fresh "
        f"interpreter: equal to make_serving_fn of the int8 model bit for bit "
        f"{'yes' if a['equal'] else 'NO'} (mean count {a['mean_count']:.2f}); _int_mm nodes "
        f"{a['int_mm_nodes']}, int8 tensors {a['int8_tensors']} {'ok' if ok_a else 'FAIL'}")
    log(f"[time] {card}: the int8 artifact {a['rate']:.1f} img/s vs in-process int8 serving "
        f"{a['rate_in_process']:.1f} img/s, bs32 640")
    ok_v, _ = finish_job(val_job)
    ok_v = ok_v and json.loads(out.read_text())["seen"] == len(VAL_SIZES) * 32
    if ok_v:
        r = json.loads(out.read_text())
        log(f"[compress] 13.4 cli.val --weights {pt2.name} on phase 7's set (square 640, "
            f"bs 32): mAP50 {r['map50']:.5f} mAP50-95 {r['map50_95']:.5f} ok")
    ok_s, _ = finish_job(sizes_job)
    sizes = json.loads((COMPRESS_DIR / "artifact_sizes.json").read_text()) if ok_s else None
    ok_s = ok_s and sizes["pt2"]["int8"] < 0.7 * sizes["pt2"]["fp32"]
    if sizes:
        log(f"[compress] 13.4 cli.artifact_sizes (yolov5s golden, 320 px, bs 1, cuda): .pt2 "
            f"bytes f32 {sizes['pt2']['fp32']}, bf16 {sizes['pt2']['bf16']}, int8 "
            f"{sizes['pt2']['int8']}; int8/f32 {sizes['ratios']['int8_vs_fp32']:.4f} "
            f"(gate < 0.7) {'ok' if ok_s else 'FAIL'}")
    return ok_a and ok_v and ok_s


def host_decompositions(planted_params) -> dict:
    """13.5's host side, in a thread from the phase's start: the port's
    ``decompose_model`` at the defaults on the planted tree and on the
    unplanted golden one, and on a plant at ``model_1`` alone."""
    import copy

    from ayolov2_torch.compress import decompose_model
    from ayolov2_torch.utils.checkpoint import load_variables

    out = {}
    t0 = time.perf_counter()
    out["cpu_map"], _, _ = decompose_model(planted_params)
    out["t_cpu"] = time.perf_counter() - t0
    golden_vars, meta = load_variables(GOLDEN)
    t0 = time.perf_counter()
    out["none_map"], _, out["report"] = decompose_model(golden_vars["params"])
    out["t_none"] = time.perf_counter() - t0
    p1 = copy.deepcopy(golden_vars)
    plant_low_rank(p1["params"], ("model_1",), seed=1)
    out["map1"], sub1, _ = decompose_model({"model_1": p1["params"]["model_1"]})
    p1["params"]["model_1"] = sub1["model_1"]
    out["p1"], out["cfg"] = p1, json.loads(meta["model_cfg"])
    return out


def decomposition(card: str, host, decompose_job) -> tuple:
    """13.5: ``cli.decompose_model`` of the golden checkpoint with rank-8
    kernels planted at PLANTED (in the background since the phase began):
    its map equal to the port's ``decompose_model`` on the CPU side of this
    process, planted and decomposed mAP50 within 0.01, the decomposed
    checkpoint validated in-process through K1 (one launch per batch), its
    raw maps card vs CPU in f32 (1e-4 of the peak) and ``cli.export`` of it;
    a plant at ``model_1`` serves without K1; the unplanted checkpoint
    decomposes nothing at the defaults. Returns (ok, K1 launches)."""
    import torch

    from ayolov2_torch.cli import val
    from ayolov2_torch.data import DetectionDataset
    from ayolov2_torch.export import make_serving_fn
    from ayolov2_torch.models import build_model
    from ayolov2_torch.ops import early_pipeline as early
    from ayolov2_torch.utils.checkpoint import load_checkpoint, load_model
    from ayolov2_torch.utils.weights import load_flax_variables

    h = host.result()
    cpu_map, none_map, report, map1, p1 = (h["cpu_map"], h["none_map"], h["report"], h["map1"],
                                            h["p1"])
    t_cpu, t_none = h["t_cpu"], h["t_none"]
    m1 = load_flax_variables(build_model(h["cfg"], nc=20, device="cuda", decompose_map=map1),
                             p1).fuse()
    serve1 = make_serving_fn(m1)
    det1, cnt1 = serve1(images_on_card((32, 640, 640, 3), 90))
    ok_1 = (set(map1) == {"model_1"} and not serve1.early and bool(torch.isfinite(det1).all()))
    log(f"[compress] 13.5 the port's decompose_model on this host: planted map {cpu_map} "
        f"({t_cpu:.1f} s); the unplanted golden checkpoint at the defaults: map {none_map}, "
        f"{sum(bool(x.get('skipped')) for x in report['layers'])} of {len(report['layers'])} "
        f"convs skipped ({t_none:.1f} s); a plant at model_1: map {map1}, serve.early "
        f"{serve1.early}, detections {tuple(det1.shape)} mean count "
        f"{cnt1.float().mean().item():.2f} {'ok' if ok_1 and none_map == {} else 'FAIL'}")
    del m1, serve1
    ok, text = finish_job(decompose_job)
    dec = COMPRESS_DIR / "decomposed.ckpt"
    ok_e = ok and "dry run OK" in text and (COMPRESS_DIR / "decomposed_tpu_nms.pt2").exists()
    if not ok:
        return False, 0
    cli_map = {k: tuple(v) for k, v in
               json.loads(load_checkpoint(dec)["meta"]["decompose_map"]).items()}
    summary = json.loads(dec.with_suffix(".args.yaml").read_text())
    d = abs(summary["map50_after"] - summary["map50_before"])
    ok_map = cli_map == cpu_map and set(cli_map) == set(PLANTED) and d <= 0.01
    log(f"[compress] 13.5 cli.decompose_model: map {cli_map} (== this host's "
        f"{'yes' if cli_map == cpu_map else 'NO'}), params {summary['params_before']:,} -> "
        f"{summary['params_after']:,}, mAP50 planted {summary['map50_before']:.5f} decomposed "
        f"{summary['map50_after']:.5f} |d| {d:.5f} (gate 0.01) {'ok' if ok_map else 'FAIL'}")
    ds = DetectionDataset(str(VAL_DIR / "images"), img_size=640, batch_size=32, rect=True,
                          pad=0.5)
    early.early_pipeline.launches = 0  # the decomposed model's in-process validation
    r = val.main(["--weights", str(dec), "--data-cfg", str(VAL_DIR / "data.json"), "-iw", "640",
                  "--batch-size", "32"])
    launches = early.early_pipeline.launches
    ok_k1 = launches == len(ds.batch_shapes) and abs(r["map50"] - summary["map50_after"]) <= 1e-3
    x = torch.from_numpy(phase7_batches(1)[0][:4]).permute(0, 3, 1, 2).float() / 255.0
    raw = {}
    for dev in ("cuda", "cpu"):
        model = load_model(dec, nc=20, device=dev)
        with torch.no_grad():
            raw[dev] = [t.cpu() for t in model(x.to(dev), training=True)]
    errs = [rel_err(a, b)[0] for a, b in zip(raw["cuda"], raw["cpu"])]
    ok_raw = max(errs) <= 1e-4
    log(f"[compress] 13.5 cli.val of the decomposed checkpoint in-process: mAP50 "
        f"{r['map50']:.5f} (cli.decompose_model's {summary['map50_after']:.5f}, gate 1e-3), "
        f"early_pipeline launches {launches} in {len(ds.batch_shapes)} "
        f"batches {'ok' if ok_k1 else 'FAIL'}; f32 raw maps of 4 images card vs CPU max|d|/peak "
        f"{' '.join(f'{e:.2e}' for e in errs)} (gate 1e-4) {'ok' if ok_raw else 'FAIL'}")
    log(f"[compress] 13.5 cli.export of the decomposed checkpoint (bs 32, 640, after "
        f"cli.decompose_model in its process): {'ok' if ok_e else 'FAIL'}")
    return ok_1 and none_map == {} and ok_map and ok_k1 and ok_raw and ok_e, launches


def search_and_swa(card: str, train_job) -> tuple:
    """13.6: ``cli.val_optimizer`` for 3 trials on phase 7's set through K1
    (its study under ``COMPRESS_DIR``), then ``--load-if-exists`` for one
    more; ``cli.create_swa_model -b 2`` on the ``epoch_N.ckpt`` files of the
    2-epoch ``cli.train --use-swa`` run (in the background since the phase
    began) and ``cli.val`` of ``swa.ckpt`` through K1. Returns (ok, K1
    launches)."""
    import re

    from ayolov2_torch.cli import create_swa_model, val, val_optimizer
    from ayolov2_torch.ops import early_pipeline as early
    from ayolov2_torch.utils.checkpoint import load_checkpoint

    store = COMPRESS_DIR / "val_optimizer_study.json"
    store.unlink(missing_ok=True)
    common = ["--weights", str(GOLDEN), "--data-cfg", str(VAL_DIR / "data.json"),
              "--optim-cfg", str(ROOT / "res/configs/cfg/val_optimizer.yaml"),
              "--batch-size", "32", "--storage", str(store)]
    early.early_pipeline.launches = 0  # the search, the SWA validation: counts from here
    t0 = time.perf_counter()
    study = val_optimizer.main(common + ["--n-trials", "3"])
    wall = time.perf_counter() - t0
    launches = early.early_pipeline.launches
    best = study.best_trial
    t0 = time.perf_counter()
    more = val_optimizer.main(common + ["--n-trials", "1", "--load-if-exists", "--base-map50",
                                        "0.5", "--base-time", "1.0"])
    saved = json.loads(store.read_text())
    launches2 = early.early_pipeline.launches - launches
    ok_s = (len(study.completed) == 3 and len(saved["trials"]) == len(more.trials) == 4
            and launches > 0 and launches2 > 0)
    log(f"[compress] 13.6 cli.val_optimizer 3 trials on phase 7's set in {wall:.1f} s (with the "
        f"baseline): " + "; ".join(
            f"w {t['params']['img_width']} conf {t['params']['conf_thr']:.3f} iou "
            f"{t['params']['iou_thr']:.3f}: mAP50 {t['user_attrs']['map50']:.4f} in "
            f"{t['user_attrs']['time_s']:.3f} s, score {t['value']:.4f}" for t in study.trials)
        + f"; best trial {best['number']}; --load-if-exists: {len(saved['trials'])} trials in "
        f"{store.name} ({time.perf_counter() - t0:.1f} s); early_pipeline launches {launches} + "
        f"{launches2} {'ok' if ok_s else 'FAIL'}")
    ok, text = finish_job(train_job, timeout=900)
    run_dir = re.search(r"Run dir: (\S+)", text)
    if not ok or not run_dir:
        return False, launches + launches2
    wdir = Path(run_dir.group(1)) / "weights"
    epochs = sorted(p.name for p in wdir.glob("epoch_*.ckpt"))
    swa = Path(create_swa_model.main(["-d", str(wdir), "-b", "2"]))
    meta = load_checkpoint(swa)["meta"]
    before = early.early_pipeline.launches
    r = val.main(["--weights", str(swa), "--data-cfg", str(VAL_DIR / "data.json"), "-iw", "320",
                  "--batch-size", "16"])
    k1 = early.early_pipeline.launches - before
    ok_w = len(epochs) == 2 and k1 > 0 and 0.0 <= r["map50"] <= 1.0
    log(f"[compress] 13.6 cli.train --use-swa (2 epochs, 320, from the golden checkpoint) wrote "
        f"{epochs}; cli.create_swa_model -b 2 -> {swa.name} (mean stored mAP50 "
        f"{meta['map50']:.5f}); cli.val of it at 320: mAP50 {r['map50']:.5f} mAP50-95 "
        f"{r['map50_95']:.5f}, early_pipeline launches {k1} {'ok' if ok_w else 'FAIL'}")
    return ok_s and ok_w, launches + launches2 + k1


def relay_job(job) -> bool:
    """A job running a phase's function: waited for, its own log lines
    printed here; ok when it exited 0."""
    ok, text = finish_job(job)
    for line in text.splitlines():
        if line.startswith(("[compress]", "[time]")):
            log(line)
    return ok


def compress_phase(card: str, seed: int, cudnn_map50: float) -> tuple:
    """Phase 13 (see the module docstring). Its longest parts start
    together at the phase's start and run beside 13.1 and 13.3: as
    background processes 13.2 (``ptq_card_vs_cpu``), ``cli.export --dtype
    int8``, ``cli.artifact_sizes``, ``cli.decompose_model`` of the planted
    checkpoint followed by ``cli.export`` of its result, and ``cli.train
    --use-swa``; 13.5's host decompositions in a thread. Returns (ok,
    early_pipeline launches of the decomposed and search paths)."""
    import concurrent.futures
    import copy

    import torch

    from ayolov2_torch.utils.checkpoint import load_variables, write_checkpoint

    t0 = time.perf_counter()
    shutil.rmtree(COMPRESS_DIR, ignore_errors=True)
    COMPRESS_DIR.mkdir(parents=True)
    golden_vars, meta = load_variables(GOLDEN)
    planted = copy.deepcopy(golden_vars)
    plant_low_rank(planted["params"], PLANTED)
    planted_ckpt = COMPRESS_DIR / "planted.ckpt"
    write_checkpoint(planted_ckpt, {"meta": meta, "model": planted, "ema": planted})
    data, cfg2 = write_train_files(COMPRESS_DIR / "swa", VAL_DIR / "images", 2, 320, 16)
    decomposed = COMPRESS_DIR / "decomposed.ckpt"
    decompose_args = ["--weights", str(planted_ckpt), "--data-cfg", str(VAL_DIR / "data.json"),
                      "-iw", "640", "--batch-size", "32", "--out", str(decomposed)]
    export_args = ["--weights", str(decomposed), "--nc", "20", "--batch-size", "32", "-iw", "640",
                   "--out", str(COMPRESS_DIR / "decomposed_tpu_nms")]
    jobs = {
        "ptq": start_job("ptq_card_vs_cpu", [
            "-c", "import sys, chip_smoke; sys.exit(0 if chip_smoke.ptq_card_vs_cpu() else 1)"]),
        "export": start_job("export_int8", [
            "-m", "ayolov2_torch.cli.export", "--weights", str(GOLDEN), "--nc", "20",
            "--batch-size", "32", "-iw", "640", "--dtype", "int8", "--calib-dir",
            str(VAL_DIR / "images"), "--calib-batches", "4", "--out",
            str(COMPRESS_DIR / "golden_int8")]),
        "sizes": start_job("artifact_sizes", [
            "-m", "ayolov2_torch.cli.artifact_sizes", "--out",
            str(COMPRESS_DIR / "artifact_sizes.json")]),
        # cli.decompose_model, then cli.export of what it wrote, in one process
        "decompose": start_job("decompose_model", ["-c", (
            "import logging, sys; logging.basicConfig(level=logging.INFO, format='%(message)s', "
            "stream=sys.stdout); from ayolov2_torch.cli import decompose_model, export; "
            f"decompose_model.main({decompose_args!r}); export.main({export_args!r})")]),
        "train": start_job("train_swa", [
            "-m", "ayolov2_torch.cli.train", "--model", str(GOLDEN), "--cfg", str(cfg2),
            "--data", str(data), "--log-dir", str(COMPRESS_DIR / "runs"), "--use-swa"]),
    }
    pool = concurrent.futures.ThreadPoolExecutor(1)
    host = pool.submit(host_decompositions, planted["params"])
    steps = [("13.1 int8 route", lambda: int8_route(card, seed)),
             ("13.3 int8 validation", lambda: int8_validation(card, cudnn_map50)),
             ("13.4 int8 export", lambda: int8_export(card, seed, jobs["export"], jobs["sizes"])),
             ("13.5 decomposition", lambda: decomposition(card, host, jobs["decompose"])),
             ("13.2 PTQ card vs CPU", lambda: relay_job(jobs["ptq"])),
             ("13.6 search and SWA", lambda: search_and_swa(card, jobs["train"])),
             ("13.7 times", lambda: int8_times(card))]
    ok, launches = True, 0
    for name, step in steps:
        t1 = time.perf_counter()
        out = step()
        if isinstance(out, tuple):
            out, n = out
            launches += n
        torch.cuda.empty_cache()
        log(f"[compress] {name}: {'ok' if out else 'FAIL'} ({time.perf_counter() - t1:.1f} s)")
        ok = ok and bool(out)  # the steps are independent: each runs, any failure fails
    pool.shutdown(wait=True)
    for _, proc, *_ in jobs.values():
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    log(f"[compress] phase 13 {'ok' if ok else 'FAIL'} in {time.perf_counter() - t0:.1f} s")
    return ok, launches


# ---- phase 14: the secondary trainers and tools ---------------------------------

SEC_DIR = ROOT / "build/chip_smoke_secondary"
GOLDEN_CFG = GOLDEN.parent.parent / "model.yaml"
SEC_BUDGET_S = 120.0


def flat_leaves(tree, prefix=()) -> dict:
    """{path: array} of a nested dict of arrays."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat_leaves(v, prefix + (k,)))
        return out
    return {prefix: np.asarray(tree)}


def pt_weights(card: str, k1_map50: float, device: str = "cuda", img: int = 640,
               bs: int = 32) -> tuple:
    """14.1: the golden checkpoint saved as the reference's ``.pt`` (a bare
    kindle state_dict, and ``{"ema": sd, "model": sd}``); ``cli.
    import_torch_weights`` of each gives the golden variables bit for bit;
    ``cli.val --weights x.pt --model-cfg`` runs through K1, one launch a
    batch, to the golden checkpoint's mAP50. Returns (ok, launches)."""
    import torch

    from ayolov2_torch.cli import import_torch_weights, val
    from ayolov2_torch.ops import early_pipeline as early
    from ayolov2_torch.utils.checkpoint import load_variables
    from ayolov2_torch.utils.weights import state_dict_from_flax

    golden, _ = load_variables(GOLDEN)
    want = flat_leaves(golden)
    sd = state_dict_from_flax(golden)
    pts = {"state_dict": SEC_DIR / "golden_sd.pt", "ema/model dict": SEC_DIR / "golden_dict.pt"}
    torch.save(sd, pts["state_dict"])
    torch.save({"epoch": 1499, "ema": sd, "model": sd}, pts["ema/model dict"])
    ok = True
    for name, pt in pts.items():
        out = import_torch_weights.main(["--weights", str(pt), "--model-cfg", str(GOLDEN_CFG),
                                         "--nc", "20", "--out", str(pt.with_suffix(".ckpt"))])
        got = flat_leaves(load_variables(out)[0])
        same = got.keys() == want.keys() and all(np.array_equal(got[k], want[k]) for k in want)
        ok = ok and same
        log(f"[secondary] 14.1 {name} .pt ({pt.stat().st_size / 1e6:.1f} MB) -> "
            f"cli.import_torch_weights -> {Path(out).name}: {len(got)} arrays, "
            f"{'equal to the golden checkpoint bit for bit' if same else 'FAIL: differ'}")
    early.early_pipeline.launches = 0  # the .pt validation: counts from here
    args = ["--weights", str(pts["state_dict"]), "--model-cfg", str(GOLDEN_CFG), "--data-cfg",
            str(VAL_DIR / "data.json"), "-iw", str(img), "--batch-size", str(bs)]
    t0 = time.perf_counter()
    r = val.main(args + (["--device", device] if device != "cuda" else []))
    launches = early.early_pipeline.launches
    batches = -(-r["seen"] // bs)
    same = abs(r["map50"] - k1_map50) <= 1e-9
    ok = ok and same and (launches == batches or device != "cuda")
    log(f"[secondary] 14.1 cli.val --weights golden_sd.pt --model-cfg model.yaml: mAP50 "
        f"{r['map50']:.6f} vs the golden .ckpt's {k1_map50:.6f} ({'equal' if same else 'FAIL'}), "
        f"early_pipeline launches {launches} in {batches} batches, "
        f"{time.perf_counter() - t0:.1f} s")
    return ok, launches


def jax_resume(card: str, seed: int, card_device: str = "cuda") -> bool:
    """14.2: the golden checkpoint's optax state (MultiSteps at accumulate 4)
    resumed into the port's TrainState: counters, nonzero momentum traces,
    the lr and momentum of update 2250; then 2 micro-steps at 320, bs 8, f32
    from that state on the card and on the CPU (the gradients accumulate:
    the window's update comes at the fourth), phase 8's gate on the loss
    items, the summed gradients, the BN statistics and the EMA."""
    import copy

    import torch

    from ayolov2_torch.models import build_model, init_model
    from ayolov2_torch.train.optimizer import make_group_schedules
    from ayolov2_torch.train.train_state import make_train_step
    from ayolov2_torch.train.trainer import scale_hyp_gains
    from ayolov2_torch.utils.checkpoint import load_checkpoint, restore_train_state
    from ayolov2_torch.utils.config import load_yaml

    gcfg = load_yaml(GOLDEN.parent.parent / "cfg.yaml")
    hyp = scale_hyp_gains(dict(gcfg["hyper_params"], label_smoothing=0.0), 3, 20, 320)
    raw = load_checkpoint(GOLDEN)
    inner = raw["optimizer"]["inner_opt_state"]["inner_states"]
    jax_step = int(inner["weight"]["inner_state"]["step"])
    base = init_model(build_model(str(GOLDEN_CFG), nc=20, device="cpu"), seed)
    batch = drawn_batch(np.random.default_rng(seed + 14), 8, 320, 20)
    runs = {}
    for dev in (card_device, "cpu"):
        model = copy.deepcopy(base).to(dev)
        if dev == "cuda":
            model = model.to(memory_format=torch.channels_last)
        state, loss = train_setup(model, hyp, 20, 16, 4, epochs=1500, steps_per_epoch=6)
        state, meta = restore_train_state(GOLDEN, state)
        opt = state.optimizer
        nonzero = sum(int(opt.opt.state[p]["momentum_buffer"].abs().sum() > 0)
                      for p in opt.params)
        start = [t.detach().clone().cpu() for t in ema_parts(state)]
        counters = (opt.updates, opt.mini_step, state.step, state.ema_updates)
        lr_fn, mom_fn = make_group_schedules(
            lr0=0.01, lrf=float(hyp["lrf"]), epochs=1500, steps_per_epoch=1,
            warmup_epochs=3.0, warmup_bias_lr=0.1, warmup_momentum=0.8, momentum=0.937,
            warmup_min_iters=max(60 // 4, 1))
        sched = [(float(opt.lr_fn(opt.updates, g)), float(lr_fn(jax_step, g)))
                 for g in ("weight", "bias", "bn_scale")]
        step = make_train_step(loss, image_dtype=torch.float32)
        data = [torch.from_numpy(a).to(dev) for a in batch]
        items = [step(state, *data).cpu().numpy() for _ in range(2)]
        grads = [p.grad.detach().clone().cpu() for p in opt.params]
        runs[dev] = (state, items, grads, start, counters, nonzero, sched,
                     float(opt.mom_fn(jax_step)))
    (sg, ig, gg, st, cg, nzg, schg, momg), (sc, ic, gc, _, cc, nzc, _, _) = (
        runs[card_device], runs["cpu"])
    item_err = max(float(np.abs(a - b).max() / np.abs(b).max()) for a, b in zip(ig, ic))
    errs = {"summed gradients": tree_delta_err(gg, gc, [torch.zeros_like(g) for g in gc]),
            "BN statistics and EMA": tree_delta_err(ema_parts(sg), ema_parts(sc), st)}
    n_params = len(sg.optimizer.params)
    ok = (cg == cc == (jax_step, 0, int(raw["meta"]["step"]), int(raw["meta"]["ema_updates"]))
          and jax_step == 2250 and nzg == nzc == n_params
          and all(a == b for a, b in schg) and item_err < 1e-4
          and all(e < 1e-2 for e in errs.values())
          and sg.optimizer.mini_step == sc.optimizer.mini_step == 2)
    log(f"[secondary] 14.2 the golden JAX run's optax state resumed: updates {cg[0]} "
        f"(optax step {jax_step}), mini_step {cg[1]}, step {cg[2]}, ema_updates {cg[3]}; "
        f"nonzero momentum traces {nzg}/{n_params}; lr at update {jax_step} "
        + ", ".join(f"{g} {a:.8f}" for g, (a, _) in zip(("weight", "bias", "bn_scale"), schg))
        + f" (the schedule's: equal), momentum {momg:.4f}; 2 micro-steps at 320 bs 8 f32 card "
        f"vs CPU: loss items max rel {item_err:.2e} (gate 1e-4), "
        + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()) + " (gate 1e-2), mini_step "
        f"{sg.optimizer.mini_step} {'ok' if ok else 'FAIL'}")
    return ok


def ema_parts(state) -> list:
    """The BN running statistics of the model, then every float tensor of
    the EMA copy."""
    sd = state.model.state_dict()
    stats = [t for k, t in sd.items() if k.endswith(("running_mean", "running_var"))]
    return stats + [t for t in state.ema_model.state_dict().values() if t.is_floating_point()]


def disk_caches(card: str, device: str = "cuda", img_size: int = 640, bs: int = 32) -> tuple:
    """14.3: phase 7's validation with ``cache_images: disk``, twice: the
    first pass writes ``<image>.ayolo.npy``, the second reads them (the
    files' times do not change); both passes' detections equal the uncached
    pass's exactly (cuDNN deterministic). Returns (ok, launches of the two
    cached passes)."""
    import torch

    from ayolov2_torch.data import DataLoader, DetectionDataset
    from ayolov2_torch.eval import YoloValidator
    from ayolov2_torch.ops import early_pipeline as early
    from ayolov2_torch.utils.checkpoint import load_model

    images = VAL_DIR / "images"
    for f in images.glob("*.ayolo.npy"):
        f.unlink()
    model = load_model(GOLDEN, nc=20, device=device)
    torch.backends.cudnn.deterministic = True
    passes, launches, mtimes = {}, 0, None
    try:
        for name, cache in (("uncached", None), ("disk 1", "disk"), ("disk 2", "disk")):
            ds = DetectionDataset(str(images), img_size=img_size, batch_size=bs, rect=True,
                                  pad=0.5, cache_images=cache)
            v = YoloValidator(model, DataLoader(ds, batch_size=bs), device=device)
            early.early_pipeline.launches = 0
            t0 = time.perf_counter()
            r = v.validation()
            wall = time.perf_counter() - t0
            if cache:
                launches += early.early_pipeline.launches
            dets = [tuple(t.cpu() for t in v.detect(b.images))
                    for b in DataLoader(ds, batch_size=bs)]
            npys = sorted(images.glob("*.ayolo.npy"))
            if name == "disk 1":
                mtimes = [f.stat().st_mtime_ns for f in npys]
            passes[name] = (r, wall, dets, len(npys))
            log(f"[time] {card}: 14.3 validation {name}: {wall:.2f} s for {r['seen']} images "
                f"({r['seen'] / wall:.1f} img/s), mAP50 {r['map50']:.6f}, {len(npys)} .ayolo.npy "
                "files")
        unchanged = mtimes == [f.stat().st_mtime_ns for f in sorted(images.glob("*.ayolo.npy"))]
    finally:
        torch.backends.cudnn.deterministic = False
        for f in images.glob("*.ayolo.npy"):
            f.unlink()
    ref = passes["uncached"]
    ok = unchanged and all(
        p[3] == ref[0]["seen"] and p[0]["map50"] == ref[0]["map50"]
        and all(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]) for a, b in zip(p[2], ref[2]))
        for p in (passes["disk 1"], passes["disk 2"]))
    log(f"[secondary] 14.3 cache_images disk: {passes['disk 1'][3]} files written, read back "
        f"unchanged {unchanged}; detections of both passes equal to the uncached pass's "
        f"{'exactly' if ok else 'FAIL'}")
    return ok, launches


def repr_learning(card: str, seed: int, card_device: str = "cuda", img: int = 320) -> bool:
    """14.4: ``cli.crop_bboxes`` of phase 7's labelled BMPs, then
    ``cli.train_repr`` for 1 epoch with ``train_config_simclr.yaml`` (simclr)
    on ``simclr.yaml`` and ``train_config_repr.yaml`` (base) on
    ``yolov5s_repr.yaml``, as shipped otherwise (320 px; bs 32 and 16);
    finite losses, ``best_e000.ckpt`` and ``last.ckpt``; one step of each
    loss card vs CPU in f32 (phase 8's gate), its views/s."""
    import copy

    import torch

    from ayolov2_torch.cli import crop_bboxes, train_repr
    from ayolov2_torch.models import build_model, init_model
    from ayolov2_torch.train.repr_trainer import RepresentationLearningTrainer
    from ayolov2_torch.utils.config import load_yaml

    crops = SEC_DIR / "crops" / "images"
    t0 = time.perf_counter()
    n = crop_bboxes.main(["--img-dir", str(VAL_DIR / "images"), "--save-dir", str(crops)])
    log(f"[secondary] 14.4 cli.crop_bboxes of phase 7's labelled BMPs: {n} crops of 32 px or "
        f"more ({time.perf_counter() - t0:.1f} s)")
    data = SEC_DIR / "repr_data.json"
    data.write_text(json.dumps({"train_path": str(crops), "val_path": str(crops), "nc": 20}))
    ok = n > 0
    for cfg_name, model_name in (("train_config_simclr.yaml", "simclr.yaml"),
                                 ("train_config_repr.yaml", "yolov5s_repr.yaml")):
        text = (ROOT / "res/configs/cfg" / cfg_name).read_text()
        for a in ("epochs: 30", "epochs: 20"):
            text = text.replace(a, "epochs: 1")
        cfg = SEC_DIR / cfg_name
        cfg.write_text(text)
        t0 = time.perf_counter()
        tr = train_repr.main(["--model", str(ROOT / "res/configs/model" / model_name), "--data",
                              str(data), "--cfg", str(cfg), "--log-dir", str(SEC_DIR / "runs")]
                             + (["--device", card_device] if card_device != "cuda" else []))
        files = sorted(p.name for p in tr.wdir.iterdir())
        good = (files == ["best_e000.ckpt", "last.ckpt"] and np.isfinite(tr.last_items).all()
                and np.isfinite(tr.state_dict.get("val_loss", np.nan)))
        ok = ok and good
        log(f"[time] {card}: 14.4 cli.train_repr {tr.rl_type} ({cfg_name}, {model_name}, bs "
            f"{tr.tcfg['batch_size']} x {tr.tcfg.get('n_trans', 2)} views at "
            f"{tr.tcfg['image_size']}, n_skip {tr.tcfg.get('n_skip', 0)}): "
            f"{tr.state.optimizer.updates} updates, first loss {float(tr.last_items[0]):.5f}, val "
            f"loss {tr.state_dict.get('val_loss', float('nan')):.5f}, {tr.views_per_s:.1f} "
            f"views/s, {time.perf_counter() - t0:.1f} s, {files} {'ok' if good else 'FAIL'}")
    # one step of each loss, card against CPU, f32. AdamW's first update is
    # lr * g / (|g| + eps) per element: the sign of the gradient wherever it
    # is far above eps, so a gradient near 0 moves its parameter by +-lr on
    # one device and -+lr on the other. Its gate is on the gradients; SGD's
    # on the parameters too.
    model_cfg = load_yaml(ROOT / "res/configs/model/simclr.yaml")
    base = init_model(build_model(model_cfg, device="cpu"), seed)
    views = np.random.default_rng(seed + 44).integers(0, 256, (16, img, img, 3), dtype=np.uint8)
    for rl_type in ("simclr", "base"):
        cfg = {"train": {"epochs": 1, "batch_size": 8, "n_trans": 2, "temperature": 0.07},
               "hyper_params": {"optimizer_params": {"lr": 0.01, "momentum": 0.937}}}
        runs = {}
        for dev in (card_device, "cpu"):
            tr = RepresentationLearningTrainer(copy.deepcopy(base), cfg, [None] * 4,
                                               rl_type=rl_type, log_dir=str(SEC_DIR / "step"),
                                               device=dev)
            grads = {}
            for i, p in enumerate(tr.model.parameters()):  # the gradients the step takes
                p.register_post_accumulate_grad_hook(
                    lambda q, i=i: grads.__setitem__(i, q.grad.detach().clone().cpu()))
            items = tr.train_step(torch.from_numpy(views).to(dev)).cpu().numpy()
            runs[dev] = (items, [p.detach().cpu() for p in tr.model.parameters()],
                         [grads[i] for i in sorted(grads)])
        (ig, pg, gg), (ic, pc, gc) = runs[card_device], runs["cpu"]
        item_err = float(np.abs(ig - ic).max() / np.abs(ic).max())
        g_err = tree_delta_err(gg, gc, [torch.zeros_like(g) for g in gc])
        p_err = tree_delta_err(pg, pc, [p.detach() for p in base.parameters()])
        good = item_err < 1e-4 and g_err < 1e-2 and (rl_type == "simclr" or p_err < 1e-2)
        ok = ok and good
        log(f"[secondary] 14.4 one {rl_type} step, simclr.yaml full width, 8 images x 2 views at "
            f"{img}, f32 card vs CPU: loss {float(ig[0]):.6f} vs {float(ic[0]):.6f} (rel "
            f"{item_err:.2e}, gate 1e-4), gradients max|card - cpu| / max|g| {g_err:.2e} (gate "
            f"1e-2), params max|card - cpu| / max|delta| {p_err:.2e} ("
            + ("gate 1e-2" if rl_type == "base" else "AdamW's first step: not gated")
            + f") {'ok' if good else 'FAIL'}")
    return ok


def kept_boxes(dets, score_thr: float = 0.9, min_size: float = 20.0) -> list:
    """The pseudo-labels' cut (the KD trainer's): score above 0.9, both
    sides above 20 px."""
    return [d[(d[:, 4] > score_thr) & (d[:, 2] - d[:, 0] > min_size)
              & (d[:, 3] - d[:, 1] > min_size)] for d in dets]


def box_iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(len(a), len(b)) IoU of xyxy boxes."""
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:4], b[None, :, 2:4])
    inter = np.prod(np.clip(rb - lt, 0, None), -1)
    area = lambda x: np.prod(x[:, 2:4] - x[:, :2], -1)  # noqa: E731
    return inter / (area(a)[:, None] + area(b)[None, :] - inter)


def near_cut(d: np.ndarray, other: np.ndarray, score_thr: float = 0.9, min_size: float = 20.0,
             nms_iou: float = 0.7) -> np.ndarray:
    """Boxes within 0.01 of the score cut, 1 px of the size cut, or 0.02 of
    the NMS cut: a box of their class at IoU 0.68-0.72 in their own set, or
    in ``other`` where that box itself matches one of ``d`` (same class, IoU
    >= 0.9). Which of two such boxes NMS keeps turns on the last bits of the
    boxes; a box of ``other`` that matches none of ``d`` excuses nothing, as
    a box that the kernel had shifted would match none."""
    near = ((np.abs(d[:, 4] - score_thr) < 0.01) | (np.abs(d[:, 2] - d[:, 0] - min_size) < 1)
            | (np.abs(d[:, 3] - d[:, 1] - min_size) < 1))
    if len(d) > 1:
        iou = box_iou(d, d)
        np.fill_diagonal(iou, 0.0)  # not against itself
        near |= ((d[:, None, 5] == d[None, :, 5]) & (np.abs(iou - nms_iou) < 0.02)).any(1)
    if len(d) and len(other):
        mirrored = np.array([matched(o[None], d) for o in other])
        near |= ((d[:, None, 5] == other[None, :, 5]) & mirrored[None, :]
                 & (np.abs(box_iou(d, other) - nms_iou) < 0.02)).any(1)
    return near


def matched(a: np.ndarray, b: np.ndarray, iou_min: float = 0.9) -> bool:
    """Every box of ``a`` has one in ``b`` of its class with IoU >= iou_min."""
    for box in a:
        same = b[b[:, 5] == box[5]]
        if not len(same):
            return False
        lt = np.maximum(box[:2], same[:, :2])
        rb = np.minimum(box[2:4], same[:, 2:4])
        inter = np.prod(np.clip(rb - lt, 0, None), 1)
        union = np.prod(box[2:4] - box[:2]) + np.prod(same[:, 2:4] - same[:, :2], 1) - inter
        if (inter / union).max() < iou_min:
            return False
    return True


def teacher_fn(model, early_on: bool, device: str = "cuda"):
    """The KD trainer's teacher (bf16), with K1 or without."""
    from ayolov2_torch.train.kd_trainer import make_teacher

    return make_teacher(model, device, early_pipeline=early_on)


def detections(serve, images) -> list:
    import torch

    from ayolov2_torch.ops.nms import detections_to_list

    det, n = serve(torch.from_numpy(np.ascontiguousarray(images)).to(serve.device))
    return detections_to_list(det.float().cpu().numpy(), n.cpu().numpy())


def confident_images(model, n: int, seed: int, size: int = 640, device: str = "cuda",
                     steps: int = 200) -> np.ndarray:
    """n synthetic images (``synthetic_image`` from ``seed``) moved by Adam
    on the pixels (lr 4 grey levels) so that the f32 teacher is sure of one
    box of one class on each (class i mod nc for image i): its best
    stride-32 anchor's objectness x that class's probability up, every other
    class's probability there down (sigmoid classes can all saturate, and a
    tie makes the best class a coin toss between two paths), until each
    image's best passes 0.97 with no other class above 0.5, or ``steps``
    end; uint8, rounded. One anchor, not several: neighbouring confident
    boxes overlap near the NMS threshold (IoU 0.7), where two paths may
    keep different ones."""
    import torch

    rng = np.random.default_rng(seed)
    x0 = np.stack([synthetic_image(rng, size, size) for _ in range(n)]).astype(np.float32)
    x = torch.tensor(x0, device=device, requires_grad=True)
    opt = torch.optim.Adam([x], lr=4.0)
    n_last = 3 * (size // 32) ** 2
    nc = model.nc
    target = torch.nn.functional.one_hot(torch.arange(n, device=device) % nc, nc).bool()
    for i in range(steps):
        decoded, _ = model(x.clamp(0, 255).permute(0, 3, 1, 2) / 255.0, training=False)
        last = decoded[:, -n_last:]
        cls = last[..., 5:]
        score = last[..., 4] * cls[target[:, None, :].expand_as(cls)].view(n, -1)
        top, idx = score.topk(1, dim=1)
        others = cls.masked_fill(target[:, None, :], 0.0).amax(-1).gather(1, idx)
        if i % 10 == 0 and top[:, 0].min().item() > 0.97 and others.max().item() < 0.5:
            break
        opt.zero_grad(set_to_none=True)
        (others.mean() - top.mean()).backward()
        opt.step()
    log(f"[secondary] 14.5 confident inputs: {n} synthetic images at {size} moved by Adam on "
        f"the pixels for {i} steps, each toward one class: best score per image min "
        f"{top[:, 0].min().item():.4f}, other classes at those anchors max "
        f"{others.max().item():.4f}")
    return x.detach().clamp(0, 255).round().to(torch.uint8).cpu().numpy()


def unmatched(a: np.ndarray, b: np.ndarray, iou_min: float = 0.9) -> list:
    """The boxes of ``a`` without a box of their class in ``b`` at IoU >=
    iou_min, each with its best IoU in ``b`` over any class."""
    out = []
    for box in a:
        if not matched(box[None], b, iou_min):
            lt = np.maximum(box[:2], b[:, :2])
            rb = np.minimum(box[2:4], b[:, 2:4])
            inter = np.prod(np.clip(rb - lt, 0, None), 1)
            union = np.prod(box[2:4] - box[:2]) + np.prod(b[:, 2:4] - b[:, :2], 1) - inter
            out.append((box.round(3).tolist(), float((inter / union).max()) if len(b) else 0.0))
    return out


def distillation_run(card: str, seed: int, device: str = "cuda", img: int = 640,
                     bs: int = 16) -> tuple:
    """14.5: ``cli.distillation`` with ``distillation.yaml`` as shipped but
    ``epochs: 1``: the golden teacher (yolov5s nc 20, ``--teacher-cfg
    model.yaml``), a yolov5s student at 640, bs 16; labelled and validation
    set phase 7's, unlabeled the same images (or confident inputs drawn for
    the teacher when it keeps none there). Gates, then times. A rehearsal on
    the CPU passes a smaller ``img`` and ``bs``, which the config then
    takes. Returns (ok, early_pipeline launches of the run and of cli.val of
    its best.ckpt)."""
    import copy

    import torch

    from ayolov2_torch.cli import distillation, val
    from ayolov2_torch.data import DataLoader, DetectionDataset
    from ayolov2_torch.models import build_model, init_model, yolov5_cfg
    from ayolov2_torch.ops import early_pipeline as early
    from ayolov2_torch.train.kd_trainer import make_kd_step
    from ayolov2_torch.utils.checkpoint import load_checkpoint, load_model

    teacher = load_model(GOLDEN, nc=20, device=device)
    k1_teacher, cudnn_teacher = teacher_fn(teacher, True, device), teacher_fn(teacher, False,
                                                                             device)
    ds = DetectionDataset(str(VAL_DIR / "images"), img_size=img, batch_size=bs)
    phase7 = [b.images for b in DataLoader(ds, batch_size=bs)]
    on_phase7 = sum(len(k) for b in phase7 for k in kept_boxes(detections(k1_teacher, b)))
    unlabeled = ""
    if on_phase7 == 0:
        unl = SEC_DIR / "unlabeled" / "images"
        unl.mkdir(parents=True, exist_ok=True)
        f32 = load_model(GOLDEN, nc=20, device=device).requires_grad_(False)
        for i, im in enumerate(confident_images(f32, 2 * bs, seed + 45, img, device)):
            write_bmp(unl / f"{i:06d}.bmp", np.ascontiguousarray(im))
        del f32
        unlabeled = str(unl)
    log(f"[secondary] 14.5 the golden teacher (bf16, K1) keeps {on_phase7} pseudo-labels above "
        f"0.9 on phase 7's {len(ds)} images; unlabeled set: "
        f"{unlabeled or 'phase 7s images'}")
    text = (ROOT / "res/configs/cfg/distillation.yaml").read_text()
    assert "epochs: 10" in text
    cfg = SEC_DIR / "distillation.yaml"
    text = text.replace("epochs: 10", "epochs: 1")
    if (img, bs) != (640, 16):
        text = text.replace("image_size: 640", f"image_size: {img}").replace(
            "batch_size: 16", f"batch_size: {bs}")
    cfg.write_text(text)
    data = SEC_DIR / "kd_data.json"
    data.write_text(json.dumps({"train_path": str(VAL_DIR / "images"),
                                "val_path": str(VAL_DIR / "images"), "nc": 20,
                                "names": [f"class{i}" for i in range(20)]}))
    args = ["--model", str(ROOT / "res/configs/model/yolov5s.yaml"), "--teacher", str(GOLDEN),
            "--teacher-cfg", str(GOLDEN_CFG), "--data", str(data), "--cfg", str(cfg),
            "--log-dir", str(SEC_DIR / "runs")] + (["--unlabeled-path", unlabeled]
                                                   if unlabeled else [])
    early.early_pipeline.launches = 0  # the KD path: counts from here
    t0 = time.perf_counter()
    tr = distillation.main(args + (["--device", "cpu"] if device == "cpu" else []))
    wall = time.perf_counter() - t0
    launches = early.early_pipeline.launches
    meta = load_checkpoint(tr.wdir / "last.ckpt")["meta"]
    n_steps = len(ds) // bs
    gates = {
        "finite losses": bool(np.isfinite(tr.mean_items).all()),
        f"step = ema_updates = {n_steps} micro-steps": (
            tr.state.step == tr.state.ema_updates == meta["step"] == meta["ema_updates"]
            == n_steps),
        "one K1 launch per pseudo batch": (device != "cuda" or (
            tr.pseudo_launches == [1] * len(tr.pseudo_launches)
            and launches == len(tr.pseudo_launches))),
        "pseudo-labels above 0.9 > 0": sum(tr.pseudo_counts) > 0,
        "best.ckpt and last.ckpt": (tr.wdir / "best.ckpt").exists(),
    }
    log(f"[secondary] 14.5 cli.distillation: {len(tr.pseudo_counts)} pseudo batches made "
        f"(the producer runs ahead), pseudo-labels above 0.9 per batch {tr.pseudo_counts}, "
        f"early_pipeline launches per batch {tr.pseudo_launches} ({launches} in all), mean loss "
        f"labeled {tr.mean_items[3]:.4f} pseudo {tr.mean_items[7]:.4f}, {wall:.1f} s")
    log(f"[time] {card}: 14.5 cli.distillation yolov5s student at {img}, bs {bs}, bf16 teacher "
        f"with K1: {tr.img_per_s:.1f} labelled img/s in its epoch ({n_steps} steps); the "
        f"producer thread made a pseudo batch (teacher, cuts, strong augmentation) in "
        f"{np.median(tr.pseudo_seconds):.3f} s (median; {min(tr.pseudo_seconds):.3f}-"
        f"{max(tr.pseudo_seconds):.3f})")
    # K1 against cuDNN: the unlabeled batches, and (when the teacher keeps
    # few boxes there) confident inputs, so that the comparison has boxes
    unl_ds = DetectionDataset(unlabeled or str(VAL_DIR / "images"), img_size=img, batch_size=bs)
    batches = [b.images for b in DataLoader(unl_ds, batch_size=bs)][:4]
    if on_phase7 < 4 * bs and not unlabeled:
        f32 = load_model(GOLDEN, nc=20, device=device).requires_grad_(False)
        batches.append(confident_images(f32, bs, seed + 47, img, device))
        del f32
    # every box is matched first; a box without a match is excused only
    # within a cut margin (near_cut), and at most a tenth of them may be
    agree, n_boxes, n_kept, n_missed, n_excused = True, 0, 0, 0, 0
    for b in batches:
        a, c = kept_boxes(detections(k1_teacher, b)), kept_boxes(detections(cudnn_teacher, b))
        n_boxes += sum(len(x) for x in a)
        for x, y in zip(a, c):
            n_kept += len(x) + len(y)
            lost = []
            for p, q in ((x, y), (y, x)):
                miss = np.array([not matched(box[None], q) for box in p], bool)
                excused = miss & near_cut(p, q)
                n_missed += int(miss.sum())
                n_excused += int(excused.sum())
                lost += unmatched(p[miss & ~excused], q)
            if lost:
                agree = False
                log(f"[secondary] 14.5 unmatched pseudo-labels (box, best IoU): {lost[:3]}")
    compared = n_kept - n_excused
    good = agree and n_boxes > 0 and compared >= 0.9 * n_kept
    gates["K1 teacher = cuDNN teacher (IoU >= 0.9, same class; a box without a match only "
          "within a score, size or NMS cut margin; 90% of the boxes compared)"] = good
    log(f"[secondary] 14.5 pseudo-labels with K1 vs without on {len(batches)} batches of {bs} "
        f"(the unlabeled set's{' and one of confident inputs' if len(batches) > 4 else ''}): "
        f"{n_boxes} boxes kept with K1, {n_kept - n_boxes} without; {n_missed} of the "
        f"{n_kept} without a match in the other set, {n_excused} of them within a cut margin "
        f"(excused); {compared} compared (gate 90%), every compared box matched "
        f"{'ok' if good else 'FAIL'}")
    early.early_pipeline.launches = 0
    r = val.main(["--weights", str(tr.wdir / "best.ckpt"), "--data-cfg",
                  str(VAL_DIR / "data.json"), "-iw", str(img), "--batch-size", "32"]
                 + (["--device", "cpu"] if device == "cpu" else []))
    val_launches = early.early_pipeline.launches
    gates["cli.val of best.ckpt through K1, mAP50 in [0, 1]"] = (
        0.0 <= r["map50"] <= 1.0 and (device != "cuda" or val_launches == -(-r["seen"] // 32)))
    log(f"[secondary] 14.5 cli.val of the run's best.ckpt: mAP50 {r['map50']:.5f}, "
        f"early_pipeline launches {val_launches}")
    # one KD step at 320, bs 4, f32, card against CPU
    _, hyp = memorize_hyp(20, 320)
    base = init_model(build_model(yolov5_cfg("s", nc=20), nc=20, device="cpu"), seed)
    rng = np.random.default_rng(seed + 46)
    lab, pse = drawn_batch(rng, 4, 320, 20), drawn_batch(rng, 4, 320, 20)
    runs = {}
    for dev in (device, "cpu"):
        model = copy.deepcopy(base).to(dev)
        state, loss = train_setup(model, hyp, 20, 4, 1, epochs=300, steps_per_epoch=100)
        start = [t.detach().clone().cpu() for t in ema_parts(state)]
        params0 = [p.detach().clone().cpu() for p in state.model.parameters()]
        step = make_kd_step(loss, 0.5, image_dtype=torch.float32)
        items = step(state, *(torch.from_numpy(a).to(dev) for a in lab + pse))
        runs[dev] = (np.concatenate([i.cpu().numpy() for i in items]),
                     [p.detach().cpu() for p in state.model.parameters()], ema_parts(state),
                     start, params0)
    (ig, pg, eg, st, p0), (ic, pc, ec, _, _) = runs[device], runs["cpu"]
    item_err = float(np.abs(ig - ic).max() / np.abs(ic).max())
    errs = {"params": tree_delta_err(pg, pc, p0), "BN statistics and EMA":
            tree_delta_err(eg, ec, st)}
    gates["one KD step card = CPU (f32)"] = item_err < 1e-4 and all(
        e < 1e-2 for e in errs.values())
    log(f"[secondary] 14.5 one KD step (labelled + 0.5 pseudo) yolov5s nc 20 at 320, bs 4, f32 "
        f"card vs CPU: loss items max rel {item_err:.2e} (gate 1e-4), "
        + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()) + " (gate 1e-2)")
    if device == "cuda":
        batch = torch.from_numpy(phase7[0]).cuda()
        k1_ms = time_ms(lambda: k1_teacher(batch), 10)
        cudnn_ms = time_ms(lambda: cudnn_teacher(batch), 10)
        student = init_model(build_model(yolov5_cfg("s", nc=20), nc=20, device="cpu"), seed)
        student = student.cuda().to(memory_format=torch.channels_last)
        state, loss = train_setup(student, tr.hyp, 20, bs, tr.accumulate, epochs=1,
                                  steps_per_epoch=n_steps)
        step = make_kd_step(loss, 0.5)
        lab16, pse16 = drawn_batch(rng, bs, img, 20), drawn_batch(rng, bs, img, 20)
        data = [torch.from_numpy(a).cuda() for a in lab16 + pse16]
        step_ms = time_ms(lambda: step(state, *data), 8)
        log(f"[time] {card}: 14.5 teacher pseudo batch (bs {bs}, {img}, bf16, NMS to 64) with K1 "
            f"{k1_ms:.3f} ms, without (cuDNN) {cudnn_ms:.3f} ms; KD micro-step (labelled + "
            f"pseudo forward, backward, optimizer at accumulate {tr.accumulate}, EMA; bf16, bs "
            f"{bs} + {bs} at {img}) {step_ms:.3f} ms")
    log("[secondary] 14.5 gates: " + "; ".join(f"{k} {'ok' if v else 'FAIL'}"
                                              for k, v in gates.items()))
    return all(gates.values()), launches + val_launches


def secondary_phase(card: str, seed: int, k1_map50: float) -> tuple:
    """Phase 14 (see the module docstring): 14.1-14.5 in order, each run
    whatever the others gave. Returns (ok, early_pipeline launches of the
    .pt validation, the cached validations, the KD run and its cli.val)."""
    import torch

    t0 = time.perf_counter()
    shutil.rmtree(SEC_DIR, ignore_errors=True)
    SEC_DIR.mkdir(parents=True)
    ok, launches = True, 0
    steps = [("14.1 .pt weights", lambda: pt_weights(card, k1_map50)),
             ("14.2 JAX run resumed", lambda: jax_resume(card, seed)),
             ("14.3 disk caches", lambda: disk_caches(card)),
             ("14.4 representation learning", lambda: repr_learning(card, seed)),
             ("14.5 distillation", lambda: distillation_run(card, seed))]
    for name, step in steps:
        t1 = time.perf_counter()
        out = step()
        if isinstance(out, tuple):
            out, n = out
            launches += n
        torch.cuda.empty_cache()
        log(f"[secondary] {name}: {'ok' if out else 'FAIL'} ({time.perf_counter() - t1:.1f} s)")
        ok = ok and bool(out)
    log(f"[secondary] phase 14 {'ok' if ok else 'FAIL'} in {time.perf_counter() - t0:.1f} s "
        f"(budget {SEC_BUDGET_S:.0f} s)")
    return ok, launches



# ---- phase 15: K1 at every width: the width-1.05 config on the card -------------

WIDTHS_DIR = ROOT / "build/chip_smoke_widths"
WIDE = "1.05"


def damp_residuals(model, factor: float = 0.3) -> int:
    """Scale the BN of the last conv of every residual bottleneck branch of
    a seeded, unfused ``model`` by ``factor``: x + f(x) then adds about
    ``factor``^2 of x's variance, not as much again. A trained network's BN
    keeps its activations bounded; a seeded one of depth 1.5 (27 residual
    blocks before the head) otherwise doubles their variance a block, to an
    rms near 1e6 with heavy tails at the head, whose logits then saturate
    (boxes of no size and full confidence). Returns the branches damped."""
    import torch

    from ayolov2_torch.models.layers import Bottleneck

    n = 0
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, Bottleneck) and m.add:
                m.cv2.bn.weight.mul_(factor)
                m.cv2.bn.bias.mul_(factor)
                n += 1
    return n


def shape_head(model, seed: int, size: int = 800, per_level: float = 2.0) -> list:
    """Shape the head of a seeded, unfused ``model`` as a trained detector's
    is shaped, measured on 2 seeded images at ``size``: each level's
    objectness has its drawn spread and a bias that leaves about
    ``per_level`` boxes an image above a score of 0.06; one class is sure
    (its logits centred on 2, sigmoid 0.88) and the others keep their prior,
    their logits spread a third as much; box sizes 1.4-2.7 anchors (their logits +1).
    A random head ranks boxes by objectness times a class score of no
    meaning, puts as many confident boxes wholly in the letterbox's padding
    as anywhere and sizes them at random: the self-labelling of phase 7 then
    finds no score cut, and the objectness prefilter of the fused path drops
    boxes that the plain path keeps. Returns each level's feature rms."""
    import statistics

    import torch

    head = model.head
    feats = []
    hook = head.register_forward_pre_hook(lambda mod, args: feats.append(args[0]))
    with torch.no_grad():
        model(images_on_card((2, size, size, 3), seed).permute(0, 3, 1, 2).float() / 255.0,
              training=True)
        hook.remove()
        found = []
        for conv, f, stride in zip(head.m, feats[0], head.strides):
            rms = float(f.float().pow(2).mean().sqrt())
            found.append(rms)
            conv.weight.mul_(0.1 / rms)
            w = conv.weight.view(head.na, head.no, -1)
            b = conv.bias.view(head.na, head.no)
            w[:, 5:] *= 1.0 / 3.0
            b[:, 5] = 2.0 - float(torch.nn.functional.conv2d(
                f.float(), conv.weight.float()).view(f.shape[0], head.na, head.no, -1)[:, :, 5]
                .mean())
            b[:, 2:4] += 1.0
            obj = torch.nn.functional.conv2d(f.float(), conv.weight.float()).view(
                f.shape[0], head.na, head.no, -1)[:, :, 4]
            n_boxes = head.na * (size // int(stride)) ** 2
            z = statistics.NormalDist().inv_cdf(1.0 - per_level / n_boxes)
            target = float(np.log(0.06 / 0.88 / (1 - 0.06 / 0.88)))  # obj of a 0.06 score
            b[:, 4] = target - float(obj.mean()) - z * float(obj.std())
    return found


def wide_checkpoint(model, path: Path, variant: str = WIDE) -> Path:
    """``model`` (unfused, seeded) as a checkpoint of its config (``variant``'s),
    params in bf16 as the trainer writes them, so that the entry points read it."""
    from ayolov2_torch.utils.checkpoint import _variables, write_checkpoint

    v = _variables(model, True)
    meta = {"model_cfg": json.dumps(named_cfg(variant)), "epoch": 0, "step": 0,
            "ema_updates": 0}
    write_checkpoint(path, {"meta": meta, "model": v, "ema": v})
    return path


def wide_artifact_check(pt2: str, ckpt: str, seed: int) -> int:
    """15.4, run as ``python3 -c`` in a fresh interpreter: the width-1.05
    checkpoint's ``.pt2`` read back by ``load_exported`` against
    ``make_serving_fn`` of the model the exporter builds from the checkpoint
    (its variables, BN folded on the CPU) on one bs 16, 800x800 batch, the
    operator's calls and widths in its graph, and the kernel's launches a
    call. Prints one ``ARTIFACT {json}`` line."""
    import torch

    from ayolov2_torch.export import load_exported, make_serving_fn
    from ayolov2_torch.models import build_model
    from ayolov2_torch.ops import early_pipeline as early
    from ayolov2_torch.utils.checkpoint import load_variables
    from ayolov2_torch.utils.weights import state_dict_from_flax

    program = torch.export.load(pt2)
    calls = [n for n in program.graph.nodes
             if n.target == torch.ops.ayolov2.early_pipeline.default]
    call = load_exported(pt2)
    imgs = images_on_card((16, 800, 800, 3), seed + 70)
    early.early_pipeline.launches = 0
    got = call(imgs)
    torch.cuda.synchronize()
    launches = early.early_pipeline.launches
    # the model as the exporter builds it (the checkpoint's variables, BN folded on the CPU)
    variables, meta = load_variables(ckpt, prefer_ema=True)
    model = build_model(json.loads(meta["model_cfg"]), device="cpu")
    model.load_state_dict(state_dict_from_flax(variables), strict=True)
    want = make_serving_fn(model.fuse(), device="cuda")(imgs)
    (dg, ng), (dw, nw) = got, want
    peak = max(dw.abs().max().item(), 1e-3)
    det_err = (max((dg[i, :n] - dw[i, :n]).abs().max().item() if n else 0.0
                   for i, n in enumerate(nw.tolist())) / peak
               if torch.equal(ng, nw) else float("inf"))
    out = {"op_calls": len(calls), "op_args": [a for a in calls[0].args[2:]] if calls else [],
           "launches_per_call": launches, "counts_equal": bool(torch.equal(ng, nw)),
           "det_err": det_err, "equal": bool(torch.equal(dg, dw) and torch.equal(ng, nw)),
           "mean_count": ng.float().mean().item()}
    print("ARTIFACT " + json.dumps(out), flush=True)
    return 0


def k1_against_plain(variant: str, ep, bs: int, h: int, w: int, seed: int) -> tuple:
    """The kernel against its plain version at one shape: (ok, max|d|)."""
    import torch

    from ayolov2_torch.ops import early_pipeline as early

    imgs = images_on_card((bs, h, w, 3), seed + h + w)
    before = early.early_pipeline.launches
    got = early.early_pipeline(imgs, ep)
    torch.cuda.synchronize()
    want = early.early_pipeline_ref(imgs, ep)
    peak, p999, mx = rel_err(got, want)
    ok = (got.shape == want.shape and bool(torch.isfinite(got.float()).all())
          and peak < TOL_PEAK and p999 < TOL_P999 and early.early_pipeline.launches == before + 1)
    plan = early.kernel_plan(ep)
    log(f"[widths] 15.1 {model_name(variant)} {ep.widths[:4]} n {ep.n} (padded "
        f"{early.padded_widths(*ep.widths[:4])}) bs{bs} {h}x{w} tile {plan.th}x{plan.tw} "
        f"bands of {plan.rb} smem {plan.total} B: max|d|/peak {peak:.5f} p99.9 {p999:.5f} "
        f"max|d| {mx:.4f} (gate {TOL_PEAK}/{TOL_P999}) {'ok' if ok else 'FAIL'}")
    return ok, mx


def k1_times(card: str, variant: str, ep, fused_state, imgs) -> dict:
    """The kernel, its plain version and the cuDNN chain of the same layers
    (the faster stem width, ``cudnn.benchmark``) at one batch, beside the
    bound and the tile (CUDA events, after warm-up)."""
    import torch

    from ayolov2_torch.ops import early_pipeline as early

    plan = early.kernel_plan(ep)
    ms = time_ms(lambda: early.early_pipeline(imgs, ep), 10)
    plain = time_ms(lambda: early.early_pipeline_ref(imgs, ep), 3, warmup=1)
    torch.backends.cudnn.benchmark = True
    try:
        chain = min(time_ms(lambda: c(imgs), 10) for c in
                    (cudnn_chain(fused_state, k) for k in (3, 8)))
    finally:
        torch.backends.cudnn.benchmark = False
    bound, by, flops, nbytes = bound_of(ep, imgs.shape[:3])
    bs, h, w = imgs.shape[:3]
    log(f"[time] {card}: early_pipeline {model_name(variant)} bs{bs} {h}x{w} tile "
        f"{plan.th}x{plan.tw} (halo factor {plan.halo:.3f}, bands of {plan.rb}): kernel "
        f"{ms:.4f} ms, bound {bound:.4f} ms ({by}: {flops / 1e9:.1f} GFLOP, "
        f"{nbytes / 1e6:.1f} MB), {ms / bound:.1f}x; plain {plain:.4f} ms; cuDNN chain "
        f"{chain:.4f} ms (the faster stem width, cudnn.benchmark)")
    return {"ms": ms, "plain_ms": plain, "bound_ms": bound, "bound_by": by, "library_ms": chain}


def widths_phase(card: str, seed: int) -> tuple:
    """Phase 15: K1 at the widths of ``yolov5_depth1.5_width1.05_800.yaml``
    (stem 72, conv1 136, C3 68 x 4, conv2 272; padded 80/144/80/288) and of a
    stem of 8 (yolov5s at width 0.125; padded 16/16/16/32), nc 80, seeded
    weights. 15.1 the kernel against its plain version (phase 3's gate):
    the 1.05 config at bs 4, 800 and 640, a ragged shape at its 2x2 tile;
    the stem-8 model at bs 4, 640 and ragged at its tile. 15.2
    ``make_serving_fn`` of the 1.05 config at bs 16, 800x800: (16, 100, 6)
    and counts, one launch a call (counted from 0 around 3 calls), raw maps
    per level against the cuDNN path (max|d|/peak < 0.03); the stem-8 model
    served at bs 4, 640 the same way (and the same against the f32 path after
    layer 3). 15.3 phase 7's 128 BMPs at -iw 800,
    labelled by this checkpoint's f32 plain path, under phase 7's gates
    (the kernel's bf16 run against bf16 cuDNN, one launch a batch; ``python
    -m ayolov2_torch.cli.val`` equal to the in-process run). 15.4
    ``cli.export`` of the checkpoint (bs 16, 800): the operator in the
    ``.pt2`` with the widths, read back in a fresh interpreter equal bit for
    bit to ``make_serving_fn`` of the model the exporter builds, one launch
    a call. 15.5 times: K1 at bs
    16, 800 and bs 8, 640 for the 1.05 set, bs 8, 640 for stem 8, each beside
    its bound, tile, plain version and cuDNN chain; the serve rate at bs 16,
    800. Returns (ok, {set: its kernels-line entry})."""
    import torch

    from ayolov2_torch.export import make_serving_fn
    from ayolov2_torch.ops import early_pipeline as early

    t_phase = time.perf_counter()
    shutil.rmtree(WIDTHS_DIR, ignore_errors=True)
    WIDTHS_DIR.mkdir(parents=True)
    models = {v: seeded_model(v, seed + 15, fuse=False) for v in (WIDE, STEM8)}
    for v, m in models.items():
        damped = damp_residuals(m)
        found = shape_head(m.eval(), seed + 16)
        log(f"[widths] {model_name(v)}: {damped} residual branches damped x0.3; the head reads "
            f"features of rms {', '.join(f'{r:.3f}' for r in found)} and is shaped as a "
            f"trained detector's (shape_head)")
    ckpt = wide_checkpoint(models[WIDE], WIDTHS_DIR / "wide.ckpt")
    export_job = start_job("widths_export", [
        "-m", "ayolov2_torch.cli.export", "--weights", str(ckpt), "--batch-size", "16",
        "-iw", "800", "--type", "tpu_nms", "--out", str(WIDTHS_DIR / "wide_tpu_nms")],
        WIDTHS_DIR, "widths")
    models = {v: m.fuse() for v, m in models.items()}
    eps = {v: early.extract_early_params(m.state_dict()).to("cuda") for v, m in models.items()}
    entries = {v: {"max_abs_err": 0.0} for v in (WIDE, STEM8)}

    # 15.1 the kernel against its plain version
    for variant, bs, h, w in ((WIDE, 4, 800, 800), (WIDE, 4, 640, 640), (WIDE, 3, 152, 216),
                              (STEM8, 4, 640, 640), (STEM8, 2, 136, 200)):
        ok, mx = k1_against_plain(variant, eps[variant], bs, h, w, seed)
        entries[variant]["max_abs_err"] = max(entries[variant]["max_abs_err"], mx)
        if not ok:
            return False, entries

    # 15.2 serving: the main path of this slice, counted from 0 around its calls
    serves = {}
    for variant, bs, size in ((WIDE, 16, 800), (STEM8, 4, 640)):
        serve_k = make_serving_fn(models[variant])
        serve_c = make_serving_fn(models[variant], early_pipeline=False)
        serves[variant] = serve_k
        imgs = images_on_card((bs, size, size, 3), seed + 151)
        serve_k(imgs)  # the first call loads the library
        torch.cuda.synchronize()
        early.early_pipeline.launches = 0
        calls = 3
        for _ in range(calls):
            det, cnt = serve_k(imgs)
        torch.cuda.synchronize()
        launches = early.early_pipeline.launches
        entries[variant]["launches"] = launches
        ok = (serve_k.early and not serve_c.early and tuple(det.shape) == (bs, 100, 6)
              and tuple(cnt.shape) == (bs,) and bool(torch.isfinite(det).all())
              and launches == calls and cnt.sum() > 0)
        log(f"[widths] 15.2 make_serving_fn {model_name(variant)} bs{bs} {size}x{size}: det "
            f"{tuple(det.shape)} counts {tuple(cnt.shape)} mean count "
            f"{cnt.float().mean().item():.2f}, early_pipeline launches {launches} in {calls} "
            f"calls {'ok' if ok else 'FAIL'}")
        if not ok:
            return False, entries
        # The raw maps of the kernel's path against the cuDNN path's, each level,
        # under phase 4's gate: in bf16, and with the rest of the network in
        # f32 (TF32 off), where bf16's own noise downstream (each bf16 path's
        # distance from the f32 path, printed beside) does not hide the kernel's.
        serve_f = make_serving_fn(models[variant], image_dtype=torch.float32,
                                  early_pipeline=False)
        serve_kf = make_serving_fn(models[variant], image_dtype=torch.float32)
        maps = [m.raw_maps(imgs) for m in (serve_kf, serve_f, serve_k, serve_c)]
        for lvl, (kf, f, a, b) in enumerate(zip(*maps)):
            peak, p999, _ = rel_err(kf, f)
            ok = kf.shape == f.shape and bool(torch.isfinite(a.float()).all()) and peak < TOL_PEAK
            (e_k, q_k, _), (e_c, q_c, _), (e_kc, q_kc, _) = (rel_err(a, f), rel_err(b, f),
                                                             rel_err(a, b))
            ok = ok and e_kc < TOL_PEAK
            log(f"[widths] 15.2 raw level {lvl} {tuple(a.shape)} kernel vs cuDNN path: bf16 "
                f"max|d|/peak {e_kc:.5f} p99.9 {q_kc:.5f}, f32 after layer 3 {peak:.5f} "
                f"({p999:.5f}) (gate {TOL_PEAK} each) {'ok' if ok else 'FAIL'}; against the f32 "
                f"cuDNN path in bf16: kernel {e_k:.5f} ({q_k:.5f}), cuDNN {e_c:.5f} ({q_c:.5f})")
            if not ok:
                return False, entries
        del serve_c, serve_f, serve_kf, maps
    torch.cuda.empty_cache()

    # 15.3 validation at -iw 800 through K1, and cli.val
    val = validation_phase(seed, card, img_size=800, weights=ckpt, nc=80, root=WIDTHS_DIR / "val",
                           name=model_name(WIDE), tag="widths", entry_points=("val",))
    if val is None:
        return False, entries
    entries[WIDE]["launches"] += val[0]
    entries[WIDE]["max_abs_err"] = max(entries[WIDE]["max_abs_err"], val[1])

    # 15.4 cli.export (running since the phase began) and the artifact read back
    ok, _ = finish_job(export_job)
    pt2 = WIDTHS_DIR / "wide_tpu_nms.pt2"
    if not ok:
        return False, entries
    side = json.loads(pt2.with_suffix(".yaml").read_text())
    check = start_job("widths_artifact_check", [
        "-c", f"import sys, chip_smoke; sys.exit(chip_smoke.wide_artifact_check({str(pt2)!r}, "
              f"{str(ckpt)!r}, {seed}))"], WIDTHS_DIR, "widths")
    ok_c, text = finish_job(check)
    lines = [ln for ln in text.splitlines() if ln.startswith("ARTIFACT ")]
    if not ok_c or not lines:
        return False, entries
    a = json.loads(lines[-1][len("ARTIFACT "):])
    c0, c1, ch, c2, n = eps[WIDE].widths
    ok = (side["early_pipeline"] and a["op_calls"] == 1 and a["op_args"] == [c0, n, c1, ch, c2]
          and a["launches_per_call"] == 1 and a["equal"])
    log(f"[widths] 15.4 cli.export --batch-size 16 -iw 800: {pt2.name} "
        f"{pt2.stat().st_size / 1e6:.1f} MB, sidecar early_pipeline {side['early_pipeline']}; "
        f"ayolov2::early_pipeline calls {a['op_calls']} with widths (c0, n, c1, ch, c2) "
        f"{a['op_args']}; read in a fresh interpreter: launches a call "
        f"{a['launches_per_call']}, equal to make_serving_fn bit for bit "
        f"{'yes' if a['equal'] else 'NO'} (counts equal {a['counts_equal']}, boxes and scores "
        f"within {a['det_err']:.2e} of the peak; mean count {a['mean_count']:.2f}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        return False, entries

    # 15.5 times, with nothing else running
    states = {v: {k: t.cuda() for k, t in m.state_dict().items()} for v, m in models.items()}
    big = images_on_card((16, 800, 800, 3), seed + 152)
    entries[WIDE].update(k1_times(card, WIDE, eps[WIDE], states[WIDE], big))
    batch8 = images_on_card((8, 640, 640, 3), seed + 153)
    k1_times(card, WIDE, eps[WIDE], states[WIDE], batch8)
    entries[STEM8].update(k1_times(card, STEM8, eps[STEM8], states[STEM8], batch8))
    rate = serve_rate(serves[WIDE], big, 10)
    log(f"[time] {card}: serve {model_name(WIDE)} bs16 800x800 uint8 -> (16, 100, 6) with K1: "
        f"{rate:.1f} img/s")
    log(f"[widths] phase 15 ok in {time.perf_counter() - t_phase:.1f} s")
    return True, entries


# ---- phase 16: image files (JPEG and PNG) without OpenCV ---------------------------

IMAGES_DIR = ROOT / "build/chip_smoke_images"
CODEC_FIXTURES = ROOT / "tests/res/torch_codec"


def sha256_of(data) -> str:
    import hashlib

    return hashlib.sha256(bytes(data)).hexdigest()


def codec_fixtures() -> bool:
    """16.1: each committed fixture read by the port gives the digest of
    ``cv2.imread``'s array that the manifest records, and each JPEG
    fixture's source, encoded by the port, the digest of ``cv2.imencode``'s
    bytes."""
    from ayolov2_torch.data.codecs import encode_jpeg
    from ayolov2_torch.data.image_io import imread

    t0 = time.perf_counter()
    manifest = json.loads((CODEC_FIXTURES / "manifest.json").read_text())
    bad, n_enc = [], 0
    for name, entry in sorted(manifest["files"].items()):
        im = imread(str(CODEC_FIXTURES / name))
        if list(im.shape) != entry["shape"] or sha256_of(im.tobytes()) != entry["sha256"]:
            bad.append(name)
        src = entry.get("source")
        if src:
            n_enc += 1
            data = encode_jpeg(codec_source(src["seed"], src["h"], src["w"], src["gray"]),
                               src["quality"])
            if sha256_of(data) != src["imencode_sha256"]:
                bad.append(f"{name} (encoded)")
    log(f"[images] 16.1 the {len(manifest['files'])} fixtures of tests/res/torch_codec read by the "
        f"port: each equal to the digest of {manifest['reference']}'s imread; the {n_enc} JPEG "
        f"sources encoded by the port: each equal to the digest of its imencode "
        f"({time.perf_counter() - t0:.1f} s) {'ok' if not bad else 'FAIL: ' + ', '.join(bad)}")
    return not bad


def images_train(device: str = "cuda", bs: int = 32, img: Optional[int] = None) -> tuple:
    """16.3: ``cli.train`` from the golden checkpoint on phase 16's set with
    ``train_config.yaml`` as shipped (processes, 1 epoch), then ``cli.val``
    (K1) on its best.ckpt. Returns (ok, early_pipeline launches of that
    ``cli.val``)."""
    import re

    from ayolov2_torch.cli import val
    from ayolov2_torch.ops import early_pipeline as early
    from ayolov2_torch.utils.checkpoint import load_checkpoint
    from ayolov2_torch.utils.config import load_yaml

    images = IMAGES_DIR / "images"
    files = sorted(f for f in images.iterdir() if f.suffix in (".jpg", ".png"))
    write_segments(IMAGES_DIR / "labels", [f.stem for f in files], [IMAGES_DIR / "segments"])
    cfg_path = shipped_cfg("a", 1, "process", bs, img, out_dir=IMAGES_DIR)
    tcfg = load_yaml(cfg_path)["train"]
    img, bs = int(tcfg["image_size"]), int(tcfg["batch_size"])
    data = IMAGES_DIR / "train.json"
    data.write_text(json.dumps({"train_path": str(images), "val_path": str(images), "nc": 20,
                                "names": [f"class{i}" for i in range(20)]}))
    dev = [] if device == "cuda" else ["--device", device]
    proc, wall = run_logged(["-m", "ayolov2_torch.cli.train", "--model", str(GOLDEN), "--data",
                             str(data), "--cfg", str(cfg_path), "--log-dir",
                             str(IMAGES_DIR / "runs"), *dev])
    out = proc.stdout + proc.stderr
    (IMAGES_DIR / "train.log").write_text(out)
    rows = re.findall(EPOCH_ROW, out)
    path = re.search(r"training images: (.*)", out)
    run_dir = re.search(r"Run dir: (\S+)", out)
    log(f"[images] 16.3 python -m ayolov2_torch.cli.train --model best.ckpt (golden) --cfg "
        f"{RECIPES['a'].name} as shipped on the JPEG/PNG set ({img} px, bs {bs}, 1 epoch, "
        f"workers_mode process): exit {proc.returncode} in {wall:.1f} s; training images "
        f"{path.group(1) if path else '?'}")
    for r in rows:
        log(f"[images]   epoch {r[0]}: {r[1]} s, {r[2]} img/s, {r[3]} steps, mean loss box {r[4]} "
            f"obj {r[5]} cls {r[6]} total {r[7]}")
    if proc.returncode != 0 or not run_dir:
        log("[images] " + " | ".join(out.strip().splitlines()[-8:]))
        return False, 0
    wdir = Path(run_dir.group(1)) / "weights"
    meta = load_checkpoint(wdir / "last.ckpt")["meta"]
    finite = all(np.isfinite(float(v)) for r in rows for v in r[4:])
    ok = (len(rows) == 1 and finite and (wdir / "best.ckpt").exists()
          and meta["step"] == meta["ema_updates"] == len(files) // bs)
    vargs = ["--weights", str(wdir / "best.ckpt"), "--data-cfg", str(data), "-iw", str(img),
             "--batch-size", str(bs), *dev]
    with captured_log():
        early.early_pipeline.launches = 0  # main path (cli.val in this process): counts from here
        t0 = time.perf_counter()
        result = val.main(vargs)
        launches = early.early_pipeline.launches
    ok = ok and launches > 0 and 0.0 <= result["map50"] <= 1.0
    log(f"[images] last.ckpt: step {meta['step']}, ema_updates {meta['ema_updates']} (micro-steps "
        f"{len(files) // bs}), losses finite {finite}; python -m ayolov2_torch.cli.val on its "
        f"best.ckpt (K1, rect): seen {result['seen']} mAP50 {result['map50']:.5f} mAP50-95 "
        f"{result['map50_95']:.5f} in {time.perf_counter() - t0:.1f} s, early_pipeline launches "
        f"{launches} {'ok' if ok else 'FAIL'}")
    return ok, launches


def host_ms(fn, n: int) -> float:
    """Mean ms of ``fn()`` on the host clock over ``n`` calls after one."""
    fn()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    return (time.perf_counter() - t0) / n * 1e3


def codec_times(card: str, bs: int = 32, img_size: int = 640) -> None:
    """16.4, on the host clock: decode and encode ms per 640x480 image; the
    val loader's ms per batch on phase 16's files and on phase 7's BMPs with
    2 and 4 threads."""
    from ayolov2_torch.data import DataLoader, DetectionDataset
    from ayolov2_torch.data.codecs import encode_jpeg
    from ayolov2_torch.data.image_io import imread
    from ayolov2_torch.utils.png import write_png

    tdir = IMAGES_DIR / "timing"
    tdir.mkdir(exist_ok=True)
    src = codec_source(112, 480, 640)  # the source of the fixture jprog640.jpg
    scene = synthetic_image(np.random.default_rng(0), 480, 640)  # a phase 7 image
    (tdir / "noisy.jpg").write_bytes(encode_jpeg(src))
    (tdir / "scene.jpg").write_bytes(encode_jpeg(scene))
    write_png(tdir / "scene.png", scene)
    write_bmp(tdir / "scene.bmp", scene)
    files = {"JPEG baseline 4:2:0 q95, phase 16's kind of image": tdir / "scene.jpg",
             "JPEG baseline 4:2:0 q95, gradient with noise": tdir / "noisy.jpg",
             "JPEG progressive 4:2:0 q75 (fixture jprog640.jpg)": CODEC_FIXTURES / "jprog640.jpg",
             "PNG 8-bit RGB (write_png)": tdir / "scene.png",
             "BMP 24-bit (phase 7's kind)": tdir / "scene.bmp"}
    parts = [f"{k} ({f.stat().st_size} B) {host_ms(lambda f=f: imread(str(f)), 20):.3f}"
             for k, f in files.items()]
    log(f"[time] {card}: 16.4 host decode ms per 640x480 image (imread, one thread, mean of 20): "
        + "; ".join(parts))
    log(f"[time] {card}: 16.4 host encode ms per 640x480 image (encode_jpeg q95 4:2:0, mean of "
        f"20): phase 16's kind {host_ms(lambda: encode_jpeg(scene), 20):.3f}, gradient with noise "
        f"{host_ms(lambda: encode_jpeg(src), 20):.3f}")
    rows = []
    for name, images in (("JPEG/PNG", IMAGES_DIR / "images"), ("BMP", VAL_DIR / "images")):
        if not images.is_dir():
            continue
        ds = DetectionDataset(str(images), img_size=img_size, batch_size=bs, rect=True, pad=0.5)
        for workers in (2, 4):
            loader = DataLoader(ds, batch_size=bs, workers=workers)
            sum(1 for _ in loader)
            t0 = time.perf_counter()
            n = sum(1 for _ in loader)
            rows.append(f"{name} {workers} threads {(time.perf_counter() - t0) / n * 1e3:.2f}")
    log(f"[time] {card}: 16.4 val loader ms per batch of {bs} (rect, {img_size}, a whole pass "
        f"after a first one): " + "; ".join(rows))


def images_phase(card: str, seed: int, bmp_img_s: float, device: str = "cuda",
                 img_size: int = 640, bs: int = 32, sizes=VAL_SIZES, per_size: int = 32,
                 train_img: Optional[int] = None) -> tuple:
    """Phase 16 (see the module docstring). Returns (ok, K1 launches of its
    validation and ``cli.val`` runs). ``device``, ``img_size``, ``bs``,
    ``sizes``, ``per_size`` and ``train_img`` shrink it for a rehearsal on
    the CPU."""
    t0 = time.perf_counter()
    ok = codec_fixtures()
    val = validation_phase(seed, card, device=device, img_size=img_size, sizes=sizes,
                           per_size=per_size, bs=bs, root=IMAGES_DIR, tag="images",
                           entry_points=("val",), files=True)
    if val is None:
        return False, 0
    log(f"[time] {card}: 16.2 warm validation pass on the JPEG/PNG files {val[4]:.1f} img/s, on "
        f"phase 7's BMPs {bmp_img_s:.1f} img/s")
    ok_train, train_launches = images_train(device, bs, train_img)
    codec_times(card, bs, img_size)
    log(f"[images] phase 16 {'ok' if ok and ok_train else 'FAIL'} in "
        f"{time.perf_counter() - t0:.1f} s")
    return ok and ok_train, val[0] + train_launches

# ---- phase 17: the native runner and the measurement CLIs -------------------------

TOOLS_DIR = ROOT / "build/chip_smoke_tools"
RUNNER_ITERS, RUNNER_WARMUP = 137, 3
TOOLS_CONFIGS = ("serve", "int8", "tta", "decomposed", "train", "latency", "sweep", "h2d")


def start_tools_jobs(seed: int) -> dict:
    """17.1, started right after phase 2 and left to run in the background:
    seeded yolov5s (nc 80, its head shaped by :func:`shape_head`) written as
    a checkpoint, ``python -m
    ayolov2_torch.cli.export --aoti`` of it (bf16, bs 32, 640, K1 in the
    graph) and the build of the C++ registration and the runner
    (``_build.TORCH_SOURCES``), each a job whose log lands in
    ``build/chip_smoke_tools/``."""
    shutil.rmtree(TOOLS_DIR, ignore_errors=True)
    TOOLS_DIR.mkdir(parents=True)
    # a seeded head puts full-confidence boxes of no size everywhere (every score 1.0 ties,
    # and the kept set then follows rounding): shaped as phase 15's, the scores spread
    model = seeded_model("s", seed + 17, fuse=False)
    shape_head(model, seed + 17, size=640, per_level=4.0)
    ckpt = wide_checkpoint(model, TOOLS_DIR / "yolov5s.ckpt", "s")
    export = start_job("export_aoti", [
        "-m", "ayolov2_torch.cli.export", "--weights", str(ckpt), "--nc", "80",
        "--batch-size", "32", "-iw", "640", "--aoti", "--no-dry-run",
        "--out", str(TOOLS_DIR / "yolov5s_tpu_nms")], root=TOOLS_DIR, tag="tools", group=True)
    build = start_job("build_runner", [
        "-c", "from ayolov2_torch.ops import _build; "
              "print(_build.build_all([], [(n, ()) for n in _build.TORCH_SOURCES]))"],
        root=TOOLS_DIR, tag="tools", group=True)
    atexit.register(stop_jobs, (export, build))
    return {"export": export, "build": build, "ckpt": ckpt}


def stop_jobs(jobs) -> None:
    """Kill the process group of each job still running (the inductor
    compile's workers with the export), as the script exits early."""
    for _, proc, *_ in jobs:
        if proc.poll() is None:
            with contextlib.suppress(OSError):
                os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()


def runner_output(text: str) -> dict:
    """The numbers of the runner's lines: img/s, ms/img, the K1 launches."""
    out = {}
    for line in text.splitlines():
        if line.startswith("total "):
            parts = line.replace(",", "").split()
            out["ms_per_img"], out["img_s"] = float(parts[3]), float(parts[5])
        elif line.startswith("early_pipeline launches:"):
            out["launches"] = int(line.split()[2])
    return out


def runner_matches(det_r, n_r, det_p, n_p, score_min: float = 0.25, iou_min: float = 0.99):
    """(images with equal counts, detections of score >= ``score_min`` of the
    Python artifact, those with a runner detection of the same class at IoU
    >= ``iou_min``, max box |d| over the images of equal counts)."""
    same = int((n_r == n_p).sum())
    wanted = found = 0
    max_box = 0.0
    for i in range(len(n_p)):
        p, r = det_p[i, :n_p[i]], det_r[i, :n_r[i]]
        if n_r[i] == n_p[i] and len(p):
            max_box = max(max_box, float(np.abs(p[:, :4] - r[:, :4]).max()))
        keep = p[p[:, 4] >= score_min]
        wanted += len(keep)
        if len(keep) and len(r):
            iou = box_iou(keep[:, :4], r[:, :4])
            iou[keep[:, 5][:, None] != r[:, 5][None, :]] = 0
            found += int((iou.max(1) >= iou_min).sum())
    return same, wanted, found, max_box


REGISTRATION_CALL = """
import ctypes, json, sys, numpy as np, torch
op, src, dst, iters = sys.argv[1], sys.argv[2], sys.argv[3], int(sys.argv[4])
torch.ops.load_library(op)
lib = ctypes.CDLL(op)
lib.ayolov2_early_pipeline_error.restype = ctypes.c_char_p
lib.ayolov2_early_pipeline_launches.restype = ctypes.c_int64
d = np.load(src)
widths, plan = [int(v) for v in d["widths"]], [int(v) for v in d["plan"]]
if lib.ayolov2_early_pipeline_configure(str(d["library"]).encode(),
        (ctypes.c_int64 * 5)(*widths), (ctypes.c_int * 14)(*plan)):
    sys.exit(lib.ayolov2_early_pipeline_error().decode())
x = torch.from_numpy(d["x"]).cuda()
w = torch.from_numpy(d["w"]).view(torch.bfloat16).cuda()
c0, c1, ch, c2, n = widths
call = lambda: torch.ops.ayolov2.early_pipeline(x, w, c0, n, c1, ch, c2)
y = call()
for _ in range(3):
    call()
torch.cuda.synchronize()
start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
start.record()
for _ in range(iters):
    call()
end.record()
torch.cuda.synchronize()
np.save(dst, y.view(torch.int16).cpu().numpy())
print(json.dumps({"ms": start.elapsed_time(end) / iters,
                  "launches": lib.ayolov2_early_pipeline_launches(),
                  "modules": sorted(m for m in sys.modules if m.startswith("ayolov2"))}))
"""


def registration_check(card: str, model, ep, imgs, call: dict) -> tuple:
    """17.2's second half: the C++ registration's CUDA body on the card, in a
    fresh interpreter that never imports the Python operator:
    ``torch.ops.load_library`` of it, configured with the sidecar's kernel
    library and plan, called as ``torch.ops.ayolov2.early_pipeline`` on the
    runner's batch (bs 32, 640) with the packaged model's weights, against
    ``early_pipeline_ref`` on the same inputs at phase 3's tolerance; its
    launches counted by the registration (1 + 3 warm-up + 20 timed). Its
    time (CUDA events, in that interpreter), the plain version's, the
    cuDNN chain's and the bound make the runner's entry of the kernels line.
    Returns (ok, those numbers)."""
    import torch

    from ayolov2_torch.ops import _build
    from ayolov2_torch.ops import early_pipeline as early

    iters = 20
    src, dst = TOOLS_DIR / "registration_in.npz", TOOLS_DIR / "registration_out.npy"
    np.savez(src, x=imgs.cpu().numpy(), w=early.pack_weights(ep).view(torch.int16).cpu().numpy(),
             widths=np.array(call["widths"]), plan=np.array(call["plan"]),
             library=np.array(call["library"]))
    proc = subprocess.run([sys.executable, "-c", REGISTRATION_CALL,
                           str(_build.path("early_pipeline_op")), str(src), str(dst),
                           str(iters)], cwd=TOOLS_DIR, capture_output=True, text=True,
                          timeout=300)
    (TOOLS_DIR / "registration.log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        log(f"[tools] the registration on the card: exit {proc.returncode}; "
            + " | ".join((proc.stdout + proc.stderr).strip().splitlines()[-6:]))
        return False, {}
    rep = json.loads(proc.stdout.strip().splitlines()[-1])
    got = torch.from_numpy(np.load(dst)).view(torch.bfloat16).cuda()
    want = early.early_pipeline_ref(imgs, ep)
    peak, p999, mx = rel_err(got, want)
    ok = (got.shape == want.shape and bool(torch.isfinite(got.float()).all())
          and peak < TOL_PEAK and p999 < TOL_P999 and rep["modules"] == []
          and rep["launches"] == 1 + 3 + iters)
    plain_ms = time_ms(lambda: early.early_pipeline_ref(imgs, ep), 5, warmup=1)
    fused_state = model.state_dict()
    torch.backends.cudnn.benchmark = True
    try:
        chain_ms = min(time_ms(lambda: chain(imgs), 20) for chain in
                       (cudnn_chain(fused_state, c) for c in (3, 8)))
    finally:
        torch.backends.cudnn.benchmark = False
    bound_ms, bound_by, _, _ = bound_of(ep, imgs.shape[:3])
    log(f"[tools] {card}: 17.2 the C++ registration's CUDA body in a fresh interpreter (port "
        f"modules imported: {rep['modules']}), configured from the sidecar, on the runner's "
        f"batch (yolov5s bs32 640) vs early_pipeline_ref: max|d|/peak {peak:.5f} p99.9 "
        f"{p999:.5f} max|d| {mx:.4f} (gate {TOL_PEAK}/{TOL_P999}); launches counted by the "
        f"registration {rep['launches']} (gate {1 + 3 + iters}) {'ok' if ok else 'FAIL'}")
    log(f"[time] {card}: early_pipeline through the C++ registration {rep['ms']:.4f} ms "
        f"(CUDA events, {iters} calls), plain {plain_ms:.4f} ms, cuDNN chain {chain_ms:.4f} ms "
        f"(the faster stem width, cudnn.benchmark), bound {bound_ms:.4f} ms ({bound_by})")
    return ok, dict(max_abs_err=mx, ms=rep["ms"], plain_ms=plain_ms, bound_ms=bound_ms,
                    bound_by=bound_by, library_ms=chain_ms)


def runner_check(card: str, jobs: dict, serve_img_s: float) -> tuple:
    """17.1-17.2: the package and the runner from :func:`start_tools_jobs`;
    the runner (``--iters 137 --warmup 3``) on the first 32 of phase 7's
    images (square 640) against ``load_exported`` of the same ``.pt2`` on
    the same batch: equal counts in at least 31 of 32 images, and a runner
    detection of the same class at IoU >= 0.99 for at least 99% of the
    artifact's detections of score >= 0.25; the registration's K1 launches
    equal to the warm-up, verification and timed calls. The runner's img/s
    beside the ``.pt2``'s and ``make_serving_fn``'s on the same batch, in
    turns, each over as many calls as the runner's; then
    :func:`registration_check`. Returns (ok, the runner's K1 launches, the
    numbers of the runner's entry of the kernels line)."""
    import torch

    from ayolov2_torch.data import DataLoader, DetectionDataset
    from ayolov2_torch.export import load_exported, make_serving_fn
    from ayolov2_torch.ops import _build
    from ayolov2_torch.utils.checkpoint import load_model

    ok_b, _ = finish_job(jobs["build"], timeout=900)
    ok_e, _ = finish_job(jobs["export"], timeout=900)
    if not (ok_b and ok_e):
        return False, 0, {}
    side = json.loads((TOOLS_DIR / "yolov5s_tpu_nms.yaml").read_text())
    aoti = side["aoti"]
    package = TOOLS_DIR / aoti["package"]
    calls = aoti["early_pipeline"]
    ok_pkg = (side["early_pipeline"] and len(calls) == 1 and bool(calls[0].get("library"))
              and aoti["device"] == "cuda")
    log(f"[tools] {card}: 17.1 cli.export --aoti of seeded yolov5s (nc 80, bf16, bs32 640): "
        f"inductor compile {aoti['compile_s']:.1f} s, {package.name} "
        f"{package.stat().st_size / 1e6:.1f} MB, torch {aoti['torch']}; early_pipeline calls "
        f"{[(c['widths'], c.get('tile')) for c in calls]} {'ok' if ok_pkg else 'FAIL'}")
    if not ok_pkg:
        return False, 0, {}

    ds = DetectionDataset(str(VAL_DIR / "images"), img_size=640, batch_size=32, rect=False,
                          stride=32)
    batch = next(iter(DataLoader(ds, batch_size=32))).images
    raw = TOOLS_DIR / "input.bin"
    raw.write_bytes(np.ascontiguousarray(batch).tobytes())
    t0 = time.perf_counter()
    proc = subprocess.run([str(_build.path("aoti_runner")), "--program", str(package),
                           "--batch", "32", "--height", "640", "--width", "640",
                           "--iters", str(RUNNER_ITERS), "--warmup", str(RUNNER_WARMUP),
                           "--input", str(raw), "--dump-output", str(TOOLS_DIR / "runner")],
                          cwd=ROOT, capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    (TOOLS_DIR / "runner.log").write_text(proc.stdout + proc.stderr)
    r = runner_output(proc.stdout)
    if proc.returncode != 0 or "img_s" not in r or "launches" not in r:
        log(f"[tools] runner: exit {proc.returncode}; "
            + " | ".join((proc.stdout + proc.stderr).strip().splitlines()[-6:]))
        return False, 0, {}
    det_r = np.fromfile(TOOLS_DIR / "runner.out0.bin", np.float32).reshape(32, 100, 6)
    n_r = np.fromfile(TOOLS_DIR / "runner.out1.bin", np.int32)
    call = load_exported(str(TOOLS_DIR / "yolov5s_tpu_nms.pt2"))
    imgs = torch.from_numpy(np.ascontiguousarray(batch)).cuda()
    det_p, n_p = (t.cpu().numpy() for t in call(imgs))
    same, wanted, found, max_box = runner_matches(det_r, n_r, det_p, n_p)
    want_launches = RUNNER_WARMUP + 1 + RUNNER_ITERS
    ok = (same >= 31 and wanted >= 16 and found >= 0.99 * wanted
          and r["launches"] == want_launches)
    log(f"[tools] 17.2 the runner (no Python; {wall:.1f} s with its start) on phase 7's first 32 "
        f"images at 640 vs load_exported of the same .pt2: equal counts in {same}/32 images "
        f"(gate 31), detections of score >= 0.25 matched at IoU >= 0.99 and the same class "
        f"{found}/{wanted} (gate 99% of at least 16), max box |d| {max_box:.4f} px (printed, "
        f"not gated); K1 launches counted by the C++ registration {r['launches']} (gate "
        f"{RUNNER_WARMUP} warm-up + 1 verification + {RUNNER_ITERS} timed = {want_launches}) "
        f"{'ok' if ok else 'FAIL'}")
    model = load_model(jobs["ckpt"], nc=80, device="cuda")
    serve = make_serving_fn(model)
    rates = {"artifact": [], "make_serving_fn": []}
    for name in ("artifact", "make_serving_fn", "make_serving_fn", "artifact"):
        rates[name].append(serve_rate(call if name == "artifact" else serve, imgs, RUNNER_ITERS))
    art, msf = np.mean(rates["artifact"]), np.mean(rates["make_serving_fn"])
    log(f"[time] {card}: the native runner {r['img_s']:.1f} img/s ({r['ms_per_img']:.5f} ms/img, "
        f"{RUNNER_ITERS} calls, yolov5s bs32 640, K1 inside) vs in this process on the same "
        f"batch, in turns of {RUNNER_ITERS} calls each: the .pt2 {art:.1f} img/s "
        f"({' '.join(f'{v:.1f}' for v in rates['artifact'])}), make_serving_fn {msf:.1f} "
        f"({' '.join(f'{v:.1f}' for v in rates['make_serving_fn'])}); runner / .pt2 "
        f"{r['img_s'] / art:.3f}, runner / make_serving_fn {r['img_s'] / msf:.3f}; phase 6's "
        f"make_serving_fn {serve_img_s:.1f}, runner / it {r['img_s'] / serve_img_s:.3f} (nan "
        "where not run)")
    ok_k, numbers = registration_check(card, model, serve.ep, imgs, calls[0])
    del serve, call, imgs, model
    torch.cuda.empty_cache()
    return ok and ok_k, r["launches"], numbers


def run_cli(name: str, args: list, timeout: int = 600) -> tuple:
    """``python -m ayolov2_torch.cli.<name>`` in a subprocess; (exit code,
    seconds, output), the output also in ``build/chip_smoke_tools/``."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", f"ayolov2_torch.cli.{name}", *args], cwd=ROOT,
                          capture_output=True, text=True, timeout=timeout)
    (TOOLS_DIR / f"{name}.log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        log(f"[tools] {name}: exit {proc.returncode}; "
            + " | ".join((proc.stdout + proc.stderr).strip().splitlines()[-6:]))
    return proc.returncode, time.perf_counter() - t0, proc.stdout


def tools_clis(card: str, serve_img_s: float) -> bool:
    """17.3-17.4: ``cli.bench_matrix --configs serve int8 tta decomposed train
    latency sweep h2d --iters 5 --sweep-prefilters exact`` (every row finite,
    the serve row's K1 launches 1 per call); ``cli.profile_train`` at 640
    with ``--bs-sweep 16 64`` (every number finite, every time, rate and MFU
    positive; the
    stage sum beside the full step); ``cli.bench_loader`` on phase 7's
    images and labels with ``train_config.yaml``'s augmentation at bs 32,
    ``--batches 5`` (both worker modes)."""
    from ayolov2_torch.cli.bench_matrix import rows_finite

    rc, secs, _ = run_cli("bench_matrix", ["--configs", *TOOLS_CONFIGS, "--iters", "5",
                                           "--sweep-prefilters", "exact",
                                           "--out", str(TOOLS_DIR / "bench_matrix.json")])
    if rc != 0:
        return False
    rows = json.loads((TOOLS_DIR / "bench_matrix.json").read_text())["rows"]
    serve = next(r for r in rows if r["metric"].endswith("_640_bs32_serve"))
    ok_m = (rows_finite(rows) and serve["k1_launches_per_call"] == 1
            and {r["metric"].split("_640_")[1] for r in rows if "_640_" in r["metric"]}
            >= {"bs32_serve", "bs32_serve_int8", "bs32_tta_serve", "bs32_decomposed_serve",
                "bs32_train_step", "bs1_p50_latency_ms"})
    log(f"[tools] {card}: 17.3 cli.bench_matrix ({secs:.1f} s, {len(rows)} rows, --iters 5): "
        + "; ".join(f"{r['metric']} {r['value']} {r['unit']}" for r in rows)
        + f"; serve K1 launches per call {serve['k1_launches_per_call']} (gate 1); every row "
        f"finite {'ok' if ok_m else 'FAIL'}")
    log(f"[time] {card}: bench_matrix's serve {serve['value']} img/s beside phase 6's "
        f"make_serving_fn {serve_img_s:.1f} img/s (nan where not run)")

    rc, secs, _ = run_cli("profile_train", ["--img-size", "640", "--bs-sweep", "16", "64",
                                            "--iters", "5",
                                            "--out", str(TOOLS_DIR / "profile_train.json")])
    if rc != 0:
        return False
    rows = json.loads((TOOLS_DIR / "profile_train.json").read_text())["rows"]
    timed = [v for row in rows for k, v in row.items()
             if k in ("fwd_ms", "opt_ema_direct_ms", "full_ms", "ms_per_step", "baseline_ms",
                      "img_per_s", "mfu_pct")]
    ok_p = (rows_finite(rows) and not any("error" in r for r in rows)
            and all(v is not None and v > 0 for v in timed))
    bd = rows[0]
    stage_sum = bd["fwd_ms"] + bd["loss_ms"] + bd["bwd_ms"] + bd["opt_ema_direct_ms"]
    log(f"[tools] {card}: 17.4 cli.profile_train ({secs:.1f} s, 640, --iters 5): "
        + "; ".join(json.dumps(r) for r in rows)
        + f"; stages fwd + loss + bwd + opt_ema_direct {stage_sum:.2f} ms beside the full step "
        f"{bd['full_ms']} ms; every number finite, every time, rate and MFU positive "
        f"{'ok' if ok_p else 'FAIL'}")

    data = TOOLS_DIR / "loader_data.json"
    data.write_text(json.dumps({"train_path": str(VAL_DIR / "images"), "nc": 20,
                                "dataset": "VOC"}))
    rc, secs, out = run_cli("bench_loader", ["--data", str(data), "--batches", "5",
                                             "--batch-size", "32"])
    if rc != 0:
        return False
    rep = json.loads([ln for ln in out.splitlines() if ln.startswith("{")][-1])
    ok_l = (rep["loader_img_s"] > 0 and rep["step_img_s"] > 0
            and set(rep["loader_by_mode_img_s"]) == {"thread", "process"})
    log(f"[tools] {card}: 17.4 cli.bench_loader ({secs:.1f} s) on phase 7's images with "
        f"train_config.yaml: {json.dumps(rep)} {'ok' if ok_l else 'FAIL'}")
    return ok_m and ok_p and ok_l


def tools_phase(card: str, jobs: dict, serve_img_s: float = float("nan")) -> tuple:
    """Phase 17 (see the module docstring). Returns (ok, the runner's K1
    launches, the numbers of the runner's entry of the kernels line)."""
    t0 = time.perf_counter()
    ok_r, launches, numbers = runner_check(card, jobs, serve_img_s)
    ok_t = ok_r and tools_clis(card, serve_img_s)
    log(f"[tools] phase 17 {'ok' if ok_t else 'FAIL'} in {time.perf_counter() - t0:.1f} s of "
        "foreground time")
    return ok_t, launches, numbers



def width_entry(variant: str, numbers: dict) -> dict:
    """Phase 15's entry of the kernels line for one width set."""
    from ayolov2_torch.models import build_model
    from ayolov2_torch.ops import early_pipeline as early

    m = build_model(named_cfg(variant), device="meta")
    widths = (m.model[0].conv.out_channels, m.model[1].conv.out_channels,
              m.model[2].cv1.conv.out_channels, m.model[3].conv.out_channels)
    padded = "/".join(str(c) for c in early.padded_widths(*widths))
    return kernel_entry(f"early_pipeline ({model_name(variant)}, widths "
                        f"{'/'.join(str(c) for c in widths)} padded to {padded})", **numbers)


def kernel_entry(name: str, **numbers) -> dict:
    """One kernel's entry of the kernels line (every key the line needs)."""
    return {"name": name, "route": "cuda", "source": "ayolov2_torch/csrc/early_pipeline.cu",
            "replaces": "ayolov2_tpu/ops/early_pipeline.py:496",
            **{k: numbers[k] for k in ("launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
                                       "bound_by", "library_ms")}}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--check-only", action="store_true",
                    help="phases 1-3 only: build the kernels and check them")
    ap.add_argument("--train-only", action="store_true",
                    help="phases 1, 2, 7, 8, 9, 10 and 11 only (phases 8-10 train on phase "
                         "7's set)")
    ap.add_argument("--host-only", action="store_true",
                    help="phases 1, 2, 7, 10 and 11 only (host augmentation and the "
                         "shipped surface)")
    ap.add_argument("--zoo-only", action="store_true",
                    help="phases 1, 2, 3, 7 and 12 only (the model zoo and export; 12.4 "
                         "validates on phase 7's set)")
    ap.add_argument("--compress-only", action="store_true",
                    help="phases 1, 2, 3, 7 and 13 only (compression and the post-training "
                         "tools; they validate on phase 7's set)")
    ap.add_argument("--secondary-only", action="store_true",
                    help="phases 1, 2, 3, 7 and 14 only (the secondary trainers and tools; "
                         "they read phase 7's set)")
    ap.add_argument("--widths-only", action="store_true",
                    help="phases 1, 2, 3 and 15 only (the kernel at the width-1.05 config's "
                         "and the stem-8 widths)")
    ap.add_argument("--images-only", action="store_true",
                    help="phases 1, 2, 3, 7 and 16 only (JPEG and PNG files through the "
                         "port's codecs)")
    ap.add_argument("--tools-only", action="store_true",
                    help="phases 1, 2, 3, 7 and 17 only (the native runner against the "
                         ".pt2 on phase 7's images, and the measurement CLIs)")
    ap.add_argument("--profile", action="store_true",
                    help="also break the bs32 serve call and the augmentation render down "
                         "by stage and by kernel (torch.profiler)")
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
    extra = ([("early_pipeline", early.kernel_defines(32, 64, 32, 128) + ("EARLY_PROFILE",))]
             if args.profile else [])
    built = _build.build_all(variants=extra + [(name, ()) for name in _build.HOST_SOURCES])
    log(f"[build] {', '.join(f'{k}: {v:.1f} s' for k, v in built.items())} "
        f"(wall {time.perf_counter() - t0:.1f} s)")
    for name, text in _build.BUILD_LOG.items():
        for line in text.splitlines():
            if ("registers" in line or "spill" in line or "error" in line.lower()
                    or "Performance Loss" in line):
                log(f"[build] {name}: {line.strip()[:240]}")
    tools_jobs = None
    if args.tools_only or not (args.check_only or args.train_only or args.host_only
                               or args.zoo_only or args.compress_only or args.secondary_only
                               or args.widths_only or args.images_only):
        tools_jobs = start_tools_jobs(args.seed)  # 17.1 in the background
        log("[tools] 17.1 started in the background: cli.export --aoti of seeded yolov5s and "
            "the build of the C++ registration and the runner")

    # ---- 3. the kernel against its plain version -------------------------
    # full-size shapes, then the risky ones: a ragged last tile in each direction
    # at each model's tile (s 8x8, n 8x16, m 4x8, l 4x4, x 2x2), an image
    # smaller than one tile, and yolov5m (depth 2) ragged. Every tile's conv1
    # rows split into bands whose last one is shorter (19 = 10 + 9 for s).
    # Then every other shipped config's width set: l_0.5, the width-1.05
    # config (padded 72/136/68/272) and the stem-8 set (padded 8/16/8/32).
    cases = [("s", 4, 640, 640), ("s", 4, 384, 640), ("m", 2, 640, 640),
             ("l", 1, 640, 640), ("x", 1, 640, 640),
             ("s", 2, 72, 136), ("s", 3, 200, 104), ("s", 1, 40, 56), ("n", 2, 136, 200),
             ("m", 2, 104, 184), ("l", 1, 264, 328), ("x", 1, 136, 264),
             ("l_0.5", 1, 640, 640), ("1.05", 1, 640, 640), (STEM8, 2, 320, 320)]
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
        plan = early.kernel_plan(ep)
        log(f"[kernel] {model_name(variant)} bs{bs} {h}x{w} tile {plan.th}x{plan.tw} bands of "
            f"{plan.rb} ring {plan.stages}x{plan.stage_bytes} B smem {plan.total} B: "
            f"max|d|/peak {peak:.5f} p99.9 {p999:.5f} max|d| {mx:.4f} "
            f"(gate {TOL_PEAK}/{TOL_P999}) {'ok' if ok else 'FAIL'}")
        if not ok:
            return 1
    if args.widths_only:
        ok15, entries = widths_phase(card, args.seed)
        if not ok15:
            log("[widths] FAIL")
            return 1
        print(json.dumps({"kernels": [width_entry(v, e) for v, e in entries.items()]}))
        log(card)
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                                 "count": torch.cuda.device_count()}}))
        return 0
    if args.tools_only:
        val = validation_phase(args.seed, card)
        if val is None or not tools_phase(card, tools_jobs)[0]:
            log("[tools] FAIL")
            return 1
        log(card)
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                                 "count": torch.cuda.device_count()}}))
        return 0
    if args.images_only:
        val = validation_phase(args.seed, card)
        if val is None or not images_phase(card, args.seed, val[4])[0]:
            log("[images] FAIL")
            return 1
        log(card)
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                                 "count": torch.cuda.device_count()}}))
        return 0
    if args.secondary_only:
        val = validation_phase(args.seed, card)
        if val is None or not secondary_phase(card, args.seed, val[2])[0]:
            log("[secondary] FAIL")
            return 1
        log(card)
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                                 "count": torch.cuda.device_count()}}))
        return 0
    if args.compress_only:
        val = validation_phase(args.seed, card)
        if val is None or not compress_phase(card, args.seed, val[3])[0]:
            log("[compress] FAIL")
            return 1
        log(card)
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                                 "count": torch.cuda.device_count()}}))
        return 0
    if args.zoo_only:
        val = validation_phase(args.seed, card)
        if val is None or not zoo_phase(card, args.seed, float("nan"), val[2],
                                        args.profile)[0]:
            log("[zoo] FAIL")
            return 1
        log(card)
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                                 "count": torch.cuda.device_count()}}))
        return 0
    if args.train_only or args.host_only:
        val = validation_phase(args.seed, card)
        if val is None:
            log("[val] FAIL")
            return 1
        step_img_s = float("nan")
        if args.train_only:
            ok8, _, step_ms, step_img_s = train_phase(card, args.seed)
            if not ok8:
                log("[train] FAIL")
                return 1
            if not augment_phase(card, step_ms, step_img_s, args.profile)[0]:
                log("[aug] FAIL")
                return 1
        torch.cuda.empty_cache()
        ok10 = host_aug_phase(step_img_s)[0]
        if not ok10:
            log("[host] FAIL")
            return 1
        if not surface_phase(card, args.seed)[0]:
            log("[surface] FAIL")
            return 1
        log(card)
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                                 "count": torch.cuda.device_count()}}))
        return 0
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
    plan = early.kernel_plan(ep)
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
        plan = early.kernel_plan(ep_v)
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

    # ---- 8. training ------------------------------------------------------
    torch.cuda.empty_cache()
    ok8, train_launches, step_ms, step_img_s = train_phase(card, args.seed)
    if not ok8:
        log("[train] FAIL")
        return 1
    launches += train_launches

    # ---- 9. device augmentation -----------------------------------------------
    torch.cuda.empty_cache()
    ok9, aug_launches = augment_phase(card, step_ms, step_img_s, args.profile)
    if not ok9:
        log("[aug] FAIL")
        return 1
    launches += aug_launches

    # ---- 10. host augmentation ---------------------------------------------
    torch.cuda.empty_cache()
    ok10, host_launches = host_aug_phase(step_img_s)
    if not ok10:
        log("[host] FAIL")
        return 1
    launches += host_launches

    # ---- 11. the shipped surface (its entry points rode on phase 10) -----------
    torch.cuda.empty_cache()
    ok11, surface_launches = surface_phase(card, args.seed)
    if not ok11:
        log("[surface] FAIL")
        return 1
    launches += surface_launches

    # ---- 12. the rest of the model zoo and the exported serving graph -----------
    torch.cuda.empty_cache()
    ok12, zoo_launches = zoo_phase(card, args.seed, rates[32], val[2], args.profile)
    if not ok12:
        log("[zoo] FAIL")
        return 1
    launches += zoo_launches

    # ---- 13. compression and the post-training tools ---------------------------
    torch.cuda.empty_cache()
    ok13, compress_launches = compress_phase(card, args.seed, val[3])
    if not ok13:
        log("[compress] FAIL")
        return 1
    launches += compress_launches

    # ---- 14. the secondary trainers and tools ---------------------------------
    torch.cuda.empty_cache()
    ok14, secondary_launches = secondary_phase(card, args.seed, val[2])
    if not ok14:
        log("[secondary] FAIL")
        return 1
    launches += secondary_launches

    # ---- 15. K1 at every width: the width-1.05 config ---------------------------
    torch.cuda.empty_cache()
    ok15, entries = widths_phase(card, args.seed)
    if not ok15:
        log("[widths] FAIL")
        return 1

    # ---- 16. image files: JPEG and PNG through the port's codecs ----------------
    torch.cuda.empty_cache()
    ok16, images_launches = images_phase(card, args.seed, val[4])
    if not ok16:
        log("[images] FAIL")
        return 1
    launches += images_launches

    # ---- 17. the native runner and the measurement CLIs -------------------------
    torch.cuda.empty_cache()
    ok17, runner_launches, runner_numbers = tools_phase(card, tools_jobs, rates[32])
    if not ok17:
        log("[tools] FAIL")
        return 1
    log(f"[time] {card}: whole script {time.perf_counter() - T_START:.1f} s")

    k1 = dict(max_abs_err=max_abs, ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound_ms,
              bound_by=bound_by, library_ms=library_ms)
    print(json.dumps({"kernels": [kernel_entry("early_pipeline", launches=launches, **k1)]
                      + [width_entry(v, e) for v, e in entries.items()]
                      + [kernel_entry("early_pipeline (yolov5s bs32 640, inside the native "
                                      "runner's AOTInductor package, launched by the C++ "
                                      "registration)", launches=runner_launches,
                                      **runner_numbers)]}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
