#!/usr/bin/env python3
"""Times of the fused early-network kernel on one NVIDIA GPU, beyond what
``chip_smoke.py`` prints: where its time goes and what its plan costs.

    python3 chip_time_early.py [--variant s] [--plans] [--ablate] [--against OLD.cu]

Always: the kernel against its plain version at a small and a full-size
shape, its time at bs 32, 64 and 128 at 640x640 (CUDA events), and the
shares of a ``-DEARLY_PROFILE`` build's clock stamps. ``--plans`` times other
tiles, band heights and ring depths than the one ``plan_early`` picks (bs 64,
one call, so the rows compare). ``--ablate`` times builds that leave one part
out (``-DEARLY_ABLATE=1..8``: the SiLU arithmetic, the wgmmas, the ldmatrix
loads, the epilogue's stores, the epilogue, the copies of the weights, the
wgmmas and the epilogue together, all three) beside the whole kernel, in
turns. ``--against OLD.cu`` (repeatable) builds another version of the
kernel's source, one with the same C interface, for example the parent
commit's unpacked by ``git archive`` into a git-ignored directory, checks it
and times it beside the tree's in turns in the same call, the only way two
versions compare. Every line carries the card's name and power limit.
"""

from __future__ import annotations

import argparse
import sys

import chip_smoke as cs

ABLATIONS = {1: "no SiLU arithmetic", 2: "no wgmma", 3: "no ldmatrix",
             4: "no epilogue stores", 5: "no epilogue", 6: "no weight copies",
             7: "no wgmma and no epilogue", 8: "no wgmma, no epilogue, no weight copies"}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--variant", default="s", choices=list("nsmlx"))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--plans", action="store_true")
    ap.add_argument("--ablate", action="store_true")
    ap.add_argument("--against", action="append", default=[], metavar="OLD.cu")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_time_early: CUDA is not available", file=sys.stderr)
        return 2
    from ayolov2_torch.ops import _build
    from ayolov2_torch.ops import early_pipeline as early

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs.card_line()
    ep = early.extract_early_params(cs.seeded_model(args.variant, args.seed).state_dict()).to("cuda")
    c0 = f"EARLY_C0={ep.c0}"
    sets = [(c0,), (c0, "EARLY_PROFILE")]
    sets += [(c0, f"EARLY_ABLATE={k}") for k in ABLATIONS] if args.ablate else []
    _build.build_all(names=[], variants=[("early_pipeline", d) for d in sets])
    for name, text in _build.BUILD_LOG.items():
        for line in text.splitlines():
            if "registers" in line or "Performance Loss" in line:
                cs.log(f"[build] {name}: {line.strip()[:200]}")

    batch = cs.images_on_card((128, 640, 640, 3), args.seed + 1)
    for shape in ((2, 72, 136), (8, 640, 640)):
        imgs = cs.images_on_card((*shape, 3), args.seed + shape[1])
        peak, p999, mx = cs.rel_err(early.early_pipeline(imgs, ep), early.early_pipeline_ref(imgs, ep))
        ok = peak < cs.TOL_PEAK and p999 < cs.TOL_P999
        cs.log(f"[check] yolov5{args.variant} {shape}: max|d|/peak {peak:.5f} p99.9 {p999:.5f} "
               f"{'ok' if ok else 'FAIL'}")
        if not ok:
            return 1
    plan = early.plan_early(ep.c0, ep.n)
    for bs in (32, 64, 128):
        ms = cs.time_ms(lambda: early.early_pipeline(batch[:bs], ep), 20, warmup=5)
        cs.log(f"[time] {card}: yolov5{args.variant} bs{bs} 640x640 tile {plan.th}x{plan.tw} bands "
               f"of {plan.rb} ring {plan.stages}: {ms:.4f} ms")
    shares = early.early_pipeline_profile(batch[:32], ep)
    cs.log(f"[profile] {card}: " + "; ".join(
        f"{k} {v}" if isinstance(v, list) else f"{k} {v:.3f}" if v < 1.5 else f"{k} {v:.0f}"
        for k, v in shares.items()))

    if args.plans:
        picked = early.plan_early
        r1 = early.tile_geometry(ep.n, plan.th, plan.tw)["r1"]
        tries = [(plan.th, plan.tw, st, rb) for st in (2, 3) for rb in (r1, plan.rb, 7, 5, 3)]
        tries += [(th, tw, 2, rb) for th, tw in early.TILES for rb in (10, 7)]
        for th, tw, st, rb in sorted(set(tries)):
            if rb > 2 * th + 1 + 2 * ep.n:
                continue
            other = early._plan_for(ep.c0, ep.n, th, tw, st, rb)
            if other.total + early.STATIC_SMEM > early.SMEM_LIMIT:
                continue
            early.plan_early = lambda c0, n, other=other: other
            ms = cs.time_ms(lambda: early.early_pipeline(batch[:64], ep), 10, warmup=3)
            cs.log(f"[plans] {card}: tile {th}x{tw} ring {st} bands of {rb} (halo factor "
                   f"{other.halo:.3f}, {other.total} B): bs64 {ms:.4f} ms")
        early.plan_early = picked

    wpack = early.pack_weights(ep).to(batch.device)
    if args.against:
        libs = {"this tree": early._lib(ep.c0)}
        libs.update({path: early._lib_with(ep.c0, source=path) for path in args.against})
        small = cs.images_on_card((3, 200, 104, 3), args.seed + 5)
        want = early.early_pipeline_ref(small, ep)
        for name, lib in libs.items():
            peak, p999, _ = cs.rel_err(early._launch(lib, small, wpack, ep.c0, ep.n), want)
            ok = peak < cs.TOL_PEAK and p999 < cs.TOL_P999
            cs.log(f"[against] {name} (3, 200, 104): max|d|/peak {peak:.5f} p99.9 {p999:.5f} "
                   f"{'ok' if ok else 'FAIL'}")
            if not ok:
                return 1
        for turn in range(3):
            for name, lib in libs.items():
                for bs in (32, 128):
                    ms = cs.time_ms(lambda: early._launch(lib, batch[:bs], wpack, ep.c0, ep.n), 20, warmup=5)
                    cs.log(f"[against] {card}: turn {turn} {name} bs{bs} {ms:.4f} ms")

    if args.ablate:
        libs = {k: early._lib_with(ep.c0, (f"EARLY_ABLATE={k}",)) for k in ABLATIONS}
        for turn in range(2):
            ms = cs.time_ms(lambda: early.early_pipeline(batch[:64], ep), 20, warmup=5)
            cs.log(f"[ablate] {card}: turn {turn} whole kernel bs64 {ms:.4f} ms")
            for k, what in ABLATIONS.items():
                ms = cs.time_ms(lambda: early._launch(libs[k], batch[:64], wpack, ep.c0, ep.n), 20, warmup=5)
                cs.log(f"[ablate] {card}: turn {turn} {what} bs64 {ms:.4f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
