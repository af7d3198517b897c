#!/usr/bin/env python3
"""Times of the early-network kernel on one NVIDIA GPU, beyond what
``chip_smoke.py`` prints: where its time goes and what its plan costs.

    python3 chip_time_early.py [--variant s] [--plans] [--ablate] [--against OLD.cu]
    python3 chip_time_early.py --forms [--only x 1.05] [--sizes 1x640x640 1x336x640]
                               [--staged-tiles x:head=12x16,bottleneck=6x32 ...]

Always: the kernel against its plain version at a small and a full-size
shape, its time at bs 32, 64 and 128 at 640x640 (CUDA events), and the
shares of a ``-DEARLY_PROFILE`` build's clock stamps. ``--plans`` times other
tiles, band heights and ring depths than the one ``plan_early`` picks (bs 64,
one call, so the rows compare). ``--ablate`` times builds that leave one part
out (``-DEARLY_ABLATE=1..8``: the SiLU arithmetic, the wgmmas, the ldmatrix
loads, the epilogue's stores, the epilogue, the copies of the weights, the
wgmmas and the epilogue together, all three) beside the whole kernel, in
turns. ``--forms`` checks both forms of the plan (``plan_of_form``: fused and
staged) against the plain version for every shipped width set (s, m, l,
l_0.5, x, the width-1.05 config and the stem-8 set) at ragged and full
shapes, then times them in turns (fused, staged, staged, fused) at bs 8,
640x640, beside the cuDNN chain of the same layers, the plain version and
the bound (yolov5s also at bs 32, the 1.05 set also at bs 16, 800x800,
every set at each of ``--sizes``; device times of calls queued behind a
sleep, so that bs 1 is not paced by the host), with the staged form's
device time by kernel (``torch.profiler``); ``--only`` narrows the sets;
``--staged-tiles`` adds, for a set, the staged form with some kernels at
other tiles than the cost picks, checked and timed in the same turns. ``--against OLD.cu`` (repeatable) builds
another version of the kernel's source, one with the same C interface, for
example the parent commit's unpacked by ``git archive`` into a git-ignored
directory, checks it and times it beside the tree's in turns (every other
turn in reverse order) in the same call, the only way two versions
compare; a source without the staged form compares only where the plan
takes the fused one (``--variant n`` or ``s``). Every line carries the
card's name and power limit.
"""

from __future__ import annotations

import argparse
import sys
import time

import chip_smoke as cs

# the shipped width sets, by chip_smoke's short names
FORM_SETS = ("s", "m", "l", "l_0.5", "x", "1.05", cs.STEM8)


def staged_variant(widths, plan, tiles: dict):
    """``plan`` (staged) with the kernels named in ``tiles`` (kind -> (rows,
    columns)) at those tiles instead of the cost's: to time the cost's
    choice against others. Raises where one does not fit a block."""
    from ayolov2_torch.ops import early_pipeline as early

    parts = []
    for p in plan.parts:
        if p.kind in tiles:
            th, tw = tiles[p.kind]
            p = (early._bands(widths, th, tw, th, "head", min(4, th)) if p.kind == "head"
                 else early._plan_for(widths, th, tw, early.RING_STAGES, 0, p.kind))
            if p is None or not early._fits(p):
                raise ValueError(f"a {th}x{tw} tile of the staged form does not fit {widths}")
        parts.append(p)
    cost = early.form_cost(widths, tuple(parts))
    return early.EarlyPlan("staged", tuple(parts), cost["halo"], cost["weight_bytes"],
                           cost["act_bytes"], cost["ms"])


def parse_tiles(specs) -> dict:
    """``SET:KIND=RxC[,KIND=RxC]`` arguments -> {set: {kind: (rows, columns)}}."""
    out = {}
    for spec in specs:
        name, rest = spec.split(":", 1)
        for item in rest.split(","):
            kind, tile = item.split("=")
            out.setdefault(name, {})[kind] = tuple(int(v) for v in tile.split("x"))
    return out


def forms(card: str, seed: int, variants, sizes=(), other_tiles=None) -> int:
    """``--forms``: both forms of each width set (and the staged form at the
    tiles ``other_tiles`` names) against the plain version, then timed in
    turns beside the cuDNN chain and the bound, at bs 8, 640x640 and
    ``sizes``."""
    import torch

    from ayolov2_torch.ops import _build
    from ayolov2_torch.ops import early_pipeline as early

    t0 = time.perf_counter()
    built = _build.build_all(names=["early_pipeline"])
    cs.log(f"[build] {', '.join(f'{k}: {v:.1f} s' for k, v in built.items())} "
           f"(wall {time.perf_counter() - t0:.1f} s)")
    for name, text in _build.BUILD_LOG.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "Performance Loss" in line:
                cs.log(f"[build] {name}: {line.strip()[:200]}")
    ok = True
    for v in variants:
        model = cs.seeded_model(v, seed)
        ep = early.extract_early_params(model.state_dict()).to("cuda")
        state = {k: t.cuda() for k, t in model.state_dict().items()}
        del model
        lib = early._lib(ep.widths)
        wpack = early._packed(ep, torch.device("cuda"))
        plans = {f: early.plan_of_form(ep.widths, f) for f in early.FORMS}
        kind_tiles = (other_tiles or {}).get(v)
        if kind_tiles:
            label = "staged at " + ", ".join(f"{k} {r}x{c}" for k, (r, c) in kind_tiles.items())
            plans[label] = staged_variant(ep.widths, plans["staged"], kind_tiles)
        chosen = early.kernel_plan(ep).form
        for f, plan in plans.items():
            cs.log(f"[forms] {cs.model_name(v)} {ep.widths}: {f}: {plan.describe()}"
                   f"{' (chosen)' if f == chosen else ''}")
        for shape in ((2, 72, 136), (3, 152, 216), (1, 40, 56), (2, 640, 640)):
            imgs = cs.images_on_card((*shape, 3), seed + shape[1] + shape[2])
            want = early.early_pipeline_ref(imgs, ep)
            for f, plan in plans.items():
                got = early._launch(lib, imgs, wpack, ep.widths, plan=plan)
                torch.cuda.synchronize()
                peak, p999, mx = cs.rel_err(got, want)
                good = (got.shape == want.shape and bool(torch.isfinite(got.float()).all())
                        and peak < cs.TOL_PEAK and p999 < cs.TOL_P999)
                ok = ok and good
                cs.log(f"[forms] {cs.model_name(v)} {f} {shape}: max|d|/peak {peak:.5f} p99.9 "
                       f"{p999:.5f} max|d| {mx:.4f} {'ok' if good else 'FAIL'}")
        if not ok:
            return 1
        shapes = [(8, 640, 640)] + ([(32, 640, 640)] if v == "s" else []) + (
            [(16, 800, 800)] if v == "1.05" else []) + list(sizes)
        for shape in shapes:
            imgs = cs.images_on_card((*shape, 3), seed + 7)
            ms = {f: [] for f in plans}
            order = list(plans)
            for f in order + order[::-1]:
                ms[f].append(cs.device_ms(lambda: early._launch(lib, imgs, wpack, ep.widths,
                                                                plan=plans[f]), 20))
            torch.backends.cudnn.benchmark = True
            try:
                chain = min(cs.device_ms(lambda: c(imgs), 20) for c in
                            (cs.cudnn_chain(state, k) for k in (3, 8)))
            finally:
                torch.backends.cudnn.benchmark = False
            plain = cs.time_ms(lambda: early.early_pipeline_ref(imgs, ep), 3, warmup=1)
            bound, by, _, _ = cs.bound_of(ep, shape)
            if shape == (8, 640, 640):
                staged_breakdown(card, cs.model_name(v), lambda: early._launch(
                    lib, imgs, wpack, ep.widths, plan=plans["staged"]))
            cs.log(f"[forms] {card}: {cs.model_name(v)} bs{shape[0]} {shape[1]}x{shape[2]} "
                   "(device time, 20 calls queued behind a sleep): "
                   + "; ".join(f"{f} {' / '.join(f'{t:.4f}' for t in ts)} ms (cost "
                               f"{early.form_cost(ep.widths, plans[f].parts, shape)['ms']:.4f})"
                               for f, ts in ms.items())
                   + f"; cuDNN chain {chain:.4f} ms; plain {plain:.4f} ms; bound {bound:.4f} ms "
                   f"({by}); chosen {chosen}")
        del state, ep
        torch.cuda.empty_cache()
    return 0 if ok else 1


def staged_breakdown(card: str, name: str, call) -> None:
    """The staged form's device time by kernel (head, bottlenecks, tail) over
    5 calls, from ``torch.profiler``; a line saying so where the profiler
    records no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            call()
        torch.cuda.synchronize()
    times = {}
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", getattr(e, "cuda_time_total", 0))
        if e.key.startswith("_ZN") or "early_" in e.key:
            kind = next((k for k in ("head", "bottleneck", "tail", "pipeline") if k in e.key), None)
            if kind and us:
                times[kind] = times.get(kind, 0.0) + us / 5e3
    if not times:
        cs.log(f"[forms] {card}: {name} staged: the profiler recorded no device time")
        return
    total = sum(times.values())
    cs.log(f"[forms] {card}: {name} bs8 640x640 staged, device ms a call by kernel "
           f"(torch.profiler, 5 calls): " + ", ".join(
               f"{k} {v:.4f} ({v / total:.1%})" for k, v in times.items()) + f"; sum {total:.4f}")


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
    ap.add_argument("--forms", action="store_true")
    ap.add_argument("--only", nargs="*", default=list(FORM_SETS))
    ap.add_argument("--sizes", nargs="*", default=[], metavar="BSxHxW")
    ap.add_argument("--staged-tiles", nargs="*", default=[], metavar="SET:KIND=RxC,...")
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
    if args.forms:
        return forms(card, args.seed, args.only,
                     [tuple(int(v) for v in size.split("x")) for size in args.sizes],
                     parse_tiles(args.staged_tiles))
    ep = early.extract_early_params(cs.seeded_model(args.variant, args.seed).state_dict()).to("cuda")
    widths = early.kernel_defines(*ep.widths[:4])
    sets = [widths, widths + ("EARLY_PROFILE",)]
    sets += [widths + (f"EARLY_ABLATE={k}",) for k in ABLATIONS] if args.ablate else []
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
    plan = early.kernel_plan(ep)
    for bs in (32, 64, 128):
        ms = cs.time_ms(lambda: early.early_pipeline(batch[:bs], ep), 20, warmup=5)
        cs.log(f"[time] {card}: yolov5{args.variant} bs{bs} 640x640 {plan.describe()}: "
               f"{ms:.4f} ms")
    shares = early.early_pipeline_profile(batch[:32], ep)
    cs.log(f"[profile] {card}: " + "; ".join(
        f"{k} {v}" if isinstance(v, list) else f"{k} {v:.3f}" if v < 1.5 else f"{k} {v:.0f}"
        for k, v in shares.items()))

    wpack = early.pack_weights(ep).to(batch.device)
    if args.plans:
        # the fused form at other tiles, band heights and ring depths than its plan's
        fused = early.plan_of_form(ep.widths, "fused").parts[0]
        r1 = early.tile_geometry(ep.n, fused.th, fused.tw)["r1"]
        tries = [(fused.th, fused.tw, st, rb) for st in (2, 3) for rb in (r1, fused.rb, 7, 5, 3)]
        tries += [(th, tw, 2, rb) for th, tw in early.TILES for rb in (10, 7)]
        lib = early._lib(ep.widths)
        for th, tw, st, rb in sorted(set(tries)):
            if rb > 2 * th + 1 + 2 * ep.n:
                continue
            other = early._plan_for(ep.widths, th, tw, st, rb)
            if not early._fits(other):
                continue
            halo = early.halo_factor(ep.c0, ep.n, th, tw, c1=ep.c1, ch=ep.ch, c2=ep.c2)
            other_plan = early.EarlyPlan("fused", (other,), halo)
            ms = cs.time_ms(lambda: early._launch(lib, batch[:64], wpack, ep.widths,
                                                  plan=other_plan), 10, warmup=3)
            cs.log(f"[plans] {card}: tile {th}x{tw} ring {st} bands of {rb} (halo factor "
                   f"{halo:.3f}, {other.total} B): bs64 {ms:.4f} ms")

    if args.against:
        libs = {"this tree": early._lib(ep.widths)}
        libs.update({path: early._lib_with(ep.widths, source=path) for path in args.against})
        small = cs.images_on_card((3, 200, 104, 3), args.seed + 5)
        want = early.early_pipeline_ref(small, ep)
        for name, lib in libs.items():
            peak, p999, _ = cs.rel_err(early._launch(lib, small, wpack, ep.widths), want)
            ok = peak < cs.TOL_PEAK and p999 < cs.TOL_P999
            cs.log(f"[against] {name} (3, 200, 104): max|d|/peak {peak:.5f} p99.9 {p999:.5f} "
                   f"{'ok' if ok else 'FAIL'}")
            if not ok:
                return 1
        order = list(libs.items())
        for turn in range(4):  # in turns, every other one reversed
            for name, lib in (order if turn % 2 == 0 else order[::-1]):
                for bs in (32, 128):
                    ms = cs.time_ms(lambda: early._launch(lib, batch[:bs], wpack, ep.widths), 20, warmup=5)
                    cs.log(f"[against] {card}: turn {turn} {name} bs{bs} {ms:.4f} ms")

    if args.ablate:
        libs = {k: early._lib_with(ep.widths, (f"EARLY_ABLATE={k}",)) for k in ABLATIONS}
        for turn in range(2):
            ms = cs.time_ms(lambda: early.early_pipeline(batch[:64], ep), 20, warmup=5)
            cs.log(f"[ablate] {card}: turn {turn} whole kernel bs64 {ms:.4f} ms")
            for k, what in ABLATIONS.items():
                ms = cs.time_ms(lambda: early._launch(libs[k], batch[:64], wpack, ep.widths), 20, warmup=5)
                cs.log(f"[ablate] {card}: turn {turn} {what} bs64 {ms:.4f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
