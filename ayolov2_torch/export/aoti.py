"""AOTInductor packages of the serving artifact, for the native runner.

The JAX package writes ``.stablehlo`` and ``.compile_options.pb`` beside its
artifact, and its C++ runner compiles them (``cpp/src/pjrt_runner/``). Here
the compile is this step: :func:`package_serving` reads an artifact of
:func:`~ayolov2_torch.export.exporter.export_serving` (``{name}.pt2`` and its
sidecar ``{name}.yaml``), compiles it with ``aoti_compile_and_package`` for
the device it was made for, and writes ``{name}.aoti.pt2``, which the runner
(``csrc/aoti_runner.cpp``) serves without Python.

Inside the package inductor emits its own code for the graph's elementwise
parts; the convolutions stay library calls (cuDNN on the card), and the
early-network operator ``ayolov2::early_pipeline`` stays the hand-written
kernel, called through the package's proxy executor, so the process that
runs the package needs the operator registered from C++
(``csrc/early_pipeline_op.cpp``). That registration knows neither the
kernel's plan nor its library: the sidecar's ``aoti`` section lists, for
each call of the operator in the graph, its widths and, in a package for the
card, the 14 ints of ``plan_early`` and the path of the kernel's library for
that width set, which the runner passes on before its first call.

The package rounds as the artifact does: inductor fuses the graph's
elementwise steps and would otherwise keep their bf16 intermediates in f32
(``emulate_precision_casts`` rounds each to bf16 where eager torch does).
On the CPU this makes a bf16 package equal to the ``.pt2`` bit for bit; on
the card, without it, the runner's detections of a seeded yolov5s parted
from the ``.pt2``'s (PERF.md).

Inductor compiles the package's C++ with ``-fopenmp``. Where the host
compiler cannot link OpenMP (a gcc without libgomp), a package for the card
is compiled through a wrapper of the compiler that leaves ``-fopenmp`` and
``-lgomp`` out: its host code runs no parallel loops (the graph's work is
the card's), and the sidecar's ``openmp`` says which was used. A CPU
package needs OpenMP and raises there as inductor does.
"""

from __future__ import annotations

import json
import logging
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, List

import torch

from ayolov2_torch.ops import _build
from ayolov2_torch.ops import early_pipeline as early

LOGGER = logging.getLogger(__name__)


def early_calls(program: torch.export.ExportedProgram, device: torch.device) -> List[Dict]:
    """One entry per call of ``ayolov2::early_pipeline`` in the graph: its
    widths (c0, c1, ch, c2, n), and on the card the kernel's plan, tile and
    library (built here if it is not yet)."""
    op = torch.ops.ayolov2.early_pipeline.default
    names = [a.name for a in op._schema.arguments]
    calls = []
    for node in program.graph.nodes:
        if node.op != "call_function" or node.target is not op:
            continue
        args = {**dict(zip(names, node.args)), **node.kwargs}
        widths = early.widths_of(args["c0"], args["n"], args.get("c1"), args.get("ch"),
                                 args.get("c2"))
        entry: Dict = {"widths": list(widths)}
        if device.type == "cuda":
            c0, c1, ch, c2, n = widths
            plan = early.plan_early(c0, n, c1, ch, c2)
            entry.update(plan=plan.as_ints(), tile=[plan.th, plan.tw], library=str(
                _build.path("early_pipeline", early.kernel_defines(c0, c1, ch, c2))))
        calls.append(entry)
    return calls


WITHOUT_OPENMP = """#!/bin/sh
# {cxx} without -fopenmp and -lgomp (written by ayolov2_torch/export/aoti.py)
for a; do shift; case "$a" in -fopenmp|-lgomp) ;; *) set -- "$@" "$a";; esac; done
exec {cxx} "$@"
"""


def openmp_links(cxx: str) -> bool:
    """Whether ``cxx`` compiles and links a program with ``-fopenmp``."""
    with tempfile.TemporaryDirectory() as d:
        src = Path(d) / "omp.cpp"
        src.write_text("#include <omp.h>\nint main() { return omp_get_max_threads() < 1; }\n")
        try:
            r = subprocess.run([cxx, "-fopenmp", str(src), "-o", str(Path(d) / "omp")],
                               capture_output=True, timeout=120)
        except OSError:
            return False
        return r.returncode == 0


def compiler_without_openmp(cxx: str) -> Path:
    """A wrapper script of ``cxx`` that drops ``-fopenmp`` and ``-lgomp``,
    under ``build/torch_kernels/``."""
    path = _build.BUILD_DIR / "cxx_without_openmp.sh"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(WITHOUT_OPENMP.format(cxx=cxx))
    path.chmod(0o755)
    return path


def package_serving(pt2_path: str) -> Dict[str, str]:
    """Compile ``{name}.pt2`` into ``{name}.aoti.pt2``; returns the paths of
    the package (``aoti``) and of the sidecar (``yaml``), to which an
    ``aoti`` section is added: the package's file name, its device, the
    compile's seconds, torch's version and the early-network calls
    (:func:`early_calls`).

    The artifact is saved without its example input (a zero batch of 39 MB
    at bs 32, 640), and the compile needs one: it is made again from the
    sidecar's ``input`` shape, on the artifact's device."""
    pt2 = Path(pt2_path)
    yaml_path = pt2.with_suffix(".yaml")
    sidecar = json.loads(yaml_path.read_text())
    device = torch.device(sidecar["platforms"][0])
    program = torch.export.load(str(pt2))
    example = torch.zeros(sidecar["input"]["shape"], dtype=torch.uint8, device=device)
    program.example_inputs = ((example,), {})
    out = pt2.with_name(pt2.stem + ".aoti.pt2")
    cxx = torch._inductor.config.cpp.cxx[1] or _build._cxx()
    openmp = device.type != "cuda" or openmp_links(cxx)
    patch = {"emulate_precision_casts": True}
    if not openmp:
        patch["cpp.cxx"] = (None, str(compiler_without_openmp(cxx)))
    t0 = time.perf_counter()
    with torch._inductor.config.patch(patch):
        torch._inductor.aoti_compile_and_package(program, package_path=str(out))
    seconds = time.perf_counter() - t0
    sidecar["aoti"] = {"package": out.name, "device": device.type, "openmp": openmp,
                       "compile_s": round(seconds, 3), "torch": torch.__version__,
                       "early_pipeline": early_calls(program, device)}
    yaml_path.write_text(json.dumps(sidecar, indent=2) + "\n")
    LOGGER.info("packaged %s for %s in %.1f s (%d early-network call(s))", out, device.type,
                seconds, len(sidecar["aoti"]["early_pipeline"]))
    return {"aoti": str(out), "yaml": str(yaml_path)}
