"""Build the CUDA sources under ``csrc/`` at first use and load them.

Each ``csrc/*.cu`` file is compiled by its own ``nvcc`` process (all started
together) into ``build/torch_kernels/<name>-<hash>.so`` at the repository
root, with a plain C interface that ``ctypes`` loads. The hash covers the
source and the flags, so an edited source builds anew. A source can also be
built with ``-D`` switches into a second library (``load(name, defines=...)``).
Nothing here runs at import time: importing the package needs neither nvcc
nor CUDA.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

# Sources that are built once per -D set and never bare: name -> the sets that
# build_all() compiles by default (each its own nvcc process and library).
VARIANTS: Dict[str, List[Tuple[str, ...]]] = {
    "early_pipeline": [(f"EARLY_C0={c0}",) for c0 in (16, 32, 48, 64, 80)],
}

_LIBS: Dict[Tuple[str, Tuple[str, ...]], ctypes.CDLL] = {}
BUILD_LOG: Dict[str, str] = {}  # name -> nvcc's stderr (ptxas register/smem report)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda)")
    return str(path)


def _source(name: str) -> Path:
    """``csrc/<name>.cu``, or ``name`` itself where it is a path to a ``.cu``
    file (another version of a kernel, built to be timed beside this one)."""
    return Path(name) if str(name).endswith(".cu") else CSRC / f"{name}.cu"


def _flags(defines: Sequence[str]) -> List[str]:
    return NVCC_FLAGS + [f"-D{d}" for d in defines]


def _target(src: Path, defines: Sequence[str] = ()) -> Path:
    h = hashlib.sha256(src.read_bytes() + " ".join(_flags(defines)).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{src.stem}-{h}.so"


def build_all(names: Optional[List[str]] = None,
              variants: Sequence[Tuple[str, Tuple[str, ...]]] = ()) -> Dict[str, float]:
    """Compile the named sources (default: all) in parallel, each with every
    -D set ``VARIANTS`` lists for it (bare where it lists none), plus each
    (name, defines) of ``variants``; returns seconds per library built (0.0
    where a current library already existed), keyed by the name, with the
    defines appended where there are any."""
    jobs = [(s, defines) for s in sorted(CSRC.glob("*.cu")) if names is None or s.stem in names
            for defines in VARIANTS.get(s.stem, [()])]
    jobs += [(_source(name), tuple(defines)) for name, defines in variants]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    times: Dict[str, float] = {}
    for src, defines in jobs:
        key = src.stem + "".join(f" -D{d}" for d in defines)
        out = _target(src, defines)
        if out.exists():
            times[key] = 0.0
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *_flags(defines), "-o", str(tmp), str(src)]
        procs[key] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                       text=True), tmp, out, time.perf_counter())
    errors = []
    for name, (proc, tmp, out, t0) in procs.items():
        stdout, stderr = proc.communicate()
        times[name] = time.perf_counter() - t0
        BUILD_LOG[name] = stdout + stderr
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu (exit {proc.returncode}):\n{stderr}")
            continue
        os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return times


def load(name: str, defines: Sequence[str] = ()) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (compiled with ``-D`` for
    each of ``defines``), built alone if needed."""
    key = (name, tuple(defines))
    lib = _LIBS.get(key)
    if lib is None:
        src = _source(name)
        if not _target(src, defines).exists():
            build_all([], [key])
        lib = ctypes.CDLL(str(_target(src, defines)))
        _LIBS[key] = lib
    return lib
