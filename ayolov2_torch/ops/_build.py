"""Build the CUDA sources under ``csrc/`` at first use and load them.

Each ``csrc/*.cu`` file is compiled by its own ``nvcc`` process (all started
together) into ``build/torch_kernels/<name>-<hash>.so`` at the repository
root, with a plain C interface that ``ctypes`` loads. The hash covers the
source and the flags, so an edited source builds anew. Nothing here runs at
import time: importing the package needs neither nvcc nor CUDA.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Optional

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_LIBS: Dict[str, ctypes.CDLL] = {}
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


def _target(src: Path) -> Path:
    h = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{src.stem}-{h}.so"


def build_all(names: Optional[List[str]] = None) -> Dict[str, float]:
    """Compile the named sources (default: all) in parallel; returns seconds
    per source built (0.0 where a current library already existed)."""
    srcs = [s for s in sorted(CSRC.glob("*.cu")) if names is None or s.stem in names]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    times: Dict[str, float] = {}
    for src in srcs:
        out = _target(src)
        if out.exists():
            times[src.stem] = 0.0
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs[src.stem] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
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


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        src = CSRC / f"{name}.cu"
        if not _target(src).exists():
            build_all([name])
        lib = ctypes.CDLL(str(_target(src)))
        _LIBS[name] = lib
    return lib
