"""Build the sources under ``csrc/`` at first use and load them.

Each ``csrc/*.cu`` file is compiled by its own ``nvcc`` process (all started
together) into ``build/torch_kernels/<name>-<hash>.so`` at the repository
root, with a plain C interface that ``ctypes`` loads. The hash covers the
source and the flags, so an edited source builds anew. A source can also be
built with ``-D`` switches into a second library (``load(name, defines=...)``).
A ``csrc/*.cpp`` file is host code (the image codecs), built the same way by
the host C++ compiler (``$CXX``, else ``c++`` or ``g++``): ``load(name)``,
or ``build_all(variants=[(name, ())])`` beside the kernels. The host sources
of ``TORCH_SOURCES`` link libtorch instead: the C++ registration of the
early-network operator (a library, never loaded into a process that has
imported the Python operator) and the native runner (an executable, built
with the registration's path); ``path(name)`` builds one and returns its
file, and their hash also covers ``torch.__version__``. A library is
written to a file of the process's own and renamed into place, so
processes that build it at once do not collide. Nothing here runs at import time: importing the
package needs neither a compiler nor CUDA.
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
CXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]
HOST_SOURCES = ("image_codec",)  # csrc/<name>.cpp, which build_all's default leaves out
# csrc/<name>.cpp built against libtorch: name -> "library" or "executable"
TORCH_SOURCES = {"early_pipeline_op": "library", "aoti_runner": "executable"}

# The early-network kernel's padded width sets (c0, c1, ch, c2) of the shipped
# configs: stem 8 (width_multiple 0.125), n, s, m, l, l_0.5 and x, and the
# width-1.05 config (stem 72, conv1 136, C3 68, conv2 272).
EARLY_SETS = ((16, 16, 16, 32), (16, 32, 16, 64), (32, 64, 32, 128), (48, 96, 48, 192),
              (64, 128, 64, 256), (80, 160, 80, 320), (80, 144, 80, 288))

# Sources that are built once per -D set and never bare: name -> the sets that
# build_all() compiles by default (each its own nvcc process and library).
# Other width sets are built at first use (``load``).
VARIANTS: Dict[str, List[Tuple[str, ...]]] = {
    "early_pipeline": [tuple(f"EARLY_{k}={c}" for k, c in zip(("C0", "C1", "CH", "C2"), s))
                       for s in EARLY_SETS],
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


def _cxx() -> str:
    for name in (os.environ.get("CXX"), "c++", "g++"):
        found = shutil.which(name) if name else None
        if found:
            return found
    raise RuntimeError("no host C++ compiler found ($CXX, c++, g++)")


def _source(name: str) -> Path:
    """``csrc/<name>.cu`` (a kernel) or else ``csrc/<name>.cpp`` (host code),
    or ``name`` itself where it is a path to a ``.cu`` file (another version
    of a kernel, built to be timed beside this one)."""
    if str(name).endswith(".cu"):
        return Path(name)
    cu = CSRC / f"{name}.cu"
    return cu if cu.exists() else CSRC / f"{name}.cpp"


def _cuda_include() -> Optional[Path]:
    """The CUDA toolkit's headers where the torch build has CUDA, else None;
    raises where torch has CUDA and the headers are missing."""
    import torch

    if torch.version.cuda is None:
        return None
    home = Path(os.environ.get("CUDA_HOME") or "/usr/local/cuda")
    if not (home / "include" / "cuda_runtime_api.h").exists():
        raise RuntimeError(f"torch {torch.__version__} has CUDA but {home}/include has no "
                           "cuda_runtime_api.h; set CUDA_HOME to the CUDA toolkit")
    return home / "include"


def _torch_flags(name: str) -> List[str]:
    """Compile flags of a ``TORCH_SOURCES`` source: libtorch's headers and
    ABI, the CUDA parts where torch has CUDA, and for the runner the path of
    the registration it opens."""
    import torch
    from torch.utils.cpp_extension import include_paths

    flags = ["-O2", "-std=c++20", "-fPIC",
             f"-D_GLIBCXX_USE_CXX11_ABI={int(torch.compiled_with_cxx11_abi())}"]
    flags += [f"-I{p}" for p in include_paths()]
    cuda = _cuda_include()
    if cuda is not None:
        flags += ["-DAYOLOV2_WITH_CUDA", f"-I{cuda}"]
    if TORCH_SOURCES[name] == "library":
        return flags + ["-shared"]
    return flags + [f"-DAYOLOV2_OP_LIBRARY=\"{_target(_source('early_pipeline_op'))}\""]


def _link_flags(src: Path) -> List[str]:
    """Flags after the source on the command line: libtorch's libraries for a
    ``TORCH_SOURCES`` source (kept with --no-as-needed: the CUDA ones register
    CUDA's hooks and the runner of a CUDA package finds no device without
    them), nothing for the others."""
    if src.stem not in TORCH_SOURCES or src.suffix != ".cpp":
        return []
    import torch

    lib = Path(torch.__file__).resolve().parent / "lib"
    cuda = ["-lc10_cuda", "-ltorch_cuda"] if torch.version.cuda is not None else []
    return [f"-L{lib}", f"-Wl,-rpath,{lib}", "-Wl,--no-as-needed", "-lc10", "-ltorch_cpu",
            "-ltorch", *cuda, "-Wl,--as-needed", "-ldl"]


def _flags(src: Path, defines: Sequence[str]) -> List[str]:
    if src.suffix == ".cpp" and src.stem in TORCH_SOURCES:
        base = _torch_flags(src.stem)
    else:
        base = CXX_FLAGS if src.suffix == ".cpp" else NVCC_FLAGS
    return base + [f"-D{d}" for d in defines]


def _target(src: Path, defines: Sequence[str] = ()) -> Path:
    flags = _flags(src, defines) + _link_flags(src)
    if src.suffix == ".cpp" and src.stem in TORCH_SOURCES:
        import torch

        flags.append(torch.__version__)
    h = hashlib.sha256(src.read_bytes() + " ".join(flags).encode()).hexdigest()[:16]
    executable = TORCH_SOURCES.get(src.stem) == "executable" and src.suffix == ".cpp"
    return BUILD_DIR / f"{src.stem}-{h}{'' if executable else '.so'}"


def build_all(names: Optional[List[str]] = None,
              variants: Sequence[Tuple[str, Tuple[str, ...]]] = ()) -> Dict[str, float]:
    """Compile the named ``.cu`` sources (default: all) in parallel, each
    with every -D set ``VARIANTS`` lists for it (bare where it lists none),
    plus each (name, defines) of ``variants`` (a kernel or a host source);
    returns seconds per library built (0.0 where a current library already
    existed), keyed by the name, with the defines appended where there are
    any. Raises with the compiler's output if any build fails."""
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
        compiler = _cxx() if src.suffix == ".cpp" else _nvcc()
        cmd = [compiler, *_flags(src, defines), "-o", str(tmp), str(src), *_link_flags(src)]
        procs[key] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                       text=True), tmp, out, time.perf_counter(), src)
    errors = []
    for name, (proc, tmp, out, t0, src) in procs.items():
        stdout, stderr = proc.communicate()
        times[name] = time.perf_counter() - t0
        BUILD_LOG[name] = stdout + stderr
        if proc.returncode != 0:
            tool = "the host compiler" if src.suffix == ".cpp" else "nvcc"
            errors.append(f"{tool} failed for {src.name} (exit {proc.returncode}):\n{stderr}")
            continue
        os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return times


def path(name: str, defines: Sequence[str] = ()) -> Path:
    """The file of ``csrc/<name>`` built with ``defines`` (a library, or the
    runner's executable), built alone if needed; raises with the compiler's
    output if it does not build."""
    src = _source(name)
    if not _target(src, defines).exists():
        build_all([], [(name, tuple(defines))])
    return _target(src, defines)


def load(name: str, defines: Sequence[str] = ()) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` or ``.cpp`` (compiled with
    ``-D`` for each of ``defines``), built alone if needed; raises with the
    compiler's output if it does not build."""
    key = (name, tuple(defines))
    lib = _LIBS.get(key)
    if lib is None:
        if name in TORCH_SOURCES:
            raise ValueError(f"{name} links libtorch and is not loaded here: use path()")
        lib = ctypes.CDLL(str(path(name, defines)))
        _LIBS[key] = lib
    return lib

