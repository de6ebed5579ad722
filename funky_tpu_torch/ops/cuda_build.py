"""Build and load the port's hand-written CUDA kernels (csrc/*.cu).

Each source has a plain C interface and includes no PyTorch header, so
nvcc builds it into a shared library in seconds; the wrappers bind it with
ctypes. A source is compiled at first use, on the machine with the card,
into `funky_tpu_torch/build/<name>_<hash>.so`: a hash of the source and
the flags keys the library, so a changed source rebuilds and an unchanged
one is reused. `build_all` starts one nvcc per source at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
from typing import Dict, Iterable

PACKAGE = pathlib.Path(__file__).resolve().parent.parent
CSRC = PACKAGE / "csrc"
BUILD_DIR = PACKAGE / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# nvcc's output of the last build of each source (with -Xptxas -v:
# registers, shared memory and spills of every kernel).
BUILD_LOGS: Dict[str, str] = {}
_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for c in (shutil.which("nvcc"),
              os.path.join(home or "/usr/local/cuda", "bin", "nvcc")):
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the port's kernels are built from "
                       "funky_tpu_torch/csrc with the CUDA toolkit")


def library_path(name: str) -> pathlib.Path:
    source = CSRC / f"{name}.cu"
    key = hashlib.sha256(source.read_bytes()
                         + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}_{key}.so"


def build_all(names: Iterable[str]) -> Dict[str, pathlib.Path]:
    """Compile every named source that has no library yet, one nvcc
    process each, all started together. Returns {name: library path};
    raises with the compiler's log if any build fails."""
    out = {name: library_path(name) for name in names}
    todo = {n: p for n, p in out.items() if not p.exists()}
    if not todo:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name, path in todo.items():
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT,
                                             text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        BUILD_LOGS[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}.cu ({proc.returncode}):\n{log}")
        else:
            os.replace(tmp, todo[name])
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    return out


def load(name: str) -> ctypes.CDLL:
    """The built library of csrc/<name>.cu, built at first use."""
    if name not in _LIBS:
        _LIBS[name] = ctypes.CDLL(str(build_all([name])[name]))
    return _LIBS[name]
