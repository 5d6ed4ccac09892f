"""Build and load the port's CUDA kernels.

Each `intent_mpc_torch/csrc/<name>.cu` compiles with nvcc into a shared
library with a plain C interface, `build/kernels/<name>-<hash>.so` at the
repository root, keyed by a hash of the source and the flags; the
library is loaded with ctypes. The build happens at first use, so a
fresh checkout builds what it runs. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from typing import Dict, List

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")

# -fmad=false and no --use_fast_math: the kernels must round like the plain
# PyTorch versions (see the note at the top of each source).
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC"]

_LOADED: Dict[str, ctypes.CDLL] = {}
BUILD_SECONDS: Dict[str, float] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def kernel_names() -> List[str]:
    return sorted(f[:-3] for f in os.listdir(CSRC) if f.endswith(".cu"))


def library_path(name: str) -> str:
    src = os.path.join(CSRC, name + ".cu")
    h = hashlib.sha256()
    with open(src, "rb") as f:
        h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, "%s-%s.so" % (name, h.hexdigest()[:16]))


def start_build(name: str):
    """Start nvcc for one source unless its library exists; returns the
    process (or None) and the library path."""
    out = library_path(name)
    if os.path.exists(out):
        return None, out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = "%s.%d.tmp" % (out, os.getpid())
    cmd = [nvcc_path()] + NVCC_FLAGS + ["-o", tmp,
                                        os.path.join(CSRC, name + ".cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT)
    return (proc, tmp), out


def finish_build(name: str, handle, out: str) -> None:
    if handle is None:
        return
    proc, tmp = handle
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError("nvcc failed for %s.cu:\n%s"
                           % (name, log.decode(errors="replace")))
    os.replace(tmp, out)


def build_all() -> Dict[str, float]:
    """Compile every csrc/*.cu in parallel (one nvcc each, all started
    together) and return the seconds each took."""
    t0 = time.perf_counter()
    started = {n: start_build(n) for n in kernel_names()}
    for n, (handle, out) in started.items():
        finish_build(n, handle, out)
        BUILD_SECONDS[n] = time.perf_counter() - t0
    return dict(BUILD_SECONDS)


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, building it first if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        t0 = time.perf_counter()
        handle, out = start_build(name)
        finish_build(name, handle, out)
        if handle is not None:
            BUILD_SECONDS[name] = time.perf_counter() - t0
        lib = ctypes.CDLL(out)
        _LOADED[name] = lib
    return lib
