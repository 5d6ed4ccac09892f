"""ctypes bindings for the native C++ QP solver and closed-loop runtime
(intent_mpc_torch/native/: the JAX package's sources, byte for byte).

The library builds with g++ on first use into
`build/native/libintentqp-<hash>.so` at the repository root, keyed by a
hash of the sources, the flags and the host's CPU model (-march=native),
as ops/build.py keys the CUDA libraries; nothing is written into the
package. Each build goes to a
name of its own and is renamed into place, so processes that build at
once never load a half-written library. `available()` is False when the
build fails; the solvers then raise with the compiler's error.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
from typing import Optional, Tuple

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE_DIR = os.path.join(_PKG, "native")
SOURCES = [os.path.join(NATIVE_DIR, "qp_solver.cpp"),
           os.path.join(NATIVE_DIR, "closed_loop.cpp")]
INCLUDES = [os.path.join(NATIVE_DIR, "closed_loop_engine.inc")]
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "native")
CXX_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-pthread"]

_lib: Optional[ctypes.CDLL] = None
_build_error: Optional[str] = None


def _cpu_model() -> str:
    """The host's CPU model and instruction-set flags: -march=native
    builds for them, so a library built on another host is not loaded."""
    found = {}
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                key = line.split(":", 1)[0].strip()
                if key in ("model name", "flags") and key not in found:
                    found[key] = line.split(":", 1)[1].strip()
    except OSError:
        pass
    return " | ".join([platform.machine()] + sorted(found.values()))


def library_path() -> str:
    h = hashlib.sha256()
    for path in SOURCES + INCLUDES:
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(CXX_FLAGS + [_cpu_model()]).encode())
    return os.path.join(BUILD_DIR, "libintentqp-%s.so" % h.hexdigest()[:16])


def _build(out: str) -> Optional[str]:
    """Compile into a temporary name and rename it to `out`; the
    compiler's error, or None."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = "%s.%d.tmp" % (out, os.getpid())
    cmd = ["g++"] + CXX_FLAGS + SOURCES + ["-o", tmp]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    except (OSError, subprocess.TimeoutExpired) as e:
        return str(e)
    if res.returncode != 0:
        return res.stderr
    os.replace(tmp, out)
    return None


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _build_error
    if _lib is not None:
        return _lib
    out = library_path()
    if not os.path.exists(out):
        _build_error = _build(out)
        if _build_error:
            return None
    lib = ctypes.CDLL(out)
    dp = ctypes.POINTER(ctypes.c_double)
    lib.imt_solve_qp.restype = ctypes.c_int
    lib.imt_solve_qp.argtypes = [
        ctypes.c_int, ctypes.c_int, dp, dp, dp, dp, dp,
        ctypes.c_double, ctypes.c_double, ctypes.c_double,
        ctypes.c_int, ctypes.c_double, ctypes.c_int, ctypes.c_int,
        dp, dp, ctypes.POINTER(ctypes.c_int), dp]
    ip = ctypes.POINTER(ctypes.c_int)
    lib.imt_solve_qp_batch.restype = ctypes.c_int
    lib.imt_solve_qp_batch.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, dp, dp, dp, dp, dp,
        ctypes.c_double, ctypes.c_double, ctypes.c_double,
        ctypes.c_int, ctypes.c_double, ctypes.c_int, ctypes.c_int,
        dp, dp, ip, ip, dp, ctypes.c_int]
    lib.imt_run_episode.restype = ctypes.c_int
    lib.imt_run_episode.argtypes = [
        ctypes.c_uint32, ctypes.c_int, ctypes.c_double, ctypes.c_double,
        ctypes.c_int, ctypes.c_int, ctypes.c_double, ctypes.c_int,
        ctypes.c_int, dp]
    lib.imt_world_probe.restype = ctypes.c_int
    lib.imt_world_probe.argtypes = [ctypes.c_uint32, ctypes.c_int,
                                    ctypes.c_double, ctypes.c_double,
                                    dp, dp, dp]
    lib.imt_intent_probe.restype = ctypes.c_int
    lib.imt_intent_probe.argtypes = [dp, dp, ctypes.c_int, dp]
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


def build_error() -> Optional[str]:
    """The compiler's error of the last failed build, or None."""
    return _build_error


def _require(what: str) -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native {what} unavailable: {_build_error}")
    return lib


def solve_qp(h_diag, q, A, l, u, rho=0.1, sigma=1e-6, alpha=1.6,
             max_iter=4000, eps=1e-9, scaling=10, adapt_interval=25,
             x0=None) -> Tuple[np.ndarray, np.ndarray, int, int]:
    """Solve min 1/2 x'diag(h)x + q'x s.t. l <= Ax <= u in f64.

    x0: optional primal warm start (reference protocol: primal from the
    previous solution, dual zero — mpcPlanner.cpp:485-509).
    Returns (x, y, status, iters); status 0 = converged, 1 = max_iter."""
    lib = _require("QP solver")
    h_diag = np.ascontiguousarray(h_diag, np.float64)
    q = np.ascontiguousarray(q, np.float64)
    A = np.ascontiguousarray(A, np.float64)
    l = np.ascontiguousarray(l, np.float64)
    u = np.ascontiguousarray(u, np.float64)
    n, m = h_diag.shape[0], A.shape[0]
    if A.shape != (m, n) or q.shape != (n,) or l.shape != (m,) \
            or u.shape != (m,):
        raise ValueError("solve_qp: shapes h %s q %s A %s l %s u %s"
                         % (h_diag.shape, q.shape, A.shape, l.shape, u.shape))
    x = np.zeros(n)
    y = np.zeros(m)
    iters = ctypes.c_int(0)
    dp = ctypes.POINTER(ctypes.c_double)

    def p(a):
        return a.ctypes.data_as(dp)

    if x0 is not None:
        x0 = np.ascontiguousarray(x0, np.float64)
        if x0.shape != (n,):
            raise ValueError("solve_qp: x0 shape %s" % (x0.shape,))
        x0p = p(x0)
    else:
        x0p = ctypes.cast(None, ctypes.POINTER(ctypes.c_double))
    status = lib.imt_solve_qp(n, m, p(h_diag), p(q), p(A), p(l), p(u),
                              rho, sigma, alpha, max_iter, eps, scaling,
                              adapt_interval, p(x), p(y),
                              ctypes.byref(iters), x0p)
    return x, y, status, iters.value


def solve_qp_batch(h_diag, q, A, l, u, rho=0.1, sigma=1e-6, alpha=1.6,
                   max_iter=4000, eps=1e-9, scaling=10, adapt_interval=25,
                   x0=None, nthreads=0):
    """Batched solve_qp over stacked problems (q (P,n), A (P,m,n),
    l/u (P,m), optional x0 (P,n)) with std::thread workers in the native
    library — the parallel executor for oracle-in-the-loop runs.
    Returns (x (P,n), y (P,m), status (P,), iters (P,))."""
    lib = _require("QP solver")
    h_diag = np.ascontiguousarray(h_diag, np.float64)
    q = np.ascontiguousarray(q, np.float64)
    A = np.ascontiguousarray(A, np.float64)
    l = np.ascontiguousarray(l, np.float64)
    u = np.ascontiguousarray(u, np.float64)
    P, m, n = A.shape
    if h_diag.shape != (n,) or q.shape != (P, n) or l.shape != (P, m) \
            or u.shape != (P, m):
        raise ValueError("solve_qp_batch: shapes h %s q %s A %s l %s u %s"
                         % (h_diag.shape, q.shape, A.shape, l.shape, u.shape))
    x = np.zeros((P, n))
    y = np.zeros((P, m))
    status = np.zeros(P, np.int32)
    iters = np.zeros(P, np.int32)
    dp = ctypes.POINTER(ctypes.c_double)
    ip = ctypes.POINTER(ctypes.c_int)

    def p(a):
        return a.ctypes.data_as(dp)

    if x0 is not None:
        x0 = np.ascontiguousarray(x0, np.float64)
        if x0.shape != (P, n):
            raise ValueError("solve_qp_batch: x0 shape %s" % (x0.shape,))
        x0p = p(x0)
    else:
        x0p = ctypes.cast(None, dp)
    lib.imt_solve_qp_batch(P, n, m, p(h_diag), p(q), p(A), p(l), p(u),
                           rho, sigma, alpha, max_iter, eps, scaling,
                           adapt_interval, p(x), p(y),
                           status.ctypes.data_as(ip),
                           iters.ctypes.data_as(ip), x0p, nthreads)
    return x, y, status, iters


_EP_FIELDS = ("goal_reached", "travel_time", "collision", "path_length",
              "min_obstacle_distance", "vel_violations", "acc_violations",
              "jerk_violations", "samples", "jerk_samples", "max_velocity",
              "solve_attempts", "solve_successes")


def run_native_episode(seed: int, num_obstacles: int = 200,
                       dynamic_ratio: float = 0.65, timeout: float = 60.0,
                       max_obstacles: int = 64, max_iter: int = 150,
                       eps: float = 1e-3, adapt_interval: int = 50,
                       nthreads: int = 6) -> dict:
    """Run one full benchmark trial entirely in the native C++ runtime
    (native/closed_loop.cpp): world -> detector -> predictor ->
    6-candidate QP planning -> scoring -> controller -> metrics, with the
    f64 solver. The system-level oracle, independent of PyTorch."""
    lib = _require("runtime")
    out = np.zeros(13)
    dp = ctypes.POINTER(ctypes.c_double)
    rc = lib.imt_run_episode(seed, num_obstacles, dynamic_ratio, timeout,
                             max_obstacles, max_iter, eps, adapt_interval,
                             nthreads, out.ctypes.data_as(dp))
    if rc != 0:
        raise RuntimeError(f"imt_run_episode failed: {rc}")
    d = dict(zip(_EP_FIELDS, out.tolist()))
    d["goal_reached"] = bool(d["goal_reached"])
    d["collision"] = bool(d["collision"])
    return d


def native_world_probe(seed: int, n: int, dynamic_ratio: float, t: float):
    """The native world's obstacle positions, boxes and static flags."""
    lib = _require("runtime")
    out_p = np.zeros((n, 3))
    out_b = np.zeros((n, 3))
    out_s = np.zeros(n)
    dp = ctypes.POINTER(ctypes.c_double)
    lib.imt_world_probe(seed, n, dynamic_ratio, t,
                        out_p.ctypes.data_as(dp), out_b.ctypes.data_as(dp),
                        out_s.ctypes.data_as(dp))
    return out_p, out_b, out_s.astype(bool)


def native_intent_probe(pos_hist, vel_hist):
    """The native predictor's 4 intent probabilities of one history."""
    lib = _require("runtime")
    ph = np.ascontiguousarray(pos_hist, np.float64)
    vh = np.ascontiguousarray(vel_hist, np.float64)
    if ph.shape != vh.shape or ph.ndim != 2 or ph.shape[1] != 3:
        raise ValueError("native_intent_probe: histories %s and %s"
                         % (ph.shape, vh.shape))
    out = np.zeros(4)
    dp = ctypes.POINTER(ctypes.c_double)
    lib.imt_intent_probe(ph.ctypes.data_as(dp), vh.ctypes.data_as(dp),
                         ph.shape[0], out.ctypes.data_as(dp))
    return out
