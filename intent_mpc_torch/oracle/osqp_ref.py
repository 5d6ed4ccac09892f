"""ctypes binding to the reference's vendored libosqp (the REAL OSQP): the
port's copy of the JAX package's binding, which loads the library from
`reference/` at the repository's root (see _LIB_PATH).

The reference links the exact binary at
trajectory_planner/include/trajectory_planner/third_party/lib/x86/libosqp.so
(OSQP 0.6.2 per third_party/osqp/constants.h:12) through the OsqpEigen
facade (third_party/OsqpEigen/Solver.hpp, used at mpcPlanner.cpp:436-527).
Every other oracle in this repo (oracle/numpy_ref.py, the port's copy of
the JAX package's; native/qp_solver.cpp) was written by the same author
from the same algorithm spec; this module is the external anchor —
identical QP matrices go through the very solver binary the reference
flies.

ABI determined from the vendored headers (read, not guessed):
  - osqp_configure.h: DLONG defined  -> c_int   = int64
                      DFLOAT undef   -> c_float = double
                      PROFILING + PRINTING defined, EMBEDDED undefined
  - types.h:          csc / OSQPData / OSQPSettings / OSQPInfo /
                      OSQPSolution / OSQPWorkspace layouts
  - constants.h:      defaults (RHO 0.1, MAX_ITER 4000, EPS 1e-3, ...)

The layout is self-verified at import: osqp_set_default_settings() must
reproduce every documented default through our struct definition, else
an offset is wrong and we refuse to run (see _verify_abi).

Reference runtime protocol (mpcPlanner.cpp:439-527) reproduced by
solve(): fresh setup per solve (new OsqpEigen::Solver per candidate),
verbose off, warm_start on, time_limit set only when not firstTime_,
warm primal = previous solution / warm dual = zeros, all other settings
OSQP defaults (NO polish — constants.h POLISH(0), never overridden).
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

# the reference's vendored tree, placed at the repository's root
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_LIB_PATH = os.path.join(_ROOT, "reference", "trajectory_planner", "include",
                         "trajectory_planner", "third_party", "lib", "x86",
                         "libosqp.so")

c_int = ctypes.c_int64      # DLONG
c_float = ctypes.c_double   # not DFLOAT

OSQP_INFTY = 1e30

# status values (constants.h:18-30)
OSQP_SOLVED = 1
OSQP_SOLVED_INACCURATE = 2
OSQP_MAX_ITER_REACHED = -2
OSQP_TIME_LIMIT_REACHED = -6


class _csc(ctypes.Structure):
    _fields_ = [("nzmax", c_int), ("m", c_int), ("n", c_int),
                ("p", ctypes.POINTER(c_int)), ("i", ctypes.POINTER(c_int)),
                ("x", ctypes.POINTER(c_float)), ("nz", c_int)]


class _OSQPData(ctypes.Structure):
    _fields_ = [("n", c_int), ("m", c_int),
                ("P", ctypes.POINTER(_csc)), ("A", ctypes.POINTER(_csc)),
                ("q", ctypes.POINTER(c_float)),
                ("l", ctypes.POINTER(c_float)),
                ("u", ctypes.POINTER(c_float))]


class _OSQPSettings(ctypes.Structure):
    # types.h:139-176 with EMBEDDED undefined, PROFILING defined.
    # linsys_solver is a C enum -> 32-bit int on linux x86-64; ctypes
    # auto-pads the following double to 8-byte alignment.
    _fields_ = [
        ("rho", c_float), ("sigma", c_float), ("scaling", c_int),
        ("adaptive_rho", c_int), ("adaptive_rho_interval", c_int),
        ("adaptive_rho_tolerance", c_float),
        ("adaptive_rho_fraction", c_float),
        ("max_iter", c_int), ("eps_abs", c_float), ("eps_rel", c_float),
        ("eps_prim_inf", c_float), ("eps_dual_inf", c_float),
        ("alpha", c_float), ("linsys_solver", ctypes.c_int32),
        ("delta", c_float), ("polish", c_int),
        ("polish_refine_iter", c_int), ("verbose", c_int),
        ("scaled_termination", c_int), ("check_termination", c_int),
        ("warm_start", c_int), ("time_limit", c_float)]


class _OSQPInfo(ctypes.Structure):
    # types.h:66-91
    _fields_ = [
        ("iter", c_int), ("status", ctypes.c_char * 32),
        ("status_val", c_int), ("status_polish", c_int),
        ("obj_val", c_float), ("pri_res", c_float), ("dua_res", c_float),
        ("setup_time", c_float), ("solve_time", c_float),
        ("update_time", c_float), ("polish_time", c_float),
        ("run_time", c_float),
        ("rho_updates", c_int), ("rho_estimate", c_float)]


class _OSQPSolution(ctypes.Structure):
    _fields_ = [("x", ctypes.POINTER(c_float)),
                ("y", ctypes.POINTER(c_float))]


class _OSQPWorkspace(ctypes.Structure):
    # types.h:182-289; only data/settings/solution/info are dereferenced,
    # the rest are opaque pointers kept for correct field offsets.
    _fields_ = (
        [("data", ctypes.POINTER(_OSQPData)),
         ("linsys_solver", ctypes.c_void_p),
         ("pol", ctypes.c_void_p),
         ("rho_vec", ctypes.POINTER(c_float)),
         ("rho_inv_vec", ctypes.POINTER(c_float)),
         ("constr_type", ctypes.POINTER(c_int))]
        + [(nm, ctypes.POINTER(c_float)) for nm in
           ("x", "y", "z", "xz_tilde", "x_prev", "z_prev", "Ax", "Px",
            "Aty", "delta_y", "Atdelta_y", "delta_x", "Pdelta_x",
            "Adelta_x", "D_temp", "D_temp_A", "E_temp")]
        + [("settings", ctypes.POINTER(_OSQPSettings)),
           ("scaling", ctypes.c_void_p),
           ("solution", ctypes.POINTER(_OSQPSolution)),
           ("info", ctypes.POINTER(_OSQPInfo)),
           ("timer", ctypes.c_void_p),
           ("first_run", c_int), ("clear_update_time", c_int),
           ("rho_update_from_solve", c_int), ("summary_printed", c_int)])


_lib = None


def _load():
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(_LIB_PATH)
    lib.osqp_set_default_settings.argtypes = [
        ctypes.POINTER(_OSQPSettings)]
    lib.osqp_set_default_settings.restype = None
    lib.osqp_setup.argtypes = [
        ctypes.POINTER(ctypes.POINTER(_OSQPWorkspace)),
        ctypes.POINTER(_OSQPData), ctypes.POINTER(_OSQPSettings)]
    lib.osqp_setup.restype = c_int
    lib.osqp_solve.argtypes = [ctypes.POINTER(_OSQPWorkspace)]
    lib.osqp_solve.restype = c_int
    lib.osqp_cleanup.argtypes = [ctypes.POINTER(_OSQPWorkspace)]
    lib.osqp_cleanup.restype = c_int
    lib.osqp_warm_start.argtypes = [
        ctypes.POINTER(_OSQPWorkspace),
        ctypes.POINTER(c_float), ctypes.POINTER(c_float)]
    lib.osqp_warm_start.restype = c_int
    _verify_abi(lib)
    _lib = lib
    return lib


def _verify_abi(lib):
    """osqp_set_default_settings must reproduce constants.h:59-119 through
    our struct layout — a single wrong offset breaks at least one field."""
    s = _OSQPSettings()
    lib.osqp_set_default_settings(ctypes.byref(s))
    expect = dict(rho=0.1, sigma=1e-6, scaling=10, adaptive_rho=1,
                  adaptive_rho_interval=0, adaptive_rho_tolerance=5.0,
                  adaptive_rho_fraction=0.4, max_iter=4000, eps_abs=1e-3,
                  eps_rel=1e-3, eps_prim_inf=1e-4, eps_dual_inf=1e-4,
                  alpha=1.6, linsys_solver=0, delta=1e-6, polish=0,
                  polish_refine_iter=3, verbose=1, scaled_termination=0,
                  check_termination=25, warm_start=1, time_limit=0.0)
    for k, v in expect.items():
        got = getattr(s, k)
        if abs(float(got) - float(v)) > 1e-12:
            raise RuntimeError(
                f"OSQP ABI self-check failed: settings.{k} = {got}, "
                f"expected {v} (struct layout mismatch)")


def available() -> bool:
    if not os.path.exists(_LIB_PATH):
        return False
    try:
        _load()
        return True
    except (OSError, AttributeError, RuntimeError):
        # not loadable, a symbol missing, or the ABI self-check failed
        return False


def _dense_to_csc(M, upper=False):
    """Column-compressed storage of a dense matrix (drop exact zeros).

    Vectorized — this runs per candidate solve on the closed-loop path.
    With upper=True, diagonal entries are kept even when exactly zero,
    matching the reference's Eigen sparse insert of every diagonal
    Hessian coefficient (castMPCToQPHessian inserts velocity weights of
    0.0 as structural entries)."""
    M = np.asarray(M, np.float64)
    m, n = M.shape
    Mt = (np.triu(M) if upper else M).T.copy()
    if upper:
        d = np.arange(min(m, n))
        zd = d[Mt[d, d] == 0.0]
        Mt[zd, zd] = np.nan                     # sentinel: keep as entry
    jj, ii = np.nonzero(Mt)                     # column-major scan
    x = Mt[jj, ii]
    if upper:
        x[np.isnan(x)] = 0.0
    p = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(jj, minlength=n), out=p[1:])
    return p, ii.astype(np.int64), x, m, n


def _make_csc(p, i, x, m, n):
    nnz = len(x)
    c = _csc()
    c.nzmax = max(nnz, 1)
    c.m = m
    c.n = n
    c.nz = -1
    # keep numpy buffers alive by attaching them
    c._pbuf = np.ascontiguousarray(p, np.int64)
    c._ibuf = np.ascontiguousarray(i, np.int64)
    c._xbuf = np.ascontiguousarray(x, np.float64)
    c.p = c._pbuf.ctypes.data_as(ctypes.POINTER(c_int))
    c.i = c._ibuf.ctypes.data_as(ctypes.POINTER(c_int))
    c.x = c._xbuf.ctypes.data_as(ctypes.POINTER(c_float))
    return c


def solve(P, q, A, l, u, *, eps_abs=1e-3, eps_rel=1e-3, max_iter=4000,
          polish=False, time_limit=0.0, warm_x=None, warm_y=None,
          verbose=False, check_termination=25, adaptive_rho=True,
          delta=1e-6, polish_refine_iter=3):
    """Solve one dense-described QP with the reference's actual libosqp.

    Defaults are the OSQP 0.6.2 defaults = exactly what the reference
    flies (it only flips verbose off, warm_start on, and sets time_limit
    after the first solve — mpcPlanner.cpp:439-444).

    Returns dict with x, y, status_val, status, iters, pri_res, dua_res,
    obj_val, solve_time, run_time, status_polish.
    """
    lib = _load()
    P = np.asarray(P, np.float64)
    q = np.ascontiguousarray(q, np.float64)
    l = np.ascontiguousarray(np.clip(l, -OSQP_INFTY, OSQP_INFTY), np.float64)
    u = np.ascontiguousarray(np.clip(u, -OSQP_INFTY, OSQP_INFTY), np.float64)
    n = P.shape[0]
    m = A.shape[0]

    Pc = _make_csc(*_dense_to_csc(P, upper=True))
    Ac = _make_csc(*_dense_to_csc(A))

    data = _OSQPData()
    data.n = n
    data.m = m
    data.P = ctypes.pointer(Pc)
    data.A = ctypes.pointer(Ac)
    data.q = q.ctypes.data_as(ctypes.POINTER(c_float))
    data.l = l.ctypes.data_as(ctypes.POINTER(c_float))
    data.u = u.ctypes.data_as(ctypes.POINTER(c_float))

    st = _OSQPSettings()
    lib.osqp_set_default_settings(ctypes.byref(st))
    st.verbose = 1 if verbose else 0
    st.warm_start = 1
    st.eps_abs = eps_abs
    st.eps_rel = eps_rel
    st.max_iter = max_iter
    st.polish = 1 if polish else 0
    st.delta = delta
    st.polish_refine_iter = polish_refine_iter
    st.time_limit = time_limit
    st.check_termination = check_termination
    st.adaptive_rho = 1 if adaptive_rho else 0

    workp = ctypes.POINTER(_OSQPWorkspace)()
    rc = lib.osqp_setup(ctypes.byref(workp), ctypes.byref(data),
                        ctypes.byref(st))
    if rc != 0:
        raise RuntimeError(f"osqp_setup failed (error {rc})")
    try:
        if warm_x is not None:
            wx = np.ascontiguousarray(warm_x, np.float64)
            wy = np.ascontiguousarray(
                warm_y if warm_y is not None else np.zeros(m), np.float64)
            rc = lib.osqp_warm_start(
                workp, wx.ctypes.data_as(ctypes.POINTER(c_float)),
                wy.ctypes.data_as(ctypes.POINTER(c_float)))
            if rc != 0:
                raise RuntimeError(f"osqp_warm_start failed ({rc})")
        rc = lib.osqp_solve(workp)
        if rc != 0:
            raise RuntimeError(f"osqp_solve failed (error {rc})")
        w = workp.contents
        info = w.info.contents
        sol = w.solution.contents
        x = np.ctypeslib.as_array(sol.x, shape=(n,)).copy()
        y = np.ctypeslib.as_array(sol.y, shape=(m,)).copy()
        return dict(
            x=x, y=y, status_val=int(info.status_val),
            status=info.status.decode(), iters=int(info.iter),
            pri_res=float(info.pri_res), dua_res=float(info.dua_res),
            obj_val=float(info.obj_val),
            solve_time=float(info.solve_time),
            run_time=float(info.run_time),
            status_polish=int(info.status_polish))
    finally:
        lib.osqp_cleanup(workp)


def solve_converged(P, q, A, l, u, eps=1e-9, max_iter=200000):
    """Convergence-mode solve + polish: the ground-truth configuration for
    matrix-level parity (tight tolerances, polish on, no time limit)."""
    return solve(P, q, A, l, u, eps_abs=eps, eps_rel=eps,
                 max_iter=max_iter, polish=True)
