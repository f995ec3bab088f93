"""ctypes bindings for the native box-constrained solver (port of
gpmpc_tpu/native.py): a host C++ projected L-BFGS with a Python
objective-and-gradient callback, a cross-validation oracle for the solvers
on the device.

The source is the repository's `native/box_solver.cpp`, read as it stands.
It is compiled at first use with the host C++ compiler ($CXX, else c++ or
g++) into `gpmpc_tpu_torch/_build/`, as a library whose name hashes the
source and the flags; nothing is written into `native/`, and no library
built elsewhere is loaded. Nothing runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Callable, NamedTuple

import numpy as np

SOURCE = Path(__file__).resolve().parents[1] / 'native' / 'box_solver.cpp'
BUILD_DIR = Path(__file__).resolve().parent / '_build'
CXX_FLAGS = ('-O2', '-fPIC', '-shared', '-std=c++17', '-Wall')

_OBJ_GRAD = ctypes.CFUNCTYPE(ctypes.c_double,
                             ctypes.POINTER(ctypes.c_double),
                             ctypes.POINTER(ctypes.c_double),
                             ctypes.c_int, ctypes.c_void_p)


class _CStats(ctypes.Structure):
    _fields_ = [('iterations', ctypes.c_int),
                ('func_evals', ctypes.c_int),
                ('final_objective', ctypes.c_double),
                ('pg_norm', ctypes.c_double),
                ('converged', ctypes.c_int)]


class NativeSolveResult(NamedTuple):
    x: np.ndarray
    objective: float
    iterations: int
    func_evals: int
    pg_norm: float
    converged: bool


_lib = None


def find_cxx() -> str:
    """The host C++ compiler: $CXX, then c++, then g++ on PATH."""
    for name in (os.environ.get('CXX'), 'c++', 'g++'):
        if name and shutil.which(name):
            return shutil.which(name)
    raise RuntimeError('no C++ compiler found ($CXX, c++, g++)')


def library_path() -> Path:
    """The library built from SOURCE: its name hashes the source and the
    flags."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(' '.join(CXX_FLAGS).encode())
    return BUILD_DIR / f'libgpmpc_native-{h.hexdigest()[:16]}.so'


def build(rebuild: bool = False) -> Path:
    """Compile SOURCE into BUILD_DIR (unless built) and return the library's
    path. The compiler writes to a temporary file that is renamed into
    place, so a concurrent or cut build never leaves a partial library."""
    out = library_path()
    if out.exists() and not rebuild:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix='.so', dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run([find_cxx(), *CXX_FLAGS, '-o', tmp, str(SOURCE)],
                       check=True, capture_output=True, text=True)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def load_library(rebuild: bool = False):
    """Build (if needed) and load the native solver library."""
    global _lib
    if _lib is not None and not rebuild:
        return _lib
    lib = ctypes.CDLL(str(build(rebuild)))
    lib.gpmpc_solve_box.restype = ctypes.c_int
    lib.gpmpc_solve_box.argtypes = [
        _OBJ_GRAD, ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_double), ctypes.c_int,
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
        ctypes.c_int, ctypes.c_double, ctypes.POINTER(_CStats)]
    _lib = lib
    return lib


def available() -> bool:
    """Whether the library builds and loads here (a C++ toolchain)."""
    try:
        load_library()
        return True
    except (RuntimeError, OSError, subprocess.CalledProcessError):
        return False


def solve_box(objective_and_grad: Callable[[np.ndarray],
                                           tuple[float, np.ndarray]],
              x0: np.ndarray, lb: np.ndarray, ub: np.ndarray,
              max_iters: int = 300, tol: float = 1e-6) -> NativeSolveResult:
    """Minimize f over the box [lb, ub] with the native projected L-BFGS.
    objective_and_grad(x) -> (f, grad), x and grad of shape (n,), NumPy f64;
    an exception it raises is raised here after the solver returns."""
    lib = load_library()
    n = int(np.asarray(x0).size)
    x = np.ascontiguousarray(np.asarray(x0, np.float64).ravel())
    lb = np.ascontiguousarray(np.broadcast_to(np.asarray(lb, np.float64),
                                              (n,)))
    ub = np.ascontiguousarray(np.broadcast_to(np.asarray(ub, np.float64),
                                              (n,)))
    err: list = []

    @_OBJ_GRAD
    def cb(x_ptr, g_ptr, n_c, _user):
        try:
            xv = np.ctypeslib.as_array(x_ptr, shape=(n_c,)).copy()
            f, g = objective_and_grad(xv)
            gv = np.ctypeslib.as_array(g_ptr, shape=(n_c,))
            gv[:] = np.asarray(g, np.float64).ravel()
            return float(f)
        except Exception as e:   # re-raised below, after the C++ returns
            err.append(e)
            return float('nan')

    stats = _CStats()
    lib.gpmpc_solve_box(
        cb, None,
        x.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), n,
        lb.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        ub.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        int(max_iters), float(tol), ctypes.byref(stats))
    if err:
        raise err[0]
    return NativeSolveResult(x=x, objective=stats.final_objective,
                             iterations=stats.iterations,
                             func_evals=stats.func_evals,
                             pg_norm=stats.pg_norm,
                             converged=bool(stats.converged))
