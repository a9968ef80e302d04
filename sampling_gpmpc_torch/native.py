"""ctypes binding of the native C++ QP solver (``native/sgpmpc_qp.cpp``).

The port's own counterpart of the JAX package's ``native.py``: the same
structured soft-constraint interior-point method on the host in float64,
the cross-implementation check that ``ocp/qp.py::solve_qp_soft`` is held
against.  The library is built with ``g++`` at first use into ``build/``
at the repository root (never into ``native/``), and rebuilt when the
source is newer than it.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
import threading
from typing import Optional

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_ROOT, "native", "sgpmpc_qp.cpp")
LIBRARY = os.path.join(_ROOT, "build", "libsgpmpc_qp_native.so")
_LIB: Optional[ctypes.CDLL] = None
_LOCK = threading.Lock()


def build(force: bool = False) -> str:
    """Compile the shared library into ``build/`` if it is missing or older
    than its source; returns its path.  The compiler writes a temporary
    file that replaces the library in one step, so processes building at
    once never load a half-written one."""
    if (force or not os.path.exists(LIBRARY)
            or os.path.getmtime(LIBRARY) < os.path.getmtime(SOURCE)):
        os.makedirs(os.path.dirname(LIBRARY), exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so",
                                   dir=os.path.dirname(LIBRARY))
        os.close(fd)
        try:
            subprocess.run(["g++", "-O3", "-march=native", "-shared",
                            "-fPIC", "-o", tmp, SOURCE],
                           check=True, capture_output=True)
            os.replace(tmp, LIBRARY)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    return LIBRARY


def _lib() -> ctypes.CDLL:
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(build())
            dp = ctypes.POINTER(ctypes.c_double)
            fn = lib.sgpmpc_solve_qp_soft
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                           dp, dp, dp, dp, dp, dp, dp, dp, dp, dp, dp,
                           ctypes.c_double, ctypes.c_int, dp, dp,
                           ctypes.POINTER(ctypes.c_int)]
            _LIB = lib
        return _LIB


def solve_qp_soft_native(H, g, G_h, d_h, G_s, lo_s, hi_s, zl, zu, Zl, Zu,
                         tol: float = 1e-8, max_iter: int = 150):
    """Solve the structured soft-constraint QP with the C++ backend.

    Takes numpy arrays or tensors (copied to float64 host arrays).
    Returns (u, gap, iters, status), as the JAX package's binding does.
    """
    def arr(x):
        if hasattr(x, "detach"):
            x = x.detach().cpu().numpy()
        return np.ascontiguousarray(np.asarray(x, dtype=np.float64))

    H, g = arr(H), arr(g)
    G_h, d_h = arr(G_h), arr(d_h)
    G_s, lo_s, hi_s = arr(G_s), arr(lo_s), arr(hi_s)
    zl, zu, Zl, Zu = arr(zl), arr(zu), arr(Zl), arr(Zu)
    nU, mh, ms = g.shape[0], d_h.shape[0], lo_s.shape[0]
    if (H.shape != (nU, nU) or G_h.shape != (mh, nU)
            or G_s.size != ms * nU
            or any(a.shape != (ms,) for a in (hi_s, zl, zu, Zl, Zu))):
        raise ValueError("solve_qp_soft_native: inconsistent shapes")
    u = np.zeros(nU)
    gap = ctypes.c_double(0.0)
    iters = ctypes.c_int(0)
    dp = ctypes.POINTER(ctypes.c_double)
    p = lambda x: x.ctypes.data_as(dp)  # noqa: E731
    status = _lib().sgpmpc_solve_qp_soft(
        nU, mh, ms, p(H), p(g), p(G_h), p(d_h), p(G_s), p(lo_s), p(hi_s),
        p(zl), p(zu), p(Zl), p(Zu), tol, max_iter,
        p(u), ctypes.byref(gap), ctypes.byref(iters))
    return u, gap.value, iters.value, status
