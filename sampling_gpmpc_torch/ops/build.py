"""Build and load the port's CUDA kernels (``csrc/*.cu``).

Each library compiles with one ``nvcc`` from one source into a shared
library with a plain C interface, loaded with ``ctypes``: no PyTorch
headers, so a build takes seconds.  ``ipm_hard`` is ``ipm.cu`` built with
``-DIPM_SOFT=0`` (the IPM kernels' hard-only instances), and ``ipm_wide`` /
``ipm_hard_wide`` the same two with ``-DIPM_WIDE=1`` (their wide branch,
128 < nU <= 256), so the four builds of the IPM kernels compile in
parallel.  Libraries land in ``build/`` at
the repository root, named by a hash of the source, the shared header and
the flags, so an edited source rebuilds and an unchanged one is reused.
Nothing is built when a module is imported: the first launch builds, or
``build_all`` builds every library in parallel.  :func:`kernel_route` is
the one rule that picks a main-path stage's body, kernel or plain twin.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import torch

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_CSRC)), "build")
SOURCES = ("gp_sample", "gp_hall", "ipm", "ipm_hard", "ipm_wide",
           "ipm_hard_wide", "batch_linalg", "batched_chol", "glue")
# library -> (source in csrc/, extra nvcc flags); the rest build name.cu
VARIANTS = {"ipm_hard": ("ipm", ("-DIPM_SOFT=0",)),
            "ipm_wide": ("ipm", ("-DIPM_WIDE=1",)),
            "ipm_hard_wide": ("ipm", ("-DIPM_SOFT=0", "-DIPM_WIDE=1"))}
SMEM_MAX = 232448          # H100 opt-in dynamic shared memory per block (227 KB)
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict = {}
_LOCK = threading.Lock()
# stages held to their plain twin (``routes.plain_route``)
PLAIN = {"gp": False, "qp": False, "glue": False}


def kernel_route(stage: str, device) -> bool:
    """Whether ``stage`` ("gp", "qp" or "glue") on ``device`` launches its
    kernel: off the CPU, unless the stage is held plain.  A wrapper on the
    kernel route raises for a device or problem its kernel cannot take."""
    return torch.device(device).type != "cpu" and not PLAIN[stage]


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return path


def _source(name: str):
    """(source file, nvcc flags) of one library."""
    src, extra = VARIANTS.get(name, (name, ()))
    return os.path.join(_CSRC, f"{src}.cu"), FLAGS + extra


def _target(name: str) -> str:
    src, flags = _source(name)
    h = hashlib.sha256()
    for f in (src, os.path.join(_CSRC, "common.cuh")):
        with open(f, "rb") as fh:
            h.update(fh.read())
    h.update(" ".join(flags).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def _start(name: str):
    """Start nvcc for one source (None if its library is current)."""
    so = _target(name)
    if os.path.exists(so):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    log = open(so[:-3] + ".log", "w")
    src, flags = _source(name)
    proc = subprocess.Popen([_nvcc(), *flags, "-o", tmp, src], stdout=log,
                            stderr=subprocess.STDOUT)
    return proc, log, tmp, so


def _finish(job) -> None:
    proc, log, tmp, so = job
    rc = proc.wait()
    log.close()
    if rc != 0:
        with open(log.name) as fh:
            raise RuntimeError(f"nvcc failed for {so}:\n{fh.read()}")
    os.replace(tmp, so)


def build_all(names=SOURCES) -> dict:
    """Build every library at once (one nvcc each, all started together).
    Returns {name: nvcc's log text} (register and shared-memory use)."""
    jobs = [(n, _start(n)) for n in names]
    for _, job in jobs:
        if job is not None:
            _finish(job)
    logs = {}
    for n in names:
        path = _target(n)[:-3] + ".log"
        logs[n] = open(path).read() if os.path.exists(path) else ""
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of one source, built on first use."""
    with _LOCK:
        if name not in _LIBS:
            job = _start(name)
            if job is not None:
                _finish(job)
            _LIBS[name] = ctypes.CDLL(_target(name))
        return _LIBS[name]


def check(rc: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry point."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")


def check_tensor(name, t, shape, device, dtype=torch.float32) -> None:
    """What a kernel takes: ``dtype`` (float32 unless said), on ``device``,
    this shape, contiguous."""
    if t.device != device or t.dtype != dtype:
        want = str(dtype).removeprefix("torch.")
        raise ValueError(f"{name}: need {want} on {device}, got {t.dtype} "
                         f"on {t.device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)} != {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")
