"""Runtime setup: device choice, dtype policy and full-f32 matmuls.

Entry points run on the GPU unless the caller passes ``device="cpu"``; a
host without CUDA raises instead of silently running on the CPU.  The
default dtype is float32 on CUDA and float64 on the CPU (the parity dtype
of the tests); ``SGPMPC_DTYPE`` overrides both.
"""

from __future__ import annotations

import os

import torch

_DTYPES = {"float32": torch.float32, "float64": torch.float64}


def full_precision() -> None:
    """Force full-f32 matmuls: the IPM Schur complements and the GP
    posterior covariances are differences of near-equal matrices, which
    TF32's ~3 decimal digits destroy."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    another one.  Raises when CUDA was asked for (or defaulted to) and is
    absent — never falls back to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run the port "
                "on the CPU")
        full_precision()
    return dev


def default_dtype(device: torch.device) -> torch.dtype:
    """``SGPMPC_DTYPE`` if set, else float32 on CUDA and float64 elsewhere."""
    name = os.environ.get("SGPMPC_DTYPE")
    if name:
        if name not in _DTYPES:
            raise ValueError(f"SGPMPC_DTYPE={name!r}; use float32 or float64")
        return _DTYPES[name]
    return torch.float32 if device.type == "cuda" else torch.float64


def resolve(device=None, dtype=None):
    """(device, dtype) of an entry point from its optional arguments."""
    dev = resolve_device(device)
    return dev, (dtype if dtype is not None else default_dtype(dev))
