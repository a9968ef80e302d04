"""Carry parameters and state from the JAX package into the port.

The JAX side hands its arrays over as numpy (``np.asarray`` of each leaf);
these functions turn them into the port's tensors on a chosen device and
dtype.  The parity tests use them to hold each module of the port against
its JAX counterpart on identical inputs.
"""

from __future__ import annotations

import numpy as np
import torch

from sampling_gpmpc_torch import setup
from sampling_gpmpc_torch.agent import GPState
from sampling_gpmpc_torch.gp.exact import GPHyperArrays
from sampling_gpmpc_torch.ocp.spec import OCPData


def _t(a, device, dtype):
    return torch.as_tensor(np.array(a), dtype=dtype, device=device)


def hyper(lengthscale, outputscale, noise_diag, jitter, beta,
          variance_is_zero, min_data_dist, device=None,
          dtype=None) -> GPHyperArrays:
    """GPHyperArrays from the JAX GPHyperArrays' fields."""
    device, dtype = setup.resolve(device, dtype)
    return GPHyperArrays(
        lengthscale=_t(lengthscale, device, dtype),
        outputscale=_t(outputscale, device, dtype),
        noise_diag=_t(noise_diag, device, dtype), jitter=float(jitter),
        beta=float(beta), variance_is_zero=float(variance_is_zero),
        min_data_dist=float(min_data_dist))


def gp_state(real_Z, real_Y, real_fact: dict, hall_Z, hall_Y, hall_n,
             device=None, dtype=None) -> GPState:
    """GPState from the JAX GPState's fields (``real_fact`` a dict of
    arrays with keys L, w, mask, Linv, alpha), filled hall buffer
    included."""
    device, dtype = setup.resolve(device, dtype)
    return GPState(
        real_Z=_t(real_Z, device, dtype), real_Y=_t(real_Y, device, dtype),
        real_fact={k: _t(v, device, dtype) for k, v in real_fact.items()},
        hall_Z=_t(hall_Z, device, dtype), hall_Y=_t(hall_Y, device, dtype),
        hall_n=int(hall_n))


def update_factor(uf: dict, device=None, dtype=None) -> dict:
    """The block-update factor dict of the JAX ``batched_update_factor``
    (keys C, L_s, alpha_r, alpha_h, w_h, mask_h; leading (ns, g_ny)), or
    its w-form without the alphas (C, L_s, w_h, mask_h) that the
    forward-sampling rollout carries."""
    device, dtype = setup.resolve(device, dtype)
    keys = ("C", "L_s", "w_h", "mask_h") + tuple(
        k for k in ("alpha_r", "alpha_h") if k in uf)
    return {k: _t(uf[k], device, dtype) for k in keys}


def ocp_data(fields: dict, device=None, dtype=None) -> OCPData:
    """OCPData from the JAX OCPData's ``_asdict()``."""
    device, dtype = setup.resolve(device, dtype)
    return OCPData(**{k: _t(fields[k], device, dtype)
                      for k in OCPData._fields})


def qp_warm_start(state, device=None, dtype=None) -> tuple:
    """The QP warm-start 11-tuple (u, sl, su, th, lh, tU, lU, tL, lL, nl, nu)."""
    device, dtype = setup.resolve(device, dtype)
    return tuple(_t(a, device, dtype) for a in state)
