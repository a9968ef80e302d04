"""Per-sample condensing of affine-dynamics trajectories onto the input.

The augmented OCP couples the ns sampled dynamics only through the shared
input (ref: src/utils/model.py:10-41), so each sample is condensed onto
dU = (du_0..du_{H-1}) on its own, batched over samples.  For

    dx_{k+1} = A_k dx_k + B_k du_k + r_k,     dx_0 fixed,

the affine map is  dx_k = T_k + Gamma_k dU  with

    T_0 = dx_0,            T_{k+1} = A_k T_k + r_k
    Gamma_0 = 0,           Gamma_{k+1} = A_k Gamma_k + B_k e_k^T .

Shapes: A (ns, H, nx, nx), B (ns, H, nx, nu), r (ns, H, nx), dx0 (ns, nx)
-> T (ns, H+1, nx), Gamma (ns, H+1, nx, H*nu).
"""

from __future__ import annotations

import torch


def condense(A, B, r, dx0):
    """Sequential condensing: the recursion above, stage by stage."""
    ns, H, nx, nu = B.shape
    T = [dx0]
    G = [A.new_zeros((ns, nx, H * nu))]
    for k in range(H):
        G_n = A[:, k] @ G[-1]
        G_n[:, :, k * nu:(k + 1) * nu] = B[:, k]
        T.append((A[:, k] @ T[-1][..., None])[..., 0] + r[:, k])
        G.append(G_n)
    return torch.stack(T, dim=1), torch.stack(G, dim=1)


def condense_parallel(A, B, r, dx0):
    """Prefix-composition condensing (the JAX package's associative scan).

    Stage k acts on the stacked (nx, nU+1) carry [Gamma | T] as
    carry' = A_k carry + C_k.  The prefix compositions
    (A_pref_k, C_pref_k) = (A_k A_pref_{k-1}, A_k C_pref_{k-1} + C_k) are
    formed by a batched loop over H, and every stage's carry is then one
    product with the initial carry.  Same contract as :func:`condense`.
    """
    ns, H, nx, nu = B.shape
    nU = H * nu
    C = A.new_zeros((ns, H, nx, nU + 1))
    C[..., nU] = r
    for k in range(H):
        C[:, k, :, k * nu:(k + 1) * nu] = B[:, k]
    A_pref, C_pref = [A[:, 0]], [C[:, 0]]
    for k in range(1, H):
        A_pref.append(A[:, k] @ A_pref[-1])
        C_pref.append(A[:, k] @ C_pref[-1] + C[:, k])
    A_pref = torch.stack(A_pref, dim=1)                     # (ns, H, nx, nx)
    C_pref = torch.stack(C_pref, dim=1)                     # (ns, H, nx, nU+1)
    carry0 = torch.cat([A.new_zeros((ns, nx, nU)), dx0[..., None]], dim=-1)
    tail = A_pref @ carry0[:, None] + C_pref
    full = torch.cat([carry0[:, None], tail], dim=1)        # (ns, H+1, nx, nU+1)
    return full[..., nU], full[..., :nU]
