"""The port's batched Cholesky / triangular-solve kernels' plain versions
against the JAX package's Pallas kernels in interpret mode.

* ``ops/batch_linalg.py`` (``chol``, ``tri_solve``) vs
  ``sampling_gpmpc_tpu/ops/batch_linalg.py`` under ``vmap`` with
  ``_INTERPRET`` set, at the shapes and tolerances of
  tests/test_batch_linalg.py (float32: 2e-4 for factors, 3e-4 for solves);
* ``ops/batched_chol.py`` vs ``pallas_chol._chol_kernel`` through
  ``pl.pallas_call(interpret=True)`` as tests/test_gp.py runs it (3e-6);
* the NaN pattern of an indefinite matrix, the zero upper triangle, and
  the shape routing (n < MIN_N and a shared factor go to torch.linalg).
On the CPU the wrappers take the plain versions; the CUDA kernels are held
to them on the GPU (tests/test_torch_kernels_cuda.py, chip_smoke.py).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg
import torch
from jax.experimental import pallas as pl

from sampling_gpmpc_tpu.ops import batch_linalg as jbl
from sampling_gpmpc_tpu.ops import pallas_chol
from sampling_gpmpc_torch.ops import batch_linalg as tbl
from sampling_gpmpc_torch.ops import batched_chol as tbc

F_TOL, S_TOL = 2e-4, 3e-4


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(jbl, "_INTERPRET", True)


def _spd(rng, b, n, dtype=np.float32):
    A = rng.standard_normal((b, n, n)).astype(dtype)
    return A @ np.swapaxes(A, 1, 2) + n * np.eye(n, dtype=dtype)


def _indefinite(rng, b, n, j0):
    """SPD matrices whose pivot j0 goes negative: the leading j0 x j0
    block stays positive definite."""
    A = _spd(rng, b, n)
    A[:, j0, j0] = -1.0
    return A


def _refuse(*a, **k):
    raise AssertionError("the kernel's plain version was taken")


def _jax_chol_kernel(A, jitter=0.0):
    b, n, _ = A.shape
    return np.asarray(pl.pallas_call(
        functools.partial(pallas_chol._chol_kernel, n=n, jitter=jitter),
        grid=(b,),
        in_specs=[pl.BlockSpec((1, n, n), lambda i: (i, 0, 0))],
        out_specs=pl.BlockSpec((1, n, n), lambda i: (i, 0, 0)),
        out_shape=jax.ShapeDtypeStruct((b, n, n), jnp.float32),
        interpret=True)(jnp.asarray(A)))


@pytest.mark.parametrize("b,n,seed", [(5, 24, 0), (3, 17, 2)])
def test_chol_matches_pallas_interpret(b, n, seed):
    """B=5, n=24, and B=3, n=17 (the JAX kernel pads the lanes)."""
    A = _spd(np.random.default_rng(seed), b, n)
    ref = np.asarray(jax.vmap(jbl.chol)(jnp.asarray(A)))
    L = tbl.chol(torch.as_tensor(A)).numpy()
    np.testing.assert_allclose(L, ref, rtol=F_TOL, atol=F_TOL)
    np.testing.assert_allclose(L, np.linalg.cholesky(A), rtol=F_TOL,
                               atol=F_TOL)
    assert np.all(np.triu(L, 1) == 0.0)


def test_chol_nested_batch():
    A = _spd(np.random.default_rng(1), 6, 20).reshape(3, 2, 20, 20)
    ref = np.asarray(jax.vmap(jax.vmap(jbl.chol))(jnp.asarray(A)))
    L = tbl.chol(torch.as_tensor(A)).numpy()
    np.testing.assert_allclose(L, ref, rtol=F_TOL, atol=F_TOL)


@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("m", [1, 7])
def test_tri_solve_matches_pallas_interpret(transposed, m):
    rng = np.random.default_rng(3)
    b, n = 4, 24
    L = np.linalg.cholesky(_spd(rng, b, n))
    R = rng.standard_normal((b, n, m)).astype(np.float32)
    ref = np.asarray(jax.vmap(lambda Li, Ri: jbl.tri_solve(
        Li, Ri, lower_factor_transposed=transposed))(
        jnp.asarray(L), jnp.asarray(R)))
    X = tbl.tri_solve(torch.as_tensor(L), torch.as_tensor(R),
                      lower_factor_transposed=transposed).numpy()
    np.testing.assert_allclose(X, ref, rtol=S_TOL, atol=S_TOL)
    X_ref = np.stack([scipy.linalg.solve_triangular(
        L[i], R[i], lower=True, trans=1 if transposed else 0)
        for i in range(b)])
    np.testing.assert_allclose(X, X_ref, rtol=S_TOL, atol=S_TOL)


def test_tri_solve_vector_rhs():
    rng = np.random.default_rng(4)
    b, n = 3, 20
    L = np.linalg.cholesky(_spd(rng, b, n))
    r = rng.standard_normal((b, n)).astype(np.float32)
    ref = np.asarray(jax.vmap(jbl.tri_solve)(jnp.asarray(L), jnp.asarray(r)))
    x = tbl.tri_solve(torch.as_tensor(L), torch.as_tensor(r)).numpy()
    assert x.shape == (b, n)
    np.testing.assert_allclose(x, ref, rtol=S_TOL, atol=S_TOL)


def test_chol_nan_pattern_of_an_indefinite_matrix():
    """A failed pivot at column j0: the plain version gives the TPU
    kernel's NaN entries exactly, and its finite entries to the bar."""
    j0, n = 7, 20
    A = _indefinite(np.random.default_rng(5), 3, n, j0)
    ref = np.asarray(jax.vmap(jbl.chol)(jnp.asarray(A)))
    L = tbl.chol(torch.as_tensor(A)).numpy()
    np.testing.assert_array_equal(np.isnan(L), np.isnan(ref))
    assert np.isnan(L[:, j0, j0]).all() and np.isfinite(L[:, :j0]).all()
    below = np.tril(np.ones((n, n), bool))[j0 + 1:]     # rows past j0
    assert np.isnan(L[:, j0 + 1:][:, below]).all()
    fin = np.isfinite(ref)
    np.testing.assert_allclose(L[fin], ref[fin], rtol=F_TOL, atol=F_TOL)
    assert np.all(np.triu(L, 1) == 0.0)


@pytest.mark.parametrize("jitter", [0.0, 0.5])
def test_batched_cholesky_matches_pallas_interpret(jitter):
    rng = np.random.default_rng(0)
    b, n = 3, 16
    X = rng.normal(size=(b, n, n)).astype("float32")
    A = np.einsum("bij,bkj->bik", X, X) + 3 * np.eye(n, dtype="float32")
    ref = _jax_chol_kernel(A, jitter)
    L = tbc.batched_cholesky(torch.as_tensor(A), jitter, use_kernel=True)
    np.testing.assert_allclose(L.numpy(), ref, atol=3e-6)
    assert np.all(np.triu(L.numpy(), 1) == 0.0)
    # the default route is torch.linalg, as the JAX default is XLA
    L_lib = tbc.batched_cholesky(torch.as_tensor(A), jitter)
    np.testing.assert_allclose(L_lib.numpy(), ref, atol=3e-6)


def test_batched_cholesky_nan_pattern_of_an_indefinite_matrix():
    j0, n = 5, 16
    A = _indefinite(np.random.default_rng(6), 2, n, j0)
    ref = _jax_chol_kernel(A)
    L = tbc.batched_cholesky_plain(torch.as_tensor(A)).numpy()
    np.testing.assert_array_equal(np.isnan(L), np.isnan(ref))
    assert np.isnan(L[:, j0:]).all() and np.isfinite(L[:, :j0]).all()
    fin = np.isfinite(ref)
    np.testing.assert_allclose(L[fin], ref[fin], atol=3e-6)


def test_shape_routing(monkeypatch):
    """The decision is made from shapes: n < MIN_N, an unbatched matrix
    and a shared (unbatched) factor go to torch.linalg; in the window a
    CPU batch takes the plain version."""
    monkeypatch.setattr(tbl, "chol_plain", _refuse)
    monkeypatch.setattr(tbl, "tri_solve_plain", _refuse)
    rng = np.random.default_rng(7)
    A12 = _spd(rng, 4, 12)
    np.testing.assert_allclose(tbl.chol(torch.as_tensor(A12)).numpy(),
                               np.linalg.cholesky(A12), rtol=F_TOL,
                               atol=F_TOL)
    A20 = _spd(rng, 1, 20)[0]
    np.testing.assert_allclose(tbl.chol(torch.as_tensor(A20)).numpy(),
                               np.linalg.cholesky(A20), rtol=F_TOL,
                               atol=F_TOL)
    # shared factor: folded into one solve, as the JAX package's XLA route
    n, m = 20, 5
    L = np.linalg.cholesky(A20)
    R = rng.standard_normal((6, n, m)).astype(np.float32)
    for transposed in (False, True):
        X = tbl.tri_solve(torch.as_tensor(L), torch.as_tensor(R),
                          lower_factor_transposed=transposed).numpy()
        ref = np.asarray(jax.vmap(lambda Ri: jbl.tri_solve(
            jnp.asarray(L), Ri, lower_factor_transposed=transposed))(
            jnp.asarray(R)))
        np.testing.assert_allclose(X, ref, rtol=S_TOL, atol=S_TOL)
    # an indefinite matrix on the library route is all NaN, as XLA's
    bad = _indefinite(rng, 2, 12, 3)
    assert np.isnan(tbl.chol(torch.as_tensor(bad)).numpy()).all()
    assert tbl.use_kernel(16) and tbl.use_kernel(180)
    assert not tbl.use_kernel(15) and not tbl.use_kernel(181)
    assert tbl.use_kernel(180, 141) and not tbl.use_kernel(180, 142)
    with pytest.raises(AssertionError, match="plain version"):
        tbl.chol(torch.as_tensor(_spd(rng, 2, 16)))


def test_plain_versions_float64_exact():
    """In float64 the plain versions carry textbook accuracy (1e-12)."""
    rng = np.random.default_rng(8)
    A = _spd(rng, 4, 30, np.float64)
    L = tbl.chol_plain(torch.as_tensor(A)).numpy()
    np.testing.assert_allclose(L, np.linalg.cholesky(A), atol=1e-12)
    L2 = tbc.batched_cholesky_plain(torch.as_tensor(A), 0.25).numpy()
    np.testing.assert_allclose(
        L2, np.linalg.cholesky(A + 0.25 * np.eye(30)), atol=1e-12)
    R = rng.standard_normal((4, 30, 3))
    for tr in (False, True):
        X = tbl.tri_solve_plain(torch.as_tensor(L), torch.as_tensor(R),
                                tr).numpy()
        ref = np.stack([scipy.linalg.solve_triangular(
            L[i], R[i], lower=True, trans=1 if tr else 0) for i in range(4)])
        np.testing.assert_allclose(X, ref, atol=1e-12)
