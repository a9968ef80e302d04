"""The port's batched Cholesky / triangular-solve kernels' plain versions
against the JAX package's Pallas kernels in interpret mode.

* ``ops/batch_linalg.py`` (``chol``, ``tri_solve``) vs
  ``sampling_gpmpc_tpu/ops/batch_linalg.py`` under ``vmap`` with
  ``_INTERPRET`` set, at the shapes and tolerances of
  tests/test_batch_linalg.py (float32: 2e-4 for factors, 3e-4 for solves);
* ``ops/batched_chol.py`` vs ``pallas_chol._chol_kernel`` through
  ``pl.pallas_call(interpret=True)`` as tests/test_gp.py runs it (3e-6);
* the NaN pattern of an indefinite matrix, the zero upper triangle, and
  the shape routing (n < MIN_N and a shared factor go to torch.linalg);
* the blocked Cholesky the kernels run (32-column panels) against the
  column sweep of the earlier design (written out here as the TPU kernels'
  masked rank-1 arithmetic) at panel widths 1, 8 and 32 in float64, and
  against the Pallas kernels at three panels (n = 70); the NaN pattern of
  a failed pivot inside a panel, at a panel boundary and in the last panel
  the same at every width;
* the blocked triangular solve (32-row panels) against the column sweep
  in float64 at n = 50, 60, 108 and 180, both directions (the same
  updates in the same order: equal at rounding level), the per-column NaN
  pattern of a zero pivot and of a non-finite right-hand side at every
  panel width, and the Pallas kernel at three panels (n = 70).
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
    # the solve's tiles leave room for up to 186 right-hand sides at n = 180
    assert tbl.use_kernel(180, 186) and not tbl.use_kernel(180, 187)
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


def _column_sweep(A):
    """The earlier design's column sweep in the TPU kernel's arithmetic
    (batch_linalg._chol_kernel): l = A[:, j] rsqrt(A[j, j]), masked
    rank-1 trailing update, column j deposited; upper triangle cleared."""
    n = A.shape[-1]
    A = torch.tril(A)
    idx = torch.arange(n)
    for j in range(n):
        col = A[..., :, j] * torch.rsqrt(A[..., j, j])[..., None]
        f = torch.where(idx > j, col, torch.zeros_like(col))
        A = A - f[..., :, None] * f[..., None, :]
        A[..., :, j] = torch.where(idx >= j, col, torch.zeros_like(col))
    return torch.tril(A)


def _column_sweep_whole_rows(A, jitter=0.0):
    """pallas_chol._chol_kernel's column sweep: the factor accumulated as
    rank-1 outer products, so a failed pivot turns whole rows NaN."""
    n = A.shape[-1]
    eye = torch.eye(n, dtype=A.dtype)
    A = A + jitter * eye
    L = torch.zeros_like(A)
    idx = torch.arange(n)
    for j in range(n):
        colv = A[..., :, j] * torch.rsqrt(A[..., j, j])[..., None]
        zero = torch.zeros_like(colv)
        lstrict = torch.where(idx > j, colv, zero)
        A = A - lstrict[..., :, None] * lstrict[..., None, :]
        L = L + torch.where(idx >= j, colv, zero)[..., :, None] * eye[j]
    return L


@pytest.mark.parametrize("n", [17, 32, 33, 70])
@pytest.mark.parametrize("panel", [1, 8, 32])
def test_blocked_plain_matches_column_sweep(panel, n):
    """float64: both plain versions at every panel width agree with the
    column sweep to 1e-12; n = 17 is one ragged panel, 33 a full panel and
    a one-column one, 70 three panels."""
    A = torch.as_tensor(_spd(np.random.default_rng(n), 3, n, np.float64))
    L = tbl.chol_plain(A, panel)
    np.testing.assert_allclose(L.numpy(), _column_sweep(A).numpy(),
                               rtol=0, atol=1e-12)
    assert bool((torch.triu(L, 1) == 0).all())
    Lb = tbc.batched_cholesky_plain(A, 0.25, panel)
    np.testing.assert_allclose(Lb.numpy(),
                               _column_sweep_whole_rows(A, 0.25).numpy(),
                               rtol=0, atol=1e-12)


@pytest.mark.parametrize("kernel", ["chol", "batched_chol"])
def test_blocked_plain_matches_pallas_interpret_three_panels(kernel):
    """n = 70 (three 32-column panels, the last ragged) against each
    Pallas kernel in interpret mode, float32, at F_TOL."""
    A = _spd(np.random.default_rng(9), 3, 70)
    if kernel == "chol":
        ref = np.asarray(jax.vmap(jbl.chol)(jnp.asarray(A)))
        L = tbl.chol(torch.as_tensor(A)).numpy()
    else:
        ref = _jax_chol_kernel(A, 0.5)
        L = tbc.batched_cholesky(torch.as_tensor(A), 0.5,
                                 use_kernel=True).numpy()
    np.testing.assert_allclose(L, ref, rtol=F_TOL, atol=F_TOL)
    assert np.all(np.triu(L, 1) == 0.0)


@pytest.mark.parametrize("j0", [5, 31, 32, 50])
def test_nan_pattern_same_at_every_panel_width(j0):
    """A failed pivot inside the first panel (5), on its last column (31),
    on the first column of the second (32) and in the last panel (50) of
    an n = 70 batch: each plain version's NaN pattern is the column
    sweep's at panel widths 1, 8 and 32, its finite entries agree."""
    A = torch.as_tensor(_indefinite(np.random.default_rng(j0), 2, 70, j0)
                        .astype(np.float64))
    for plain, sweep in ((tbl.chol_plain, _column_sweep),
                         (tbc.batched_cholesky_plain,
                          _column_sweep_whole_rows)):
        ref = sweep(A)
        assert bool(torch.isnan(ref[:, j0, j0]).all())
        for panel in (1, 8, 32):
            L = plain(A, panel=panel)
            assert torch.equal(torch.isnan(L), torch.isnan(ref)), panel
            fin = torch.isfinite(ref)
            np.testing.assert_allclose(L[fin].numpy(), ref[fin].numpy(),
                                       rtol=0, atol=1e-12)
    # batch_linalg: row j0 keeps its earlier columns, rows past it are NaN
    L = tbl.chol_plain(A)
    assert bool(torch.isfinite(L[:, :j0]).all())
    assert bool(torch.isfinite(L[:, j0, :j0]).all())
    i = torch.arange(70)
    past = (i[:, None] > j0) & (i[None, :] <= i[:, None])
    assert bool(torch.isnan(L[:, past]).all())


def test_kernel_ranges_unchanged():
    """The blocked layout narrows no range: batched_chol's kernel takes
    every n up to 239 (the column-sweep layout's limit), and chol routes
    exactly the JAX window 16..180 to the kernel."""
    for n in range(1, 240):
        tbc.check_supported(n, torch.float32)
    assert tbc.smem_bytes(239) == 152064 and tbc.smem_bytes(180) == 88704
    with pytest.raises(ValueError, match="shared memory"):
        tbc.check_supported(tbl.PANEL * 10 + 1, torch.float32)
    with pytest.raises(ValueError, match="float32"):
        tbc.check_supported(50, torch.float64)
    routed = [n for n in range(1, 400) if tbl.use_kernel(n)]
    assert routed == list(range(tbl.MIN_N, tbl.MAX_N + 1)) == \
        list(range(16, 181))


@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("n", [50, 60, 108, 180])
def test_blocked_tri_solve_matches_column_sweep(n, transposed):
    """float64: tri_solve_plain at the kernel's panel width (32) and at 8
    agrees with the column sweep (panel 1) to 1e-12, and with scipy."""
    rng = np.random.default_rng(n)
    L = torch.as_tensor(np.linalg.cholesky(_spd(rng, 3, n, np.float64)))
    R = torch.as_tensor(rng.standard_normal((3, n, 5)))
    ref = tbl.tri_solve_plain(L, R, transposed, panel=1)
    for panel in (8, 32):
        X = tbl.tri_solve_plain(L, R, transposed, panel=panel)
        np.testing.assert_allclose(X.numpy(), ref.numpy(), rtol=0,
                                   atol=1e-12)
    X_ref = np.stack([scipy.linalg.solve_triangular(
        L[i].numpy(), R[i].numpy(), lower=True, trans=1 if transposed else 0)
        for i in range(3)])
    np.testing.assert_allclose(ref.numpy(), X_ref, rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("j0", [5, 31, 32, 50])
def test_tri_solve_nan_pattern_same_at_every_panel_width(j0):
    """n = 70, both directions: a zero pivot at row j0 turns every column
    NaN in every row, as the TPU kernel's masked update does; a NaN in one
    column of the right-hand side at row j0 turns that column NaN in every
    row and leaves the others finite and equal to the clean solve's; the
    same entries at panel widths 1, 8 and 32."""
    rng = np.random.default_rng(j0)
    n, m = 70, 4
    L = torch.as_tensor(np.linalg.cholesky(_spd(rng, 2, n, np.float64)))
    R = torch.as_tensor(rng.standard_normal((2, n, m)))
    L0 = L.clone()
    L0[:, j0, j0] = 0.0
    R1 = R.clone()
    R1[:, j0, 2] = float("nan")
    for tr in (False, True):
        clean = tbl.tri_solve_plain(L, R, tr)
        for panel in (1, 8, 32):
            X0 = tbl.tri_solve_plain(L0, R, tr, panel=panel)
            assert bool(torch.isnan(X0).all()), (tr, panel)
            X1 = tbl.tri_solve_plain(L, R1, tr, panel=panel)
            assert bool(torch.isnan(X1[..., 2]).all())
            keep = [0, 1, 3]
            assert torch.equal(X1[..., keep], clean[..., keep])


@pytest.mark.parametrize("transposed", [False, True])
def test_blocked_tri_solve_matches_pallas_interpret_three_panels(transposed):
    """n = 70 (three 32-row panels, the last ragged), m = 3, against the
    Pallas kernel in interpret mode, float32, at S_TOL; and a zero pivot
    gives the same all-NaN result there."""
    rng = np.random.default_rng(11)
    b, n, m = 3, 70, 3
    L = np.linalg.cholesky(_spd(rng, b, n))
    R = rng.standard_normal((b, n, m)).astype(np.float32)

    def jax_solve(Lx):
        return np.asarray(jax.vmap(lambda Li, Ri: jbl.tri_solve(
            Li, Ri, lower_factor_transposed=transposed))(
            jnp.asarray(Lx), jnp.asarray(R)))

    X = tbl.tri_solve(torch.as_tensor(L), torch.as_tensor(R),
                      lower_factor_transposed=transposed).numpy()
    np.testing.assert_allclose(X, jax_solve(L), rtol=S_TOL, atol=S_TOL)
    L0 = L.copy()
    L0[:, 40, 40] = 0.0
    ref0 = jax_solve(L0)
    X0 = tbl.tri_solve(torch.as_tensor(L0), torch.as_tensor(R),
                       lower_factor_transposed=transposed).numpy()
    np.testing.assert_array_equal(np.isnan(X0), np.isnan(ref0))
    assert np.isnan(X0).all()
