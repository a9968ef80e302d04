"""The port's train-axis-sharded GP posterior
(``sampling_gpmpc_torch/gp/train_sharded.py``) against the dense Cholesky
posterior and the JAX package's sharded posterior.

The sizes and bars of the JAX package's tests/test_train_sharded.py: 32
points in [-2, 2]^2 (96 rows with gradients) over 8 blocks against the
dense posterior at 1e-8, with and without gradient observations; 2 blocks
against 4 at 1e-9 (40 points); the conditioning-set bound read through the
port's own ``config.load_problem``.  The blocks are the threads of a
``BlockGroup``; float64 on the CPU on one torch thread.
"""

import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sampling_gpmpc_torch.gp.kernel import kernel_matrix
from sampling_gpmpc_torch.gp.train_sharded import sharded_posterior_fn
from sampling_gpmpc_torch.parallel.collectives import BlockGroup, split

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(old)


def dense_posterior(Z, y, noise, X, ls, os_, with_grad):
    K = kernel_matrix(Z, Z, ls, os_, with_grad) + torch.diag(noise)
    L = torch.linalg.cholesky(K)
    Kxz = kernel_matrix(X, Z, ls, os_, with_grad)
    mean = Kxz @ torch.cholesky_solve(y[:, None], L)[:, 0]
    cov = (kernel_matrix(X, X, ls, os_, with_grad)
           - Kxz @ torch.cholesky_solve(Kxz.T, L))
    return mean, 0.5 * (cov + cov.T)


def _problem(with_grad, n_pts=32, m=5, d=2, seed=0):
    """JAX's tests/test_train_sharded.py::_problem, as numpy arrays."""
    rng = np.random.default_rng(seed)
    Z = rng.uniform(-2, 2, size=(n_pts, d))
    X = rng.uniform(-2, 2, size=(m, d))
    rows = n_pts * (1 + d) if with_grad else n_pts
    y = rng.normal(size=(rows,))
    noise = rng.uniform(1e-3, 1e-2, size=(rows,))
    return Z, y, noise, X, np.array([0.9] * d), 0.7


def _sharded(n, Z, y, noise, X, ls, os_, with_grad):
    t = lambda a: torch.as_tensor(a, dtype=torch.float64)  # noqa: E731
    Z, y, noise, X = t(Z), t(y), t(noise), t(X)
    if n == 1:
        return sharded_posterior_fn(None, ls, os_, with_grad)(Z, y, noise, X)
    g = BlockGroup(n)
    f = sharded_posterior_fn(g, ls, os_, with_grad)
    outs = g.run(lambda: f(split(Z, g, 0), split(y, g, 0),
                           split(noise, g, 0), X))
    for m, c in outs[1:]:            # replicated results
        assert torch.equal(m, outs[0][0]) and torch.equal(c, outs[0][1])
    return outs[0]


@pytest.mark.parametrize("with_grad", [False, True])
@pytest.mark.parametrize("n", [1, 8])
def test_sharded_matches_dense(with_grad, n):
    Z, y, noise, X, ls, os_ = _problem(with_grad)
    mean_s, cov_s = _sharded(n, Z, y, noise, X, ls, os_, with_grad)
    t = lambda a: torch.as_tensor(a, dtype=torch.float64)  # noqa: E731
    mean_d, cov_d = dense_posterior(t(Z), t(y), t(noise), t(X), ls, os_,
                                    with_grad)
    np.testing.assert_allclose(mean_s.numpy(), mean_d.numpy(), atol=1e-8,
                               rtol=1e-8)
    np.testing.assert_allclose(cov_s.numpy(), cov_d.numpy(), atol=1e-8)
    assert torch.equal(cov_s, cov_s.T)


def test_partition_count_invariance():
    Z, y, noise, X, ls, os_ = _problem(with_grad=False, n_pts=40)
    m2, c2 = _sharded(2, Z, y, noise, X, ls, os_, False)
    m4, c4 = _sharded(4, Z, y, noise, X, ls, os_, False)
    np.testing.assert_allclose(m2.numpy(), m4.numpy(), atol=1e-9)
    np.testing.assert_allclose(c2.numpy(), c4.numpy(), atol=1e-9)


@pytest.mark.parametrize("with_grad", [False, True])
def test_matches_jax_sharded_posterior(with_grad):
    """The same numpy inputs through JAX's sharded_posterior_fn on an
    8-device CPU mesh: 1e-8, the bar both hold against the dense path."""
    from sampling_gpmpc_tpu.gp.train_sharded import (
        sharded_posterior_fn as jfn)
    from sampling_gpmpc_tpu.parallel.mesh import sample_mesh as jmesh
    Z, y, noise, X, ls, os_ = _problem(with_grad)
    jm, jc = jax.jit(jfn(jmesh(8, axis="train"), "train", ls, os_,
                         with_grad))(jnp.asarray(Z), jnp.asarray(y),
                                     jnp.asarray(noise), jnp.asarray(X))
    m, c = _sharded(8, Z, y, noise, X, ls, os_, with_grad)
    np.testing.assert_allclose(m.numpy(), np.asarray(jm), atol=1e-8)
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), atol=1e-8)


def test_conditioning_set_bound_for_shipped_configs():
    """Conditioning-set rows per (sample, output) of every shipped config,
    read by the port's loader: the closed-loop configs stay within 4096
    rows (the dense per-device path), while the 150-SQP-iteration
    car-residual config passes 16,000 (the workload this module is for)."""
    from sampling_gpmpc_torch.config import load_problem
    sizes = {}
    for path in glob.glob(os.path.join(HERE, "params", "params_*.yaml")):
        try:
            params, spec, _ = load_problem(path)
        except KeyError:
            continue    # approx-scheme envs (drone) live outside the registry
        n_real = (params["env"]["n_data_x"]
                  * params["env"].get("n_data_u", 1))
        sizes[os.path.basename(path)] = (
            (n_real + spec.H * spec.max_sqp_iter) * spec.Ty)
    small = {k: v for k, v in sizes.items() if "car_residual" not in k}
    assert small and max(small.values()) <= 4096, small
    assert max(sizes.values()) > 16000, sizes
