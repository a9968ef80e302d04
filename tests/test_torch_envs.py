"""Pendulum1D, 2D pendulum and residual-car (``bicycle_Bdx``) dynamics of
the port vs the JAX package (float64, 1e-12: the same closed forms) and
their analytic Jacobians vs torch autodiff (the car's are in
tests/test_torch_car.py)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sampling_gpmpc_tpu.config import load_problem as jload
from sampling_gpmpc_tpu.envs import make_env as jmake_env
from sampling_gpmpc_torch.config import load_problem as tload
from sampling_gpmpc_torch.envs import make_env as tmake_env

PDIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "params")
TOL = 1e-12


@pytest.fixture(scope="module")
def envs():
    path = os.path.join(PDIR, "params_pendulum1D_samples.yaml")
    jp, js, _ = jload(path)
    tp, ts, _ = tload(path)
    return jmake_env(js, jp), tmake_env(ts, tp)


def _points(n=16, seed=0):
    rng = np.random.default_rng(seed)
    return np.stack([rng.uniform(2.0, 3.7, n), rng.uniform(-2.5, 2.5, n),
                     rng.uniform(-5, 5, n)], axis=-1)        # (n, nx+nu)


def test_dynamics_match_jax(envs):
    jenv, tenv = envs
    xu = _points()
    txu = torch.as_tensor(xu)
    jxu = jnp.asarray(xu)
    pairs = [
        (jax.vmap(jenv.f_val_jac)(jxu), tenv.f_val_jac(txu)),
        (jax.vmap(jenv.g_val)(jenv.g_inputs(jxu)),
         tenv.g_val(tenv.g_inputs(txu))),
        (jax.vmap(jenv.g_prior)(jenv.g_inputs(jxu)),
         tenv.g_prior(tenv.g_inputs(txu))),
        (jax.vmap(jenv.B_d)(jxu), tenv.B_d(txu)),
        (jax.vmap(jenv.discrete_dyn)(jxu[:, :2], jxu[:, 2:]),
         tenv.discrete_dyn(txu[:, :2], txu[:, 2:])),
    ]
    dg = np.random.default_rng(1).normal(size=(xu.shape[0], 1, 3))
    pairs.append((jax.vmap(jenv.assemble_val_jac)(jxu, jnp.asarray(dg)),
                  tenv.assemble_val_jac(txu, torch.as_tensor(dg))))
    for ref, got in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=TOL,
                                   rtol=TOL)


def test_training_grid_matches_jax(envs):
    jenv, tenv = envs
    (jX, jY), (tX, tY) = jenv.training_grid(), tenv.training_grid()
    np.testing.assert_allclose(tX, jX, atol=TOL)
    np.testing.assert_allclose(tY, jY, atol=TOL)


def test_analytic_jacobians_match_autodiff(envs):
    """f_val_jac's derivative columns and g_prior's gradient entries are
    the Jacobians of their value columns (torch.func.jacfwd)."""
    _, tenv = envs
    for xu in torch.as_tensor(_points(4, seed=2)):
        J = torch.func.jacfwd(lambda v: tenv.f_val_jac(v)[:, 0])(xu)
        np.testing.assert_allclose(tenv.f_val_jac(xu)[:, 1:].numpy(),
                                   J.numpy(), atol=TOL)
        z = tenv.g_inputs(xu)
        Jg = torch.func.jacfwd(lambda v: tenv.g_val(v))(z)
        np.testing.assert_allclose(tenv.g_prior(z)[:, 1:].numpy(),
                                   Jg.numpy(), atol=TOL)


PENDULUM_CONFIGS = ["params_pendulum", "params_pendulum_samples",
                    "params_pendulum_invariant"]


def _pendulum_envs(name):
    path = os.path.join(PDIR, name + ".yaml")
    jp, js, _ = jload(path)
    tp, ts, _ = tload(path)
    assert ts.env_name == "pendulum"
    return jmake_env(js, jp), tmake_env(ts, tp)


@pytest.mark.parametrize("name", PENDULUM_CONFIGS)
def test_pendulum_dynamics_match_jax(name):
    """The 2D pendulum (the GP models the whole map, B_d = I): the known
    part (all zeros), g_val, g_prior's value and gradient rows, B_d, the
    plant step and the assembled rows against the JAX package."""
    jenv, tenv = _pendulum_envs(name)
    assert tenv.spec.g_idx_inputs == (0, 1, 2)
    assert tenv.spec.pad_g == (0, 1, 2, 3)
    xu = _points(seed=3)
    txu, jxu = torch.as_tensor(xu), jnp.asarray(xu)
    dg = np.random.default_rng(4).normal(size=(xu.shape[0], 2, 4))
    pairs = [
        (jax.vmap(jenv.f_val_jac)(jxu), tenv.f_val_jac(txu)),
        (jax.vmap(jenv.g_val)(jenv.g_inputs(jxu)),
         tenv.g_val(tenv.g_inputs(txu))),
        (jax.vmap(jenv.g_prior)(jenv.g_inputs(jxu)),
         tenv.g_prior(tenv.g_inputs(txu))),
        (jax.vmap(jenv.B_d)(jxu), tenv.B_d(txu)),
        (jax.vmap(jenv.discrete_dyn)(jxu[:, :2], jxu[:, 2:]),
         tenv.discrete_dyn(txu[:, :2], txu[:, 2:])),
        (jax.vmap(jenv.assemble_val_jac)(jxu, jnp.asarray(dg)),
         tenv.assemble_val_jac(txu, torch.as_tensor(dg))),
    ]
    for ref, got in pairs:
        assert tuple(got.shape) == tuple(np.shape(ref))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=TOL,
                                   rtol=TOL)
    assert not tenv.f_val_jac(txu).any()
    np.testing.assert_array_equal(tenv.B_d(txu[0]).numpy(), np.eye(2))


@pytest.mark.parametrize("name", PENDULUM_CONFIGS)
def test_pendulum_training_grid_matches_jax(name):
    """The n_data_x^2 n_data_u grid over (x1, x2, u) and its targets."""
    jenv, tenv = _pendulum_envs(name)
    (jX, jY), (tX, tY) = jenv.training_grid(), tenv.training_grid()
    assert tX.shape == (45, 3)                     # 3 x 3 x 5
    assert tY.shape == (2, 45, 4)
    np.testing.assert_allclose(tX, jX, atol=TOL)
    np.testing.assert_allclose(tY, jY, atol=TOL)


def test_pendulum_analytic_jacobians_match_autodiff():
    """g_prior's gradient entries are the Jacobians of g_val
    (torch.autograd through torch.func.jacfwd), and the plant step's
    Jacobian is B_d times them."""
    _, tenv = _pendulum_envs("params_pendulum")
    for xu in torch.as_tensor(_points(4, seed=5)):
        z = tenv.g_inputs(xu)
        Jg = torch.func.jacfwd(tenv.g_val)(z)
        np.testing.assert_allclose(tenv.g_prior(z)[:, 1:].numpy(),
                                   Jg.numpy(), atol=TOL)
        Jd = torch.autograd.functional.jacobian(
            lambda v: tenv.discrete_dyn(v[:2], v[2:]), xu)
        np.testing.assert_allclose(Jd.numpy(), Jg.numpy(), atol=TOL)


def _car_points(n=16, seed=0):
    rng = np.random.default_rng(seed)
    return np.stack([rng.uniform(0, 70, n), rng.uniform(0, 6, n),
                     rng.uniform(-1.1, 1.1, n), rng.uniform(9, 16, n),
                     rng.uniform(-0.6, 0.6, n), rng.uniform(-2, 2, n)],
                    axis=-1)                                # (n, nx+nu)


@pytest.mark.parametrize("name", ["params_car_residual",
                                  "params_car_residual_fs"])
def test_car_residual_matches_jax(name):
    """Values, g_prior Jacobians, the constant B_d, B_d_dyn = v I,
    transform_sensitivity (Ty = 3, and the value-only Ty = 1 of the
    forward-sampling config), the assembled rows and the training grid."""
    path = os.path.join(PDIR, name + ".yaml")
    jp, js, _ = jload(path)
    tp, ts, _ = tload(path)
    jenv, tenv = jmake_env(js, jp), tmake_env(ts, tp)
    assert ts.env_name == "bicycle_Bdx"
    xu = _car_points()
    txu, jxu = torch.as_tensor(xu), jnp.asarray(xu)
    dg = np.random.default_rng(1).normal(size=(xu.shape[0], 3, ts.Ty))
    pairs = [
        (jax.vmap(jenv.f_val_jac)(jxu), tenv.f_val_jac(txu)),
        (jax.vmap(jenv.g_val)(jenv.g_inputs(jxu)),
         tenv.g_val(tenv.g_inputs(txu))),
        (jax.vmap(jenv.g_prior)(jenv.g_inputs(jxu)),
         tenv.g_prior(tenv.g_inputs(txu))),
        (jax.vmap(jenv.B_d)(jxu), tenv.B_d(txu)),
        (jax.vmap(jenv.B_d_dyn)(jxu), tenv.B_d_dyn(txu)),
        (jax.vmap(jenv.discrete_dyn)(jxu[:, :4], jxu[:, 4:]),
         tenv.discrete_dyn(txu[:, :4], txu[:, 4:])),
        (jax.vmap(jenv.transform_sensitivity)(jnp.asarray(dg), jxu),
         tenv.transform_sensitivity(torch.as_tensor(dg), txu)),
        (jax.vmap(jenv.assemble_val_jac)(jxu, jnp.asarray(dg)),
         tenv.assemble_val_jac(txu, torch.as_tensor(dg))),
    ]
    for ref, got in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=TOL,
                                   rtol=TOL)
    (jX, jY), (tX, tY) = jenv.training_grid(), tenv.training_grid()
    assert tX.shape == (45, 2)                     # 5 phi x 9 delta
    np.testing.assert_allclose(tX, jX, atol=TOL)
    np.testing.assert_allclose(tY, jY, atol=TOL)
    # g_prior's gradient entries are the Jacobians of g_val
    for z in tenv.g_inputs(txu[:4]):
        Jg = torch.func.jacfwd(tenv.g_val)(z)
        np.testing.assert_allclose(tenv.g_prior(z)[:, 1:].numpy(),
                                   Jg.numpy(), atol=TOL)
