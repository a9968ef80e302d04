"""Environment registry (ref: main.py:73 `globals()[dynamics]`)."""

from sampling_gpmpc_torch.config import ProblemSpec
from sampling_gpmpc_torch.envs import car, car_residual, pendulum1d
from sampling_gpmpc_torch.envs.base import Env

_REGISTRY = {"Pendulum1D": pendulum1d, "bicycle": car,
             "bicycle_Bdx": car_residual}

# GP index metadata (g_idx_inputs, pad_g) of every env the configs name,
# including those whose dynamics are not ported yet: config loading needs
# it for every params/*.yaml (values of the JAX package's env modules)
_META = {
    "pendulum": ((0, 1, 2), (0, 1, 2, 3)),
    "Pendulum1D": (pendulum1d.G_IDX_INPUTS, pendulum1d.PAD_G),
    "bicycle": (car.G_IDX_INPUTS, car.PAD_G),
    "bicycle_Bdx": (car_residual.G_IDX_INPUTS, car_residual.PAD_G),
}


def make_env(spec: ProblemSpec, params: dict) -> Env:
    if spec.env_name not in _REGISTRY:
        raise NotImplementedError(
            f"env {spec.env_name!r} is not ported yet: pendulum comes with "
            "a later port slice")
    return _REGISTRY[spec.env_name].make(spec, params)


def env_meta(name: str) -> dict:
    g_idx, pad_g = _META[name]
    return {"g_idx": tuple(g_idx), "pad_g": tuple(pad_g)}
