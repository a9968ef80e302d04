"""Environment registry (ref: main.py:73 `globals()[dynamics]`)."""

from sampling_gpmpc_torch.config import ProblemSpec
from sampling_gpmpc_torch.envs import car, car_residual, pendulum, pendulum1d
from sampling_gpmpc_torch.envs.base import Env

_REGISTRY = {"pendulum": pendulum, "Pendulum1D": pendulum1d, "bicycle": car,
             "bicycle_Bdx": car_residual}

# GP index metadata (g_idx_inputs, pad_g) of every env the configs name:
# config loading needs it for every params/*.yaml
_META = {name: (mod.G_IDX_INPUTS, mod.PAD_G)
         for name, mod in _REGISTRY.items()}


def make_env(spec: ProblemSpec, params: dict) -> Env:
    return _REGISTRY[spec.env_name].make(spec, params)


def env_meta(name: str) -> dict:
    g_idx, pad_g = _META[name]
    return {"g_idx": tuple(g_idx), "pad_g": tuple(pad_g)}
