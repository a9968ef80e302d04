"""sampling_gpmpc_torch — PyTorch/CUDA port of the sampling-based GP-MPC.

The same method as ``sampling_gpmpc_tpu`` (exact derivative GP, per-sample
function draws, one augmented SQP-RTI OCP over all samples, closed loop),
written for an NVIDIA Hopper GPU.  Module names match the JAX package so
each counterpart is easy to find:

    config.py     — reference-compatible YAML experiment configs
    envs/         — dynamics models (this slice: Pendulum1D)
    gp/           — derivative-RBF kernels, exact conditioning, sampling
    agent.py      — GP state, epistemic draws, function-sample stage
    ops/          — hand-written CUDA kernels + their plain torch versions
    ocp/          — OCP data, condensing, structured soft QP, SQP-RTI
    dempc.py      — closed-loop receding-horizon driver
    recorder.py   — data.pkl-compatible artifacts
    convert.py    — JAX-side numpy arrays -> the port's tensors

Importing this package imports neither ``jax`` nor ``sampling_gpmpc_tpu``.
"""

__version__ = "0.1.0"
