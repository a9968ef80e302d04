"""The benchmark of the PyTorch and CUDA port of sampling-based GP-MPC.

Run one cell (from the root of a checkout, on a machine with an NVIDIA
GPU):

    python -m perfbench.run --workload <name> --seed <n> --seconds <s>
        --trace <0|1>

``BENCHMARK.json`` at the root names the cells, their configurations,
traffic mixes and metrics; this package finds each by name.
"""
