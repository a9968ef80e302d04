#!/bin/bash
# Batch experiment runner of the port (counterpart of the repository root's
# run_experiment.sh, which drives the JAX package): runs a set of seeds for
# one config back to back through python -m sampling_gpmpc_torch.main, on
# the GPU unless told otherwise.  Arguments after -- go to every run, e.g.
# --device cpu (float64 on the CPU) or -q.
#   sampling_gpmpc_torch/run_experiment.sh params_pendulum1D_samples 0 1 2
#   sampling_gpmpc_torch/run_experiment.sh params_car 42 -- --device cpu -q
set -e
cd "$(dirname "$0")/.."
PARAM=${1:-params_pendulum1D_samples}
shift || true
SEEDS=()
while [ $# -gt 0 ] && [ "$1" != "--" ]; do
    SEEDS+=("$1")
    shift
done
if [ "$1" = "--" ]; then
    shift
fi
if [ ${#SEEDS[@]} -eq 0 ]; then
    SEEDS=(42)
fi
for i in "${SEEDS[@]}"; do
    echo "=== $PARAM seed $i ==="
    python -m sampling_gpmpc_torch.main -param "$PARAM" -env 0 -i "$i" "$@"
done
