"""The least time the card could take for a forward-sampling rollout's
work, from the sizes alone.

A rollout of ns realizations and g_ny outputs runs T steps; at step t each
realization's GP of each output is conditioned on the R real rows (one
factor shared by every realization) and on t rows of its own, appended one
a step.  The work counted is what the algorithm needs, whichever launches
do it, so that a change to how the work is split, fused or laid out leaves
the yardstick as it is:

* bytes: each step reads the shared real factor (its lower triangle), its
  weights and inputs once an output; each realization's cross-covariance
  block (R x t), the filled triangle of its own factor, its weights and
  inputs once an output, its state and base draws; and writes the
  appended row (R + t + 2 entries: the cross-covariance column, the
  factor's row and diagonal, the weight), the sampled value and GP input
  an output, and the next state;
* operations, a realization and output: three triangular solves against
  the real factor (the weights, the prediction, the appended column:
  3 R^2), three against its own (3 t^2), three products with its
  cross-covariance block (6 R t), the kernel row against the R + t
  conditioning points ((R + t)(3 D + 2)) and four dots over them (the
  mean, the variance, the Schur complement, the new weight: 8 (R + t)).

Each step's bound is the larger of its bytes over the HBM bandwidth and
its operations over the peak rate (bounds.bound_s: 67 TFLOP/s, the float32
rate outside the tensor cores and the float64 rate on them, so that the
bound stays a bound in either precision); the rollout's is their sum, the
steps being sequential.  Imports nothing of the measured program.
"""

from __future__ import annotations

from perfbench import bounds


def step_bound(ns: int, g_ny: int, R: int, t: int, D: int, nx: int,
               word: int):
    """(bytes, operations) of step t of a rollout, in elements of
    ``word`` bytes."""
    shared = R * (R + 1) // 2 + R + R * D
    own_read = R * t + t * (t + 1) // 2 + t + t * D + 1
    own_write = (R + t + 2) + 1 + D
    nbytes = word * (g_ny * shared
                     + ns * (g_ny * (own_read + own_write) + 2 * nx))
    flops = ns * g_ny * (3 * R * R + 3 * t * t + 6 * R * t
                         + (R + t) * (3 * D + 2) + 8 * (R + t))
    return nbytes, flops


def rollout_s(sizes: dict) -> float:
    """Bound of one rollout at the sizes (ns, g_ny, R, T, D, nx, word) of
    a configuration."""
    z = sizes
    return sum(bounds.bound_s(*step_bound(z["ns"], z["g_ny"], z["R"], t,
                                          z["D"], z["nx"], z["word"]))
               for t in range(z["T"]))
