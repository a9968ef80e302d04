"""Seconds from the start of the benchmark's entry module to the first
timed step: imports, the CUDA context, the problem, the CUDA libraries
(built with nvcc on a checkout's first run), the draws and the warm-up."""

LAYER = "Set-up"
MOVES = "setup_s"


def read(ctx):
    return ctx.setup_s
