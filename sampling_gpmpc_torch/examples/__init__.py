"""The port's examples: iterative GP conditioning (E7) and the LQR sanity
check (E10); the drone example is ``sampling_gpmpc_torch.
drone_obstacle_avoidance``."""
