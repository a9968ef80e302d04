"""The approximate sampling MPC (BLR nominal model + sampled-trajectory
tightenings) of the planar drone: port of ``sampling_gpmpc_tpu/approx``."""
