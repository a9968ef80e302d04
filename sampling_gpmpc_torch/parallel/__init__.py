"""Sample-axis sharding of the port (counterpart of
``sampling_gpmpc_tpu/parallel/``): collectives over a process group or an
in-process block group, the sample layout, the sharded solve, closed loop
and rollout, and multi-process start-up."""
