"""The plain reference of the benchmark: the sampling GP-MPC step worked
out again from the configuration file and the draws, in any dtype on any
device.  Imports nothing of the measured program."""
