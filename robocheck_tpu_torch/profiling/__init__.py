"""Counters, timers and the stage-isolating probe kernels of the port
(the counterpart of `robocheck_tpu.profiling` and of the JAX package's
`scripts/bisect_stage{1,2,3}.py` probes)."""
