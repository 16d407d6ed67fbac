"""runner.outside_steps_pct.service: the same share over the sweeps,
each from its first job's dispatch to its last volume on the host."""
from tomobench.readers import outside_steps_pct as read  # noqa: F401
