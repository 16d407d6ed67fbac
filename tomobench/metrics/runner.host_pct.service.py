"""runner.host_pct.service: the same share over the sweeps, each from
its first job's dispatch to its last volume on the host."""
from tomobench.copies import host_pct as read  # noqa: F401
