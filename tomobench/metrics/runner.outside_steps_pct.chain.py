"""runner.outside_steps_pct.chain: the share of the requests' walls that
their ``plugin.*.process`` spans leave uncovered (runner set-up, host
work between the steps, the result's read)."""
from tomobench.readers import outside_steps_pct as read  # noqa: F401
