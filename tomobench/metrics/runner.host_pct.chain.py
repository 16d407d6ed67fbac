"""runner.host_pct.chain: the share of the requests' walls that neither
their ``plugin.*.process`` spans nor their copy spans cover (runner
set-up and host work between the steps; the read is a span)."""
from tomobench.copies import host_pct as read  # noqa: F401
