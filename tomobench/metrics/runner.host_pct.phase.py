"""runner.host_pct.phase: the share of the whole ROI scans' walls that
neither their ``plugin.*.process`` spans nor their copy spans cover
(runner set-up and host work between the steps)."""
from tomobench.copies import host_pct as read  # noqa: F401
