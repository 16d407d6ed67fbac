"""runner.host_pct.mpi4: the share of the whole scans' walls that
neither their ``plugin.*.process`` spans nor their copy spans (the
scatter, the gather) cover: runner set-up, the all-to-all between
cards, and host work between the steps."""
from tomobench.copies import host_pct as read  # noqa: F401
