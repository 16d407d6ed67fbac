"""transport.to_host_reused_pct.service: the same share over a service
cell's sweeps (each variant's volume read off the card)."""
from tomobench.reuse import reused_pct as read  # noqa: F401
