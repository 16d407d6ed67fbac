"""transport.to_host_reused_pct.chain: the share (%) of the bytes of
the ``transport.to_host`` spans (each volume read off the card) whose
page-locked host block came from the allocator's cache, with no new
page-locked allocation (the span's ``reused``)."""
from tomobench.reuse import reused_pct as read  # noqa: F401
