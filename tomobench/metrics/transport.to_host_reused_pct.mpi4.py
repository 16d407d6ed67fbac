"""transport.to_host_reused_pct.mpi4: the share (%) of the bytes of
the ``transport.to_host`` spans (each whole volume gathered off the
four cards) whose page-locked staging blocks all came from the host
allocator's cache, with no new page-locked allocation (the span's
``reused``).  A program whose gather carries no ``reused`` reads
nothing."""
from tomobench.reuse import reused_pct as read  # noqa: F401
