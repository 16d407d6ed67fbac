"""transport.to_device_staged_pct.mpi4: the share (%) of the bytes of
the ``transport.to_device`` spans (each raw scan scattered from host
memory over the four cards) that went through page-locked staging
blocks, every card fed at once (the span's ``staged``).  A program
whose spans carry no ``staged`` reads nothing."""
from tomobench.staged import staged_pct as read  # noqa: F401
