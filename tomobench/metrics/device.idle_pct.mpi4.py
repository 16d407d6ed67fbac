"""device.idle_pct.mpi4: the share of the traced window in which no
kernel, copy or set ran on a card, averaged over the four cards."""
from tomobench.readers import idle_pct as read  # noqa: F401
