"""device.idle_pct.chain: the share of the traced window in which no
kernel, copy or set ran on a card, averaged over the cell's cards."""
from tomobench.readers import idle_pct as read  # noqa: F401
