"""device.idle_pct.phase: the share of the traced window in which no
kernel, copy or set ran on the card."""
from tomobench.readers import idle_pct as read  # noqa: F401
