"""device.idle_pct.service: the same share, in a service cell."""
from tomobench.readers import idle_pct as read  # noqa: F401
