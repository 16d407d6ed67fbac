"""transport.to_device_staged_pct.chain: the share (%) of the bytes of
the ``transport.to_device`` spans (each raw band handed from host
memory to the card) that went through page-locked staging blocks (the
span's ``staged``).  A program whose spans carry no ``staged`` reads
nothing."""
from tomobench.staged import staged_pct as read  # noqa: F401
