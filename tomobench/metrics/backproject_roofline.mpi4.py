"""backproject_roofline.mpi4: ``backproject_roofline`` of the whole
scan over four cards: the frozen least time of each request's
backprojection (every slice of the volume, on the cell's four cards)
over its ``plugin.fbp_recon.process`` span, which ends when every card
has finished its share, in %."""
from tomobench.metrics.backproject_roofline import read  # noqa: F401
