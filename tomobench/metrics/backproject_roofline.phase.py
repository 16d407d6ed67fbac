"""backproject_roofline.phase: ``backproject_roofline`` of the whole
720-row ROI: the frozen least time of each request's backprojection
over its ``plugin.fbp_recon.process`` span, in %."""
from tomobench.metrics.backproject_roofline import read  # noqa: F401
