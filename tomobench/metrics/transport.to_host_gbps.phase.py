"""transport.to_host_gbps.phase: the bytes of the ``transport.to_host``
spans (each whole ROI's volume read off the card into host memory) over
their summed walls, GB/s."""
from tomobench.copies import TO_HOST, gbps


def read(rec):
    return gbps(rec, TO_HOST)
