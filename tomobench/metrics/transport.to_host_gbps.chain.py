"""transport.to_host_gbps.chain: the bytes of the ``transport.to_host``
spans (each volume read off the card into host memory) over their
summed walls, GB/s."""
from tomobench.copies import TO_HOST, gbps


def read(rec):
    return gbps(rec, TO_HOST)
