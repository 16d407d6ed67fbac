"""transport.to_host_gbps.mpi4: the bytes of the ``transport.to_host``
spans (each whole volume gathered off the four cards into host memory)
over their summed walls, GB/s."""
from tomobench.copies import TO_HOST, gbps


def read(rec):
    return gbps(rec, TO_HOST)
