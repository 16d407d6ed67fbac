"""transport.alltoall_gbps.mpi4: the bytes of the
``transport.alltoall`` spans (each re-split of a scan between the
slots: the projections' blocks sent to the slots that hold their
sinograms) over their summed walls, GB/s."""
from tomobench.copies import gbps

ALLTOALL = "transport.alltoall"


def read(rec):
    return gbps(rec, ALLTOALL)
