"""transport.to_device_gbps.mpi4: the bytes of the
``transport.to_device`` spans (each raw scan scattered from host memory
over the four cards, one block a card) over their summed walls, GB/s."""
from tomobench.copies import TO_DEVICE, gbps


def read(rec):
    return gbps(rec, TO_DEVICE)
